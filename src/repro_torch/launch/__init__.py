"""Launchers and the cell catalogue: the training launcher (:mod:`.train`),
the mesh geometry and placement specs (:mod:`.mesh`), the 43-cell catalogue
with its FLOP models (:mod:`.cells`), the H100 roofline terms and the
collective count (:mod:`.roofline`), and the dry-run that counts each
cell's program on ``meta`` (:mod:`.dryrun`)."""
