"""Launchers and the cell catalogue: the training launcher (:mod:`.train`),
the mesh geometry and placement specs (:mod:`.mesh`), the 43-cell catalogue
with its FLOP models (:mod:`.cells`) and the H100 roofline terms
(:mod:`.roofline`).  The reference's dry-run (``launch/dryrun.py``), which
lowers XLA programs on forced TPU meshes, is not ported."""
