"""Launchers: the training launcher (:mod:`.train`).  The reference's mesh,
cell, dry-run and roofline modules, which lower XLA programs on TPU meshes,
are not ported yet."""
