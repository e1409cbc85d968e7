"""Graph500 generation and Kernel 1 (host-side numpy copies of
``repro.graphgen``)."""

from repro_torch.graphgen import builder, kronecker  # noqa: F401
