"""Graph500 generation and Kernel 1, and the codec study's synthetic
streams (host-side numpy copies of ``repro.graphgen``)."""

from repro_torch.graphgen import builder, kronecker, zipf  # noqa: F401
