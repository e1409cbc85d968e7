"""Vertical bit packing: ``ref`` is the plain PyTorch version, ``ops`` the
wrapper of the CUDA kernel ``csrc/bitpack.cu``."""

from repro_torch.kernels.bitpack import ops, ref  # noqa: F401
from repro_torch.kernels.bitpack.ref import B_CLASSES, CHUNK  # noqa: F401
