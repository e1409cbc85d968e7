"""Bitmap popcounts: ``ref`` is the plain PyTorch version, ``ops`` the
wrappers of the CUDA kernels ``csrc/popcount.cu``."""

from repro_torch.kernels.popcount import ops, ref  # noqa: F401
