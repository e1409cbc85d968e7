"""ELL frontier expansion, push and pull: ``ref`` is the plain PyTorch
version, ``ops`` the wrappers of the CUDA kernels ``csrc/spmv.cu``."""

from repro_torch.kernels.spmv import ops, ref  # noqa: F401
