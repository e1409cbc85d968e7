"""ELL frontier expansion, push and pull, and the frontier algebras' value
gather: ``ref`` is the plain PyTorch version, ``ops`` the wrappers of the
CUDA kernels ``csrc/spmv.cu``."""

from repro_torch.kernels.spmv import ops, ref  # noqa: F401
