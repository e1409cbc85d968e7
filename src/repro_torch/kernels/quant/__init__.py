"""Int8 block quantization: ``ref`` is the plain PyTorch version, ``ops``
the wrapper of the CUDA kernel ``csrc/quant.cu``."""

from repro_torch.kernels.quant import ops, ref  # noqa: F401
