"""Wrapper of the int8 block-quantize kernel (``csrc/quant.cu``).

CPU tensors go to the plain version in :mod:`.ref`; CUDA tensors go to the
kernel or raise.  Any N that is a multiple of 128 is taken (the Pallas
kernel needed N % 1024 == 0; the payload path pads only to 128).
``dequantize`` stays plain, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.quant import ref

KERNEL = "quantize"

dequantize = ref.dequantize


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N,) float32 -> (q int8 (N,), scales f32 (N/128,))."""
    if not kernels.on_cuda(x):
        return ref.quantize(x)
    kernels.require(x, "x", (torch.float32,), 1)
    n = x.shape[0]
    if n % ref.GROUP:
        raise ValueError(f"quantize: N={n} is not a multiple of {ref.GROUP}")
    if x.data_ptr() % 16:
        raise ValueError("quantize: x must be 16-byte aligned (float4 loads)")
    # two allocations: one buffer cut into the codes and the scales took more
    # host time (two views) than the second allocation saved (bench.host_floor)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(n // ref.GROUP, dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scales
    kernels.launch(KERNEL, "rt_quantize", (kernels.P, kernels.P, kernels.P, kernels.I64),
                   x.data_ptr(), q.data_ptr(), scales.data_ptr(), n // ref.GROUP)
    return q, scales
