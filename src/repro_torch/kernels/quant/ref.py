"""Plain PyTorch version of int8 block quantization.

The port's copy of ``repro/kernels/quant/ref.py``: per group of ``GROUP``
consecutive values, ``scale = max|g| / 127`` and
``q = clip(round(g / scale), -127, 127)`` as int8, with an all-zero group
dividing by 1.  ``torch.round`` rounds half to even, as ``jnp.round`` does,
and both divisions are IEEE quotients on every device, as the kernel's are.
"""

from __future__ import annotations

import torch

GROUP = 128  # values per scale group


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N,) float -> (q int8 (N,), scales f32 (N/GROUP,)). N % GROUP == 0."""
    n = x.shape[0]
    assert n % GROUP == 0, n
    g = x.to(torch.float32).reshape(-1, GROUP)
    amax = g.abs().amax(dim=1)
    # a tensor divisor: on CUDA, torch divides by a Python scalar as a
    # multiply by its reciprocal, which can miss the IEEE quotient by an ulp
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(g / safe[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    g = q.to(torch.float32).reshape(-1, GROUP) * scale[:, None]
    return g.reshape(-1).to(dtype)
