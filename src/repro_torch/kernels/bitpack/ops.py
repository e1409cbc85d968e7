"""Wrapper of the bit-packing kernel (``csrc/bitpack.cu``).

CPU tensors go to the plain version in :mod:`.ref`; CUDA tensors go to the
kernel or raise.  ``b=32`` is the identity on the bit pattern and launches
nothing.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.bitpack import ref

KERNEL = "pack"
_ARGS = (kernels.P, kernels.P, kernels.I64, kernels.I64, kernels.I32, kernels.I32)
_MAX_PLANES = 65535  # gridDim.y


def pack_planes(values: torch.Tensor, b: int) -> torch.Tensor:
    """(B, n) values -> (B, chunk_pad(n)*b/32) int32 packed words.

    ``values`` is bool/uint8 (membership planes, read in place) or int32
    (uint32 bit patterns); any ``n`` — positions past ``n`` pack as zeros.
    """
    if b not in ref.B_CLASSES:
        raise ValueError(f"bit width {b} not in {ref.B_CLASSES}")
    if not kernels.on_cuda(values):
        return ref.pack_planes(values, b)
    kernels.require(values, "pack_planes", (torch.bool, torch.uint8, torch.int32), 2)
    planes, n = values.shape
    if b == 32:
        return ref.pack_planes(values, 32)
    if planes > _MAX_PLANES:
        raise ValueError(f"pack_planes: at most {_MAX_PLANES} planes, got {planes}")
    words = ref.words_for(n, b)
    out = torch.empty((planes, words), dtype=torch.int32, device=values.device)
    if out.numel() == 0:
        return out
    name = "rt_pack_u32" if values.dtype == torch.int32 else "rt_pack_u8"
    kernels.launch(KERNEL, name, _ARGS, values.data_ptr(), out.data_ptr(), n,
                   words, planes, b)
    return out


def pack(values: torch.Tensor, b: int) -> torch.Tensor:
    """(n,) values -> (chunk_pad(n)*b/32,) int32 packed words."""
    return pack_planes(values.reshape(1, -1), b)[0]
