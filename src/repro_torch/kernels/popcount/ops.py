"""Wrappers of the popcount kernels (``csrc/popcount.cu``).

CPU tensors go to the plain version in :mod:`.ref`; CUDA tensors go to the
kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.popcount import ref

BLOCKS_KERNEL = "popcount_blocks"
PLANES_KERNEL = "popcount_planes"
WORDS_KERNEL = "popcount_words"
_MAX_PLANES = 65535  # gridDim.y


def popcount_planes(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words -> (B,) int32 per-plane bit counts (any ``W``)."""
    if not kernels.on_cuda(words):
        return ref.popcount_planes(words)
    kernels.require(words, "popcount_planes", (torch.int32,), 2)
    planes, w = words.shape
    if planes > _MAX_PLANES:
        raise ValueError(f"popcount_planes: at most {_MAX_PLANES} planes, got {planes}")
    out = torch.zeros(planes, dtype=torch.int32, device=words.device)
    if words.numel() == 0:
        return out
    kernels.launch(PLANES_KERNEL, "rt_popcount_planes",
                   (kernels.P, kernels.P, kernels.I64, kernels.I32),
                   words.data_ptr(), out.data_ptr(), w, planes)
    return out


def popcount_blocks(words: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words -> (ceil(W/1024),) int32 per-1024-word-block counts."""
    if not kernels.on_cuda(words):
        return ref.popcount_blocks(words)
    kernels.require(words, "popcount_blocks", (torch.int32,), 1)
    out = torch.empty(-(-words.shape[0] // ref.BLOCK_WORDS), dtype=torch.int32,
                      device=words.device)
    if out.numel() == 0:
        return out
    kernels.launch(BLOCKS_KERNEL, "rt_popcount_blocks", (kernels.P, kernels.P, kernels.I64),
                   words.data_ptr(), out.data_ptr(), words.shape[0])
    return out


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word bit counts, same shape, int32."""
    if not kernels.on_cuda(words):
        return ref.popcount_words(words)
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise TypeError("popcount_words: expected contiguous int32 words")
    out = torch.empty_like(words)
    if words.numel() == 0:
        return out
    kernels.launch(WORDS_KERNEL, "rt_popcount_words",
                   (kernels.P, kernels.P, kernels.I64),
                   words.data_ptr(), out.data_ptr(), words.numel())
    return out
