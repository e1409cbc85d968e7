"""Plain PyTorch version of the popcount kernels (SWAR over int64 lanes
masked to 32 bits: PyTorch has no shifts on ``uint32`` and int32 ``>>`` is
arithmetic, so ``>> 24`` on an int32 word would smear the sign bit)."""

from __future__ import annotations

import torch


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word bit counts of int32 words holding uint32 bit patterns."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount_total(words: torch.Tensor) -> torch.Tensor:
    """Bits set over all of ``words`` -> 0-d int32."""
    return popcount_words(words).sum(dtype=torch.int32)


def popcount_planes(words: torch.Tensor) -> torch.Tensor:
    """(B, W) words -> (B,) int32 per-plane bit counts."""
    return popcount_words(words).sum(dim=1, dtype=torch.int32)


BLOCK_WORDS = 1024  # words per partial count, as the TPU kernel's (8, 128) tile


def popcount_blocks(words: torch.Tensor) -> torch.Tensor:
    """(W,) words -> (ceil(W/1024),) int32 per-block bit counts (the last
    block zero-padded)."""
    pad = (-words.shape[0]) % BLOCK_WORDS
    counts = popcount_words(words)
    if pad:
        counts = torch.cat([counts, counts.new_zeros(pad)])
    return counts.reshape(-1, BLOCK_WORDS).sum(dim=1, dtype=torch.int32)
