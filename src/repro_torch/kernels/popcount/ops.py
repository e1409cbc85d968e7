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
_PLANES_ARGS = (kernels.P, kernels.P, kernels.P, kernels.I64, kernels.I32, kernels.I32)
_BLOCKS_ARGS = (kernels.P, kernels.P, kernels.I64, kernels.I32)
#: per (device, stream): the ticket words of popcount_planes, one 64-bit word
#: a plane (blocks done, bits so far), 0 between calls; zeroed once, when
#: made or grown
_SCRATCH: dict[tuple[torch.device, int], torch.Tensor] = {}


def _ticket_scratch(device: torch.device, planes: int) -> torch.Tensor:
    """The zeroed ticket words of the current stream on ``device``: the
    stream :func:`kernels.launch` launches on for tensors on ``device``.

    Calls on one stream run in order, so each finds the words as the last
    one left them, 0; calls on two streams get separate words."""
    key = (device, kernels.current_stream(device))
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < planes:
        buf = torch.zeros(max(planes, 1024), dtype=torch.int64, device=device)
        _SCRATCH[key] = buf
    return buf


def popcount_planes(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 words -> (B,) int32 per-plane bit counts (any ``W``).

    On a CUDA tensor: one launch, no fill.  The blocks of a plane sum their
    counts through a ticket word that must be 0 when the call starts; the
    last block leaves it 0 again.  The words are kept per (device, stream),
    so calls on one stream share them in order and calls on two streams
    never do."""
    if not kernels.on_cuda(words):
        return ref.popcount_planes(words)
    kernels.require(words, "popcount_planes", (torch.int32,), 2)
    planes, w = words.shape
    if planes > _MAX_PLANES:
        raise ValueError(f"popcount_planes: at most {_MAX_PLANES} planes, got {planes}")
    out = torch.empty(planes, dtype=torch.int32, device=words.device)
    if planes == 0:
        return out
    scratch = _ticket_scratch(words.device, planes)
    kernels.launch(PLANES_KERNEL, "rt_popcount_planes", _PLANES_ARGS, words.device,
                   words.data_ptr(), out.data_ptr(), scratch.data_ptr(), w, planes,
                   kernels.vec_rows(words))
    return out


def popcount_blocks(words: torch.Tensor) -> torch.Tensor:
    """(W,) int32 words -> (ceil(W/1024),) int32 per-1024-word-block counts.

    On a CUDA tensor: one warp a block; the whole blocks of a 16-byte
    aligned base take 16-byte loads, the ragged last block and a misaligned
    base scalar loads, in the same kernel."""
    if not kernels.on_cuda(words):
        return ref.popcount_blocks(words)
    kernels.require(words, "popcount_blocks", (torch.int32,), 1)
    out = torch.empty(-(-words.shape[0] // ref.BLOCK_WORDS), dtype=torch.int32,
                      device=words.device)
    if out.numel() == 0:
        return out
    kernels.launch(BLOCKS_KERNEL, "rt_popcount_blocks", _BLOCKS_ARGS, words.device,
                   words.data_ptr(), out.data_ptr(), words.shape[0],
                   int(words.data_ptr() % 16 == 0))
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
                   (kernels.P, kernels.P, kernels.I64), words.device,
                   words.data_ptr(), out.data_ptr(), words.numel())
    return out


#: the plain reduction on either device, as in the reference
popcount_total = ref.popcount_total
