"""Wrappers of the bit-packing kernels (``csrc/bitpack.cu``).

CPU tensors go to the plain version in :mod:`.ref`; CUDA tensors go to the
kernel or raise.  ``b=32`` is the identity on the bit pattern and launches
nothing.  The delta coding and the fixed-capacity compaction are plain
PyTorch on both devices, as the reference leaves them to XLA; the id-stream
helpers (:func:`pack_sorted_ids`, :func:`unpack_sorted_ids`) pack and
unpack through :func:`pack` and :func:`unpack`, so on CUDA tensors they
launch the two kernels.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.bitpack import ref
from repro_torch.kernels.bitpack.ref import (  # noqa: F401
    compact_ids,
    gaps_from_sorted,
    sorted_from_gaps,
)

KERNEL = "pack"
UNPACK_KERNEL = "unpack"
_ARGS = (kernels.P, kernels.P, kernels.I64, kernels.I64, kernels.I32, kernels.I32,
         kernels.I32)
_BYTE_ARGS = (kernels.P, kernels.P, kernels.I64, kernels.I64, kernels.I32, kernels.I32)
_UNPACK_BITS_ARGS = (kernels.P, kernels.P, kernels.I64, kernels.I32)
_UNPACK_ARGS = (kernels.P, kernels.P, kernels.I64, kernels.I32, kernels.I32, kernels.I32)


def pack_planes(values: torch.Tensor, b: int) -> torch.Tensor:
    """(B, n) values -> (B, chunk_pad(n)*b/32) int32 packed words.

    ``values`` is bool/uint8 (membership planes, read in place) or int32
    (uint32 bit patterns); any ``n`` — positions past ``n`` pack as zeros.
    Bool/uint8 planes pack as 0/1 at ``b=1`` (a nonzero byte is a member);
    at wider ``b`` they are cast to int32 first.
    """
    if b not in ref.B_CLASSES:
        raise ValueError(f"bit width {b} not in {ref.B_CLASSES}")
    if not kernels.on_cuda(values):
        return ref.pack_planes(values, b)
    kernels.require(values, "pack_planes", (torch.bool, torch.uint8, torch.int32), 2)
    planes, n = values.shape
    if b == 32:
        return ref.pack_planes(values, 32)
    if values.dtype != torch.int32 and b > 1:
        values = values.to(torch.int32)
    words = ref.words_for(n, b)
    out = torch.empty((planes, words), dtype=torch.int32, device=values.device)
    if out.numel() == 0:
        return out
    if values.dtype == torch.int32:
        kernels.launch(KERNEL, "rt_pack_u32", _ARGS, values.data_ptr(), out.data_ptr(), n,
                       words, planes, b, kernels.vec_rows(values))
    else:
        kernels.launch(KERNEL, "rt_pack_u8", _BYTE_ARGS, values.data_ptr(), out.data_ptr(), n,
                       words, planes, kernels.vec_rows(values))
    return out


def pack(values: torch.Tensor, b: int) -> torch.Tensor:
    """(n,) values -> (chunk_pad(n)*b/32,) int32 packed words."""
    return pack_planes(values.reshape(1, -1), b)[0]


def unpack_planes(words: torch.Tensor, b: int) -> torch.Tensor:
    """(B, W) int32 words -> (B, W*32/b) values; ``W*32/b`` is a multiple of
    1024.  ``b=1`` gives bool planes, other widths int32."""
    if b not in ref.B_CLASSES:
        raise ValueError(f"bit width {b} not in {ref.B_CLASSES}")
    if not kernels.on_cuda(words):
        return ref.unpack_planes(words, b)
    kernels.require(words, "unpack_planes", (torch.int32,), 2)
    planes, w = words.shape
    if (w * 32 // b) % ref.CHUNK:
        raise ValueError(f"unpack_planes: {w} words at width {b} are not whole chunks")
    if b == 32:
        return words
    out = torch.empty((planes, w * 32 // b), dtype=torch.bool if b == 1 else torch.int32,
                      device=words.device)
    if out.numel() == 0:
        return out
    if b == 1:
        kernels.launch(UNPACK_KERNEL, "rt_unpack_u8", _UNPACK_BITS_ARGS, words.data_ptr(),
                       out.data_ptr(), w, planes)
    else:
        kernels.launch(UNPACK_KERNEL, "rt_unpack_u32", _UNPACK_ARGS, words.data_ptr(),
                       out.data_ptr(), w, planes, b, kernels.vec_rows(words))
    return out


def unpack(words: torch.Tensor, b: int) -> torch.Tensor:
    """(W,) words -> (W*32/b,) values, as :func:`unpack_planes`."""
    return unpack_planes(words.reshape(1, -1), b)[0]


def pack_sorted_ids(ids: torch.Tensor, count, b: int) -> torch.Tensor:
    """Delta + pack a sorted (cap,) id stream (the paper's frontier codec) ->
    (cap*b/32,) int32 words; the gaps must fit ``b`` bits."""
    return pack(ref.to_int32_bits(gaps_from_sorted(ids, count)), b)


def unpack_sorted_ids(words: torch.Tensor, count, b: int, fill: int) -> torch.Tensor:
    """Inverse of :func:`pack_sorted_ids`: the sorted ids, ``fill`` at
    positions ``>= count``."""
    return sorted_from_gaps(unpack(words, b), count, fill)


def compressed_words(capacity: int, b: int) -> int:
    """Static packed-word count of an id stream of ``capacity`` values."""
    assert capacity % ref.CHUNK == 0, capacity
    return capacity * b // 32
