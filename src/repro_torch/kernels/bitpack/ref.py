"""Plain PyTorch version of the vertical bit-packing kernel.

Layout ("vertical", per 1024-value chunk): with bit width ``b``, a chunk of
``CHUNK`` values packs into ``32*b`` words; word ``j`` of a chunk holds
``chunk[k*32*b + j]`` at bit offset ``k*b`` for ``k < 32//b``.  At ``b=1``
value ``i`` of a chunk sits in word ``i % 32``, bit ``i // 32`` — not
LSB-first (``repro/kernels/bitpack/ref.py``).

Words are int32 tensors holding the uint32 bit patterns JAX uses.  The
arithmetic runs in int64 masked to 32 bits: PyTorch has no shifts on
``uint32``, and int32 ``>>`` is arithmetic.
"""

from __future__ import annotations

import torch

CHUNK = 1024
B_CLASSES = (1, 2, 4, 8, 16, 32)
_MASK32 = 0xFFFFFFFF


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def chunk_pad(n: int) -> int:
    """``n`` rounded up to whole 1024-value chunks."""
    return n + (-n) % CHUNK


def words_for(n: int, b: int) -> int:
    """Packed words for ``n`` values at width ``b`` (``n`` chunk-padded)."""
    return chunk_pad(n) * b // 32


def pack_planes(values: torch.Tensor, b: int) -> torch.Tensor:
    """(B, n) values (< 2**b) -> (B, words_for(n, b)) int32 packed words.

    Positions past ``n`` in the last chunk pack as zeros.
    """
    assert b in B_CLASSES, b
    planes, n = values.shape
    v = values.to(torch.int64) & _MASK32
    pad = (-n) % CHUNK
    if pad:
        v = torch.cat([v, v.new_zeros((planes, pad))], dim=1)
    if b == 32:
        return to_int32_bits(v)
    k_per_word = 32 // b
    wc = 32 * b
    v = v.reshape(planes, -1, k_per_word, wc)
    out = torch.zeros((planes, v.shape[1], wc), dtype=torch.int64, device=v.device)
    for k in range(k_per_word):
        out |= v[:, :, k, :] << (k * b)
    return to_int32_bits(out & _MASK32).reshape(planes, -1)


def pack(values: torch.Tensor, b: int) -> torch.Tensor:
    """(n,) values -> (words_for(n, b),) int32 packed words."""
    return pack_planes(values.reshape(1, -1), b)[0]
