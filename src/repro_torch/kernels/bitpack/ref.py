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

    Positions past ``n`` in the last chunk pack as zeros.  At ``b=1`` a
    bool/uint8 plane packs as membership: a nonzero byte is a 1.
    """
    assert b in B_CLASSES, b
    planes, n = values.shape
    if b == 1 and values.dtype in (torch.bool, torch.uint8):
        values = values != 0
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


def unpack_planes(words: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of :func:`pack_planes`: (B, W) int32 words -> (B, W*32/b)
    values, ``W*32/b`` a multiple of ``CHUNK``.

    ``b=1`` gives bool membership planes; every other width gives int32
    (values < 2**b, and at ``b=32`` the words' own bit patterns).
    """
    assert b in B_CLASSES, b
    planes, w = words.shape
    assert (w * 32 // b) % CHUNK == 0, (w, b)
    if b == 32:
        return words.to(torch.int32)
    k_per_word = 32 // b
    wc = 32 * b
    v = (words.to(torch.int64) & _MASK32).reshape(planes, -1, 1, wc)
    shifts = (torch.arange(k_per_word, device=words.device, dtype=torch.int64) * b)
    vals = (v >> shifts[None, None, :, None]) & ((1 << b) - 1)
    vals = vals.reshape(planes, -1)
    return vals == 1 if b == 1 else vals.to(torch.int32)


def unpack(words: torch.Tensor, b: int) -> torch.Tensor:
    """(W,) words -> (W*32/b,) values, as :func:`unpack_planes`."""
    return unpack_planes(words.reshape(1, -1), b)[0]


# ---------------------------------------------------------------------------
# delta (gap) coding of sorted id streams and fixed-capacity compaction
# ---------------------------------------------------------------------------


def gaps_from_sorted(ids: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Sorted ids (..., cap) padded to a static capacity -> int64 gaps.

    ``gaps[0] = ids[0]``, ``gaps[i] = ids[i] - ids[i-1]``; positions
    ``>= count`` are zero.  ``count`` has the leading shape of ``ids``.
    The values are the reference's uint32 gaps, held in int64.
    """
    cap = ids.shape[-1]
    idx = torch.arange(cap, device=ids.device)
    cnt = torch.as_tensor(count, device=ids.device).to(torch.int64)[..., None]
    # repeat the last valid id into the padding so padded gaps are zero
    src = torch.clamp(torch.minimum(idx, cnt - 1), 0, cap - 1)
    ids_m = torch.gather(ids.to(torch.int64), -1, src.expand(ids.shape))
    prev = torch.cat([torch.zeros_like(ids_m[..., :1]), ids_m[..., :-1]], dim=-1)
    return torch.where(idx < cnt, (ids_m - prev) & _MASK32, 0)


def sorted_from_gaps(gaps: torch.Tensor, count: torch.Tensor, fill: int) -> torch.Tensor:
    """Inverse of :func:`gaps_from_sorted` -> int32 ids; positions
    ``>= count`` get ``fill``.  The prefix sum wraps at 32 bits as the
    reference's uint32 cumsum does."""
    ids = to_int32_bits(torch.cumsum(gaps.to(torch.int64) & _MASK32, dim=-1) & _MASK32)
    idx = torch.arange(gaps.shape[-1], device=gaps.device)
    cnt = torch.as_tensor(count, device=gaps.device).to(torch.int64)[..., None]
    return torch.where(idx < cnt, ids, fill).to(torch.int32)


def required_width_class(gaps: torch.Tensor) -> torch.Tensor:
    """Index into :data:`B_CLASSES` of the smallest width that covers
    ``max(gaps)`` (uint32 values, or int32 words holding them) -> 0-d
    int32."""
    m = (gaps.to(torch.int64) & _MASK32).max()
    return sum((m >= (1 << b)).to(torch.int32) for b in B_CLASSES[:-1])


def pack_sorted_ids(ids: torch.Tensor, count, b: int) -> torch.Tensor:
    """Delta + pack of a sorted (cap,) id stream (the paper's codec) ->
    (cap*b/32,) int32 words; the gaps must fit ``b`` bits."""
    return pack(to_int32_bits(gaps_from_sorted(ids, count)), b)


def unpack_sorted_ids(words: torch.Tensor, count, b: int, fill: int) -> torch.Tensor:
    """Unpack + prefix sum back to the sorted ids; positions ``>= count``
    get ``fill``."""
    return sorted_from_gaps(unpack(words, b), count, fill)


def compact_ids(mask_bits: torch.Tensor, capacity: int, fill: int):
    """Stream-compact (..., n) membership planes -> (ids (..., capacity)
    int32 ascending, count (...) int32).

    The reference is ``jnp.nonzero(size=capacity)``: ids past
    ``capacity`` are dropped and padding slots hold ``fill``, but
    ``count`` is the full popcount even when it exceeds ``capacity``.
    Here a cumsum gives each set bit its slot and one scatter writes it,
    with a fixed output size and no device->host copy; slots past
    ``capacity`` land in a spill column that is cut off.
    """
    lead, n = mask_bits.shape[:-1], mask_bits.shape[-1]
    bits = mask_bits.reshape(-1, n).to(torch.bool)
    slot = torch.cumsum(bits, dim=1, dtype=torch.int64) - 1
    slot = torch.where(bits & (slot < capacity), slot, capacity)
    out = torch.full((bits.shape[0], capacity + 1), fill, dtype=torch.int32,
                     device=bits.device)
    pos = torch.arange(n, dtype=torch.int32, device=bits.device).expand(bits.shape[0], n)
    out.scatter_(1, slot, pos)
    count = bits.sum(dim=1, dtype=torch.int32)
    return out[:, :capacity].reshape(*lead, capacity), count.reshape(lead)
