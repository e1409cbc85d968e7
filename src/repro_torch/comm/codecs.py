"""Host-side integer-sequence codecs (paper §5.2, Tables 5.4/5.5).

These are *variable-length* codecs operating on numpy arrays — the faithful
reproduction of the paper's compression study.  The paper's chosen codec is
Lemire's **S4-BP128 with delta coding on top** (Frame-of-Reference binary
packing, 128-integer blocks, per-block bit width); here the same scheme is
implemented (``BP128Delta``) next to the comparison codecs the paper tables
include: VByte/varint (Ueno et al.'s VLQ family), a dense bitmap codec
(Huiwei et al.'s bitmap-index family), patched FOR with exceptions
(NewPFOR-style), and raw copy.

Every codec implements ``encode(np.ndarray[uint32]) -> bytes`` and
``decode(bytes, n) -> np.ndarray[uint32]`` and is registered with the factory
in :mod:`repro_torch.comm.registry` (the paper's §5.3 "Factory" pattern).

The port's copy of ``repro/comm/codecs.py``: numpy and ``struct`` only, on
the host as in the reference, and byte-identical in what it encodes.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

BLOCK = 128  # paper's S4-BP128 block length


def _required_bits(x: np.ndarray) -> int:
    """Bits needed to represent max(x) (0 -> 0 bits)."""
    if x.size == 0:
        return 0
    m = int(x.max())
    return int(m).bit_length()


def delta_encode(ids: np.ndarray) -> np.ndarray:
    """Sorted ids -> non-negative gaps (paper: delta compression / d-gaps)."""
    ids = np.asarray(ids, dtype=np.uint64)
    gaps = np.empty_like(ids)
    if ids.size:
        gaps[0] = ids[0]
        np.subtract(ids[1:], ids[:-1], out=gaps[1:])
    return gaps.astype(np.uint32)


def delta_decode(gaps: np.ndarray) -> np.ndarray:
    return np.cumsum(gaps.astype(np.uint64)).astype(np.uint32)


def zigzag_encode(x: np.ndarray) -> np.ndarray:
    """Signed -> unsigned interleave (used for non-monotone streams)."""
    x = x.astype(np.int64)
    return ((x << 1) ^ (x >> 63)).astype(np.uint32)


def zigzag_decode(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> 1) ^ (-(u & 1)).astype(np.uint64)).astype(np.int64)


# ---------------------------------------------------------------------------
# bit packing primitives (vertical layout shared with kernels/bitpack)
# ---------------------------------------------------------------------------


def pack_bits(values: np.ndarray, b: int) -> np.ndarray:
    """Pack ``values`` (< 2**b) into uint32 words, b bits each, LSB-first.

    Horizontal layout (classic): value i occupies bits [i*b, (i+1)*b) of the
    concatenated bit stream.  Used by the host codecs; the TPU kernel uses the
    vertical per-1024-chunk layout instead (see kernels/bitpack/ref.py).
    """
    if b == 0 or values.size == 0:
        return np.zeros(0, dtype=np.uint32)
    if b == 32:
        return values.astype(np.uint32)
    n = values.size
    nbits = n * b
    nwords = -(-nbits // 32)
    bit_idx = np.arange(n, dtype=np.uint64) * b
    word_idx = (bit_idx // 32).astype(np.int64)
    off = (bit_idx % 32).astype(np.uint64)
    v = values.astype(np.uint64)
    out = np.zeros(nwords + 1, dtype=np.uint64)
    np.bitwise_or.at(out, word_idx, (v << off) & 0xFFFFFFFF)
    spill = (v >> (np.uint64(32) - off)) * (off > 0)
    np.bitwise_or.at(out, word_idx + 1, spill)
    return out[:nwords].astype(np.uint32)


def unpack_bits(words: np.ndarray, b: int, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`."""
    if b == 0:
        return np.zeros(n, dtype=np.uint32)
    if b == 32:
        return words[:n].astype(np.uint32)
    w = np.concatenate([words.astype(np.uint64), np.zeros(1, dtype=np.uint64)])
    bit_idx = np.arange(n, dtype=np.uint64) * b
    word_idx = (bit_idx // 32).astype(np.int64)
    off = bit_idx % 32
    lo = w[word_idx] >> off
    hi = np.where(off > 0, w[word_idx + 1] << (np.uint64(32) - off), 0)
    mask = np.uint64((1 << b) - 1)
    return ((lo | hi) & mask).astype(np.uint32)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec interface (paper: "codec"/"scheme"/"encoding")."""

    name: str = "copy"
    is_sorted_input: bool = False  # True => codec applies delta first

    def encode(self, values: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode(self, blob: bytes, n: int) -> np.ndarray:
        raise NotImplementedError

    def ratio(self, values: np.ndarray) -> float:
        """compression ratio = original / compressed (paper eq. (4))."""
        blob = self.encode(values)
        return (values.size * 4) / max(len(blob), 1)


class Copy(Codec):
    """No-op codec — the paper's "Copy (No C/D)" baseline row."""

    def __init__(self) -> None:
        super().__init__()
        object.__setattr__(self, "name", "copy")

    def encode(self, values: np.ndarray) -> bytes:
        return values.astype(np.uint32).tobytes()

    def decode(self, blob: bytes, n: int) -> np.ndarray:
        return np.frombuffer(blob, dtype=np.uint32, count=n).copy()


class BP128(Codec):
    """Binary packing, 128-int blocks, per-block bit width (FOR family).

    The paper's S4-BP128 minus the SIMD lane interleave (layout differences
    do not change size).  Block header: 1 byte bit-width.  No exceptions —
    width is the block max (plain PackedBinary / AFOR-1).
    """

    def __init__(self, delta: bool = False, name: str | None = None) -> None:
        super().__init__()
        object.__setattr__(self, "name", name or ("bp128d" if delta else "bp128"))
        object.__setattr__(self, "is_sorted_input", delta)
        object.__setattr__(self, "_delta", delta)

    def encode(self, values: np.ndarray) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        if self._delta:
            values = delta_encode(values)
        out = bytearray()
        for s in range(0, values.size, BLOCK):
            blk = values[s : s + BLOCK]
            b = _required_bits(blk)
            out.append(b)
            out += pack_bits(blk, b).tobytes()
        return bytes(out)

    def decode(self, blob: bytes, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        pos = 0
        s = 0
        mv = memoryview(blob)
        while s < n:
            cnt = min(BLOCK, n - s)
            b = mv[pos]
            pos += 1
            nwords = -(-cnt * b // 32) if b else 0
            words = np.frombuffer(mv[pos : pos + 4 * nwords], dtype=np.uint32)
            pos += 4 * nwords
            out[s : s + cnt] = unpack_bits(words, b, cnt)
            s += cnt
        if self._delta:
            out = delta_decode(out)
        return out


class PFOR(Codec):
    """Patched Frame-of-Reference (NewPFOR-style exceptions, paper §5.2.B).

    Per block choose the width ``b`` minimizing packed size + exception cost;
    values >= 2**b store their high bits in an exception area (position byte +
    packed high bits), Zukowski-et-al's "patched coding".
    """

    def __init__(self, delta: bool = True) -> None:
        super().__init__()
        object.__setattr__(self, "name", "pfor-delta" if delta else "pfor")
        object.__setattr__(self, "is_sorted_input", delta)
        object.__setattr__(self, "_delta", delta)

    @staticmethod
    def _best_width(blk: np.ndarray) -> int:
        bits_full = _required_bits(blk)
        best_b, best_cost = bits_full, blk.size * bits_full
        for b in range(max(bits_full - 16, 0), bits_full):
            n_exc = int((blk >= (1 << b)).sum()) if b < 32 else 0
            if n_exc > blk.size // 8:  # bounded exception budget
                continue
            cost = blk.size * b + n_exc * (8 + max(bits_full - b, 0)) + 8
            if cost < best_cost:
                best_b, best_cost = b, cost
        return best_b

    def encode(self, values: np.ndarray) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        if self._delta:
            values = delta_encode(values)
        out = bytearray()
        for s in range(0, values.size, BLOCK):
            blk = values[s : s + BLOCK]
            bits_full = _required_bits(blk)
            b = self._best_width(blk)
            exc_pos = np.nonzero(blk >= (1 << b) if b < 32 else np.zeros_like(blk, bool))[0]
            low = blk & np.uint32((1 << b) - 1 if b < 32 else 0xFFFFFFFF)
            hb = max(bits_full - b, 0)
            out += struct.pack("<BBB", b, len(exc_pos), hb)
            out += pack_bits(low, b).tobytes()
            out += exc_pos.astype(np.uint8).tobytes()
            out += pack_bits((blk[exc_pos].astype(np.uint64) >> b).astype(np.uint32), hb).tobytes()
        return bytes(out)

    def decode(self, blob: bytes, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        pos, s = 0, 0
        mv = memoryview(blob)
        while s < n:
            cnt = min(BLOCK, n - s)
            b, n_exc, hb = struct.unpack_from("<BBB", mv, pos)
            pos += 3
            nwords = -(-cnt * b // 32) if b else 0
            low = unpack_bits(np.frombuffer(mv[pos : pos + 4 * nwords], np.uint32), b, cnt)
            pos += 4 * nwords
            exc_pos = np.frombuffer(mv[pos : pos + n_exc], np.uint8).astype(np.int64)
            pos += n_exc
            nwords_h = -(-n_exc * hb // 32) if hb else 0
            high = unpack_bits(np.frombuffer(mv[pos : pos + 4 * nwords_h], np.uint32), hb, n_exc)
            pos += 4 * nwords_h
            blk = low.astype(np.uint64)
            blk[exc_pos] |= high.astype(np.uint64) << b
            out[s : s + cnt] = blk.astype(np.uint32)
            s += cnt
        if self._delta:
            out = delta_decode(out)
        return out


class VByte(Codec):
    """Variable Byte / varint (paper §5.2.B.b — Ueno et al.'s VLQ family)."""

    def __init__(self, delta: bool = True) -> None:
        super().__init__()
        object.__setattr__(self, "name", "vbyte-delta" if delta else "vbyte")
        object.__setattr__(self, "is_sorted_input", delta)
        object.__setattr__(self, "_delta", delta)

    def encode(self, values: np.ndarray) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        if self._delta:
            values = delta_encode(values)
        v = values.astype(np.uint64)
        nbytes = np.maximum((64 - np.minimum(64, _nlz64(v))) + 6, 7) // 7
        out = np.zeros(int(nbytes.sum()), dtype=np.uint8)
        pos = np.concatenate([[0], np.cumsum(nbytes)[:-1]]).astype(np.int64)
        rem = v.copy()
        k = 0
        alive = np.ones(v.size, dtype=bool)
        while alive.any():
            idx = np.nonzero(alive)[0]
            byte = (rem[idx] & 0x7F).astype(np.uint8)
            more = (k + 1) < nbytes[idx]
            out[pos[idx] + k] = byte | (more.astype(np.uint8) << 7)
            rem[idx] >>= np.uint64(7)
            alive[idx] = more
            k += 1
        return out.tobytes()

    def decode(self, blob: bytes, n: int) -> np.ndarray:
        data = np.frombuffer(blob, dtype=np.uint8)
        out = np.zeros(n, dtype=np.uint64)
        i = 0
        for j in range(n):
            shift, val = 0, 0
            while True:
                byte = int(data[i])
                i += 1
                val |= (byte & 0x7F) << shift
                if not byte & 0x80:
                    break
                shift += 7
            out[j] = val
        out32 = out.astype(np.uint32)
        return delta_decode(out32) if self._delta else out32


class Bitmap(Codec):
    """Dense bitmap of a sorted id set over a universe (Huiwei et al. family).

    Encodes *membership*, not order; only valid for strictly increasing
    unique ids.  Universe = max id + 1, stored as a header.
    """

    def __init__(self) -> None:
        super().__init__()
        object.__setattr__(self, "name", "bitmap")
        object.__setattr__(self, "is_sorted_input", True)

    def encode(self, values: np.ndarray) -> bytes:
        values = np.asarray(values, dtype=np.uint32)
        universe = int(values.max()) + 1 if values.size else 0
        words = np.zeros(-(-universe // 32) or 1, dtype=np.uint32)
        np.bitwise_or.at(words, values // 32, np.uint32(1) << (values % 32))
        return struct.pack("<I", universe) + words.tobytes()

    def decode(self, blob: bytes, n: int) -> np.ndarray:
        (universe,) = struct.unpack_from("<I", blob, 0)
        words = np.frombuffer(blob, dtype=np.uint32, offset=4)
        bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool).ravel()
        ids = np.nonzero(bits[:universe])[0].astype(np.uint32)
        assert ids.size == n, (ids.size, n)
        return ids


def _nlz64(v: np.ndarray) -> np.ndarray:
    """Number of leading zeros of uint64 (vectorized)."""
    v = v.astype(np.uint64)
    bits = np.zeros(v.shape, dtype=np.int64)
    x = v.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        hi = x >> np.uint64(shift)
        take = hi != 0
        bits[take] += shift
        x = np.where(take, hi, x)
    bits[v != 0] += 1  # bits = position of highest set bit
    return 64 - bits
