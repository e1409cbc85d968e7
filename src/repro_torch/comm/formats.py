"""Wire formats: every fixed-geometry representation a collective carries.

The port's counterpart of ``repro/comm/formats.py``.  Collectives move
tensors of static shape, so the paper's variable-length compressed
exchange becomes a set of wire formats, each knowing its word count up
front and, all but the int8 payload, packing/unpacking losslessly:

* :class:`IdStreamFormat` — delta (gap) coding + vertical 16-bit packing
  with patched exceptions (PFOR with a static exception capacity),
  optionally carrying a bit-packed per-id payload (candidate parents in the
  BFS row phase).
* :class:`BitmapFormat` — dense width-1 membership bitmap, the always-valid
  fallback.
* :class:`RawIdFormat` — uncompressed 32-bit id list at full capacity (the
  paper's Baseline).
* :class:`DenseFormat` — uncompressed dense int32 value vector (row-phase
  fallback).
* :class:`BitmapParentFormat` — found-bitmap + bit-packed parents, the
  bottom-up (pull) row exchange.
* :class:`Int8Format` — block-quantized int8 float payload with one f32
  scale per 128 values (lossy; the 2D GNN's feature exchanges).

Words are int32 tensors holding the uint32 bit patterns; the codecs do
their arithmetic in int64 masked to 32 bits.  Every pack/unpack here takes
a leading batch of streams — ``(N, ...)`` — where the reference ``vmap``s
a single-stream function.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.core.algebra import INF
from repro_torch.kernels.bitpack import ops as bp
from repro_torch.kernels.bitpack import ref as bpref
from repro_torch.kernels.quant import ops as quant

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# static-shape patched id-stream codec (PFOR-16 with exception slots)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IdStreamSpec:
    """Static geometry of one packed sorted-id stream.

    cap: id capacity (multiple of 1024, <= 65536 so positions fit 16 bits).
    width: low-bits width (16 covers the paper's measured 15-bit entropy).
    """

    cap: int
    width: int = 16

    def __post_init__(self):
        assert self.cap % bpref.CHUNK == 0 and self.cap <= 1 << 16, self.cap
        assert self.width in (8, 16), self.width

    @property
    def exc_cap(self) -> int:
        return self.cap // 8

    @property
    def n_words(self) -> int:
        return self.cap * self.width // 32 + self.exc_cap


def pack_id_stream(ids: torch.Tensor, count: torch.Tensor, spec: IdStreamSpec):
    """Sorted ids (N, >= cap) int32 + counts (N,) -> (words (N, n_words)
    int32, meta (N, 2) int32 = (count, exception count)).

    Counts must fit the spec (count <= cap, exceptions <= exc_cap), which
    bucket selection guarantees.
    """
    ids = ids[:, : spec.cap]
    gaps = bpref.gaps_from_sorted(ids, count)  # int64 uint32 values, 0 past count
    low = gaps & ((1 << spec.width) - 1)
    high = gaps >> spec.width
    exc_pos, exc_count = bp.compact_ids(high > 0, spec.exc_cap, fill=spec.cap)
    slot = torch.arange(spec.exc_cap, device=ids.device)
    exc_val = torch.where(
        slot < exc_count[:, None].to(torch.int64),
        torch.gather(high, 1, torch.clamp(exc_pos, 0, spec.cap - 1).to(torch.int64)),
        0,
    )
    exc_words = (exc_pos.to(torch.int64) | (exc_val << 16)) & _MASK32
    low_words = bp.pack_planes(low.to(torch.int32), spec.width)
    words = torch.cat([low_words, bpref.to_int32_bits(exc_words)], dim=1)
    meta = torch.stack([count.to(torch.int32), exc_count.to(torch.int32)], dim=1)
    return words, meta


def unpack_id_stream(words: torch.Tensor, meta: torch.Tensor, spec: IdStreamSpec,
                     fill: int):
    """Inverse of :func:`pack_id_stream` -> (ids (N, cap) int32, count (N,))."""
    count, exc_count = meta[:, 0], meta[:, 1]
    n_low = spec.cap * spec.width // 32
    low = bp.unpack_planes(words[:, :n_low].contiguous(), spec.width).to(torch.int64)
    exc_words = words[:, n_low:].to(torch.int64) & _MASK32
    exc_pos = exc_words & 0xFFFF
    exc_val = exc_words >> 16
    slot = torch.arange(spec.exc_cap, device=words.device)
    pos = torch.where(slot < exc_count[:, None].to(torch.int64), exc_pos, spec.cap)
    high = torch.zeros((words.shape[0], spec.cap + 1), dtype=torch.int64,
                       device=words.device)
    high.scatter_(1, pos, exc_val)
    gaps = (low + (high[:, : spec.cap] << spec.width)) & _MASK32
    return bpref.sorted_from_gaps(gaps, count, fill), count


def pack_bitmap(bits: torch.Tensor) -> torch.Tensor:
    """(..., s) membership -> (..., s/32) int32 words (vertical width-1)."""
    return bp.pack_planes(bits.reshape(-1, bits.shape[-1]), 1).reshape(
        *bits.shape[:-1], -1)


def unpack_bitmap(words: torch.Tensor) -> torch.Tensor:
    """(..., s/32) words -> (..., s) bool."""
    return bp.unpack_planes(words.reshape(-1, words.shape[-1]).contiguous(), 1).reshape(
        *words.shape[:-1], -1)


# ---------------------------------------------------------------------------
# plane (multi-source batch) headers: B id streams under ONE wire header
# ---------------------------------------------------------------------------

#: bits of the packed plane header that hold the id count (counts reach
#: cap <= 2**16 inclusive, so 17 bits; the exception count, <= cap/8 <= 8192,
#: rides in the remaining 14 bits of a non-negative int32)
PLANE_COUNT_BITS = 17


def plane_meta_words(b: int) -> int:
    """Sideband words of ``b`` id streams sharing one exchange: a single
    stream keeps the (count, exc_count) pair; batched planes pack both
    counts of each plane into one word."""
    return 2 if b == 1 else b


def pack_plane_meta(counts: torch.Tensor, exc_counts: torch.Tensor) -> torch.Tensor:
    """Per-plane (count, exc_count) -> one packed int32 word per plane."""
    return (counts.to(torch.int32) | (exc_counts.to(torch.int32) << PLANE_COUNT_BITS))


def unpack_plane_meta(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_plane_meta` -> (counts, exc_counts)."""
    return words & ((1 << PLANE_COUNT_BITS) - 1), words >> PLANE_COUNT_BITS


def plane_wire_bytes(fmt, b: int) -> int:
    """Wire bytes of ``b`` frontier planes carried by one exchange of ``fmt``:
    dense formats scale linearly, id-stream formats share a packed
    one-word-per-plane sideband."""
    if b == 1:
        return fmt.wire_bytes
    if isinstance(fmt, IdStreamFormat):
        return 4 * (b * fmt.data_words + plane_meta_words(b))
    return b * fmt.wire_bytes


# ---------------------------------------------------------------------------
# wire-format objects
# ---------------------------------------------------------------------------


@runtime_checkable
class WireFormat(Protocol):
    """Static wire geometry of one exchange participant."""

    @property
    def name(self) -> str: ...

    @property
    def data_words(self) -> int: ...  # u32 payload words on the wire

    @property
    def meta_words(self) -> int: ...  # int32 sideband words (0 if none)

    @property
    def wire_bytes(self) -> int: ...  # total bytes per participant


@dataclasses.dataclass(frozen=True)
class BitmapFormat:
    """Width-1 dense membership bitmap over ``s`` vertices."""

    s: int

    @property
    def name(self) -> str:
        return "bitmap"

    @property
    def data_words(self) -> int:
        return self.s // 32

    @property
    def meta_words(self) -> int:
        return 0

    @property
    def wire_bytes(self) -> int:
        return 4 * self.data_words

    def pack(self, bits: torch.Tensor) -> torch.Tensor:
        return pack_bitmap(bits)

    def unpack(self, words: torch.Tensor) -> torch.Tensor:
        return unpack_bitmap(words)


@dataclasses.dataclass(frozen=True)
class IdStreamFormat:
    """Delta + PFOR16 packed sorted-id stream, optional bit-packed payload
    riding in the same word vector (``payload_width`` bits per id, 0 =
    none)."""

    spec: IdStreamSpec
    payload_width: int = 0

    @property
    def name(self) -> str:
        return f"pfor{self.spec.width}[{self.spec.cap}]"

    @property
    def payload_words(self) -> int:
        return self.spec.cap * self.payload_width // 32

    @property
    def data_words(self) -> int:
        return self.spec.n_words + self.payload_words

    @property
    def meta_words(self) -> int:
        return 2

    @property
    def wire_bytes(self) -> int:
        return 4 * (self.data_words + self.meta_words)

    def pack(self, ids: torch.Tensor, count: torch.Tensor,
             payload: torch.Tensor | None = None):
        """ids (N, >= cap) sorted, padded + counts (N,) [+ payload (N, cap)]
        -> words (N, data_words), meta (N, 2)."""
        words, meta = pack_id_stream(ids, count, self.spec)
        if self.payload_width:
            assert payload is not None
            cap = self.spec.cap
            keep = torch.arange(cap, device=ids.device) < count[:, None]
            pay = torch.where(keep, payload[:, :cap], 0).to(torch.int32)
            words = torch.cat([words, bp.pack_planes(pay, self.payload_width)], dim=1)
        return words, meta

    def unpack(self, words: torch.Tensor, meta: torch.Tensor, fill: int):
        """-> (ids (N, cap) int32, count (N,), payload (N, cap) int32 | None)."""
        n_words = self.spec.n_words
        ids, count = unpack_id_stream(words[:, :n_words], meta, self.spec, fill)
        payload = None
        if self.payload_width:
            payload = bp.unpack_planes(words[:, n_words:].contiguous(), self.payload_width)
        return ids, count, payload


@dataclasses.dataclass(frozen=True)
class BitmapParentFormat:
    """Found-bitmap + dense bit-packed parent payload (bottom-up row phase).

    Every position of an owned chunk is one *found* bit plus a
    ``payload_width``-bit column-local parent id in the same word vector:
    ``s/32 + s*payload_width/32`` words per chunk, independent of frontier
    density.  The receiver rebuilds global parents as
    ``sender_col * n_c + local`` and min-reduces.
    """

    s: int
    payload_width: int

    def __post_init__(self):
        assert self.s % bpref.CHUNK == 0, self.s
        assert self.payload_width in bpref.B_CLASSES and self.payload_width < 32, (
            self.payload_width
        )

    @property
    def name(self) -> str:
        return f"bitmap+p{self.payload_width}"

    @property
    def data_words(self) -> int:
        return self.s // 32 + self.s * self.payload_width // 32

    @property
    def meta_words(self) -> int:
        return 0

    @property
    def wire_bytes(self) -> int:
        return 4 * self.data_words

    def pack(self, prop: torch.Tensor) -> torch.Tensor:
        """(..., s) int32 column-local candidates (INF = none) -> words."""
        bits = prop < INF
        payload = torch.where(bits, prop, 0).to(torch.int32)
        flat = payload.reshape(-1, self.s)
        pw = bp.pack_planes(flat, self.payload_width).reshape(*prop.shape[:-1], -1)
        return torch.cat([pack_bitmap(bits), pw], dim=-1)

    def unpack(self, words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (found (..., s) bool, local parent (..., s) int32)."""
        nb = self.s // 32
        bits = unpack_bitmap(words[..., :nb])
        pw = words[..., nb:]
        local = bp.unpack_planes(pw.reshape(-1, pw.shape[-1]).contiguous(),
                                 self.payload_width).reshape(bits.shape)
        return bits, local


@dataclasses.dataclass(frozen=True)
class RawIdFormat:
    """Uncompressed 32-bit id list at full static capacity (paper Baseline)."""

    cap: int

    @property
    def name(self) -> str:
        return "raw-id"

    @property
    def data_words(self) -> int:
        return self.cap

    @property
    def meta_words(self) -> int:
        return 1  # the count

    @property
    def wire_bytes(self) -> int:
        return 4 * (self.data_words + self.meta_words)

    def pack(self, bits: torch.Tensor):
        """(..., cap) membership -> (ids (..., cap) int32, meta (..., 1))."""
        ids, count = bp.compact_ids(bits, self.cap, fill=self.cap)
        return ids, count[..., None].to(torch.int32)

    def unpack(self, ids: torch.Tensor, meta: torch.Tensor, fill: int):
        valid = torch.arange(self.cap, device=ids.device) < meta[..., :1]
        return torch.where(valid & (ids < self.cap), ids, fill), meta[..., 0]


@dataclasses.dataclass(frozen=True)
class DenseFormat:
    """Uncompressed dense value vector (row-phase fallback), int32."""

    s: int

    @property
    def name(self) -> str:
        return "dense-i32"

    @property
    def data_words(self) -> int:
        return self.s

    @property
    def meta_words(self) -> int:
        return 0

    @property
    def wire_bytes(self) -> int:
        return 4 * self.s


@dataclasses.dataclass(frozen=True)
class Int8Format:
    """Block-quantized int8 payload + one f32 scale per ``group`` values."""

    n: int  # values per participant
    group: int = quant.ref.GROUP

    @property
    def name(self) -> str:
        return "int8"

    @property
    def data_words(self) -> int:
        return self.n // 4  # int8 payload measured in u32-word equivalents

    @property
    def meta_words(self) -> int:
        return self.n // self.group  # f32 scales

    @property
    def wire_bytes(self) -> int:
        return self.n + 4 * (self.n // self.group)

    def pack(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return quant.quantize(x)

    def unpack(self, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        return quant.dequantize(q, scales)
