"""Bucket ladders: the capacity classes an adaptive exchange may carry.

The port's counterpart of ``repro/comm/ladder.py``.  Runtime variable
sizing is replaced by a small ladder of static capacities.  Every rank
computes the smallest bucket that fits its streams; a max over the
communicator group makes the choice uniform inside the group, and the
group runs the branch whose collective carries exactly that many words
(:class:`repro_torch.comm.engine.AdaptiveExchange`).

A bucket is kept only if it undercuts the dense floor in wire words AND
wins the modelled pack + transmit + unpack race against it under
:class:`repro_torch.comm.threshold.ThresholdPolicy` (paper §5.4.3).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm.formats import IdStreamFormat, IdStreamSpec
from repro_torch.comm.threshold import ThresholdPolicy
from repro_torch.kernels.bitpack import ops as bp
from repro_torch.kernels.bitpack import ref as bpref

#: the break-even policy every ladder is pruned with: the reference's
#: modelled defaults (an NVLink-calibrated policy is later work)
THRESHOLD = ThresholdPolicy()


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Sparse-id buckets (ascending capacity) + dense fallback.

    ``s`` = chunk width (multiple of 1024).  ``floor_words`` is the dense
    fallback's wire size: s/32 for membership bitmaps (column phase), s for
    int32 candidate vectors (row phase).  ``payload_width`` adds per-id
    payload words (packed parents) to each bucket's wire cost.
    """

    s: int
    specs: tuple[IdStreamSpec, ...]
    floor_words: int
    payload_width: int = 0

    @classmethod
    def default(
        cls,
        s: int,
        floor_words: int | None = None,
        payload_width: int = 0,
    ) -> "BucketLadder":
        floor = floor_words if floor_words is not None else s // 32
        caps: list[int] = []
        for frac in (256, 64, 16, 4):
            cap = max(s // frac, bpref.CHUNK)
            cap = min(cap, 1 << 16)
            wire = IdStreamSpec(cap).n_words + cap * payload_width // 32
            if (
                cap < s
                and cap not in caps
                and wire < floor
                and THRESHOLD.should_pack(cap, wire, floor, stream_len=s)
            ):
                caps.append(cap)
        return cls(
            s=s,
            specs=tuple(IdStreamSpec(c) for c in sorted(caps)),
            floor_words=floor,
            payload_width=payload_width,
        )

    @property
    def n_branches(self) -> int:
        return len(self.specs) + 1  # + dense fallback

    def bucket_for(self, count: torch.Tensor, exc_count: torch.Tensor) -> torch.Tensor:
        """Smallest usable bucket index per stream (before the group max)."""
        b = torch.full(count.shape, len(self.specs), dtype=torch.int32,
                       device=count.device)
        for i in range(len(self.specs) - 1, -1, -1):
            ok = (count <= self.specs[i].cap) & (exc_count <= self.specs[i].exc_cap)
            b = torch.where(ok, i, b)
        return b

    def words_for_branch(self, i: int) -> int:
        """Wire words of branch ``i`` (payload priced at the stored width)."""
        if i < len(self.specs):
            return self.specs[i].n_words + self.specs[i].cap * self.payload_width // 32
        return self.floor_words

    def formats(self) -> tuple[IdStreamFormat, ...]:
        """One sparse wire format per bucket (payload width baked in)."""
        return tuple(IdStreamFormat(spec, self.payload_width) for spec in self.specs)


def stream_stats(bits: torch.Tensor, s: int):
    """(..., s) membership -> ids (..., s), count (...), exception count
    (...) of each gap stream (what bucketing reads)."""
    ids, count = bp.compact_ids(bits, s, fill=s)
    gaps = bpref.gaps_from_sorted(ids, count)
    exc_count = ((gaps >> 16) > 0).sum(dim=-1, dtype=torch.int32)
    return ids, count, exc_count
