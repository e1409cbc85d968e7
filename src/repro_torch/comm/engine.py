"""AdaptiveExchange: one engine behind every adaptive collective.

The port's counterpart of ``repro/comm/engine.py``, over a grid
(:class:`repro_torch.comm.grid.SimGrid`, or one process per rank,
:class:`repro_torch.comm.procgrid.ProcessGrid`):

* :meth:`AdaptiveExchange.dispatch` — each rank's bucket choice (from the
  ladder) is made uniform inside each communicator group with a recorded
  ``pmax``.  Consensus is per group, not global: over ``"data"`` each of
  the C column groups gets its own bucket.  The bucket of every group that
  holds a local rank is read to the host once, and each branch then runs
  over the groups that chose it — where JAX's ``lax.switch`` runs one
  branch per group.  On ``meta`` every branch runs over every group (the
  dry-run's count of the program).  A single-branch exchange skips the
  consensus.
* :meth:`all_gather` / :meth:`all_to_all` / :meth:`pmax` / :meth:`pmin` /
  :meth:`psum` / :meth:`ppermute` — the grid's collectives, each recording one rank's
  result-shape bytes per call as the reference engine does, with
  ``moved_bytes`` excluding identity ``ppermute`` pairs, the own chunk of
  a gather or all-to-all, and counting the ring all-reduce's
  ``2(g-1)/g`` volume.  With ``planes > 1`` payload bytes are attributed
  per plane under ``{phase}@p{k}``; the consensus stays under ``phase``.

A call is recorded once for the local ranks that ran it, tagged with its
call index (:meth:`repro_torch.comm.stats.CommStats.call_index`): the
index of the top-level exchange and the call's position inside the
branch, the same in every process, so that the ledgers of the processes
of a grid merge into the one a single process of every rank records.

Per-rank values are lists over the grid's ranks (``None`` for a rank
outside the call or not held here); ``groups`` restricts a call to some of
the axis's communicator groups.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.comm.grid import Grid
from repro_torch.comm.ladder import BucketLadder
from repro_torch.comm.stats import CommStats

CONSENSUS = "consensus"  # fmt label of the bucket-choice all-reduce


def nbytes_of(x: torch.Tensor) -> int:
    """Result-shape bytes (bool counts as 1)."""
    return math.prod(x.shape) * x.element_size()


@dataclasses.dataclass(frozen=True)
class AdaptiveExchange:
    """One adaptive exchange site: phase name, grid axis, ladder, stats."""

    phase: str  # logical zone, e.g. "bfs/column"
    grid: Grid
    axis: Any  # grid axis name or tuple of names
    ladder: BucketLadder | None = None  # None -> single fixed format
    stats: CommStats | None = None
    planes: int = 1  # source planes riding every payload

    @property
    def group_size(self) -> int:
        return self.grid.group_size(self.axis)

    def groups(self, groups=None) -> list[list[int]]:
        return groups if groups is not None else self.grid.groups(self.axis)

    def ranks(self, groups=None) -> list[int]:
        """The local ranks of ``groups`` (default: every group of the axis
        that holds one)."""
        local = set(self.grid.local_ranks)
        return [p for g in self.groups(groups) for p in g if p in local]

    # -- recording collective primitives ------------------------------------

    def _rec(self, fmt: str, kind: str, part: str, out: list, groups,
             moved: int | None = None, per_plane: bool = True) -> None:
        if self.stats is None:
            return
        ranks = self.ranks(groups)
        nbytes = nbytes_of(out[ranks[0]])
        call = self.stats.call_index()
        if self.planes > 1 and per_plane:
            assert nbytes % self.planes == 0, (self.phase, nbytes, self.planes)
            share = nbytes // self.planes
            for k in range(self.planes):
                m = None
                if moved is not None:
                    m = moved // self.planes
                    if k == self.planes - 1:  # keep the moved total exact
                        m += moved - self.planes * (moved // self.planes)
                self.stats.record(f"{self.phase}@p{k}", fmt, kind, part, share,
                                  moved_bytes=m, ranks=len(ranks), call=call)
        else:
            self.stats.record(self.phase, fmt, kind, part, nbytes, moved_bytes=moved,
                              ranks=len(ranks), call=call)

    def _peer_share(self, out: list, groups) -> int:
        """Result bytes minus the own chunk (gathers/all-to-alls keep 1/g)."""
        nbytes = nbytes_of(out[self.ranks(groups)[0]])
        return nbytes * (self.group_size - 1) // self.group_size

    def all_gather(self, xs: Sequence, *, fmt: str, part: str = "words",
                   groups=None) -> list:
        out = self.grid.all_gather(xs, self.axis, self.groups(groups))
        self._rec(fmt, "all-gather", part, out, groups, moved=self._peer_share(out, groups))
        return out

    def all_to_all(self, xs: Sequence, *, fmt: str, part: str = "words",
                   groups=None) -> list:
        out = self.grid.all_to_all(xs, self.axis, self.groups(groups))
        self._rec(fmt, "all-to-all", part, out, groups, moved=self._peer_share(out, groups))
        return out

    def pmax(self, xs: Sequence, *, fmt: str = CONSENSUS, part: str = "bucket",
             groups=None) -> list:
        out = self.grid.pmax(xs, self.axis, self.groups(groups))
        # one consensus serves every plane: never split per plane
        self._rec(fmt, "all-reduce", part, out, groups,
                  moved=2 * self._peer_share(out, groups), per_plane=False)
        return out

    def pmin(self, xs: Sequence, *, fmt: str = CONSENSUS, part: str = "bucket",
             groups=None) -> list:
        out = self.grid.pmin(xs, self.axis, self.groups(groups))
        # consensus-shaped like pmax (the SSSP window floor rides this)
        self._rec(fmt, "all-reduce", part, out, groups,
                  moved=2 * self._peer_share(out, groups), per_plane=False)
        return out

    def psum(self, xs: Sequence, *, fmt: str, part: str = "value", groups=None) -> list:
        out = self.grid.psum(xs, self.axis, self.groups(groups))
        self._rec(fmt, "all-reduce", part, out, groups,
                  moved=2 * self._peer_share(out, groups))
        return out

    def ppermute(self, xs: Sequence, perm, *, fmt: str, part: str = "words",
                 groups=None) -> list:
        out = self.grid.ppermute(xs, self.axis, perm, self.groups(groups))
        # identity pairs (src == dst) count full result bytes but move
        # nothing; ranks outside ``perm`` receive zeros without traffic
        n_moved = sum(1 for src, dst in perm if src != dst)
        self._rec(fmt, "collective-permute", part, out, groups,
                  moved=nbytes_of(out[self.ranks(groups)[0]]) * n_moved // self.group_size)
        return out

    # -- adaptive dispatch ----------------------------------------------------

    def dispatch(
        self,
        local_bucket: Sequence | None,
        branches: Sequence[Callable[[list], list]],
    ) -> list:
        """Per-group consensus branch selection.

        ``branches`` is index-aligned with the ladder's sparse formats,
        dense fallback last; each takes the list of groups it runs over and
        returns per-rank results for their ranks.  ``local_bucket`` holds
        each rank's smallest usable bucket (0-d int32; ignored when only
        one branch exists).

        On ``meta`` buckets (shapes only, no value to read) every branch
        runs over every group, once each in ladder order, as the
        reference's ``lax.switch`` holds every branch in its program; the
        per-rank results are the last branch's.  The ``CommStats`` ledger
        of such a run is the reference's trace-time ledger (every rung
        recorded), not what one run sends.  Buckets that mix ``meta`` with
        another device raise.
        """
        scope = (self.stats.exchange() if self.stats is not None
                 else contextlib.nullcontext(lambda: None))
        with scope as branch:
            groups = self.groups()
            if len(branches) == 1:
                return branches[0](groups)
            assert local_bucket is not None
            kinds = {local_bucket[p].device.type for p in self.ranks()}
            if "meta" in kinds and kinds != {"meta"}:
                raise ValueError(f"buckets must all lie on meta or none, got {sorted(kinds)}")
            bucket = self.pmax(local_bucket)
            if kinds == {"meta"}:
                plan = [(b, groups) for b in range(len(branches))]
            else:
                chosen = torch.stack([bucket[self.ranks([g])[0]] for g in groups]).cpu().tolist()
                plan = [(b, [g for g, c in zip(groups, chosen) if c == b])
                        for b in sorted(set(chosen))]
            out = [None] * self.grid.size
            for b, gs in plan:
                branch()  # each branch numbers its calls from the same place
                part = branches[b](gs)
                for p, v in enumerate(part):
                    if v is not None:
                        out[p] = v
            return out
