"""Butterfly row exchange: the log2(C)-stage merge-and-recompress wire plan.

The port's counterpart of ``repro/comm/butterfly.py`` (ButterFly BFS,
arXiv:2103.13577), over a :class:`repro_torch.comm.grid.SimGrid`.  The row
phase's direct all-to-all is replaced by a butterfly: each of log2(C)
stages exchanges with ONE partner (``ppermute``) and re-compresses the
merged candidate stream before the next hop, so the adaptive wire formats
(PFOR16 id streams, found-bitmap + packed parents) apply at every stage.

* **reduce-scatter butterfly** (push and pull row phases): each rank folds
  its (C, s) candidate planes into a (P, slots, s) leaf state (P = largest
  power of two <= C); stage t pairs rank j with ``j ^ 2^t`` and moves the
  ``P / 2^(t+1)`` leaf rows whose destination bit t matches the partner,
  merging received rows into the kept half.  After all stages rank j holds
  its own fully reduced chunk.
* **recursive-doubling butterfly** (the bottom-up unreached all-gather):
  the same pairing in the opposite direction, each stage forwarding the
  2^t-chunk block gathered so far, until every rank holds the grid row's
  whole membership.
* **non-power-of-two C**: the ``extra = C - P`` overhang ranks ppermute
  their whole state onto ranks ``0..extra-1`` before stage 0 (each low
  rank's leaf gains a second slot for the overhang destination), idle
  through the stages, and get their reduced chunk back in a final unfold.

Each stage records its bytes under its own zone (``{phase}[btfly:t]``,
``[btfly:fold]``, ``[btfly:unfold]``), and :func:`stage_unit_bytes` is the
static byte model of one subchunk on the wire at a stage, which the host
replay (:mod:`repro_torch.bench.bfs_comm`) is checked against.

Merged streams lose their sender, so the parent payload carries GLOBAL
ids: :func:`row_wire` sizes the ladder's payload class from the full vertex
count and takes found-bitmap + packed global parents as the dense floor
while that class stays below 32 bits (dense int32 at 32).

Per-rank values are lists over the grid's ranks.  ``SimGrid.ppermute``
hands a receiver the sender's own tensor, so every merge below is out of
place: a rank never writes into a tensor another rank may hold.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import collectives as cc
from repro_torch.comm.engine import AdaptiveExchange
from repro_torch.comm.formats import (
    INF,
    BitmapFormat,
    BitmapParentFormat,
    DenseFormat,
    plane_wire_bytes,
)
from repro_torch.comm.grid import SimGrid
from repro_torch.comm.ladder import BucketLadder
from repro_torch.core.algebra import width_class


@dataclasses.dataclass(frozen=True)
class ButterflySchedule:
    """Static stage plan of the butterfly over ``c`` ranks.

    ``p`` is the largest power of two <= c; the ``extra = c - p`` overhang
    ranks fold onto ranks ``0..extra-1`` (their leaf gains a second slot)
    before the log2(p) pairwise stages, and unfold afterwards.
    """

    c: int

    @property
    def p(self) -> int:
        return 1 << (self.c.bit_length() - 1)

    @property
    def extra(self) -> int:
        return self.c - self.p

    @property
    def slots(self) -> int:
        return 2 if self.extra else 1

    @property
    def n_stages(self) -> int:
        return self.p.bit_length() - 1  # log2(p)

    def stage_perm(self, t: int) -> list[tuple[int, int]]:
        """Pairwise swap of stage ``t`` (overhang ranks idle)."""
        return [(r, r ^ (1 << t)) for r in range(self.p)]

    def stage_blocks(self, t: int) -> int:
        """Leaf rows exchanged at stage ``t`` (times ``slots`` subchunks)."""
        return self.p >> (t + 1)

    def fold_perm(self) -> list[tuple[int, int]]:
        return [(self.p + e, e) for e in range(self.extra)]

    def unfold_perm(self) -> list[tuple[int, int]]:
        return [(e, self.p + e) for e in range(self.extra)]

    def leaf_of_chunk(self, q: int) -> tuple[int, int]:
        """Grid-row chunk index -> (leaf row, slot)."""
        return (q, 0) if q < self.p else (q - self.p, 1)


def row_wire(s: int, n: int, payload_width: int | None = None
             ) -> tuple[BucketLadder, BitmapParentFormat | DenseFormat]:
    """Ladder + dense floor of the butterfly row stages (shared with the
    host replay, so device and replay price the same wire).

    The payload class covers GLOBAL parent ids in [0, n); below 32 bits the
    floor is found-bitmap + packed parents (s/32 + s*w/32 words), at 32 the
    dense int32 vector.  ``payload_width`` overrides the id class for an
    algebra whose payload is a value."""
    w = width_class(n) if payload_width is None else payload_width
    if w < 32:
        floor = BitmapParentFormat(s, w)
        floor_words = floor.data_words
    else:
        floor = DenseFormat(s)
        floor_words = s
    return BucketLadder.default(s, floor_words=floor_words, payload_width=w), floor


def unreached_wire(s: int) -> tuple[BucketLadder, BitmapFormat]:
    """Ladder + bitmap floor of the staged unreached all-gather."""
    return BucketLadder.default(s), BitmapFormat(s)


def stage_unit_bytes(s: int, n: int, fmt_name: str, zone: str = "row", b: int = 1) -> int:
    """Static byte model: wire bytes of ONE subchunk (all ``b`` source
    planes) under ``fmt_name`` on the ``zone`` wire (``row`` or
    ``unreached``; one ``pfor16[...]`` name prices differently on the two,
    the row stream carrying the parent payload).  Id streams share the
    plane header at ``b > 1``; dense floors scale linearly."""
    if zone == "row":
        ladder, floor = row_wire(s, n)
    elif zone == "unreached":
        ladder, floor = unreached_wire(s)
    else:
        raise KeyError(f"unknown butterfly zone {zone!r}")
    if fmt_name == floor.name:
        return plane_wire_bytes(floor, b)
    for fmt in ladder.formats():
        if fmt.name == fmt_name:
            return plane_wire_bytes(fmt, b)
    raise KeyError(f"unknown {zone} stage format {fmt_name!r}")


# ---------------------------------------------------------------------------
# reduce-scatter butterfly: the staged row phase (push and pull)
# ---------------------------------------------------------------------------


def build_row_exchange(s: int, grid: SimGrid, axis, n_c: int, *, b: int = 1,
                       to_global: bool = False, stats=None, phase: str = "bfs/row",
                       alg=None):
    """Build ``fn(prop) -> out`` over per-rank lists: ``(b, c, s)`` int32
    candidates in, each rank's ``(b, s)`` merged chunk out, the staged
    analog of the direct row all-to-all + min over ``b`` source planes.

    ``to_global`` globalizes column-local pull candidates (``j*n_c +
    local``) before the first stage; push candidates are global already.
    ``alg`` (``None``: BFS min-parents) supplies the merge: min algebras ride
    the staged compressed wire with their payload class, a sum algebra
    exchanges dense int32 blocks per stage and add-merges them."""
    c = grid.group_size(axis)
    n = n_c * c
    sched = ButterflySchedule(c)
    is_sum = alg is not None and alg.reduce == "sum"
    payload_is_id = alg is None or alg.payload_is_id
    ladder, floor = row_wire(
        s, n, payload_width=None if payload_is_id else alg.row_payload_width(n_c, n))
    empty = 0 if is_sum else INF
    combine = torch.minimum if alg is None else alg.combine
    dense = DenseFormat(s)
    p, extra, slots = sched.p, sched.extra, sched.slots
    col = grid.axis_index(axis)
    ranks = [q for g in grid.groups(axis) for q in g]

    def exchange(blocks, perm, gate, zone):
        if is_sum:
            ex = AdaptiveExchange(zone, grid, axis, None, stats, planes=b)
            return ex.ppermute(blocks, perm, fmt=dense.name)
        ex = AdaptiveExchange(zone, grid, axis, ladder, stats, planes=b)
        return cc.ppermute_min_block(ex, blocks, perm, ladder, floor, gate=gate)

    def merged(state, rows, recv):
        """``state`` with leaf rows ``rows`` merged with ``recv``, out of place."""
        out = state.clone()
        out[rows] = combine(state[rows], recv)
        return out

    def run(prop: list) -> list:
        assert prop[ranks[0]].shape == (b, c, s), (prop[ranks[0]].shape, b, c, s)
        if to_global and payload_is_id:
            prop = [None if x is None else torch.where(x < INF, col[q] * n_c + x, INF)
                    for q, x in enumerate(prop)]
        if c == 1:
            return [None if x is None else x[:, 0] for x in prop]
        jv = [j & (p - 1) for j in col]
        # leaf state (p, slots, b, s): row k slot 0 = destination chunk k,
        # slot 1 = chunk p + k
        state = [None] * grid.size
        for q in ranks:
            t = prop[q].transpose(0, 1)  # (c, b, s): leaf-major layout
            if extra:
                over = torch.cat([t[p:], torch.full((p - extra, b, s), empty,
                                                    dtype=torch.int32, device=t.device)])
                state[q] = torch.stack([t[:p], over], dim=1)
            else:
                state[q] = t[:p, None].contiguous()
        if extra:
            # folded first stage: the overhang ranks merge their whole
            # candidate state onto ranks 0..extra-1
            recv = exchange([None if x is None else x.reshape(p * slots, b, s) for x in state],
                            sched.fold_perm(), gate=[j >= p for j in col],
                            zone=f"{phase}[btfly:fold]")
            for q in ranks:
                if col[q] < extra:
                    state[q] = combine(state[q], recv[q].reshape(p, slots, b, s))
        for t in range(sched.n_stages):
            m = 1 << t
            nblk = sched.stage_blocks(t)
            # rows base, base + 2m, ...: the leaves whose bit t is the
            # partner's (sent) or mine (kept)
            send = [slice((jv[q] ^ m) & (2 * m - 1), None, 2 * m) for q in range(grid.size)]
            keep = [slice(jv[q] & (2 * m - 1), None, 2 * m) for q in range(grid.size)]
            recv = exchange([None if x is None else x[send[q]].reshape(nblk * slots, b, s)
                             for q, x in enumerate(state)],
                            sched.stage_perm(t), gate=[j < p for j in col],
                            zone=f"{phase}[btfly:{t}]")
            for q in ranks:
                if col[q] < p:  # the overhang ranks idle (their state is unused)
                    state[q] = merged(state[q], keep[q],
                                      recv[q].reshape(nblk, slots, b, s))
        own = [None] * grid.size
        for q in ranks:
            own[q] = state[q][jv[q], 0]  # my merged leaf, slot 0
        if extra:
            recv = exchange([None if x is None else x[jv[q], 1][None]
                             for q, x in enumerate(state)],
                            sched.unfold_perm(), gate=[j < extra for j in col],
                            zone=f"{phase}[btfly:unfold]")
            for q in ranks:
                if col[q] >= p:
                    own[q] = recv[q][0]
        return own

    return run


# ---------------------------------------------------------------------------
# recursive-doubling butterfly: the staged unreached all-gather
# ---------------------------------------------------------------------------


def build_unreached_gather(s: int, grid: SimGrid, axis, *, b: int = 1, stats=None,
                           phase: str = "bfs/unreached"):
    """Build ``fn(bits) -> out`` over per-rank lists: ``(b, s)`` bool in,
    ``(b, c*s)`` bool out (chunk q of the grid row at ``[:, q*s:(q+1)*s]``),
    the staged membership all-gather over the grid row that the pull
    direction probes, one doubling schedule carrying all ``b`` planes."""
    c = grid.group_size(axis)
    sched = ButterflySchedule(c)
    ladder, _ = unreached_wire(s)
    p, extra, slots = sched.p, sched.extra, sched.slots
    col = grid.axis_index(axis)
    ranks = [q for g in grid.groups(axis) for q in g]

    def exchange(blocks, perm, gate, zone):
        ex = AdaptiveExchange(zone, grid, axis, ladder, stats, planes=b)
        return cc.ppermute_membership_block(ex, blocks, perm, ladder, gate=gate)

    def run(bits: list) -> list:
        assert bits[ranks[0]].shape == (b, s), (bits[ranks[0]].shape, b, s)
        if c == 1:
            return list(bits)
        jv = [j & (p - 1) for j in col]
        state = [None] * grid.size
        for q in ranks:
            state[q] = torch.zeros((p, slots, b, s), dtype=torch.bool, device=grid.device)
            if col[q] < p:
                state[q][jv[q], 0] = bits[q]
        if extra:
            recv = exchange([None if x is None else x[None] for x in bits],
                            sched.fold_perm(), gate=[j >= p for j in col],
                            zone=f"{phase}[btfly:fold]")
            for q in ranks:
                if col[q] < extra:
                    state[q][jv[q], 1] = recv[q][0]
        # the blocks sent below are packed into fresh words, so each rank's
        # state is only ever written by its owner
        for t in range(sched.n_stages):
            blk = 1 << t
            start = [(v >> t) << t for v in jv]
            recv = exchange([None if x is None else
                             x[start[q]:start[q] + blk].reshape(blk * slots, b, s)
                             for q, x in enumerate(state)],
                            sched.stage_perm(t), gate=[j < p for j in col],
                            zone=f"{phase}[btfly:{t}]")
            for q in ranks:
                if col[q] < p:
                    lo = start[q] ^ blk
                    state[q][lo:lo + blk] = recv[q].reshape(blk, slots, b, s)
        if extra:
            # the overhang ranks need the whole gathered row back
            recv = exchange([None if x is None else x.reshape(p * slots, b, s)
                             for x in state],
                            sched.unfold_perm(), gate=[j < extra for j in col],
                            zone=f"{phase}[btfly:unfold]")
            for q in ranks:
                if col[q] >= p:
                    state[q] = recv[q].reshape(p, slots, b, s)
        out = [None] * grid.size
        for q in ranks:
            flat = state[q][:, 0].transpose(0, 1).reshape(b, -1)
            if extra:
                flat = torch.cat([flat, state[q][:extra, 1].transpose(0, 1).reshape(b, -1)],
                                 dim=1)
            out[q] = flat
        return out

    return run
