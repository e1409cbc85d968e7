"""Traversal policies: direction optimization for the single-device BFS.

The port's counterpart of ``repro/core/traversal.py:77-177, 206-385,
422-481``.  Beamer's direction-optimizing BFS switches between push
(top-down) and pull (bottom-up) expansion per level:

* ``top_down``      — push: frontier sources propose themselves to their
  neighbors.
* ``bottom_up``     — pull: only unreached destinations accumulate
  candidates, probing the frontier through its packed bitmap.
* ``direction_opt`` — a per-plane switch driven by the popcount
  :class:`DensityOracle` and the anticipatory Beamer ``m_f`` edge signal.

The reference traces both directions under ``lax.cond``; here the level
loop takes one device->host copy per level — the (B,) frontier counts,
direction flags and the algebra's ``alive`` — and Python decides which
pass runs.  Every policy serves every frontier algebra
(:mod:`repro_torch.core.algebra`): value algebras take the backend's value
expansion and merge the two passes with the algebra's combine.

On the 2D grid (``repro/core/traversal.py:59-76,180-414``) a policy's
``expand_dist`` runs the local expansion of every rank's block and the row
exchange of the wire plan, over per-rank lists; the pull direction first
gathers the unreached membership of the grid row.  A rank the process does
not hold (a ``None`` entry) is skipped.  The default bottom-up
entry density comes from the row ladder (:func:`ladder_alpha`), so one
oracle decides the wire bucket and the direction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.comm.ladder import BucketLadder
from repro_torch.core import lookup
from repro_torch.core.algebra import ALGEBRAS, INF, LOCAL_EXCHANGE, per_rank
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.popcount import ops as pc_ops


BFS = ALGEBRAS["bfs"]  # the default algebra: candidates are parent ids


def ladder_alpha(s: int, payload_width: int) -> float:
    """Bottom-up entry density from the row ladder's geometry: pull wins
    where a chunk's candidate count overflows the largest sparse bucket
    (a ladder with no sparse bucket gives 0.25)."""
    ladder = BucketLadder.default(s, floor_words=s, payload_width=payload_width)
    return ladder.specs[-1].cap / s if ladder.specs else 0.25


@dataclasses.dataclass(frozen=True)
class DensityOracle:
    """Popcount-based frontier-density oracle.

    ``local_count`` is the membership popcount of one (n,) plane over its
    packed bitmap (one pack and one ``popcount_blocks`` launch);
    ``plane_counts`` is its multi-source form over (B, n) planes (one pack
    and one ``popcount_planes`` launch for all B planes).
    ``next_direction`` applies alpha/beta hysteresis on the count, per
    plane, plus the anticipatory Beamer signal: ``m_f`` (edges incident to
    the frontier) against ``m_u`` (edges incident to unreached vertices),
    entering pull on ``alpha_mf * m_f > m_u`` while the frontier grows
    (Beamer et al. SC'12, alpha = 14).
    """

    n: int  # vertex count the density is measured against
    alpha: float = 0.25  # switch to bottom-up above this frontier density
    beta: float = 0.05  # fall back to top-down below this density
    alpha_mf: float = 14.0  # Beamer edge heuristic

    def local_count(self, bits: torch.Tensor) -> torch.Tensor:
        """(n,) bool membership -> int32 scalar size, on the input's device:
        the width-1 pack zero-pads to the 1024-bit chunk (the reference's
        ``_pad_to_chunk``), ``popcount_blocks`` counts each 1024-word block,
        and the partials are summed."""
        words = bp_ops.pack(bits, 1)
        return pc_ops.popcount_blocks(words).sum(dtype=torch.int32)

    def plane_counts(self, bits: torch.Tensor) -> torch.Tensor:
        """(B, n) bool membership planes -> (B,) int32 sizes."""
        return pc_ops.popcount_planes(bp_ops.pack_planes(bits, 1))

    def next_direction(self, count, was_bottom_up, m_f=None, m_u=None,
                       growing=None) -> torch.Tensor:
        """Hysteresis: enter pull above alpha*n (or on the Beamer edge
        signal when ``m_f``/``m_u`` are given, gated on ``growing``), leave
        below beta*n.  Elementwise over planes; float32 as the reference."""
        c = count.to(torch.float32)
        enter = c > self.alpha * self.n
        if m_f is not None:
            edge = self.alpha_mf * m_f.to(torch.float32) > m_u.to(torch.float32)
            if growing is not None:
                edge = edge & growing
            enter = enter | edge
        return torch.where(was_bottom_up, c >= self.beta * self.n, enter)


def degree_vector(src: torch.Tensor, dst: torch.Tensor, n_src: int,
                  n_dst: int) -> torch.Tensor:
    """Per-destination degree of an edge list (sentinel edges excluded)."""
    valid = (src < n_src) & (dst < n_dst)
    deg = torch.zeros(n_dst + 1, dtype=torch.int32, device=dst.device)
    deg.index_add_(0, torch.clamp(dst, max=n_dst).to(torch.int64),
                   valid.to(torch.int32))
    return deg[:n_dst]


def edge_signals(deg: torch.Tensor, new: torch.Tensor, parent: torch.Tensor):
    """Beamer ``(m_f, m_u)`` degree dots over ``(B, n)`` planes, float32:
    the dots reach 2m, which wraps int32 at Graph500 scales, and the oracle
    only thresholds their ratio.  Sums are exact while they stay < 2**24."""
    degf = deg.to(torch.float32)[None, :]
    zero = degf.new_zeros(())
    m_f = torch.where(new, degf, zero).sum(dim=1)
    m_u = torch.where((parent < 0) & ~new, degf, zero).sum(dim=1)
    return m_f, m_u


class DistLevelCtx(NamedTuple):
    """Everything a policy needs to expand one level on the grid; the
    exchange callables come from the wire plan, the expansion from the
    backend.  Per-rank values are lists over the grid's ranks."""

    expand: object  # ExpansionBackend
    blocks: list  # each rank's LocalBlock
    n_r: int  # row-slice width (destinations per grid row)
    n_c: int  # column-slice width (sources per grid column)
    s: int  # owned-chunk width
    c: int  # grid columns
    col_index: list[int]  # each rank's grid column j
    row_exchange: Callable | None  # push: (B,c,s) global candidates -> (B,s) min
    row_exchange_bu: Callable | None  # pull: (B,c,s) LOCAL candidates -> (B,s)
    unreached_gather: Callable | None  # (B,s) own unreached -> (B,n_r) row slice
    algebra: object = BFS  # FrontierAlgebra
    row_base: list | None = None  # each rank's first global row id, i * n_r


class TraversalPolicy:
    """One expansion direction, or a per-level switch over them.

    ``propose_batch`` produces the (B, n) candidate planes of the
    single-device driver; ``expand_dist`` runs local expansion + the row
    exchange on the grid and returns each rank's (B, s) combined global
    candidates for its owned chunk.  ``alg`` / ``x`` (``ctx.algebra`` /
    ``x_col`` on the grid) switch a value algebra onto the backend's value
    expansion, ``x`` being the per-source message operands; with an id
    algebra (the default, BFS) the candidates are parent ids.
    ``passes`` is the host's ``(run_top_down, run_bottom_up)`` decision for
    this level, from the per-level host copy (:func:`host_passes`); only a
    switching policy reads it.
    """

    name: str = ""
    starts_bottom_up: bool = False
    uses_top_down: bool = True
    uses_bottom_up: bool = False

    def propose_batch(self, expand, block, value, frontier, use_bu,
                      passes, alg=BFS, x=None, plane_mask=None) -> torch.Tensor:
        raise NotImplementedError

    def expand_dist(self, ctx: DistLevelCtx, value: list, f_col: list, use_bu: list,
                    active: list, passes, x_col=None, plane_mask=None) -> list:
        raise NotImplementedError

    def next_direction(self, oracle: DensityOracle, count, use_bu, m_f=None,
                       m_u=None, growing=None) -> torch.Tensor:
        """Direction flags for the next level (fixed for single-direction
        policies)."""
        return torch.full(count.shape, self.starts_bottom_up, dtype=torch.bool,
                          device=count.device)


class TopDownPolicy(TraversalPolicy):
    name = "top_down"

    def propose_batch(self, expand, block, value, frontier, use_bu,
                      passes, alg=BFS, x=None, plane_mask=None):
        # push: every frontier source proposes itself, or the algebra's
        # message of its value, to its neighbors
        if alg.payload_is_id:
            return expand.push_planes(block, frontier)
        return expand.push_value_planes(block, frontier, x, alg)

    def expand_dist(self, ctx, value, f_col, use_bu, active, passes, x_col=None,
                    plane_mask=None):
        # id payloads: the backend returns column-LOCAL min candidates; the
        # push wire carries global ids, and min commutes with the shift
        # j * n_c.  Value payloads are global already: the bases only
        # derive the edge messages.
        alg = ctx.algebra
        prop = [None] * len(f_col)
        for p, blk in enumerate(ctx.blocks):
            if blk is None:  # a rank this process does not hold
                continue
            col_base = ctx.col_index[p] * ctx.n_c
            if alg.payload_is_id:
                local = ctx.expand.push_planes(blk, f_col[p])  # (B, n_r)
                glob = torch.where(local < INF, col_base + local, INF)
            else:
                glob = ctx.expand.push_value_planes(blk, f_col[p], x_col[p], alg,
                                                    row_base=ctx.row_base[p],
                                                    col_base=col_base)
            prop[p] = glob.reshape(-1, ctx.c, ctx.s)
        return ctx.row_exchange(prop)


class BottomUpPolicy(TraversalPolicy):
    name = "bottom_up"
    starts_bottom_up = True
    uses_top_down = False
    uses_bottom_up = True

    def propose_batch(self, expand, block, value, frontier, use_bu,
                      passes, alg=BFS, x=None, plane_mask=None):
        mask = alg.pull_mask(value)
        if plane_mask is not None:
            mask = mask & plane_mask[:, None]
        if alg.payload_is_id:
            return expand.pull_planes(block, frontier, mask)
        return expand.pull_value_planes(block, frontier, mask, x, alg)

    def expand_dist(self, ctx, value, f_col, use_bu, active, passes, x_col=None,
                    plane_mask=None):
        # the pull-mask membership of the whole row slice, gathered over the
        # grid row; exhausted planes are masked out so that their permanent
        # unreached set does not escalate the gather the live planes pay for
        alg = ctx.algebra
        pm = active if plane_mask is None else per_rank(torch.logical_and, plane_mask, active)
        mask = per_rank(lambda v, m: alg.pull_mask(v) & m[:, None], value, pm)
        unreached = ctx.unreached_gather(mask)  # (B, n_r) per rank
        # id candidates stay column-LOCAL so the payload bit-packs at the
        # column-width class; the receiver globalizes per sender
        prop = [None] * len(f_col)
        for p, blk in enumerate(ctx.blocks):
            if blk is None:
                continue
            if alg.payload_is_id:
                local = ctx.expand.pull_planes(blk, f_col[p], unreached[p])
            else:
                local = ctx.expand.pull_value_planes(
                    blk, f_col[p], unreached[p], x_col[p], alg,
                    row_base=ctx.row_base[p], col_base=ctx.col_index[p] * ctx.n_c)
            prop[p] = local.reshape(-1, ctx.c, ctx.s)
        return ctx.row_exchange_bu(prop)


class DirectionOptPolicy(TraversalPolicy):
    """Beamer-style per-level switch between push and pull, per plane.

    One gated pass per direction over all planes: planes routed to the
    direction a pass does not serve ride it masked-empty, and a pass whose
    plane set is empty does not run.  The two passes merge with the
    algebra's combine (min for BFS).
    """

    name = "direction_opt"
    uses_top_down = True
    uses_bottom_up = True

    def __init__(self):
        self._td = TopDownPolicy()
        self._bu = BottomUpPolicy()

    def propose_batch(self, expand, block, value, frontier, use_bu,
                      passes, alg=BFS, x=None, plane_mask=None):
        act = frontier.any(dim=1)
        td_mask = ~use_bu & act
        bu_mask = use_bu & act
        run_td, run_bu = passes
        out = None
        if run_td:
            out = self._td.propose_batch(expand, block, value,
                                         frontier & td_mask[:, None], use_bu,
                                         passes, alg=alg, x=x)
        if run_bu:
            # the pull pass's mask is restricted to its planes, so it
            # proposes nothing for planes riding the push direction
            bu = self._bu.propose_batch(expand, block, value,
                                        frontier & bu_mask[:, None], use_bu,
                                        passes, alg=alg, x=x, plane_mask=bu_mask)
            out = bu if out is None else alg.combine(out, bu)
        if out is None:
            out = torch.full(value.shape, alg.empty, dtype=torch.int32,
                             device=value.device)
        return out

    def expand_dist(self, ctx, value, f_col, use_bu, active, passes, x_col=None,
                    plane_mask=None):
        # one pass per direction over all planes, as on one device; the
        # host's passes skip a direction no live plane takes, which is
        # group-uniform because the flags derive from psum-ed counts
        alg = ctx.algebra
        run_td, run_bu = passes
        td_mask = per_rank(lambda u, a: ~u & a, use_bu, active)
        bu_mask = per_rank(lambda u, a: u & a, use_bu, active)

        def masked(planes):
            return per_rank(lambda f, m: f & m[:, None], f_col, planes)

        out = None
        if run_td:
            out = self._td.expand_dist(ctx, value, masked(td_mask), use_bu, active, passes,
                                       x_col=x_col)
        if run_bu:
            # the pull pass's plane mask keeps push planes out of the
            # unreached bitmap, hence out of the pull wire's content
            bu = self._bu.expand_dist(ctx, value, masked(bu_mask), use_bu, active, passes,
                                      x_col=x_col, plane_mask=bu_mask)
            out = bu if out is None else per_rank(alg.combine, out, bu)
        if out is None:
            out = per_rank(lambda v: torch.full((v.shape[0], ctx.s), alg.empty,
                                                dtype=torch.int32, device=v.device), value)
        return out

    def next_direction(self, oracle, count, use_bu, m_f=None, m_u=None,
                       growing=None):
        return oracle.next_direction(count, use_bu, m_f=m_f, m_u=m_u,
                                     growing=growing)


@dataclasses.dataclass
class LevelState:
    """The level loop's carry: (B, n) planes on the device, the (B,) counts
    and direction flags both on the device and as the host's copy."""

    value: torch.Tensor  # (B, n) int32 algebra values (BFS: parents, -1 unreached)
    level: torch.Tensor  # (B, n) int32 level of the last improvement, -1 none
    frontier: torch.Tensor  # (B, n) bool
    depth: int
    active: bool  # the algebra goes on (BFS: some plane still expanding)
    use_bu: torch.Tensor  # (B,) bool: plane expands bottom-up next level
    counts: torch.Tensor  # (B,) int32 frontier sizes (growing-guard carry)
    host_counts: np.ndarray  # host copy of ``counts``
    host_use_bu: np.ndarray  # host copy of ``use_bu``
    aux: tuple = ()  # algebra-private carry (SSSP's pending planes)


def host_passes(state: LevelState) -> tuple[bool, bool]:
    """Which directions run this level, from the host copy alone."""
    act = state.host_counts > 0
    bu = state.host_use_bu
    return bool((act & ~bu).any()), bool((act & bu).any())


def level_once(policy: TraversalPolicy, oracle: DensityOracle, alg,
               state: LevelState, expand, block, deg=None) -> LevelState:
    """One traversal level over every source plane, for the frontier
    algebra ``alg``.

    Value algebras propose messages of ``alg.source_values`` (PageRank's
    x = v/deg reads ``deg``); the update and then ``alg.post_update`` over
    :data:`~repro_torch.core.algebra.LOCAL_EXCHANGE` give the next
    frontier, counts and liveness.  For id payloads, ``deg`` also feeds the
    anticipatory Beamer ``m_f`` signal into the per-plane direction
    decision.  The one device->host copy of the level brings back the
    counts, the flags and ``alive``.
    """
    x = alg.source_values(state.value, deg) if alg.needs_values else None
    proposed = policy.propose_batch(
        expand, block, state.value, state.frontier, state.use_bu,
        host_passes(state), alg=alg, x=x,
    )
    value, new = alg.update(state.value, proposed, state.depth, state.value.shape[1])
    (aux,), (frontier,), (counts,), (alive,) = alg.post_update(
        LOCAL_EXCHANGE, [state.aux], [state.value], [value], [new], [state.frontier],
        oracle.plane_counts)
    m_f = m_u = growing = None
    if deg is not None and alg.payload_is_id:
        m_f, m_u = edge_signals(deg, new, state.value)
        growing = counts > state.counts
    use_bu = policy.next_direction(oracle, counts, state.use_bu,
                                   m_f=m_f, m_u=m_u, growing=growing)
    host = torch.cat([counts, use_bu.to(torch.int32),
                      alive.reshape(1).to(torch.int32)]).cpu().numpy()
    b = counts.shape[0]
    return LevelState(
        value=value,
        level=torch.where(new, state.depth + 1, state.level),
        frontier=frontier,
        depth=state.depth + 1,
        active=bool(host[-1]),
        use_bu=use_bu,
        counts=counts,
        host_counts=host[:b],
        host_use_bu=host[b:2 * b].astype(bool),
        aux=aux,
    )


POLICIES = {p.name: p for p in (TopDownPolicy(), BottomUpPolicy(),
                                 DirectionOptPolicy())}


def resolve(name: str) -> TraversalPolicy:
    """Traversal policy by name (``top_down`` | ``bottom_up`` |
    ``direction_opt``, or one added by
    :func:`repro_torch.comm.registry.register_traversal`)."""
    return lookup(POLICIES, "traversal policy", name)
