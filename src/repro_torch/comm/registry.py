"""The registry axes: the host codec factory, the wire plans, and the
registration API over the traversal policies, the expansion backends and
the frontier algebras.

The port's counterpart of ``repro/comm/registry.py``.  A distributed
traversal is an *algebra x policy x wire-plan x expansion* point, each axis
a name table: the codecs and :data:`WIRE_PLANS` here,
``core.traversal.POLICIES``, ``core.expand.BACKENDS`` and
``core.algebra.ALGEBRAS`` beside the code they name.  ``register_*`` adds
to those tables (a name held already raises ``ValueError``), the lookups
(``wire_plan``, ``traversal``, ``expansion``, ``algebra``) read them (an
unknown name raises :class:`repro_torch.core.UnknownName`, a ``KeyError``
naming the known names), and ``available_*`` lists them, so a registered
policy, backend or algebra is usable by name in ``bfs`` and ``build_bfs``.

The host codecs are the paper's §5.3 "Factory": a codec is a name resolved
outside the timed code.  The ``raw``, ``bitmap``, ``auto`` and ``btfly``
wire plans build the BFS collectives; ``btfly`` (ButterFly BFS) keeps
``auto``'s column gather and replaces the row exchanges and the unreached
gather with the log2(C)-stage butterflies of
:mod:`repro_torch.comm.butterfly`, each stage re-bucketing the merged
stream.  A plan's builders take the grid, the axis and ``b``, the number
of source planes each exchange carries, and return plane-batched callables
over per-rank lists:

* ``build_column(s, grid, axis, *, b, ...)`` -> ``fn(bits (b, s) bool) ->
  (b, g*s) bool``: the frontier membership all-gather over the grid column;
* ``build_row(s, grid, axis, n_c, parent_width, *, b, ...)`` ->
  ``fn(prop (b, c, s) int32 global candidates) -> (b, s)``: push row phase;
* ``build_row_bu(...)`` -> ``fn(prop (b, c, s) column-LOCAL candidates) ->
  (b, s) global parents``: pull row phase;
* ``build_unreached(s, grid, axis, *, b, ...)`` -> the unreached-membership
  all-gather over the grid row that the pull direction probes.

At ``b == 1`` each builder uses the single-source wire (its two-word
sideband); at ``b > 1`` all planes share one bucket consensus and one
collective pair per exchange.  The row builders take the frontier
algebra as ``alg`` (default BFS).  Id payloads (BFS parents) travel
column-local and the receiver re-globalizes them; value payloads (SSSP
distances, CC labels) are global already and travel as they are; a sum
algebra (PageRank) takes the dense int32 wire with its add-combine under
every plan, its candidates being dense partial sums (on ``btfly``, one
dense block a stage).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.comm import butterfly, codecs
from repro_torch.comm import collectives as cc
from repro_torch.comm.engine import AdaptiveExchange
from repro_torch.comm.formats import INF, BitmapParentFormat
from repro_torch.comm.ladder import BucketLadder
from repro_torch.core import lookup, register
from repro_torch.core.algebra import ALGEBRAS
from repro_torch.core.expand import BACKENDS
from repro_torch.core.traversal import POLICIES

BFS = ALGEBRAS["bfs"]

# ---------------------------------------------------------------------------
# host codec factory (paper §5.3 "Factory")
# ---------------------------------------------------------------------------

_CODECS: dict[str, Callable[[], codecs.Codec]] = {}


def register_codec(name: str, factory: Callable[[], codecs.Codec]) -> None:
    if name in _CODECS:
        raise ValueError(f"codec {name!r} already registered")
    _CODECS[name] = factory


def make_codec(name: str) -> codecs.Codec:
    """Instantiate a codec by name (paper: Factory call before Kernel 2)."""
    try:
        return _CODECS[name]()
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; known: {sorted(_CODECS)}") from None


def available_codecs() -> list[str]:
    return sorted(_CODECS)


# Built-in codecs (the paper's comparison set, Table 5.4).
register_codec("copy", codecs.Copy)
register_codec("bp128", lambda: codecs.BP128(delta=False))
register_codec("bp128d", lambda: codecs.BP128(delta=True))  # paper's choice: S4-BP128+delta
register_codec("pfor", lambda: codecs.PFOR(delta=False))
register_codec("pfor-delta", lambda: codecs.PFOR(delta=True))
register_codec("vbyte", lambda: codecs.VByte(delta=False))
register_codec("vbyte-delta", lambda: codecs.VByte(delta=True))
register_codec("bitmap", codecs.Bitmap)


# ---------------------------------------------------------------------------
# wire plans (in-graph exchange modes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WirePlan:
    """Builders for one exchange mode's column/row collectives."""

    name: str
    build_column: Callable
    build_row: Callable
    build_row_bu: Callable
    build_unreached: Callable


def _one(fn, xs):
    """Run a single-source collective on plane 0 of per-rank (1, ...) values."""
    got = fn([None if x is None else x[0] for x in xs])
    return [None if x is None else x[None] for x in got]


def _raw_column(s, grid, axis, *, b=1, stats=None, phase="bfs/column"):
    ex = AdaptiveExchange(phase, grid, axis, None, stats, planes=b)
    if b == 1:
        return lambda bits: _one(lambda x: cc.gather_raw_ids(ex, x), bits)
    return lambda bits: cc.gather_raw_ids_planes(ex, bits)


def _bitmap_column(s, grid, axis, *, b=1, stats=None, phase="bfs/column"):
    ex = AdaptiveExchange(phase, grid, axis, None, stats, planes=b)
    if b == 1:
        return lambda bits: _one(lambda x: cc.gather_bitmap(ex, x), bits)
    return lambda bits: cc.gather_bitmap_planes(ex, bits)


def _auto_column(s, grid, axis, *, b=1, stats=None, phase="bfs/column"):
    ladder = BucketLadder.default(s)
    if b == 1:
        return lambda bits: _one(lambda x: cc.allgather_membership(
            x, grid, axis, ladder, stats=stats, phase=phase), bits)
    return lambda bits: cc.allgather_membership_planes(
        bits, grid, axis, ladder, stats=stats, phase=phase)


def _sum_algebra(alg) -> bool:
    """Sum algebras bypass the min-merge wires: every row exchange is the
    dense int32 one with the algebra's add-combine."""
    return alg.reduce == "sum"


def _localize_n_c(alg, n_c):
    """Column-slice width for payload localization, or None when the payload
    is a global value rather than a source id."""
    return n_c if alg.payload_is_id else None


def _dense_row(s, grid, axis, n_c, parent_width, *, b=1, stats=None,
               phase="bfs/row", alg=BFS):
    ex = AdaptiveExchange(phase, grid, axis, None, stats, planes=b)
    if _sum_algebra(alg):
        return lambda prop: cc.alltoall_dense_combine_planes(ex, prop, alg)
    if b == 1:
        return lambda prop: _one(lambda x: cc.alltoall_dense_min(ex, x), prop)
    return lambda prop: cc.alltoall_dense_min_planes(ex, prop)


def _auto_row(s, grid, axis, n_c, parent_width, *, b=1, stats=None,
              phase="bfs/row", alg=BFS):
    if _sum_algebra(alg):
        return _dense_row(s, grid, axis, n_c, parent_width, b=b, stats=stats,
                          phase=phase, alg=alg)
    # the row phase's dense fallback is a 32-bit candidate vector -> its own
    # (deeper) ladder, with the payload priced into every bucket; parent ids
    # pack COLUMN-LOCAL offsets (parent_width = class(n_c)), values their
    # algebra's class, as they are (n_c=None)
    ladder = BucketLadder.default(s, floor_words=s, payload_width=parent_width)
    loc = _localize_n_c(alg, n_c)
    if b == 1:
        return lambda prop: _one(lambda x: cc.alltoall_min_candidates(
            x, grid, axis, ladder, stats=stats, phase=phase, n_c=loc), prop)
    return lambda prop: cc.alltoall_min_candidates_planes(
        prop, grid, axis, ladder, stats=stats, phase=phase, n_c=loc)


def _dense_row_bu(s, grid, axis, n_c, parent_width, *, b=1, stats=None,
                  phase="bfs/row-pull", alg=BFS):
    """Baseline pull row exchange: globalize id candidates, dense int32 wire."""
    ex = AdaptiveExchange(phase, grid, axis, None, stats, planes=b)
    if _sum_algebra(alg):
        return lambda prop: cc.alltoall_dense_combine_planes(ex, prop, alg)
    col = grid.axis_index(axis)
    loc = _localize_n_c(alg, n_c)

    def run(prop):
        glob = prop
        if loc is not None:
            glob = [None if x is None else torch.where(x < INF, col[p] * n_c + x, INF)
                    for p, x in enumerate(prop)]
        if b == 1:
            return _one(lambda x: cc.alltoall_dense_min(ex, x), glob)
        return cc.alltoall_dense_min_planes(ex, glob)

    return run


def _bitmap_row_bu(s, grid, axis, n_c, parent_width, *, b=1, stats=None,
                   phase="bfs/row-pull", alg=BFS):
    """Compressed pull row exchange: found-bitmap + bit-packed payloads."""
    if _sum_algebra(alg) or parent_width >= 32:
        # width-32 payloads (values, huge n_c) would not undercut the dense
        # vector; sum candidates are dense by nature
        return _dense_row_bu(s, grid, axis, n_c, parent_width, b=b, stats=stats,
                             phase=phase, alg=alg)
    fmt = BitmapParentFormat(s, parent_width)
    ex = AdaptiveExchange(phase, grid, axis, None, stats, planes=b)
    loc = _localize_n_c(alg, n_c)
    if b == 1:
        return lambda prop: _one(lambda x: cc.alltoall_bitmap_min(ex, x, fmt, loc), prop)
    return lambda prop: cc.alltoall_bitmap_min_planes(ex, prop, fmt, loc)


def _btfly_row(s, grid, axis, n_c, parent_width, *, b=1, stats=None, phase="bfs/row",
               alg=BFS):
    """log2(C)-stage butterfly push row phase (merge + re-bucket per hop)."""
    return butterfly.build_row_exchange(s, grid, axis, n_c, b=b, to_global=False,
                                        stats=stats, phase=phase, alg=alg)


def _btfly_row_bu(s, grid, axis, n_c, parent_width, *, b=1, stats=None,
                  phase="bfs/row-pull", alg=BFS):
    """Butterfly pull row phase: globalize column-local candidates, then the
    same staged merge as the push direction."""
    return butterfly.build_row_exchange(s, grid, axis, n_c, b=b, to_global=True,
                                        stats=stats, phase=phase, alg=alg)


def _btfly_unreached(s, grid, axis, *, b=1, stats=None, phase="bfs/unreached"):
    return butterfly.build_unreached_gather(s, grid, axis, b=b, stats=stats, phase=phase)


# the unreached-membership gather rides the same wire as the plan's
# uncompressed or bitmap column gather (over the grid row)
WIRE_PLANS = {
    p.name: p
    for p in (
        WirePlan("raw", _raw_column, _dense_row, _dense_row_bu, _raw_column),
        WirePlan("bitmap", _bitmap_column, _dense_row, _bitmap_row_bu, _bitmap_column),
        WirePlan("auto", _auto_column, _auto_row, _bitmap_row_bu, _bitmap_column),
        # ButterFly BFS: the adaptive column gather, staged row exchanges
        # and a staged unreached gather
        WirePlan("btfly", _auto_column, _btfly_row, _btfly_row_bu, _btfly_unreached),
    )
}


def register_wire_plan(plan: WirePlan) -> None:
    register(WIRE_PLANS, "wire plan", plan)


def wire_plan(name: str) -> WirePlan:
    """Wire plan by name (``raw`` | ``bitmap`` | ``auto`` | ``btfly``, or a
    registered one)."""
    return lookup(WIRE_PLANS, "wire plan", name)


def available_wire_plans() -> list[str]:
    return sorted(WIRE_PLANS)


# ---------------------------------------------------------------------------
# traversal policies (direction optimization, paper §3.1), expansion
# backends (local block storage) and frontier algebras (the semiring axis):
# the tables live beside their code, in repro_torch.core
# ---------------------------------------------------------------------------


def register_traversal(policy) -> None:
    """Register a traversal policy object (it must expose ``.name``)."""
    register(POLICIES, "traversal policy", policy)


def traversal(name: str):
    return lookup(POLICIES, "traversal policy", name)


def available_traversals() -> list[str]:
    return sorted(POLICIES)


def register_algebra(alg) -> None:
    """Register a frontier algebra object (it must expose ``.name``)."""
    register(ALGEBRAS, "frontier algebra", alg)


def algebra(name: str):
    return lookup(ALGEBRAS, "frontier algebra", name)


def available_algebras() -> list[str]:
    return sorted(ALGEBRAS)


def register_expansion(backend) -> None:
    """Register a local-expansion backend object (it must expose ``.name``)."""
    register(BACKENDS, "expansion backend", backend)


def expansion(name: str):
    """Expansion backend by its registered name (``core.expand.resolve``
    also takes the alias ``auto``)."""
    return lookup(BACKENDS, "expansion backend", name)


def available_expansions() -> list[str]:
    return sorted(BACKENDS)
