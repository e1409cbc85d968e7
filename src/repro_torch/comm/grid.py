"""The R x C grid of ranks: its geometry, and SimGrid, every rank in one process.

The port's counterpart of the ``jax.make_mesh`` + ``shard_map`` pair.  Every
per-rank value is a Python list of R*C entries, indexed by rank ``p = i*C +
j`` (grid row ``i``, grid column ``j``); the per-rank body of the
distributed BFS is written once against such lists.  A grid holds the
tensors of its *local ranks* (:attr:`Grid.local_ranks`) and ``None`` for
every other rank, and for a rank that takes no part in a call.  Two grids
implement the interface:

* :class:`SimGrid` — every rank in this process, on one device (local
  ranks: all of them);
* :class:`repro_torch.comm.procgrid.ProcessGrid` — one process per rank
  over ``torch.distributed`` (local ranks: its own).

The collectives follow ``jax.lax``'s semantics exactly — tiled
``all_gather`` and ``all_to_all`` (split and concatenate on dim 0),
``psum``, ``pmax``, ``pmin``, ``ppermute`` (a rank no pair sends to
receives zeros), and ``reduce_scatter`` (``psum_scatter`` tiled on dim 0)
— over the communicator groups of an axis:

* the row axes (``"data"``) — the R ranks that share a grid column ``j``
  (C groups);
* ``"model"`` — the C ranks that share a grid row ``i`` (R groups);
* the row axes and ``"model"`` — the whole grid, linearized row-major.

The row axes may be a fold of several mesh axes, as JAX's
``DistBFSConfig(row_axes=("pod", "data"))``: ``row_fold={"pod": 2,
"data": 2}`` gives R = 4, and a collective over ``("pod", "data")`` runs
over the R ranks of a grid column in the row-major order that
``jax.lax.axis_index(("pod", "data"))`` gives, grid row ``i = pod * 2 +
data``.  A collective over part of the fold is not supported.

``axis_index`` is a rank's position within its group.  A collective may be
restricted to a subset of an axis's groups (an adaptive exchange's groups
can pick different branches).  The grid moves no bytes itself and records
nothing: :class:`repro_torch.comm.engine.AdaptiveExchange` keeps the
ledger.

The differentiable collectives (``ad_all_gather``, ``ad_all_to_all``,
``ad_ppermute``, ``ad_psum``: autodiff counterparts of the grid's own, as
``jax.grad`` transposes ``shard_map``'s collectives) run a grid's
collective forward and its transpose backward, written with the grid's
own collectives — an all-gather's transpose as a ``psum`` and a slice, or
(``scatter=True``) the grid's ``reduce_scatter``, the same sums of the
slice alone — so that float sums run in group order on both grids and
``SimGrid`` and ``ProcessGrid`` give the same gradients bit for bit on the
CPU.  :func:`pmean_trees` means per-rank trees of tensors
(gradients) over an axis.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from repro_torch import resolve_device, tree

ROW_AXIS = "data"
COL_AXIS = "model"
ALL_AXES = (ROW_AXIS, COL_AXIS)


def axis_names(axis) -> tuple[str, ...]:
    """An axis name or a tuple of names -> a tuple of names."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Grid:
    """The static geometry of an R x C grid, its row axes possibly folded."""

    #: seconds of host<->device copies of a staged transport (a
    #: ``ProcessGrid`` under gloo with CUDA tensors; 0 elsewhere)
    staging_s = 0.0

    def __init__(self, rows: int, cols: int, row_fold=None):
        if rows < 1 or cols < 1:
            raise ValueError(f"grid must be at least 1x1, got {rows}x{cols}")
        self.rows, self.cols = rows, cols
        if row_fold is None:
            self.row_axes: tuple[str, ...] = (ROW_AXIS,)
        else:
            fold = dict(row_fold)
            sizes = list(fold.values())
            if (COL_AXIS in fold or not fold or any(k < 1 for k in sizes)
                    or math.prod(sizes) != rows):
                raise ValueError(f"row fold {fold} does not span the {rows} grid rows "
                                 f"(its sizes must multiply to R; {COL_AXIS!r} is the "
                                 "column axis)")
            self.row_axes = tuple(fold)
        self.row_fold = None if row_fold is None else dict(row_fold)
        self.all_axes = self.row_axes + (COL_AXIS,)

    @property
    def size(self) -> int:
        return self.rows * self.cols

    @property
    def local_ranks(self) -> list[int]:
        """The ranks whose tensors this process holds."""
        raise NotImplementedError

    def _new(self) -> list:
        return [None] * self.size

    def barrier(self) -> None:
        """Wait for every process of the grid (one process: no wait)."""

    def local(self, fn: Callable[[int], object]) -> list:
        """A per-rank list: ``fn(p)`` for each local rank ``p``, ``None``
        elsewhere."""
        out = [None] * self.size
        for p in self.local_ranks:
            out[p] = fn(p)
        return out

    def _axis(self, axis) -> str:
        names = axis_names(axis)
        if names == self.row_axes:
            return "row"
        if names == (COL_AXIS,):
            return "col"
        if names == self.all_axes:
            return "all"
        raise ValueError(f"unknown grid axis {axis!r}: the grid has row axes "
                         f"{self.row_axes} and column axis {COL_AXIS!r} (a "
                         "collective over part of a row fold is not supported)")

    def all_groups(self, axis) -> list[list[int]]:
        """Every communicator group of ``axis``, each a list of ranks in
        axis-index order (ascending rank order too)."""
        kind = self._axis(axis)
        r, c = self.rows, self.cols
        if kind == "row":
            return [[i * c + j for i in range(r)] for j in range(c)]
        if kind == "col":
            return [[i * c + j for j in range(c)] for i in range(r)]
        return [list(range(r * c))]

    def groups(self, axis) -> list[list[int]]:
        """The communicator groups of ``axis`` that hold a local rank."""
        local = set(self.local_ranks)
        return [g for g in self.all_groups(axis) if local.intersection(g)]

    def group_size(self, axis) -> int:
        return len(self.all_groups(axis)[0])

    def axis_index(self, axis) -> list[int]:
        """Each rank's position within its group of ``axis``."""
        out = [0] * self.size
        for g in self.all_groups(axis):
            for a, p in enumerate(g):
                out[p] = a
        return out


class SimGrid(Grid):
    """R x C ranks in this process on one device (``device=None`` means
    ``cuda``); ``row_fold`` as for :class:`Grid`."""

    def __init__(self, rows: int, cols: int, device=None, *, row_fold=None):
        super().__init__(rows, cols, row_fold)
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        fold = "" if self.row_fold is None else f", row_fold={self.row_fold}"
        return f"SimGrid({self.rows}x{self.cols}, {self.device}{fold})"

    @property
    def local_ranks(self) -> list[int]:
        return list(range(self.size))

    def assemble(self, xs: Sequence, dim: int = 1) -> torch.Tensor:
        """Every rank's tensor concatenated along ``dim`` in rank order (the
        global output of the program, not one of its collectives)."""
        return torch.cat(list(xs), dim=dim)

    def gather_objects(self, obj) -> list:
        """Every process's ``obj``: this one's."""
        return [obj]

    # -- collectives over per-rank lists -------------------------------------

    def all_gather(self, xs: Sequence, axis, groups=None) -> list:
        """Tiled all-gather: each member gets its group's values
        concatenated along dim 0, in axis-index order."""
        out = self._new()
        for g in groups or self.groups(axis):
            cat = torch.cat([xs[p] for p in g], dim=0)
            for p in g:
                out[p] = cat
        return out

    def all_to_all(self, xs: Sequence, axis, groups=None) -> list:
        """Tiled all-to-all, split and concatenated on dim 0: member ``a``
        receives chunk ``a`` of every member's value, in sender order."""
        out = self._new()
        for g in groups or self.groups(axis):
            parts = [torch.chunk(xs[p], len(g), dim=0) for p in g]
            for a, p in enumerate(g):
                out[p] = torch.cat([parts[b][a] for b in range(len(g))], dim=0)
        return out

    def _reduce(self, xs, axis, groups, op) -> list:
        out = self._new()
        for g in groups or self.groups(axis):
            acc = xs[g[0]]
            for p in g[1:]:
                acc = op(acc, xs[p])
            for p in g:
                out[p] = acc
        return out

    def psum(self, xs: Sequence, axis, groups=None) -> list:
        return self._reduce(xs, axis, groups, torch.add)

    def reduce_scatter(self, xs: Sequence, axis, groups=None) -> list:
        """Tiled reduce-scatter on dim 0: member ``a`` gets chunk ``a`` of
        the group's sum, added in group order (each group summed once, the
        bits of ``psum``'s chunk)."""
        summed = self._reduce(xs, axis, groups, torch.add)
        idx = self.axis_index(axis)
        k = self.group_size(axis)
        out = self._new()
        for g in groups or self.groups(axis):
            parts = split_rows(summed[g[0]], k)
            for p in g:
                out[p] = parts[idx[p]]
        return out

    def pmax(self, xs: Sequence, axis, groups=None) -> list:
        return self._reduce(xs, axis, groups, torch.maximum)

    def pmin(self, xs: Sequence, axis, groups=None) -> list:
        return self._reduce(xs, axis, groups, torch.minimum)

    def ppermute(self, xs: Sequence, axis, perm, groups=None) -> list:
        """``perm``: (src, dst) pairs of axis indices; a member no pair
        sends to receives zeros."""
        out = self._new()
        receivers = {dst for _, dst in perm}
        for g in groups or self.groups(axis):
            for src, dst in perm:
                out[g[dst]] = xs[g[src]]
            for a, p in enumerate(g):
                if a not in receivers:
                    out[p] = torch.zeros_like(xs[p])
        return out


def split_rows(x: torch.Tensor, k: int) -> tuple:
    """``x`` in ``k`` equal chunks of dim 0 (a reduce-scatter's tiles)."""
    if x.shape[0] % k:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not split over {k} ranks")
    return torch.chunk(x, k, dim=0)


# ---------------------------------------------------------------------------
# differentiable collectives: each backward is the collective's transpose,
# written with the grid's own collectives, so that SimGrid and ProcessGrid
# do the same float arithmetic (sums in group order) and agree bit for bit
# ---------------------------------------------------------------------------


def _own(grid: Grid, xs: Sequence, avoid) -> list:
    """The local ranks' entries of a per-rank list, each a tensor of its own:
    an entry that is one of ``avoid`` or the same object as an earlier entry
    is cloned (a custom autograd function must not return one tensor twice,
    and a transpose must not hand back a cotangent it was given)."""
    out, seen = [], {id(a) for a in avoid}
    for p in grid.local_ranks:
        y = xs[p]
        if id(y) in seen:
            y = y.clone()
        seen.add(id(y))
        out.append(y)
    return out


def _spread(grid: Grid, xs) -> list:
    """The local ranks' tensors, in local-rank order, as a per-rank list."""
    out = grid._new()
    for p, x in zip(grid.local_ranks, xs):
        out[p] = x
    return out


class _Collective(torch.autograd.Function):
    """A collective over the local ranks' tensors whose backward runs
    ``transpose`` over the cotangents."""

    @staticmethod
    def forward(ctx, grid, fwd, transpose, *xs):
        ctx.grid, ctx.transpose = grid, transpose
        return tuple(_own(grid, fwd(_spread(grid, xs)), xs))

    @staticmethod
    def backward(ctx, *cts):
        grid = ctx.grid
        return (None, None, None, *_own(grid, ctx.transpose(_spread(grid, cts)), cts))


def _differentiable(grid: Grid, xs: Sequence, fwd, transpose) -> list:
    ranks = grid.local_ranks
    if not (torch.is_grad_enabled() and any(xs[p].requires_grad for p in ranks)):
        return fwd(xs)
    return _spread(grid, _Collective.apply(grid, fwd, transpose, *(xs[p] for p in ranks)))


def ad_all_gather(grid: Grid, xs: Sequence, axis, scatter: bool = False) -> list:
    """``grid.all_gather`` whose backward is a reduce-scatter: the group's
    cotangents summed (``grid.psum``, group order), then this rank's slice;
    with ``scatter``, ``grid.reduce_scatter`` (the same bits, only the
    slice summed and moved)."""
    def transpose(cts):
        if scatter:
            return grid.reduce_scatter(cts, axis)
        summed = grid.psum(cts, axis)
        idx, k = grid.axis_index(axis), grid.group_size(axis)
        return grid.local(lambda p: torch.chunk(summed[p], k, dim=0)[idx[p]])

    return _differentiable(grid, xs, lambda v: grid.all_gather(v, axis), transpose)


def ad_all_to_all(grid: Grid, xs: Sequence, axis) -> list:
    """``grid.all_to_all``; the tiled all-to-all is its own inverse, and so
    its own transpose."""
    def run(v):
        return grid.all_to_all(v, axis)

    return _differentiable(grid, xs, run, run)


def ad_ppermute(grid: Grid, xs: Sequence, axis, perm) -> list:
    """``grid.ppermute``; the transpose sends each pair back (a member that
    sent nothing gets a zero cotangent)."""
    back = [(dst, src) for src, dst in perm]
    return _differentiable(grid, xs, lambda v: grid.ppermute(v, axis, perm),
                           lambda v: grid.ppermute(v, axis, back))


def ad_psum(grid: Grid, xs: Sequence, axis) -> list:
    """``grid.psum``, whose transpose is ``psum``."""
    def run(v):
        return grid.psum(v, axis)

    return _differentiable(grid, xs, run, run)


def pmean_trees(grid: Grid, trees: Sequence, axis=None) -> list:
    """The mean over ``axis`` (default: the whole grid) of each local rank's
    tree of tensors, leaf by leaf: the leaves flattened into one vector, one
    ``grid.psum`` (a float sum in group order), over the group size.
    Returns a per-rank list of trees (the members of a group share theirs).
    Not differentiable: it means gradients."""
    axis = grid.all_axes if axis is None else axis
    ranks = grid.local_ranks
    shapes = [g.shape for g in tree.leaves(trees[ranks[0]])]
    vec = grid.local(lambda p: torch.cat([g.reshape(-1) for g in tree.leaves(trees[p])]))
    total = grid.psum(vec, axis)
    k = grid.group_size(axis)
    means: dict[int, object] = {}  # one per group's sum

    def mean(p):
        if id(total[p]) not in means:
            parts = torch.split(total[p] / k, [math.prod(s) for s in shapes])
            means[id(total[p])] = tree.flatten(trees[p])[1](
                [x.view(s) for x, s in zip(parts, shapes)])
        return means[id(total[p])]

    return grid.local(mean)
