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
receives zeros) — over the communicator groups of an axis:

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
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from repro_torch import resolve_device

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
