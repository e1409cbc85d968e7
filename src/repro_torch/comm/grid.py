"""SimGrid: an R x C grid of ranks simulated in one process on one device.

The port's counterpart of the ``jax.make_mesh`` + ``shard_map`` pair.  Every
per-rank value is a Python list of R*C tensors on ``grid.device``, indexed by
rank ``p = i*C + j`` (grid row ``i``, grid column ``j``); the per-rank body of
the distributed BFS is written once against such lists, and a rank that
takes no part in a call holds ``None``.  The collectives follow
``jax.lax``'s semantics exactly — tiled ``all_gather`` and ``all_to_all``
(split and concatenate on dim 0), ``psum``, ``pmax``, ``pmin``, ``ppermute``
(a rank no pair sends to receives zeros) — over the communicator groups of an axis:

* ``"data"``  — the R ranks that share a grid column ``j`` (C groups);
* ``"model"`` — the C ranks that share a grid row ``i`` (R groups);
* ``("data", "model")`` — the whole grid, linearized row-major.

``axis_index`` is a rank's position within its group.  A collective may be
restricted to a subset of an axis's groups (an adaptive exchange's groups
can pick different branches).  The grid moves no bytes itself and records
nothing: :class:`repro_torch.comm.engine.AdaptiveExchange` keeps the
ledger.  A process-group backend would hand the same body a list of one
tensor, its own rank's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import resolve_device

ROW_AXIS = "data"
COL_AXIS = "model"
ALL_AXES = (ROW_AXIS, COL_AXIS)


class SimGrid:
    """R x C ranks on one device (``device=None`` means ``cuda``)."""

    def __init__(self, rows: int, cols: int, device=None):
        if rows < 1 or cols < 1:
            raise ValueError(f"grid must be at least 1x1, got {rows}x{cols}")
        self.rows, self.cols = rows, cols
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"SimGrid({self.rows}x{self.cols}, {self.device})"

    @property
    def size(self) -> int:
        return self.rows * self.cols

    def _axis(self, axis) -> str | tuple[str, str]:
        if isinstance(axis, (tuple, list)):
            axis = tuple(axis)
            if len(axis) == 1:
                axis = axis[0]
        if axis in (ROW_AXIS, COL_AXIS, ALL_AXES):
            return axis
        raise ValueError(f"unknown grid axis {axis!r}: the grid has {ALL_AXES} "
                         "(a multi-axis row fold is not supported)")

    def groups(self, axis) -> list[list[int]]:
        """The communicator groups of ``axis``, each a list of ranks in
        axis-index order."""
        axis = self._axis(axis)
        r, c = self.rows, self.cols
        if axis == ROW_AXIS:
            return [[i * c + j for i in range(r)] for j in range(c)]
        if axis == COL_AXIS:
            return [[i * c + j for j in range(c)] for i in range(r)]
        return [list(range(r * c))]

    def group_size(self, axis) -> int:
        return len(self.groups(axis)[0])

    def axis_index(self, axis) -> list[int]:
        """Each rank's position within its group of ``axis``."""
        out = [0] * self.size
        for g in self.groups(axis):
            for a, p in enumerate(g):
                out[p] = a
        return out

    # -- collectives over per-rank lists -------------------------------------

    def _new(self) -> list:
        return [None] * self.size

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
