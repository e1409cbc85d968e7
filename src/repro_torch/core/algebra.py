"""Frontier algebras: the (message, combine, update) triple of a level.

The port's counterpart of ``repro/core/algebra.py:51-370``.  An algebra
owns the message a frontier source proposes along an edge, the combine
that merges candidates (on the wire and in the local reduce), the update
that folds them into the value plane, and its termination consensus
(:meth:`FrontierAlgebra.post_update`).  Four instances, resolved by name:

``bfs``       min-parent: the candidate is the source id, so wires may
              localize and re-globalize it; a vertex activates on first touch.
``sssp``      min-plus over int32 distances and the hashed edge weights of
              :func:`edge_weight`; delta-stepping: the frontier is the
              pending set within ``delta`` of the global minimum tentative
              distance, a recorded ``pmin`` ("window").
``cc``        min-label propagation from a dense frontier to the component
              minimum.
``pagerank``  plus-times: x = v/deg, v' = (1-d)/n + d * sum, float32 values
              carried as their int32 bit patterns (:meth:`enc` / :meth:`dec`),
              until the global L1 residual (a recorded ``psum``) is <= ``tol``.

Every wire and carry plane is int32.  Min-algebras use ``INF`` as the
absent candidate; the sum algebra uses 0, the bit pattern of 0.0, so a
sum needs no mask.

``post_update`` serves both drivers: its planes are per-rank lists (one
entry on the single device, which passes :data:`LOCAL_EXCHANGE`, whose
all-reduces are identities; ``None`` for a rank that a process of a grid
does not hold, which :func:`per_rank` skips), and ``ex`` is the grid's
termination exchange on the distributed driver.  Every collective it runs
feeds the next frontier or ``alive``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lookup
from repro_torch.kernels.bitpack.ref import B_CLASSES
from repro_torch.kernels.spmv import ref as spmv_ref

INF = 2**31 - 1  # int32 max: "no candidate" on every min-candidate plane


def width_class(n: int) -> int:
    """Smallest bit-packing class covering ids in [0, n) (the reference's
    ``repro/comm/butterfly.py:width_class``)."""
    need = max((n - 1).bit_length(), 1)
    for b in B_CLASSES:
        if b >= need:
            return b
    return 32


def edge_weight(u, v, max_weight: int = 31):
    """Deterministic symmetric weight in [1, max_weight] of edges (u, v).

    Torch tensors go through :func:`repro_torch.kernels.spmv.ref.edge_weight`
    (int64 masked to 32 bits, the form the kernel's plain version uses);
    numpy arrays through numpy's uint32, which wraps as the reference's
    ``xp=np`` form.  Both give the reference's weights exactly."""
    if isinstance(u, torch.Tensor) or isinstance(v, torch.Tensor):
        return spmv_ref.edge_weight(torch.as_tensor(u), torch.as_tensor(v), max_weight)
    a = np.atleast_1d(np.minimum(u, v)).astype(np.uint32)
    b = np.atleast_1d(np.maximum(u, v)).astype(np.uint32)
    h = (a * np.uint32(2654435761)) ^ (b * np.uint32(40503) + np.uint32(2654435769))
    h = h ^ (h >> np.uint32(16))
    w = (h % np.uint32(max_weight)).astype(np.int32) + 1
    return w.reshape(np.broadcast_shapes(np.shape(u), np.shape(v)))


def per_rank(fn, *xs) -> list:
    """``fn`` over the per-rank entries of the lists ``xs``, position by
    position; ``None`` where any of them is ``None`` (a rank this process
    does not hold)."""
    return [None if any(v is None for v in vals) else fn(*vals) for vals in zip(*xs)]


class _LocalExchange:
    """Engine facade of the single-device driver: a group of one, so the
    algebra's all-reduces (``psum`` / ``pmin``) are identities."""

    def psum(self, xs, **kw):
        return xs

    def pmin(self, xs, **kw):
        return xs


LOCAL_EXCHANGE = _LocalExchange()


@dataclasses.dataclass(frozen=True)
class FrontierAlgebra:
    """One vertex program's semiring and activation rule (module doc)."""

    name = ""
    reduce = "min"  # "min" | "sum": the combine's shape
    payload_is_id = False  # wires may localize / re-globalize the payload
    needs_values = False  # the column phase gathers source values
    needs_deg = False  # the driver computes the (owned) degree vector
    starts_dense = False  # initial frontier = every vertex
    uses_weights = False  # messages add edge_weight

    # --- transport -------------------------------------------------------

    @property
    def empty(self) -> int:
        """Absent candidate on the int32 wire."""
        return INF if self.reduce == "min" else 0

    def enc(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def dec(self, x: torch.Tensor) -> torch.Tensor:
        return x

    # --- semiring --------------------------------------------------------

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.reduce == "min":
            return torch.minimum(a, b)
        return self.enc(self.dec(a) + self.dec(b))

    def segment_combine(self, vals: torch.Tensor, segs: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
        """Per-destination reduce of (e,) candidates into ``num_segments``
        (int64 ``segs``); the sum needs no mask (0 decodes to 0.0)."""
        if self.reduce == "min":
            out = torch.full((num_segments,), INF, dtype=torch.int32, device=vals.device)
            return out.scatter_reduce_(0, segs, vals, "amin")
        out = torch.zeros(num_segments, dtype=torch.float32, device=vals.device)
        return self.enc(out.index_add_(0, segs, self.dec(vals)))

    def row_payload_width(self, n_c: int, n: int) -> int:
        """Bit-packing class of the row wire's candidate payload."""
        return 32

    # --- messages --------------------------------------------------------

    def source_values(self, value: torch.Tensor, deg) -> torch.Tensor:
        """Per-source message operand x from the owned value plane."""
        return value

    def edge_weights(self, src_g: torch.Tensor, dst_g: torch.Tensor):
        """Per-edge operand of :meth:`edge_message` from the global ids
        (``None`` where the message needs none).  It depends on no plane,
        so an expansion computes it once for all B planes, as the
        reference's ``vmap`` over planes leaves it unbatched."""
        return None

    def edge_message(self, x_src: torch.Tensor, w) -> torch.Tensor:
        """Candidate an edge proposes to its destination (encoded), from
        its source's value and its :meth:`edge_weights` entry."""
        return x_src

    # --- state -----------------------------------------------------------

    def init(self, hit: torch.Tensor, idx: torch.Tensor, roots: torch.Tensor, n: int):
        """Initial (value, frontier) planes; ``idx`` are the (s,) global
        ids of the owned vertices, ``hit`` the (B, s) root planes."""
        raise NotImplementedError

    def init_aux(self, frontier: torch.Tensor) -> tuple:
        """Algebra-private level-loop carry of one rank."""
        return ()

    def update(self, value: torch.Tensor, cand: torch.Tensor, depth: int, n: int):
        """Fold reduced candidates into the value plane -> (value', new)."""
        raise NotImplementedError

    def pull_mask(self, value: torch.Tensor) -> torch.Tensor:
        """Destinations that accumulate candidates in pull expansion."""
        return torch.ones(value.shape, dtype=torch.bool, device=value.device)

    def post_update(self, ex, aux: list, value_prev: list, value: list, new: list,
                    frontier_prev: list, plane_counts):
        """Next ``(aux, frontier, counts, alive)`` per rank after an update.

        Every argument but ``ex`` and ``plane_counts`` (the popcount
        kernel) is a per-rank list; ``alive`` holds 0-d bool tensors, equal
        on every rank.  Default: fixed point — the frontier is what
        improved, and the program stops when nothing did (one recorded
        all-reduce of the per-plane counts, "termination")."""
        counts = ex.psum(per_rank(plane_counts, new), fmt="termination")
        return aux, new, counts, per_rank(lambda c: (c > 0).any(), counts)

    def finalize(self, value: torch.Tensor) -> torch.Tensor:
        """The owned value plane in the algebra's output domain."""
        return value


@dataclasses.dataclass(frozen=True)
class BfsAlgebra(FrontierAlgebra):
    """Min-parent BFS: the candidate is the source id (membership bits
    carry the whole message, so no value gather)."""

    name = "bfs"
    payload_is_id = True

    def row_payload_width(self, n_c: int, n: int) -> int:
        return width_class(n_c)  # column-local parents

    def init(self, hit, idx, roots, n):
        value = torch.where(hit, roots[:, None], -1).to(torch.int32)
        return value, hit

    def update(self, value, cand, depth, n):
        new = (cand < INF) & (value < 0)
        return torch.where(new, cand, value), new

    def pull_mask(self, value):
        return value < 0


@dataclasses.dataclass(frozen=True)
class SsspAlgebra(FrontierAlgebra):
    """Min-plus single-source shortest paths with delta-stepping windows.

    Distances are int32 (INF = unreached).  The aux ``pending`` plane holds
    every vertex whose distance improved but whose edges were not relaxed
    at that distance; a level relaxes the pending set within ``delta`` of
    the global minimum pending distance.  Termination: no pending vertex
    anywhere (the window vertex is always in the frontier, so the counts
    say it)."""

    name = "sssp"
    needs_values = True
    uses_weights = True
    delta: int = 31
    max_weight: int = 31

    def init(self, hit, idx, roots, n):
        return torch.where(hit, 0, INF).to(torch.int32), hit

    def init_aux(self, frontier):
        return (frontier,)

    def edge_weights(self, src_g, dst_g):
        return edge_weight(src_g, dst_g, self.max_weight)

    def edge_message(self, x_src, w):
        return torch.where(x_src >= INF - w, INF, x_src + w)

    def update(self, value, cand, depth, n):
        return torch.minimum(value, cand), cand < value

    def post_update(self, ex, aux, value_prev, value, new, frontier_prev, plane_counts):
        pending = per_rank(lambda a, fp, nw: (a[0] & ~fp) | nw, aux, frontier_prev, new)
        local_min = per_rank(lambda pd, v: torch.where(pd, v, INF).amin(dim=1).to(torch.int32),
                             pending, value)  # (B,) window floor share
        floor = ex.pmin(local_min, fmt="window")

        def window(m, pd, v):
            thresh = torch.where(m >= INF - self.delta, INF, m + self.delta)
            return pd & (v <= thresh[:, None])

        frontier = per_rank(window, floor, pending, value)
        counts = ex.psum(per_rank(plane_counts, frontier), fmt="frontier")
        return (per_rank(lambda pd: (pd,), pending), frontier, counts,
                per_rank(lambda c: (c > 0).any(), counts))


@dataclasses.dataclass(frozen=True)
class CcAlgebra(FrontierAlgebra):
    """Min-label propagation: every vertex starts with its own global id
    and a dense frontier; each component converges to its minimum id.
    The roots play no part (every plane computes the same labels)."""

    name = "cc"
    needs_values = True
    starts_dense = True

    def row_payload_width(self, n_c: int, n: int) -> int:
        return width_class(n)  # labels are global ids

    def init(self, hit, idx, roots, n):
        value = idx.to(torch.int32)[None, :].expand(hit.shape).contiguous()
        return value, torch.ones_like(hit)

    def update(self, value, cand, depth, n):
        return torch.minimum(value, cand), cand < value


@dataclasses.dataclass(frozen=True)
class PageRankAlgebra(FrontierAlgebra):
    """Plus-times PageRank to an L1 residual <= ``tol``; dangling mass is
    not redistributed (the host oracle applies the same rule)."""

    name = "pagerank"
    reduce = "sum"
    needs_values = True
    needs_deg = True
    starts_dense = True
    damping: float = 0.85
    tol: float = 1e-4

    def enc(self, x):
        return x.to(torch.float32).view(torch.int32)

    def dec(self, x):
        return x.view(torch.float32)

    def init(self, hit, idx, roots, n):
        v0 = torch.full(hit.shape, 1.0 / n, dtype=torch.float32, device=hit.device)
        return self.enc(v0), torch.ones_like(hit)

    def source_values(self, value, deg):
        v = self.dec(value)
        x = torch.where(deg[None, :] > 0, v / torch.clamp(deg, min=1)[None, :], 0.0)
        return self.enc(x)

    def update(self, value, cand, depth, n):
        v = (1.0 - self.damping) / n + self.damping * self.dec(cand)
        value_new = self.enc(v)
        return value_new, value_new != value

    def post_update(self, ex, aux, value_prev, value, new, frontier_prev, plane_counts):
        res_local = per_rank(lambda v, vp: (self.dec(v) - self.dec(vp)).abs().sum(dim=1),
                             value, value_prev)  # (B,) L1 share
        res = ex.psum(res_local, fmt="residual")
        frontier = per_rank(lambda v: torch.ones(v.shape, dtype=torch.bool, device=v.device),
                            value)
        # the frontier is dense every round: its counts are a local
        # constant, only the residual goes over the wire
        return (aux, frontier, per_rank(plane_counts, frontier),
                per_rank(lambda r: (r > self.tol).any(), res))

    def finalize(self, value):
        return self.dec(value)


ALGEBRAS = {a.name: a for a in (BfsAlgebra(), SsspAlgebra(), CcAlgebra(),
                                PageRankAlgebra())}


def resolve(algebra) -> FrontierAlgebra:
    """An algebra by name (one of :data:`ALGEBRAS`, which
    :func:`repro_torch.comm.registry.register_algebra` extends), or a
    :class:`FrontierAlgebra` instance passed through (a custom ``delta`` or
    ``tol`` needs no registration)."""
    if isinstance(algebra, FrontierAlgebra):
        return algebra
    return lookup(ALGEBRAS, "frontier algebra", algebra)
