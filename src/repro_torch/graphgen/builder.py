"""Edge list -> CSR construction (Graph500 "Kernel 1") and the ELL / hybrid
local-expansion containers.

The port's copy of ``repro/graphgen/builder.py``: every array it returns
is byte-identical to the reference's for the same input.  One
change of method, not of result: :func:`build_csr` sorts one int64 key
``src * span + dst`` in place instead of a two-key ``lexsort`` and a
gather, which gives the same (src, dst) order in a fraction of the host
time — what keeps Kernel 1 at scale 22 within a chip run's time limit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row graph + symmetric COO view.

    Attributes:
      n: vertex count.
      row_ptr: (n+1,) int64 CSR offsets.
      col_idx: (m,) int32 CSR adjacency (deduped, self-loop-free, symmetric).
      src/dst: (m,) int32 COO view of the same edges (sorted by src).
      m_input: number of *input* (pre-dedup, directed) edges — the TEPS
        denominator uses input edges within the traversed component.
    """

    n: int
    row_ptr: np.ndarray
    col_idx: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    m_input: int

    @property
    def m(self) -> int:
        return int(self.col_idx.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[v] : self.row_ptr[v + 1]]


def symmetrize(edges: np.ndarray) -> np.ndarray:
    """Append reversed edges: BFS treats the Graph500 graph as undirected."""
    return np.concatenate([edges, edges[:, ::-1]], axis=0)


def build_csr(
    edges: np.ndarray,
    n: int | None = None,
    drop_self_loops: bool = True,
    dedupe: bool = True,
    symmetrize_edges: bool = True,
) -> CSRGraph:
    """Build a symmetric CSR graph from an (m, 2) directed edge array of
    non-negative vertex ids.

    Pass ``symmetrize_edges=False`` when the input is already symmetric."""
    edges = np.asarray(edges, dtype=np.int64)
    m_input = int(edges.shape[0])
    if n is None:
        n = int(edges.max()) + 1 if edges.size else 0

    sym = symmetrize(edges) if symmetrize_edges else edges
    if drop_self_loops:
        sym = sym[sym[:, 0] != sym[:, 1]]
    # Sort by (src, dst) through one int64 key; dedupe equal neighbours.
    span = max(n, int(sym.max()) + 1 if sym.size else 1)
    key = sym[:, 0] * span + sym[:, 1]
    del sym
    key.sort()
    if dedupe and key.size:
        keep = np.ones(key.size, dtype=bool)
        keep[1:] = key[1:] != key[:-1]
        key = key[keep]

    src = (key // span).astype(np.int32)
    dst = (key % span).astype(np.int32)
    counts = np.bincount(src, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSRGraph(
        n=n, row_ptr=row_ptr, col_idx=dst.copy(), src=src, dst=dst, m_input=m_input
    )


def relabel_by_degree(g: CSRGraph) -> tuple[CSRGraph, np.ndarray]:
    """Paper §3.1 "vertex sorting": relabel vertices by descending degree.

    High-degree vertices get small ids, so the frontier's sorted id sequence
    concentrates near zero with small gaps, the numerical property the
    paper's delta+bitpack codec exploits (§5.4.1).  Ties keep their order
    (a stable sort).  Returns the relabeled graph, whose ``m_input`` is the
    original's, and the permutation ``new_id = perm[old_id]``.
    """
    deg = g.degrees()
    order = np.argsort(-deg, kind="stable")  # old ids in new order
    perm = np.empty_like(order)
    perm[order] = np.arange(g.n)
    new_edges = np.stack([perm[g.src], perm[g.dst]], axis=1)
    rebuilt = build_csr(
        new_edges, n=g.n, drop_self_loops=False, dedupe=False, symmetrize_edges=False
    )
    # m_input is a property of the original generator stream; preserve it.
    return dataclasses.replace(rebuilt, m_input=g.m_input), perm


def block_pad(g: CSRGraph, multiple: int) -> CSRGraph:
    """Pad the vertex count to a multiple with isolated vertices (static
    padding in place of the paper's odd-rank residuum handling, §7.2.1)."""
    n_pad = -(-g.n // multiple) * multiple
    if n_pad == g.n:
        return g
    row_ptr = np.concatenate(
        [g.row_ptr, np.full(n_pad - g.n, g.row_ptr[-1], dtype=g.row_ptr.dtype)]
    )
    return CSRGraph(n=n_pad, row_ptr=row_ptr, col_idx=g.col_idx, src=g.src, dst=g.dst,
                    m_input=g.m_input)


# ---------------------------------------------------------------------------
# ELL / hybrid local-expansion containers
# ---------------------------------------------------------------------------


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def ell_from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n_rows: int,
    n_cols: int,
    k: int,
    width: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Degree-split one local COO edge block at ``k``.

    Rows (destinations) with degree <= ``k`` move *entirely* into a dense
    destination-major ``(n_rows, width)`` ELL slab (sentinel-padded with
    ``n_cols``, which never hits a frontier bitmap); heavier rows keep all
    their edges in the returned COO residue — each row's edge set lives in
    exactly one structure, so ``min(slab result, residue result)`` equals
    the flat min over the union.  ``width`` defaults to ``k``.  Edges at
    the (``n_cols``, ``n_rows``) sentinels are dropped.
    """
    width = k if width is None else width
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    valid = (src < n_cols) & (dst < n_rows)
    s, d = src[valid], dst[valid]
    deg = np.bincount(d, minlength=n_rows)
    in_slab = deg[d] <= k
    nbr = np.full((n_rows, max(width, 1)), n_cols, np.int32)
    sd, ss = d[in_slab], s[in_slab]
    order = np.argsort(sd, kind="stable")
    sd, ss = sd[order], ss[order]
    starts = np.searchsorted(sd, np.arange(n_rows))
    rank = np.arange(sd.size) - starts[sd]
    nbr[sd, rank] = ss
    return nbr, s[~in_slab].astype(np.int32), d[~in_slab].astype(np.int32)


def select_split_k(
    degrees: np.ndarray, waste_budget: float = 0.5, multiple: int = 8
) -> int:
    """Pick the hybrid degree split from a block's degree histogram.

    Chooses the largest ``k`` (a ``multiple``-aligned slab width) whose ELL
    slab keeps padding waste under the budget, where waste is the fraction
    of slab slots holding sentinels:

        waste(k) = 1 - (edges of rows with degree <= k) / (n_rows * k)

    Falls back to the smallest slab when even that exceeds the budget.
    """
    deg = np.asarray(degrees)
    n_rows = int(deg.size)
    max_deg = int(deg.max(initial=0))
    if n_rows == 0 or max_deg == 0:
        return multiple
    hist = np.bincount(deg)
    covered = np.cumsum(np.arange(hist.size) * hist)  # edges of rows deg<=k
    best = multiple
    for k in range(multiple, max_deg + multiple, multiple):
        if covered[min(k, hist.size - 1)] >= (1.0 - waste_budget) * n_rows * k:
            best = k
    return best


def edge_degrees(
    src: np.ndarray, dst: np.ndarray, n_rows: int, n_cols: int
) -> np.ndarray:
    """Per-destination degree over the valid (non-sentinel) edges."""
    src, dst = np.asarray(src), np.asarray(dst)
    valid = (src < n_cols) & (dst < n_rows)
    return np.bincount(dst[valid], minlength=n_rows)[:n_rows]


def ell_graph_arrays(
    src: np.ndarray, dst: np.ndarray, n: int, deg_multiple: int = 8
) -> tuple[np.ndarray, int]:
    """Whole-graph ELL slab: ``k`` covers the heaviest row (rounded to
    ``deg_multiple``), so the residue is empty.  Returns (slab, k)."""
    k = _round_up(max(int(edge_degrees(src, dst, n, n).max(initial=1)), 1),
                  deg_multiple)
    nbr, res_s, _ = ell_from_edges(src, dst, n, n, k)
    if res_s.size:
        raise AssertionError("pure ELL must cover every row")
    return nbr, k


def hybrid_graph_arrays(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    waste_budget: float = 0.5,
    split_k: int | None = None,
    deg_multiple: int = 8,
    res_multiple: int = 1024,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Whole-graph hybrid COO/ELL split.

    Returns (slab, residue src, residue dst, k); the residue arrays are
    sentinel-padded ((n, n)) to a ``res_multiple`` capacity.
    """
    deg = edge_degrees(src, dst, n, n)
    k = split_k or select_split_k(deg, waste_budget, deg_multiple)
    nbr, res_s, res_d = ell_from_edges(src, dst, n, n, k)
    cap = _round_up(max(res_s.size, 1), res_multiple)
    pad = cap - res_s.size
    res_s = np.concatenate([res_s, np.full(pad, n, np.int32)])
    res_d = np.concatenate([res_d, np.full(pad, n, np.int32)])
    return nbr, res_s, res_d, k
