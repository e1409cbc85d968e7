"""Graph500 BFS-tree validation — the benchmark's 5 rules (paper Alg. 1 l.5).

The port's copy of ``repro/core/validate.py`` (``validate_bfs_tree``,
``compute_levels``, ``reference_bfs``, ``traversed_edges`` and the frontier
algebras' oracles ``reference_sssp``, ``reference_cc``,
``reference_pagerank``): host-side numpy,
independent of the implementation under test.  The reference's per-vertex
Python loops (the rule-5 edge check, the child gather of
``compute_levels`` and the frontier loop of ``reference_bfs``) are
vectorized here, and the rule-4 reference BFS runs only where the other
rules leave it something to find; every verdict and every level is
unchanged.

  1. the BFS tree is a tree and does not contain cycles;
  2. each tree edge connects vertices whose BFS levels differ by exactly one;
  3. every edge in the input graph connects vertices whose levels differ by
     at most one, or both endpoints are unreached (same component check);
  4. the BFS tree spans exactly the connected component of the root;
  5. a node and its BFS parent are joined by an edge of the original graph.
"""

from __future__ import annotations

import dataclasses

import heapq

import numpy as np

from repro_torch.core.algebra import INF, edge_weight
from repro_torch.graphgen.builder import CSRGraph


@dataclasses.dataclass(frozen=True)
class ValidationResult:
    ok: bool
    failures: tuple[str, ...]
    n_reached: int
    n_tree_edges: int

    def __bool__(self) -> bool:
        return self.ok


def _gather_segments(values: np.ndarray, starts: np.ndarray,
                     ends: np.ndarray) -> np.ndarray:
    """Concatenation of ``values[starts[i]:ends[i]]`` over i, without a
    Python loop: one ``repeat`` of the segment offsets plus an arange."""
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return values[:0]
    offsets = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return values[offsets + np.arange(total)]


def compute_levels(parent: np.ndarray, root: int, max_iter: int | None = None) -> np.ndarray:
    """Levels by walking the parent links down from the root; -1 marks a
    vertex the walk never reaches (a cycle, or a detached parent chain)."""
    n = parent.shape[0]
    level = np.full(n, -1, dtype=np.int64)
    level[root] = 0
    reached = parent >= 0
    frontier = np.array([root])
    depth = 0
    max_iter = max_iter or n
    children = np.argsort(parent[reached], kind="stable")
    nodes = np.nonzero(reached)[0][children]
    parents_sorted = parent[nodes]
    while frontier.size and depth < max_iter:
        depth += 1
        lo = np.searchsorted(parents_sorted, frontier, side="left")
        hi = np.searchsorted(parents_sorted, frontier, side="right")
        nxt = _gather_segments(nodes, lo, hi)
        nxt = nxt[level[nxt] < 0]
        level[nxt] = depth
        frontier = nxt
    return level


def _edges_exist(g: CSRGraph, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Whether each (u[k], v[k]) is an edge of ``g``.

    A vectorized binary search for v[k] in row u[k] (sorted in every graph
    ``build_csr`` makes), over only the queries still searching; a query
    the search misses is checked again by a scan of its row, so an
    unsorted CSR gets the same answer as the reference's per-edge scan.
    """
    starts, ends = g.row_ptr[u], g.row_ptr[u + 1]
    lo, hi = starts.copy(), ends.copy()
    live = np.nonzero(lo < hi)[0]
    while live.size:
        mid = (lo[live] + hi[live]) // 2
        right = g.col_idx[mid] < v[live]
        lo[live[right]] = mid[right] + 1
        hi[live[~right]] = mid[~right]
        live = live[lo[live] < hi[live]]
    found = lo < ends
    found[found] = g.col_idx[lo[found]] == v[found]
    for k in np.nonzero(~found)[0]:
        found[k] = np.any(g.col_idx[starts[k] : ends[k]] == v[k])
    return found


def validate_bfs_tree(
    g: CSRGraph, parent: np.ndarray, root: int, level: np.ndarray | None = None
) -> ValidationResult:
    parent = np.asarray(parent, dtype=np.int64)[: g.n]
    n = g.n
    failures: list[str] = []

    reached = parent >= 0
    root_ok = bool(reached[root]) and parent[root] == root
    if not root_ok:
        failures.append("rule1: root parent must be root itself")

    lv = compute_levels(parent, root)
    # Rule 1: no cycles — every reached vertex must get a finite level.
    stuck = reached & (lv < 0)
    if stuck.any():
        failures.append(f"rule1: {int(stuck.sum())} reached vertices not connected to root (cycle)")

    if level is not None:
        level = np.asarray(level, dtype=np.int64)[:n]
        mism = reached & (lv >= 0) & (level != lv)
        if mism.any():
            failures.append(f"levels: {int(mism.sum())} reported levels disagree with tree depth")

    # Rule 2 & 5: tree edges exist in graph and span exactly one level.
    tree_v = np.nonzero(reached & (np.arange(n) != root))[0]
    tree_u = parent[tree_v]
    all_exist = True
    if tree_v.size:
        exists = _edges_exist(g, tree_u, tree_v)
        all_exist = bool(exists.all())
        if not all_exist:
            failures.append(f"rule5: {int((~exists).sum())} tree edges missing from graph")
        dl = lv[tree_v] - lv[tree_u]
        bad = (lv[tree_v] >= 0) & (lv[tree_u] >= 0) & (dl != 1)
        if bad.any():
            failures.append(f"rule2: {int(bad.sum())} tree edges do not span exactly one level")

    # Rule 3: every graph edge spans <= 1 level, both-or-neither reached.
    # One int32 code per vertex carries both facts: 0 unreached, else
    # level + 2 (a stuck vertex's level is -1), so |code_u - code_v| is the
    # level span of an edge whose ends are both reached.
    code = np.where(reached, lv + 2, 0).astype(np.int32)
    cu, cv = code[g.src], code[g.dst]
    ru, rv = cu > 0, cv > 0
    n_cross = int(np.count_nonzero(ru != rv))
    if n_cross:
        failures.append(f"rule4: {n_cross} edges cross the reached boundary")
    n_span = int(np.count_nonzero(ru & rv & (np.abs(cu - cv) > 1)))
    if n_span:
        failures.append(f"rule3: {n_span} graph edges span more than one level")

    # Rule 4: reached set == connected component of root.  When the root is
    # its own parent, no reached vertex is stuck, every tree edge is a graph
    # edge and no edge crosses the reached boundary, the reached set is
    # connected to the root through graph edges and closed under them: it is
    # the root's component, and the reference BFS would find no difference.
    if not (root_ok and not stuck.any() and all_exist and n_cross == 0):
        comp = reference_bfs(g, root) >= 0
        if (reached != comp).any():
            failures.append(
                f"rule4: reached set differs from root component by {int((reached != comp).sum())}"
            )

    return ValidationResult(
        ok=not failures,
        failures=tuple(failures),
        n_reached=int(reached.sum()),
        n_tree_edges=int(tree_v.size),
    )


def reference_bfs(g: CSRGraph, root: int) -> np.ndarray:
    """Plain host BFS returning levels (-1 unreached) — the oracle."""
    level = np.full(g.n, -1, dtype=np.int64)
    level[root] = 0
    frontier = np.array([root], dtype=np.int64)
    seen = np.zeros(g.n, dtype=bool)
    d = 0
    while frontier.size:
        d += 1
        nbrs = _gather_segments(g.col_idx, g.row_ptr[frontier], g.row_ptr[frontier + 1])
        nbrs = nbrs[level[nbrs] < 0]
        if nbrs.size * 8 < g.n:
            nbrs = np.unique(nbrs)
        else:  # sorted unique ids without sorting a dense level
            seen[nbrs] = True
            nbrs = np.nonzero(seen)[0]
            seen[nbrs] = False
        level[nbrs] = d
        frontier = nbrs
    return level


def reference_sssp(g: CSRGraph, root: int, max_weight: int = 31) -> np.ndarray:
    """Host Dijkstra over the hashed edge weights — the SSSP oracle.

    Weights come from :func:`repro_torch.core.algebra.edge_weight` on numpy
    arrays (uint32 wrap, the reference's weights exactly); unreached
    vertices hold ``INF``, the driver's encoding.  A heap loop: fine at
    test sizes, hours at Graph500 scales."""
    dist = np.full(g.n, np.iinfo(np.int64).max, dtype=np.int64)
    dist[root] = 0
    pq = [(0, int(root))]
    while pq:
        du, u = heapq.heappop(pq)
        if du > dist[u]:
            continue
        nbrs = g.col_idx[g.row_ptr[u] : g.row_ptr[u + 1]]
        if nbrs.size == 0:
            continue
        w = edge_weight(np.full(nbrs.size, u, np.int64), nbrs.astype(np.int64),
                        max_weight=max_weight).astype(np.int64)
        for v, nd in zip(nbrs, du + w):
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (int(nd), int(v)))
    return np.where(dist == np.iinfo(np.int64).max, np.int64(INF), dist)


def reference_cc(g: CSRGraph) -> np.ndarray:
    """Union-find min labels — the connected-components oracle: per vertex,
    the minimum vertex id of its component (min-label propagation's fixed
    point)."""
    parent = np.arange(g.n, dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(g.src, g.dst):
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    # union keeps the smaller root, so the roots are the component minima
    return np.array([find(i) for i in range(g.n)])


def reference_pagerank(g: CSRGraph, n: int | None = None, damping: float = 0.85,
                       tol: float = 1e-4, max_iter: int = 500) -> np.ndarray:
    """Host float64 power iteration — the PageRank oracle, with the
    ``pagerank`` algebra's conventions: uniform 1/n start over the
    (padded) vertex count ``n``, dangling mass not redistributed, stop on a
    global L1 step residual <= ``tol``.  Pass the distributed driver's
    padded ``part.n`` as ``n`` to compare elementwise."""
    n = g.n if n is None else n
    src = np.concatenate([g.src, g.dst]).astype(np.int64)
    dst = np.concatenate([g.dst, g.src]).astype(np.int64)
    deg = np.zeros(n, np.int64)
    np.add.at(deg, src, 1)
    v = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        contrib = np.where(deg > 0, v / np.maximum(deg, 1), 0.0)
        nxt = np.full(n, (1.0 - damping) / n)
        np.add.at(nxt, dst, damping * contrib[src])
        done = np.abs(nxt - v).sum() <= tol
        v = nxt
        if done:
            break
    return v


def traversed_edges(g: CSRGraph, parent: np.ndarray) -> int:
    """TEPS numerator: input edges with both endpoints in the traversed
    component (Graph500 counts undirected input edges once)."""
    reached = np.asarray(parent)[: g.n] >= 0
    both = reached[g.src] & reached[g.dst]
    return int(both.sum()) // 2
