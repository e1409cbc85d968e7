"""The port's host-side copies — Graph500 generator, Kernel-1 CSR builder,
ELL/hybrid containers, tree validator, TEPS helpers — against
``repro.graphgen``, ``repro.core.validate`` and ``benchmarks.teps``."""

import numpy as np
import pytest

from repro.core import validate as jvalidate
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro_torch.bench import teps
from repro_torch.core import validate
from repro_torch.graphgen import builder, kronecker


def _same_graph(a, b):
    assert a.n == b.n and a.m_input == b.m_input
    for field in ("row_ptr", "col_idx", "src", "dst"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


@pytest.mark.parametrize("scale,edgefactor,seed", [(6, 16, 1), (10, 16, 1), (11, 8, 5)])
def test_kronecker_and_build_csr_byte_identical(scale, edgefactor, seed):
    edges = kronecker.kronecker_edges(scale, edgefactor, seed=seed)
    jedges = jkronecker.kronecker_edges(scale, edgefactor, seed=seed)
    assert edges.dtype == jedges.dtype and edges.tobytes() == jedges.tobytes()
    _same_graph(builder.build_csr(edges, n=1 << scale),
                jbuilder.build_csr(jedges, n=1 << scale))


@pytest.mark.parametrize("kw", [{}, {"dedupe": False}, {"drop_self_loops": False},
                                {"symmetrize_edges": False}, {"n": None}])
def test_build_csr_options_byte_identical(kw):
    """Duplicates, self loops and the option matrix on a random multigraph:
    the key sort gives the reference's lexsort order exactly."""
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 300, size=(5000, 2))
    kw = {"n": 300, **kw}
    _same_graph(builder.build_csr(edges, **kw), jbuilder.build_csr(edges, **kw))


@pytest.mark.parametrize("scale", [9, 12])
def test_containers_byte_identical(scale):
    g = jbuilder.build_csr(jkronecker.kronecker_edges(scale, seed=3), n=1 << scale)
    deg = jbuilder.edge_degrees(g.src, g.dst, g.n, g.n)
    np.testing.assert_array_equal(builder.edge_degrees(g.src, g.dst, g.n, g.n), deg)
    for budget in (0.3, 0.5, 0.8):
        assert builder.select_split_k(deg, budget) == jbuilder.select_split_k(deg, budget)
    for ours, ref in (
        (builder.ell_graph_arrays(g.src, g.dst, g.n), jbuilder.ell_graph_arrays(g.src, g.dst, g.n)),
        (builder.hybrid_graph_arrays(g.src, g.dst, g.n),
         jbuilder.hybrid_graph_arrays(g.src, g.dst, g.n)),
        (builder.hybrid_graph_arrays(g.src, g.dst, g.n, split_k=16),
         jbuilder.hybrid_graph_arrays(g.src, g.dst, g.n, split_k=16)),
        (builder.ell_from_edges(g.src, g.dst, g.n, g.n, 8, width=24),
         jbuilder.ell_from_edges(g.src, g.dst, g.n, g.n, 8, width=24)),
    ):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            else:
                assert a == b


def _graph_and_tree(scale=9, seed=4):
    g = builder.build_csr(kronecker.kronecker_edges(scale, seed=seed), n=1 << scale)
    root = int(np.argmax(g.degrees()))
    level = validate.reference_bfs(g, root)
    # the min-id parent a level below, as bfs() picks it
    parent = np.full(g.n, -1, np.int64)
    ok = (level[g.src] >= 0) & (level[g.dst] == level[g.src] + 1)
    best = np.full(g.n, np.iinfo(np.int64).max)
    np.minimum.at(best, g.dst[ok], g.src[ok])
    parent = np.where(best < np.iinfo(np.int64).max, best, -1)
    parent[root] = root
    return g, root, parent, level


def _verdict(v):
    return (v.ok, v.failures, v.n_reached, v.n_tree_edges)


def _corruptions(g, root, parent, level):
    """(name, parent, level) trees that break each validation rule."""
    reached = np.nonzero((parent >= 0) & (np.arange(g.n) != root))[0]
    deep = reached[np.argmax(level[reached])]
    out = [("good", parent, level)]
    p = parent.copy()
    p[deep] = root if level[deep] > 1 else deep  # not a graph edge / wrong span
    out.append(("wrong_parent", p, level))
    p = parent.copy()
    a, b = deep, parent[deep]
    p[b] = a  # two-cycle a <-> b
    out.append(("cycle", p, level))
    lv = level.copy()
    lv[deep] += 1
    out.append(("level_off_by_one", parent, lv))
    p = parent.copy()
    p[deep] = -1  # a reached vertex dropped from the tree
    out.append(("dropped_vertex", p, level))
    p = parent.copy()
    p[root] = deep
    out.append(("bad_root", p, level))
    unreached = np.nonzero(parent < 0)[0]
    if unreached.size:
        p = parent.copy()
        p[unreached[0]] = root  # claims a vertex of another component
        out.append(("foreign_vertex", p, level))
    return out


@pytest.mark.parametrize("with_level", [True, False])
def test_validator_same_verdicts(with_level):
    g, root, parent, level = _graph_and_tree()
    jg = jbuilder.build_csr(jkronecker.kronecker_edges(9, seed=4), n=1 << 9)
    names = []
    for name, p, lv in _corruptions(g, root, parent, level):
        lv = lv if with_level else None
        ours = validate.validate_bfs_tree(g, p, root, lv)
        ref = jvalidate.validate_bfs_tree(jg, p, root, lv)
        assert _verdict(ours) == _verdict(ref), name
        # a reported level is only checked when levels are passed
        expect_ok = name == "good" or (name == "level_off_by_one" and not with_level)
        assert ours.ok == expect_ok, (name, ours.failures)
        names.append(name)
    assert len(names) >= 6


def test_validator_unsorted_rows_same_verdicts():
    """A CSR whose rows are not sorted still gets the reference's rule-5
    answer (the bisection's misses are rescanned)."""
    g, root, parent, level = _graph_and_tree(8, seed=6)
    col = g.col_idx.copy()
    for v in range(g.n):
        lo, hi = g.row_ptr[v], g.row_ptr[v + 1]
        col[lo:hi] = col[lo:hi][::-1]
    shuffled = builder.CSRGraph(n=g.n, row_ptr=g.row_ptr, col_idx=col, src=g.src,
                                dst=g.dst, m_input=g.m_input)
    jg = jbuilder.CSRGraph(n=g.n, row_ptr=g.row_ptr, col_idx=col, src=g.src,
                           dst=g.dst, m_input=g.m_input)
    for name, p, lv in _corruptions(g, root, parent, level):
        assert _verdict(validate.validate_bfs_tree(shuffled, p, root, lv)) == \
            _verdict(jvalidate.validate_bfs_tree(jg, p, root, lv)), name


@pytest.mark.parametrize("scale,seed", [(8, 1), (10, 2)])
def test_reference_bfs_levels_and_traversed_edges_match(scale, seed):
    g, hub, parent, _ = _graph_and_tree(scale, seed)
    jg = jbuilder.build_csr(jkronecker.kronecker_edges(scale, seed=seed), n=1 << scale)
    for root in (0, hub, g.n - 1):
        np.testing.assert_array_equal(validate.reference_bfs(g, root),
                                      jvalidate.reference_bfs(jg, root))
    np.testing.assert_array_equal(validate.compute_levels(parent, hub),
                                  jvalidate.compute_levels(parent, hub))
    assert validate.traversed_edges(g, parent) == jvalidate.traversed_edges(jg, parent)


def test_reference_bfs_path_graph():
    n = 300
    path = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    g = builder.build_csr(path, n=n)
    np.testing.assert_array_equal(validate.reference_bfs(g, 0), np.arange(n))


def test_teps_helpers():
    g = builder.build_csr(kronecker.kronecker_edges(10, seed=1), n=1 << 10)
    benchmarks_teps = pytest.importorskip("benchmarks.teps")
    np.testing.assert_array_equal(teps.valid_roots(g, 64, seed=2),
                                  benchmarks_teps.valid_roots(g, 64, seed=2))
    assert teps.harmonic_mean([1.0, 2.0, 4.0]) == pytest.approx(3 / 1.75)
    with pytest.raises(ValueError):
        teps.valid_roots(builder.build_csr(np.array([[0, 1]]), n=4), 3)
