"""The port's single-device BFS against ``repro.core.bfs`` (the live JAX
reference for ``direction_opt``): 3 policies x 3 backends x B in {1, 4},
plus ``bfs_levels``, the ``max_levels`` guard, root validation, the
no-card behaviour of the entry points and the Graph500 harness."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bfs as jbfs
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro_torch.bench import graph500
from repro_torch.core import bfs, expand, validate
from repro_torch.graphgen import builder

SCALE = 10


@pytest.fixture(scope="module")
def graph():
    g = jbuilder.build_csr(jkronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)
    return g, builder.build_csr(jkronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("expand_name", ["coo", "ell", "hybrid"])
@pytest.mark.parametrize("policy", ["top_down", "bottom_up", "direction_opt"])
def test_bfs_matches_jax(graph, policy, expand_name, batch):
    jg, g = graph
    roots = np.array([0, 17, 300, 1000], np.int32)[:batch]
    root = roots if batch > 1 else int(roots[0])
    ref = jbfs.bfs(jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.asarray(root), jg.n,
                   policy=policy, expand=expand_name)
    res = bfs.bfs(g.src, g.dst, root, g.n, policy=policy, expand=expand_name,
                  device="cpu")
    np.testing.assert_array_equal(res.parent.numpy(), np.asarray(ref.parent))
    np.testing.assert_array_equal(res.level.numpy(), np.asarray(ref.level))
    assert res.n_levels == int(ref.n_levels)
    parents = res.parent.numpy().reshape(batch, -1)
    levels = res.level.numpy().reshape(batch, -1)
    for k, r in enumerate(roots):
        v = validate.validate_bfs_tree(g, parents[k], int(r), levels[k])
        assert v.ok, v.failures


def test_bfs_levels_matches_jax(graph):
    jg, g = graph
    roots = np.array([3, 99, 512], np.int32)
    for root, policy in ((roots, "direction_opt"), (5, "top_down")):
        ref, jsizes = jbfs.bfs_levels(jnp.asarray(jg.src), jnp.asarray(jg.dst),
                                      jnp.asarray(root), jg.n, max_levels=12,
                                      policy=policy, expand="hybrid")
        res, sizes = bfs.bfs_levels(g.src, g.dst, root, g.n, max_levels=12,
                                    policy=policy, expand="hybrid", device="cpu")
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
        np.testing.assert_array_equal(res.parent.numpy(), np.asarray(ref.parent))
        np.testing.assert_array_equal(res.level.numpy(), np.asarray(ref.level))
        assert res.n_levels == int(ref.n_levels)


@pytest.mark.parametrize("policy", ["top_down", "direction_opt"])
def test_max_levels_truncation_matches_jax(policy):
    n = 256
    path = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    g = builder.build_csr(path, n=n)
    ref = jbfs.bfs(jnp.asarray(g.src), jnp.asarray(g.dst), jnp.int32(0), n,
                   max_levels=10, policy=policy, expand="ell")
    res = bfs.bfs(g.src, g.dst, 0, n, max_levels=10, policy=policy, expand="ell",
                  device="cpu")
    assert res.n_levels == int(ref.n_levels) == 10
    np.testing.assert_array_equal(res.level.numpy(), np.asarray(ref.level))
    np.testing.assert_array_equal(res.parent.numpy(), np.asarray(ref.parent))
    assert (res.level.numpy()[11:] == -1).all()


@pytest.mark.parametrize("roots,err", [
    (np.array([[0, 1]]), ValueError),
    (np.array([0.5]), TypeError),
    (np.array([], np.int32), ValueError),
    (np.array([0, 2000]), ValueError),
    (np.array([-1]), ValueError),
    (np.array([3, 5, 3]), ValueError),
])
def test_validate_roots_errors_match_jax(roots, err):
    with pytest.raises(err):
        jbfs.validate_roots(roots, 1024)
    with pytest.raises(err):
        bfs.validate_roots(roots, 1024)


def test_validate_roots_and_hub_roots():
    assert bfs.validate_roots(np.int64(7), 10).shape == ()
    np.testing.assert_array_equal(bfs.validate_roots(torch.tensor([4, 2]), 10), [4, 2])
    deg = np.array([3, 9, 9, 1, 0, 9])
    np.testing.assert_array_equal(bfs.hub_roots(deg, 4), jbfs.hub_roots(deg, 4))


def test_entry_points_raise_without_a_card(graph, monkeypatch):
    """device=None means CUDA; with no card the port raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, g = graph
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bfs.bfs(g.src, g.dst, 0, g.n, policy="direction_opt", expand="hybrid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bfs.bfs_levels(g.src, g.dst, 0, g.n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        expand.block_from_arrays("coo", g.src, g.dst, (), g.n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph500.run(6, n_roots=8)


def test_graph500_harness_on_cpu():
    out = graph500.run(9, n_roots=16, batch=8, device="cpu")
    assert out["n_valid"] == 16 and out["device"] == "cpu"
    assert len(out["teps"]) == 16 and out["teps_harmonic_mean"] > 0
    assert out["slab_edges"] + out["residue_edges"] == out["m_stored"]
    assert out["split_k"] == 8
    with pytest.raises(ValueError):
        graph500.search(graph500.build(6, device="cpu"), np.arange(5), batch=4)
