"""Expansion backends and the density oracle: the port against
``repro.core.expand`` / ``repro.core.traversal`` on the same inputs, with
the JAX package's containers carried across by ``block_from_arrays``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import expand as jexpand
from repro.core import traversal as jtraversal
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro_torch.core import expand, traversal


def _graph(scale):
    return jbuilder.build_csr(jkronecker.kronecker_edges(scale, seed=1), n=1 << scale)


def _planes(rng, b, n, density):
    return rng.random((b, n)) < density


@pytest.mark.parametrize("scale", [10, 12])
@pytest.mark.parametrize("backend", ["coo", "ell", "hybrid", "auto"])
def test_backends_match_jax(scale, backend):
    g = _graph(scale)
    jb = jexpand.resolve(backend)
    extra = jb.graph_arrays(g.src, g.dst, g.n)
    jblock = jb.local_block(jnp.asarray(g.src), jnp.asarray(g.dst),
                            tuple(jnp.asarray(a) for a in extra), g.n, g.n)
    block = expand.block_from_arrays(backend, g.src, g.dst, extra, g.n, "cpu")
    ours = expand.resolve(backend)
    rng = np.random.default_rng(scale)
    for density in (0.002, 0.05, 0.5):
        f = _planes(rng, 3, g.n, density)
        un = _planes(rng, 3, g.n, 0.6)
        push = np.asarray(jb.push_planes(jblock, jnp.asarray(f)))
        pull = np.asarray(jb.pull_planes(jblock, jnp.asarray(f), jnp.asarray(un)))
        np.testing.assert_array_equal(
            ours.push_planes(block, torch.from_numpy(f)).numpy(), push)
        np.testing.assert_array_equal(
            ours.pull_planes(block, torch.from_numpy(f), torch.from_numpy(un)).numpy(), pull)


def test_resolve_and_block_errors():
    assert expand.resolve("auto") is expand.resolve("hybrid")
    with pytest.raises(ValueError):
        expand.resolve("csr")
    with pytest.raises(ValueError):
        expand.block_from_arrays("coo", np.zeros(2, np.int32), np.zeros(2, np.int32),
                                 (np.zeros((4, 8), np.int32),), 4, "cpu")


@pytest.mark.parametrize("scale", [9, 11])
def test_density_oracle_and_edge_signals_match_jax(scale):
    """Counts, degree vector, Beamer m_f/m_u and the per-plane direction
    flags; the graph keeps 2m < 2**24, so the float32 sums are exact."""
    g = _graph(scale)
    assert 2 * g.m < 2**24
    rng = np.random.default_rng(scale)
    b = 5
    new = _planes(rng, b, g.n, 0.1)
    parent = np.where(_planes(rng, b, g.n, 0.5), 1, -1).astype(np.int32)
    was_bu = rng.random(b) < 0.5
    prev = rng.integers(0, g.n // 4, size=b).astype(np.int32)

    joracle = jtraversal.DensityOracle(g.n)
    oracle = traversal.DensityOracle(g.n)
    jcounts = np.asarray(joracle.plane_counts(jnp.asarray(new)))
    counts = oracle.plane_counts(torch.from_numpy(new))
    np.testing.assert_array_equal(counts.numpy(), jcounts)

    jdeg = jtraversal.degree_vector(jnp.asarray(g.src), jnp.asarray(g.dst), g.n, g.n)
    deg = traversal.degree_vector(torch.from_numpy(g.src), torch.from_numpy(g.dst), g.n, g.n)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))

    jm_f, jm_u = jtraversal.edge_signals(jdeg, jnp.asarray(new), jnp.asarray(parent))
    m_f, m_u = traversal.edge_signals(deg, torch.from_numpy(new), torch.from_numpy(parent))
    np.testing.assert_array_equal(m_f.numpy(), np.asarray(jm_f))
    np.testing.assert_array_equal(m_u.numpy(), np.asarray(jm_u))

    growing = counts > torch.from_numpy(prev)
    for kw, jkw in (({}, {}),
                    ({"m_f": m_f, "m_u": m_u, "growing": growing},
                     {"m_f": jm_f, "m_u": jm_u, "growing": jnp.asarray(growing.numpy())}),
                    ({"m_f": m_f, "m_u": m_u}, {"m_f": jm_f, "m_u": jm_u})):
        ours = oracle.next_direction(counts, torch.from_numpy(was_bu), **kw)
        ref = joracle.next_direction(jnp.asarray(jcounts), jnp.asarray(was_bu), **jkw)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # counts around the alpha/beta thresholds themselves
    edge = torch.tensor([int(0.25 * g.n), int(0.25 * g.n) + 1, int(0.05 * g.n),
                         int(0.05 * g.n) - 1], dtype=torch.int32)
    for bu in (False, True):
        flags = torch.full((4,), bu)
        np.testing.assert_array_equal(
            oracle.next_direction(edge, flags).numpy(),
            np.asarray(joracle.next_direction(jnp.asarray(edge.numpy()),
                                              jnp.asarray(flags.numpy()))))


def test_policy_passes_are_gated_per_direction():
    """direction_opt runs only the passes some active plane needs, and
    planes riding the other direction come back INF."""
    g = _graph(9)
    block = expand.block_from_arrays("hybrid", g.src, g.dst,
                                     expand.resolve("hybrid").graph_arrays(g.src, g.dst, g.n),
                                     g.n, "cpu")
    backend = expand.resolve("hybrid")
    pol = traversal.resolve("direction_opt")
    rng = np.random.default_rng(0)
    frontier = torch.from_numpy(_planes(rng, 3, g.n, 0.05))
    value = torch.where(frontier, 0, -1).to(torch.int32)
    use_bu = torch.tensor([False, True, False])
    both = pol.propose_batch(backend, block, value, frontier, use_bu, (True, True))
    td_only = pol.propose_batch(backend, block, value, frontier, use_bu, (True, False))
    push = backend.push_planes(block, frontier)
    np.testing.assert_array_equal(td_only[[0, 2]].numpy(), push[[0, 2]].numpy())
    assert bool((td_only[1] == expand.INF).all())
    assert torch.equal(both[[0, 2]], td_only[[0, 2]])
    none = pol.propose_batch(backend, block, value, frontier, use_bu, (False, False))
    assert bool((none == expand.INF).all())
    with pytest.raises(ValueError):
        traversal.resolve("sideways")
