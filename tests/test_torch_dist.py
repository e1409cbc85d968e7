"""The port's distributed BFS on a simulated grid against the JAX package.

One module fixture runs the JAX ``build_bfs`` in a subprocess with forced
host devices (the main process keeps one device) and saves each
configuration's parents, levels and depth; the port runs the same graph
and roots on ``SimGrid(..., "cpu")`` and must equal them bit for bit.
Distributed ``direction_opt`` has no live JAX reference on the installed
jax (its ``lax.cond`` branches fail to trace), so it is held against the
JAX single-device ``bfs`` and ``validate.reference_bfs``.  The ledger is
held against the host byte replay ``benchmarks.bfs_comm.simulate_batch``,
under the direct (``auto``) and the butterfly (``btfly``) row plans.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs as jbfs
from repro.core import validate as jvalidate
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro_torch.comm import CommStats, SimGrid
from repro_torch.core import bfs, csr, distributed_bfs as dbfs
from repro_torch.graphgen import builder, kronecker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 14
ROOTS = [3, 17, 1000, 12345]
# (name, grid, mode, policy, expand, batched)
CONFIGS = (
    [(f"{m}-{p}", (2, 2), m, p, "hybrid", True)
     for m in ("raw", "bitmap", "auto") for p in ("top_down", "bottom_up")]
    + [("auto-top_down-coo", (2, 2), "auto", "top_down", "coo", True),
       ("scalar-auto-top_down", (2, 2), "auto", "top_down", "hybrid", False),
       ("scalar-auto-bottom_up", (2, 2), "auto", "bottom_up", "hybrid", False),
       ("2x3-auto-top_down", (2, 3), "auto", "top_down", "hybrid", True)]
    # the butterfly: two stages at C = 4, fold + one stage + unfold at C = 3
    + [(f"{r}x{c}-btfly-{p}", (r, c), "btfly", p, "hybrid", True)
       for r, c in ((2, 2), (2, 3), (1, 4)) for p in ("top_down", "bottom_up")]
    + [("scalar-btfly-top_down", (2, 2), "btfly", "top_down", "hybrid", False)]
)

_JAX_RUN = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import csr as csrmod, distributed_bfs as dbfs
from repro.graphgen import builder, kronecker
scale, roots, configs, out = json.loads(sys.argv[1])
g = builder.build_csr(kronecker.kronecker_edges(scale, seed=1), n=1 << scale)
res = {}
for name, (r, c), mode, policy, expand, batched in configs:
    mesh = jax.make_mesh((r, c), ("data", "model"), devices=jax.devices()[: r * c])
    bg = csrmod.partition_2d(g, rows=r, cols=c)
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=expand)
    fn = dbfs.build_bfs(mesh, bg, cfg)
    root = jnp.asarray(roots, jnp.int32) if batched else jnp.int32(roots[0])
    parent, level, depth = fn(*dbfs.shard_blocked(mesh, bg, cfg), root)
    res[name + "/parent"] = np.asarray(parent)
    res[name + "/level"] = np.asarray(level)
    res[name + "/depth"] = np.asarray(depth)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def graph():
    return builder.build_csr(kronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dist") / "runs.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=6",
           "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    arg = json.dumps([SCALE, ROOTS, CONFIGS, str(out)])
    proc = subprocess.run([sys.executable, "-c", _JAX_RUN, arg], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("name,shape,mode,policy,expand,batched", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_port_equals_jax_build_bfs(jax_results, graph, name, shape, mode, policy,
                                   expand, batched):
    r, c = shape
    grid = SimGrid(r, c, "cpu")
    bg = csr.partition_2d(graph, r, c)
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=expand)
    root = np.asarray(ROOTS, np.int32) if batched else np.int32(ROOTS[0])
    parent, level, depth = dbfs.build_bfs(grid, bg, cfg)(*dbfs.shard_blocked(grid, bg, cfg),
                                                        root)
    np.testing.assert_array_equal(parent.numpy(), jax_results[name + "/parent"])
    np.testing.assert_array_equal(level.numpy(), jax_results[name + "/level"])
    assert depth == int(jax_results[name + "/depth"])


@pytest.mark.parametrize("mode", ["raw", "bitmap", "auto", "btfly"])
def test_direction_opt_equals_jax_single_device(graph, mode):
    """Distributed direction_opt (no live JAX reference) equals the JAX
    single-device bfs and the host reference's levels, batched and scalar."""
    jg = jbuilder.build_csr(jkronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)
    grid = SimGrid(2, 2, "cpu")
    bg = csr.partition_2d(graph, 2, 2)
    cfg = dbfs.DistBFSConfig(mode=mode, policy="direction_opt", expand="hybrid")
    fn = dbfs.build_bfs(grid, bg, cfg)
    blocks = dbfs.shard_blocked(grid, bg, cfg)
    roots = np.asarray(ROOTS, np.int32)
    parent, level, _ = fn(*blocks, roots)
    ref = jbfs.bfs(jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.asarray(roots), jg.n,
                   policy="direction_opt", expand="hybrid")
    np.testing.assert_array_equal(parent[:, : graph.n].numpy(), np.asarray(ref.parent))
    np.testing.assert_array_equal(level[:, : graph.n].numpy(), np.asarray(ref.level))
    assert (parent[:, graph.n:] == -1).all() and (level[:, graph.n:] == -1).all()
    for k, r in enumerate(ROOTS):
        np.testing.assert_array_equal(level[k, : graph.n].numpy(),
                                      jvalidate.reference_bfs(jg, r))
    p1, l1, _ = fn(*blocks, np.int32(ROOTS[1]))
    assert torch.equal(p1, parent[1]) and torch.equal(l1, level[1])


@pytest.mark.parametrize(
    "policy,mode",
    [pytest.param(p, m, id=p if m == "auto" else f"{p}-{m}")
     for m in ("auto", "btfly") for p in ("top_down", "bottom_up", "direction_opt")])
def test_ledger_equals_host_replay(policy, mode):
    """Scale 15, 2x2, B=4 hub roots: the port's ledger against
    ``simulate_batch``'s plan (``alltoall`` for ``auto``, ``btfly``), and
    under ``btfly`` each stage zone's bytes per format against the
    replay's stage log.  The replay prices the L levels that discover
    vertices; the device loop runs one more, whose frontier finds nothing,
    so the port runs with ``max_levels = L`` (its results are complete by
    then).  ``repro_torch.bench.bfs_comm.device_terms`` and
    ``replay_terms`` put both in the replay's conventions: cluster totals,
    link bytes for the column and row zones, result bytes for the
    transpose, all-reduces doubled, one consensus per group and exchange;
    the replay also charges a consensus to each unreached stage whose
    ladder has no sparse bucket (s < 65,536 here), where the device, as
    JAX's, has a single branch and none, and ``replay_terms`` takes it off.
    """
    from benchmarks import bfs_comm as jbfs_comm
    from repro.comm import butterfly as jbutterfly
    from repro_torch.bench import bfs_comm

    scale, r, c, b = 15, 2, 2, 4
    g = builder.build_csr(kronecker.kronecker_edges(scale, seed=1), n=1 << scale)
    roots = bfs.hub_roots(g.degrees(), b)
    jg = jbuilder.build_csr(jkronecker.kronecker_edges(scale, seed=1), n=1 << scale)
    depth = max(int(jvalidate.reference_bfs(jg, int(x)).max()) for x in roots)
    rep = jbfs_comm.simulate_batch(scale, r, c, b, policy=policy, graph=jg)
    assert rep["roots"] == [int(x) for x in roots]

    grid = SimGrid(r, c, "cpu")
    bg = csr.partition_2d(g, r, c)
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand="hybrid", max_levels=depth)
    stats = CommStats()
    _, level, n_levels = dbfs.build_bfs(grid, bg, cfg, stats=stats)(
        *dbfs.shard_blocked(grid, bg, cfg), roots)
    assert n_levels == depth
    for k, x in enumerate(roots):
        np.testing.assert_array_equal(level[k, : g.n].numpy(),
                                      jvalidate.reference_bfs(jg, int(x)))

    assert not [x for x in stats.records()
                if bfs_comm.split_phase(x.phase)[0] == "bfs/column" and x.part == "bucket"]
    plan = "alltoall" if mode == "auto" else mode
    got = bfs_comm.device_terms(stats, r, c)
    want = bfs_comm.replay_terms(rep, plan, bg.part.chunk)
    # the one adjustment replay_terms makes: 8 bytes per unreached stage,
    # whose ladder has no sparse bucket at this chunk
    assert not jbutterfly.unreached_wire(bg.part.chunk)[0].specs
    n_unreached = sum(e.get("zone") == "unreached" for e in rep["btfly_stages"])
    assert rep["plans"][plan]["consensus_bytes"] - want["consensus_bytes"] == (
        8 * n_unreached if mode == "btfly" else 0)
    assert got == want and (mode == "auto") != bool(got["stages"])


def test_build_bfs_rejects_bad_input(graph):
    grid = SimGrid(2, 2, "cpu")
    bg = csr.partition_2d(graph, 2, 2)
    fn = dbfs.build_bfs(grid, bg)
    blocks = dbfs.shard_blocked(grid, bg)
    with pytest.raises(ValueError):
        fn(*blocks, np.asarray([1, 1], np.int32))  # duplicate roots
    with pytest.raises(ValueError):
        fn(*blocks, np.int32(graph.n))  # out of range
    with pytest.raises(TypeError):
        fn(blocks[0], np.int32(0))
    with pytest.raises(ValueError):
        grid.groups(("pod", "data"))  # a multi-axis row fold is not ported
    with pytest.raises(ValueError):
        dbfs.build_bfs(SimGrid(2, 3, "cpu"), bg)
    with pytest.raises(ValueError):
        dbfs.build_bfs(grid, bg, dbfs.DistBFSConfig(mode="nope"))  # an unknown plan


@pytest.mark.parametrize("shape", [(2, 2), (2, 3), (1, 4)])
def test_partition_and_block_containers_byte_identical(graph, shape):
    """``core/csr.py`` is a numpy copy of the reference's: the partition, its
    transpose permutation and every backend's per-block containers."""
    from repro.core import csr as jcsr
    from repro.core import expand as jexpand
    from repro_torch.core import expand

    jg = jbuilder.build_csr(jkronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)
    bg, jbg = csr.partition_2d(graph, *shape), jcsr.partition_2d(jg, *shape)
    assert dataclasses.astuple(bg.part) == dataclasses.astuple(jbg.part)
    assert bg.part.transpose_perm() == jbg.part.transpose_perm()
    assert csr.padded_geometry(graph.n, *shape) == jcsr.padded_geometry(jg.n, *shape)
    for field in ("src_local", "dst_local", "e_counts"):
        a, b = getattr(bg, field), getattr(jbg, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for name in ("coo", "ell", "hybrid"):
        ours, ref = expand.resolve(name).block_arrays(bg), jexpand.resolve(name).block_arrays(jbg)
        assert len(ours) == len(ref) == len(expand.resolve(name).extra_ndims)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
