"""The distributed BFS on one process per rank (``ProcessGrid`` over gloo)
against the same run on ``SimGrid``, the pod-folded row axis against JAX,
tree betweenness against the numpy original, and the kernels'
cross-process build lock.

One module fixture per grid shape spawns the gloo workers once
(:func:`repro_torch.comm.procgrid.spawn`, CPU tensors) and runs every case
in them (:func:`repro_torch.bench.distributed.proc_cases`); the test
process runs the same cases on ``SimGrid(..., "cpu")``.  Each case must
give bit-identical parents (values), levels and level counts, and a merged
ledger equal to ``SimGrid``'s in every field of every record.  The graph is
scale 14: the smallest at which a 2x2 grid's chunk (s = 4,096) gives the
row ladder a sparse bucket, so that the adaptive exchange has a choice to
make (and, from root 661, its two grid rows choose differently).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import bfs as jbfs
from repro.core.centrality import tree_betweenness as np_tree_betweenness
from repro_torch import kernels
from repro_torch.bench import distributed as dist_bench, graph500
from repro_torch.comm import CommStats, SimGrid
from repro_torch.comm import procgrid
from repro_torch.core import centrality, csr
from repro_torch.core import distributed_bfs as dbfs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 14
ROOTS = [4902, 13688, 1820, 4307]
#: a degree-1 root: at its second level one grid row's candidates fit the
#: row ladder's 1,024-id bucket and the other's do not
DIVERGE_ROOTS = [661]
CASES_2X2 = (
    [dict(mode=m, policy=p) for m in ("raw", "bitmap", "auto", "btfly")
     for p in ("top_down", "bottom_up")]
    + [dict(mode=m, policy="direction_opt") for m in ("auto", "btfly")]
    + [dict(mode="auto", policy="top_down", algebra="sssp"),
       dict(mode="auto", policy="top_down", roots=DIVERGE_ROOTS),
       dict(mode="btfly", policy="top_down", roots=DIVERGE_ROOTS)]
)
CASES_1X4 = [dict(mode="btfly", policy=p) for p in ("top_down", "bottom_up")]
FOLD = {"pod": 2, "data": 2}
CASES_FOLD = [dict(mode="auto", policy="top_down")]


def _case_id(case: dict) -> str:
    return "-".join(str(v) if k != "roots" else f"root{v[0]}" for k, v in case.items())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: torch's intra-op threads would only contend with the
    workers and the other test processes.  Restored when the module ends."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def graph():
    return graph500.generate(SCALE, 16, 1)[0]


def _spawned(shape, cases, row_fold=None):
    spec = {"scale": SCALE, "roots": ROOTS, "cases": cases}
    return procgrid.spawn(dist_bench.proc_cases, *shape, device="cpu", row_fold=row_fold,
                          args=(spec,), timeout_s=600)


def _simulated(graph, shape, cases, row_fold=None):
    st = dist_bench.setup(graph, SimGrid(*shape, "cpu", row_fold=row_fold), "hybrid")
    out = []
    for case in cases:
        case = dict(case)
        out.append(dist_bench.run_case(st, case.pop("roots", ROOTS), **case))
    return out


@pytest.fixture(scope="module")
def runs_2x2(graph):
    return _spawned((2, 2), CASES_2X2), _simulated(graph, (2, 2), CASES_2X2)


@pytest.fixture(scope="module")
def runs_1x4(graph):
    return _spawned((1, 4), CASES_1X4), _simulated(graph, (1, 4), CASES_1X4)


def _assert_same(procs, sim, k):
    """Case ``k`` of every process equals the SimGrid run: rank 0's planes,
    every process's level count and merged ledger."""
    want = sim[k]
    got = procs[0]["cases"][k]
    np.testing.assert_array_equal(got["value"], want["value"])
    np.testing.assert_array_equal(got["level"], want["level"])
    for proc in procs:
        case = proc["cases"][k]
        assert case["n_levels"] == want["n_levels"]
        assert case["stats"].table() == want["stats"].table()
        assert case["staging_s"] == 0.0  # CPU tensors: nothing to stage


def _diverged(stats: CommStats, size: int) -> list[str]:
    """Phases with a call that only some of the grid's groups ran."""
    return sorted({r.phase for r in stats.records() if r.grid_bytes != r.nbytes * size})


@pytest.mark.parametrize("k", range(len(CASES_2X2)),
                         ids=[_case_id(c) for c in CASES_2X2])
def test_process_grid_equals_simgrid_2x2(runs_2x2, k):
    procs, sim = runs_2x2
    _assert_same(procs, sim, k)


@pytest.mark.parametrize("k", range(len(CASES_1X4)),
                         ids=[_case_id(c) for c in CASES_1X4])
def test_process_grid_equals_simgrid_1x4_btfly(runs_1x4, k):
    procs, sim = runs_1x4
    _assert_same(procs, sim, k)
    # C = 4: two butterfly stages
    phases = {r.phase.split("@")[0] for r in sim[k]["stats"].records()}
    assert {p for p in phases if "[btfly:" in p} >= {
        f"bfs/{z}[btfly:{t}]" for t in (0, 1)
        for z in (("row",) if CASES_1X4[k]["policy"] == "top_down" else ("row-pull",))}


def test_groups_chose_different_buckets(runs_2x2):
    """The merge holds where the exchange's groups diverge: SimGrid records
    one call per branch that some groups chose, and the processes' merged
    ledger equals it (the equality itself is in the case tests)."""
    procs, sim = runs_2x2
    for k, case in enumerate(CASES_2X2):
        if case.get("roots") == DIVERGE_ROOTS:
            div = _diverged(sim[k]["stats"], 4)
            assert div, f"case {_case_id(case)}: no exchange diverged"
            assert any(p.startswith("bfs/row") for p in div), div
            assert _diverged(procs[0]["cases"][k]["stats"], 4) == div
    # with several planes every group took the same bucket at every level
    assert not _diverged(sim[CASES_2X2.index(dict(mode="auto", policy="top_down"))]["stats"], 4)


def test_simgrid_ledger_merges_to_itself(runs_2x2):
    """A SimGrid's indexed calls merge into the ledger it recorded."""
    _, sim = runs_2x2
    for out in sim:
        stats = out["stats"]
        assert CommStats.merged([stats.calls()]).table() == stats.table()


def test_workers_report_their_rank_and_launches(runs_2x2):
    """Each worker returns its rank and its own launch counts (none here:
    CPU tensors take the plain versions, and only kernel launches count)."""
    procs, _ = runs_2x2
    assert [p["rank"] for p in procs] == [0, 1, 2, 3]
    assert all(p["launches"] == {} for p in procs)


def test_commstats_merge_rules():
    """Per (call index, key): one call, one rank's bytes, grid bytes summed;
    a process that records one call twice, or ranks that disagree, raise."""
    key = ("bfs/row", "bitmap", "all-to-all", "words")
    a = [((0, 1), key, 100, 50, 1)]
    b = [((0, 1), key, 100, 50, 1), ((1, 0), key, 100, 50, 1)]
    rec, = CommStats.merged([a, b]).records()
    assert (rec.count, rec.nbytes, rec.moved_bytes, rec.grid_bytes,
            rec.grid_moved_bytes) == (2, 200, 100, 300, 150)
    with pytest.raises(ValueError):
        CommStats.merged([a + a])
    with pytest.raises(ValueError):
        CommStats.merged([a, [((0, 1), key, 101, 50, 1)]])


def test_process_grid_pod_fold_equals_simgrid(graph):
    """4 processes on a 4x1 grid whose row axes fold ("pod", "data") =
    (2, 2): the same trees and merged ledger as the unfolded SimGrid."""
    procs = _spawned((4, 1), CASES_FOLD, row_fold=FOLD)
    sim = _simulated(graph, (4, 1), CASES_FOLD)
    _assert_same(procs, sim, 0)


_JAX_FOLD = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import csr as csrmod, distributed_bfs as dbfs
from repro.graphgen import builder, kronecker
scale, roots, policies, out = json.loads(sys.argv[1])
g = builder.build_csr(kronecker.kronecker_edges(scale, seed=1), n=1 << scale)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
bg = csrmod.partition_2d(g, rows=4, cols=2)
res = {}
for policy in policies:
    cfg = dbfs.DistBFSConfig(row_axes=("pod", "data"), col_axis="model", mode="auto",
                             policy=policy)
    fn = dbfs.build_bfs(mesh, bg, cfg)
    parent, level, depth = fn(*dbfs.shard_blocked(mesh, bg, cfg), jnp.asarray(roots, jnp.int32))
    res[policy + "/parent"] = np.asarray(parent)
    res[policy + "/level"] = np.asarray(level)
    res[policy + "/depth"] = np.asarray(depth)
np.savez(out, **res)
"""
FOLD_SCALE = 12
FOLD_ROOTS = [3, 17, 1000, 2345]
FOLD_POLICIES = ["top_down", "bottom_up"]


@pytest.fixture(scope="module")
def jax_fold(tmp_path_factory):
    """JAX build_bfs on a (pod, data, model) = (2, 2, 2) mesh, row axes
    ("pod", "data"), in an 8-device subprocess."""
    out = tmp_path_factory.mktemp("jax_fold") / "runs.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    arg = json.dumps([FOLD_SCALE, FOLD_ROOTS, FOLD_POLICIES, str(out)])
    proc = subprocess.run([sys.executable, "-c", _JAX_FOLD, arg], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("policy", FOLD_POLICIES)
def test_pod_fold_equals_jax_build_bfs(jax_fold, policy):
    """SimGrid with row_fold (pod, data) = (2, 2) on a 4x2 grid equals JAX's
    row_axes=("pod", "data") run bit for bit, and its ledger equals the
    unfolded 4x2 SimGrid's."""
    g = graph500.generate(FOLD_SCALE, 16, 1)[0]
    bg = csr.partition_2d(g, 4, 2)
    roots = np.asarray(FOLD_ROOTS, np.int32)
    runs = {}
    for fold in (FOLD, None):
        grid = SimGrid(4, 2, "cpu", row_fold=fold)
        cfg = dbfs.DistBFSConfig(mode="auto", policy=policy, expand="hybrid",
                                 row_axes=grid.row_axes)
        stats = CommStats()
        parent, level, depth = dbfs.build_bfs(grid, bg, cfg, stats=stats)(
            *dbfs.shard_blocked(grid, bg, cfg), roots)
        runs[fold is None] = (parent.numpy(), level.numpy(), depth, stats.table())
    parent, level, depth, table = runs[False]
    np.testing.assert_array_equal(parent, jax_fold[policy + "/parent"])
    np.testing.assert_array_equal(level, jax_fold[policy + "/level"])
    assert depth == int(jax_fold[policy + "/depth"])
    assert runs[True][3] == table
    np.testing.assert_array_equal(runs[True][0], parent)


def test_fold_axes_are_checked():
    grid = SimGrid(4, 2, "cpu", row_fold=FOLD)
    assert grid.row_axes == ("pod", "data")
    assert grid.groups(("pod", "data")) == SimGrid(4, 2, "cpu").groups("data")
    assert grid.axis_index(("pod", "data", "model")) == list(range(8))
    with pytest.raises(ValueError):
        grid.groups("data")  # part of the fold
    with pytest.raises(ValueError):
        SimGrid(4, 2, "cpu", row_fold={"pod": 3, "data": 2})
    bg = csr.partition_2d(graph500.generate(10, 16, 1)[0], 4, 2)
    with pytest.raises(ValueError):
        dbfs.build_bfs(grid, bg, dbfs.DistBFSConfig())  # row axes ("data",)


def test_process_grid_refuses_a_wrong_world(tmp_path):
    """A 2x2 grid over a world of one process raises; so does nccl with
    more ranks than cards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="world of 4"):
            procgrid.ProcessGrid(2, 2, device="cpu")
        grid = procgrid.ProcessGrid(1, 1, device="cpu")
        assert grid.local_ranks == [0] and grid.groups("model") == [[0]]
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="one card per rank"):
        procgrid.check_transport("nccl", 4, 1)
    procgrid.check_transport("nccl", 4, 4)
    procgrid.check_transport("gloo", 4, 1)


def _fail_on_rank_1(grid):
    if grid.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    grid.barrier()  # waits for rank 1, which never comes
    return grid.rank


def test_a_worker_failure_reaches_the_caller():
    with pytest.raises(RuntimeError) as err:
        procgrid.spawn(_fail_on_rank_1, 1, 2, device="cpu", timeout_s=60, grace_s=3)
    assert "rank 1 fails on purpose" in str(err.value)
    assert "--- rank 0" in str(err.value)


def _children() -> set[int]:
    """This process's live child processes, from /proc."""
    out = set()
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (FileNotFoundError, ProcessLookupError):  # ended meanwhile
            continue
        if int(fields[1]) == os.getpid():
            out.add(int(d))
    return out


def _rank_of(grid):
    return grid.rank


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="reads child processes from /proc")
def test_spawn_leaves_no_process_running():
    """Neither a run nor a failed run leaves a child behind: the workers are
    joined, and the resource tracker that the spawn method starts is stopped
    with them (it would otherwise live until the caller exits)."""
    before = _children()
    assert procgrid.spawn(_rank_of, 1, 2, device="cpu", timeout_s=60) == [0, 1]
    assert _children() == before
    with pytest.raises(RuntimeError):
        procgrid.spawn(_fail_on_rank_1, 1, 2, device="cpu", timeout_s=60, grace_s=3)
    assert _children() == before


def test_tree_betweenness_path_graph():
    """tests/test_algebra.py's path 0-1-2-3: interior vertices carry the
    dependency mass, the root endpoint none."""
    got = centrality.tree_betweenness(np.array([[0, 0, 1, 2]]), np.array([[0, 1, 2, 3]]), 4)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), [0.0, 2.0, 1.0, 0.0])
    np.testing.assert_array_equal(
        got.numpy(), np_tree_betweenness(np.array([[0, 0, 1, 2]]),
                                         np.array([[0, 1, 2, 3]]), 4))


def test_tree_betweenness_equals_numpy_on_jax_bfs_planes(graph):
    """Batched planes of the JAX single-device bfs(), and a single plane."""
    import jax.numpy as jnp

    res = jbfs.bfs(jnp.asarray(graph.src), jnp.asarray(graph.dst),
                   jnp.asarray(ROOTS, jnp.int32), graph.n, policy="top_down")
    parent, level = np.array(res.parent), np.array(res.level)
    np.testing.assert_array_equal(centrality.tree_betweenness(parent, level, graph.n).numpy(),
                                  np_tree_betweenness(parent, level, graph.n))
    np.testing.assert_array_equal(
        centrality.tree_betweenness(parent[1], level[1], graph.n).numpy(),
        np_tree_betweenness(parent[1], level[1], graph.n))


def test_tree_betweenness_equals_numpy_on_build_bfs_planes(jax_fold, runs_2x2, graph):
    """Padded (B, n') planes of JAX build_bfs (the folded 4x2 run) and of the
    port's process grid."""
    n = 1 << FOLD_SCALE
    parent, level = jax_fold["top_down/parent"], jax_fold["top_down/level"]
    assert parent.shape[1] > n  # the grid pads the vertex space
    np.testing.assert_array_equal(centrality.tree_betweenness(parent, level, n).numpy(),
                                  np_tree_betweenness(parent, level, n))
    procs, _ = runs_2x2
    case = procs[0]["cases"][CASES_2X2.index(dict(mode="auto", policy="direction_opt"))]
    got = centrality.tree_betweenness(torch.from_numpy(case["value"]),
                                      torch.from_numpy(case["level"]), graph.n)
    np.testing.assert_array_equal(got.numpy(),
                                  np_tree_betweenness(case["value"], case["level"], graph.n))
    assert got.sum() > 0


def test_build_waits_for_another_process_build(tmp_path, monkeypatch):
    """Callers that start together compile once: the others wait on the
    build directory's lock and reuse the library."""
    compiled = []

    def fake_compile(sources, out_dir, lib):
        compiled.append(out_dir)
        threading.Event().wait(0.3)  # a build that takes a while
        lib.write_bytes(b"")
        return "log"

    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "_compile", fake_compile)
    got = []
    threads = [threading.Thread(target=lambda: got.append(kernels.build())) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiled) == 1
    assert sorted(log for _, log in got) == ["", "", "", "log"]
    assert len({path for path, _ in got}) == 1
