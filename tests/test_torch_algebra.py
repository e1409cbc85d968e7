"""The port's frontier algebras (SSSP, CC, PageRank) against the JAX package.

Kernel level: the plain ``gspmm`` value gather against the Pallas kernel
``gspmm_min_planes_pallas`` in interpret mode (exact), and the PageRank sum
form against ``ops.gspmm_planes``.  Single device: ``bfs(algebra=)`` against
JAX ``bfs(algebra=)`` (SSSP and CC bit for bit, PageRank within float32
rounding) and the port's own host oracles.  Distributed: SSSP against JAX
``build_bfs`` from a 6-device subprocess (started when the module starts,
so it overlaps the single-device tests); CC, PageRank and
``direction_opt``, which have no live distributed JAX reference on the
installed jax, against JAX single-device ``bfs(algebra=)`` and the oracles.
The value records of the ledger are held against
``scripts/check_bench_comm.value_unit_bytes`` and SSSP's against JAX's
trace-time records.
"""

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algebra as jalgebra
from repro.core import bfs as jbfs
from repro.core import validate as jvalidate
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro.kernels.bitpack import ref as jbp_ref
from repro.kernels.spmv import ops as jsp_ops
from repro.kernels.spmv import spmv as jspmv
from repro_torch.comm import CommStats, SimGrid
from repro_torch.core import algebra, bfs, csr, validate
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.graphgen import builder, kronecker
from repro_torch.kernels.spmv import ops as sp_ops
from repro_torch.kernels.spmv import ref as sp_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = algebra.INF
SCALE = 9  # single device
DIST_SCALE = 12  # the grid: s = 1024 on 2x2, width_class(n) = 16 < 32
ROOTS = [0, 17, 300, 411]
DIST_ROOTS = [3, 17, 1000, 2345]
# PageRank float32 against float32 in another summation order: relative
# rounding of a few ulp per vertex, so max |d| stays far below 1e-5 * max
PAGERANK_MAX_ABS = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only contend
    with the JAX side and the other test processes.  Restored when the
    module ends."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# edge weights and the kernel's plain version
# ---------------------------------------------------------------------------


def test_edge_weight_torch_numpy_jax_exact():
    rng = np.random.default_rng(0)
    top = 2**31 - 1
    u = np.concatenate([rng.integers(0, top, 4000), [0, 1, top, top - 1, top]])
    v = np.concatenate([rng.integers(0, top, 4000), [top, 0, 0, top, top]])
    want = np.asarray(jalgebra.edge_weight(jnp.asarray(u.astype(np.int32)),
                                           jnp.asarray(v.astype(np.int32)), 29))
    got_np = algebra.edge_weight(u, v, 29)
    got_t = algebra.edge_weight(torch.from_numpy(u), torch.from_numpy(v), 29)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(algebra.edge_weight(v, u, 29), want)  # symmetric
    assert got_t.dtype == torch.int32 and want.min() >= 1 and want.max() <= 29


def _slab(rng, n_rows, k, n_real):
    nbr = rng.integers(0, n_real, size=(n_rows, k)).astype(np.int32)
    nbr[rng.random((n_rows, k)) < 0.3] = n_real  # sentinel slots
    return nbr


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("op", ["copy", "minplus"])
def test_gspmm_plain_equals_pallas_interpret(op, b):
    """The plain version against the Pallas kernel in interpret mode, exactly:
    on an aligned (1024, 8) slab directly, and through ``ops.gspmm_planes``
    (which pads ragged rows to 1024 and masks pull rows) on a ragged one,
    push and pull, with nonzero bases and values near INF."""
    rng = np.random.default_rng(7 * b + len(op))
    n_cols = 2048
    jalg = jalgebra.SsspAlgebra(max_weight=29) if op == "minplus" else jalgebra.CcAlgebra()
    alg = algebra.SsspAlgebra(max_weight=29) if op == "minplus" else algebra.CcAlgebra()
    x = rng.integers(0, 2**31 - 1, size=(b, n_cols)).astype(np.int32)
    x[:, ::5] = INF - rng.integers(0, 40, size=x[:, ::5].shape)
    f = np.asarray(jbp_ref.pack(jnp.asarray((rng.random(b * n_cols) < 0.3)
                                            .astype(np.uint32)), 1)).reshape(b, -1)
    bases = (512, 1024)

    nbr = _slab(rng, 1024, 8, 1900)
    want = jspmv.gspmm_min_planes_pallas(
        jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(x),
        jnp.asarray([bases], jnp.int32), n_cols, op=op, max_weight=29, interpret=True)
    got = sp_ref.gspmm_min_planes(torch.from_numpy(nbr), _i32(f), torch.from_numpy(x),
                                  n_cols, op, 29, *bases)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    nbr = _slab(rng, 1500, 13, 1900)
    u = np.asarray(jbp_ref.pack(jnp.asarray((rng.random(b * 2048) < 0.5)
                                            .astype(np.uint32)), 1)).reshape(b, -1)
    xs = x[:, :1900]  # n_x < n_cols: the tail reads as INF
    for uw in (None, u):
        want = jsp_ops.gspmm_planes(
            jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(xs), n_cols, jalg,
            row_base=bases[0], col_base=bases[1],
            u_words=None if uw is None else jnp.asarray(uw), interpret=True)
        got = sp_ops.gspmm_planes(torch.from_numpy(nbr), _i32(f), torch.from_numpy(xs),
                                  n_cols, alg, row_base=bases[0], col_base=bases[1],
                                  u_words=None if uw is None else _i32(uw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gspmm_sum_equals_jax_pagerank():
    """PageRank's sum form (plain on every device, as in the reference)
    against JAX ``ops.gspmm_planes`` within float32 rounding of K terms."""
    rng = np.random.default_rng(5)
    n_cols, k = 2048, 11
    nbr = _slab(rng, 700, k, 2000)
    vals = rng.random((2, n_cols)).astype(np.float32) / 1000
    x = vals.view(np.int32)
    f = np.asarray(jbp_ref.pack(jnp.asarray((rng.random(2 * n_cols) < 0.6)
                                            .astype(np.uint32)), 1)).reshape(2, -1)
    u = np.asarray(jbp_ref.pack(jnp.asarray((rng.random(2 * 1024) < 0.5)
                                            .astype(np.uint32)), 1)).reshape(2, -1)
    for uw in (None, u):
        want = np.asarray(jsp_ops.gspmm_planes(
            jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(x), n_cols,
            jalgebra.PageRankAlgebra(), u_words=None if uw is None else jnp.asarray(uw)))
        got = sp_ops.gspmm_planes(torch.from_numpy(nbr), _i32(f), torch.from_numpy(x),
                                  n_cols, algebra.PageRankAlgebra(),
                                  u_words=None if uw is None else _i32(uw))
        np.testing.assert_allclose(got.numpy().view(np.float32), want.view(np.float32),
                                   rtol=k * np.finfo(np.float32).eps, atol=0)


def test_algebra_registry_and_wrappers_refuse_other_devices():
    custom = algebra.SsspAlgebra(delta=7)
    assert algebra.resolve(custom) is custom and algebra.resolve("cc").name == "cc"
    assert algebra.resolve("pagerank").reduce == "sum" and algebra.resolve("bfs").payload_is_id
    with pytest.raises(ValueError):
        algebra.resolve("betweenness")
    meta = torch.zeros((1, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sp_ops.gspmm_planes(torch.zeros((4, 2), dtype=torch.int32), meta,
                            torch.zeros((1, 2048), dtype=torch.int32), 2048,
                            algebra.CcAlgebra())


# ---------------------------------------------------------------------------
# single device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph():
    edges = jkronecker.kronecker_edges(SCALE, seed=1)
    return jbuilder.build_csr(edges, n=1 << SCALE), builder.build_csr(edges, n=1 << SCALE)


def _run_both(graph, alg, policy, expand, root):
    jg, g = graph
    ref = jbfs.bfs(jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.asarray(root), jg.n,
                   policy=policy, expand=expand, algebra=alg, max_levels=256)
    res = bfs.bfs(g.src, g.dst, root, g.n, policy=policy, expand=expand, device="cpu",
                  algebra=alg, max_levels=256)
    return ref, res


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("policy", ["top_down", "bottom_up", "direction_opt"])
@pytest.mark.parametrize("expand", ["coo", "ell", "hybrid"])
@pytest.mark.parametrize("alg", ["sssp", "cc"])
def test_min_algebras_equal_jax_and_oracles(graph, alg, expand, policy, batch):
    """Values, levels and level counts bit for bit against JAX; values
    against the port's host oracles."""
    _, g = graph
    roots = np.asarray(ROOTS[:batch], np.int32)
    root = roots if batch > 1 else int(roots[0])
    ref, res = _run_both(graph, alg, policy, expand, root)
    np.testing.assert_array_equal(res.parent.numpy(), np.asarray(ref.parent))
    np.testing.assert_array_equal(res.level.numpy(), np.asarray(ref.level))
    assert res.n_levels == int(ref.n_levels) < 256
    values = res.parent.numpy().reshape(batch, -1)
    for k, r in enumerate(roots):
        want = validate.reference_sssp(g, int(r)) if alg == "sssp" else validate.reference_cc(g)
        np.testing.assert_array_equal(values[k], want)


@pytest.mark.parametrize("policy,expand", [("top_down", "coo"), ("top_down", "hybrid"),
                                           ("bottom_up", "ell"),
                                           ("direction_opt", "hybrid")])
def test_pagerank_equals_jax_and_oracle(graph, policy, expand):
    """Within float32 rounding of JAX (same level count), and within the
    JAX package's own bound of the float64 oracle
    (``tests/test_algebra.py::test_pagerank_residual_convergence``)."""
    _, g = graph
    ref, res = _run_both(graph, "pagerank", policy, expand, np.asarray(ROOTS[:2], np.int32))
    got = res.parent.numpy()
    assert res.parent.dtype == torch.float32
    assert res.n_levels == int(ref.n_levels) < 256
    assert np.abs(got - np.asarray(ref.parent)).max() < PAGERANK_MAX_ABS
    host = validate.reference_pagerank(g, n=g.n)
    assert np.abs(got - host).max() < 1e-3
    assert np.abs(got.sum(axis=1) - host.sum()).max() < 1e-2


def test_oracles_equal_jax_package():
    """The port's copies of ``reference_sssp`` / ``reference_cc`` /
    ``reference_pagerank`` give the JAX package's arrays."""
    rng = np.random.default_rng(4)
    for n, m in ((48, 140), (64, 90), (300, 900)):
        edges = rng.integers(0, n, size=(m, 2))
        jg, g = jbuilder.build_csr(edges, n=n), builder.build_csr(edges, n=n)
        for root in (0, n // 2):
            np.testing.assert_array_equal(validate.reference_sssp(g, root),
                                          jvalidate.reference_sssp(jg, root))
        np.testing.assert_array_equal(validate.reference_cc(g), jvalidate.reference_cc(jg))
        np.testing.assert_array_equal(validate.reference_pagerank(g, n=n + 5),
                                      jvalidate.reference_pagerank(jg, n=n + 5))


# ---------------------------------------------------------------------------
# distributed
# ---------------------------------------------------------------------------

# (name, grid, mode, policy, expand, batched, record the ledger)
DIST_CONFIGS = (
    [(f"{m}-{p}-{e}", (2, 2), m, p, e, True, m == "auto" and p == "top_down" and e == "hybrid")
     for m in ("raw", "bitmap", "auto") for p in ("top_down", "bottom_up")
     for e in ("coo", "hybrid")]
    + [("scalar-auto-top_down", (2, 2), "auto", "top_down", "hybrid", False, False),
       ("2x3-auto-top_down", (2, 3), "auto", "top_down", "hybrid", True, False)]
)

_JAX_RUN = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.comm import CommStats
from repro.core import csr as csrmod, distributed_bfs as dbfs
from repro.graphgen import builder, kronecker
scale, roots, configs, out = json.loads(sys.argv[1])
g = builder.build_csr(kronecker.kronecker_edges(scale, seed=1), n=1 << scale)
res, ledgers = {}, {}
for name, (r, c), mode, policy, expand, batched, record in configs:
    mesh = jax.make_mesh((r, c), ("data", "model"), devices=jax.devices()[: r * c])
    bg = csrmod.partition_2d(g, rows=r, cols=c)
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=expand, algebra="sssp")
    stats = CommStats() if record else None
    fn = dbfs.build_bfs(mesh, bg, cfg, stats=stats)
    root = jnp.asarray(roots, jnp.int32) if batched else jnp.int32(roots[0])
    value, level, depth = fn(*dbfs.shard_blocked(mesh, bg, cfg), root)
    res[name + "/value"] = np.asarray(value)
    res[name + "/level"] = np.asarray(level)
    res[name + "/depth"] = np.asarray(depth)
    if record:
        ledgers[name] = [[x.phase, x.fmt, x.collective, x.part, x.nbytes, x.moved_bytes]
                         for x in stats.records()]
np.savez(out, **res)
with open(out + ".json", "w") as fh:
    json.dump(ledgers, fh)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_dist_run(tmp_path_factory):
    """Start JAX ``build_bfs`` (sssp) in a 6-device subprocess when the module
    starts; the distributed tests wait for it."""
    out = str(tmp_path_factory.mktemp("jax_algebra") / "runs.npz")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=6",
           "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    arg = json.dumps([DIST_SCALE, DIST_ROOTS, DIST_CONFIGS, out])
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RUN, arg], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def result():
        if "runs" not in box:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + stderr[-3000:]
            with open(out + ".json") as fh:
                box["runs"] = dict(np.load(out)), json.load(fh)
        return box["runs"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def dist_graph():
    return builder.build_csr(kronecker.kronecker_edges(DIST_SCALE, seed=1),
                             n=1 << DIST_SCALE)


def _dist(g, shape, alg, mode, policy, expand, roots, stats=None):
    grid = SimGrid(*shape, "cpu")
    bg = csr.partition_2d(g, *shape)
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=expand, algebra=alg)
    fn = dbfs.build_bfs(grid, bg, cfg, stats=stats)
    return (*fn(*dbfs.shard_blocked(grid, bg, cfg), roots), bg.part)


@pytest.mark.parametrize("name,shape,mode,policy,expand,batched,record", DIST_CONFIGS,
                         ids=[c[0] for c in DIST_CONFIGS])
def test_sssp_equals_jax_build_bfs(jax_dist_run, dist_graph, name, shape, mode, policy,
                                   expand, batched, record):
    runs, _ = jax_dist_run()
    roots = np.asarray(DIST_ROOTS, np.int32) if batched else np.int32(DIST_ROOTS[0])
    value, level, depth, _ = _dist(dist_graph, shape, "sssp", mode, policy, expand, roots)
    np.testing.assert_array_equal(value.numpy(), runs[name + "/value"])
    np.testing.assert_array_equal(level.numpy(), runs[name + "/level"])
    assert depth == int(runs[name + "/depth"])


def _jax_single(g, alg, roots, n=None):
    return jbfs.bfs(jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(roots),
                    n or g.n, policy="top_down", expand="hybrid", algebra=alg,
                    max_levels=256)


@pytest.mark.parametrize("mode", ["raw", "bitmap", "auto"])
@pytest.mark.parametrize("alg,policy", [("sssp", "direction_opt"), ("cc", "bottom_up"),
                                        ("cc", "direction_opt")])
def test_no_live_reference_equals_jax_single_device(dist_graph, alg, policy, mode):
    """Distributed cc and direction_opt (no live distributed JAX reference)
    against JAX single-device ``bfs(algebra=)`` and the host oracles.  CC's
    labels are global ids of class 16 here, so its pull row takes
    ``bitmap+p16`` with global payloads under bitmap and auto."""
    g, n = dist_graph, dist_graph.n
    roots = np.asarray(DIST_ROOTS, np.int32)
    stats = CommStats()
    value, level, _, _ = _dist(g, (2, 2), alg, mode, policy, "hybrid", roots, stats)
    ref = _jax_single(g, alg, roots)
    np.testing.assert_array_equal(value[:, :n].numpy(), np.asarray(ref.parent))
    np.testing.assert_array_equal(level[:, :n].numpy(), np.asarray(ref.level))
    want = (validate.reference_sssp(g, DIST_ROOTS[2]) if alg == "sssp"
            else validate.reference_cc(g))
    np.testing.assert_array_equal(value[2, :n].numpy(), want)
    pull_fmts = {x.fmt for x in stats.records() if x.phase.startswith(f"{alg}/row-pull")}
    if alg == "cc" and mode != "raw":
        assert pull_fmts == {"bitmap+p16"}, pull_fmts
    elif pull_fmts:
        assert pull_fmts == {"dense-i32"}, pull_fmts


@pytest.mark.parametrize("shape", [(2, 2), (2, 3)])
def test_pagerank_grid_within_tolerance(dist_graph, shape):
    """PageRank under auto on the grid against JAX single-device over the
    grid's padded vertex count, within float32 rounding."""
    g = dist_graph
    roots = np.asarray(DIST_ROOTS[:1], np.int32)
    value, _, depth, part = _dist(g, shape, "pagerank", "auto", "top_down", "hybrid", roots)
    ref = _jax_single(g, "pagerank", roots, n=part.n)
    assert value.dtype == torch.float32 and depth == int(ref.n_levels)
    assert np.abs(value.numpy() - np.asarray(ref.parent)).max() < PAGERANK_MAX_ABS


def _zone(phase: str) -> str:
    return re.sub(r"@p\d+$", "", phase)


def test_value_ledger_equals_static_model_and_jax(jax_dist_run, dist_graph):
    """Every ``values`` and ``dense-i32`` record of the port's ledger is the
    static byte model's (``scripts/check_bench_comm.value_unit_bytes``) times
    its calls, for every algebra; and SSSP's records under auto + top_down
    equal JAX's trace-time records call for call: every port key is one of
    JAX's with the same per-call bytes, and every exchange that is not an
    adaptive branch ran."""
    from scripts.check_bench_comm import value_unit_bytes

    g = dist_graph
    roots = np.asarray(DIST_ROOTS, np.int32)
    for alg, mode, policy in (("sssp", "auto", "top_down"), ("sssp", "raw", "bottom_up"),
                              ("cc", "bitmap", "direction_opt"),
                              ("pagerank", "auto", "top_down")):
        stats = CommStats()
        _, _, _, part = _dist(g, (2, 2), alg, mode, policy, "hybrid", roots, stats)
        checked = 0
        for rec in stats.records():
            if rec.fmt in ("values", "dense-i32"):
                unit = value_unit_bytes(rec.fmt, rec.collective, part.chunk, part.rows,
                                        part.cols)
                assert rec.nbytes == unit * rec.count, (alg, rec)
                checked += 1
        assert checked >= 3, (alg, mode, policy)
        zones = {_zone(r.phase) for r in stats.records()}
        assert zones >= {f"{alg}/values", f"{alg}/transpose"}
        assert not any(z.startswith("bfs/") for z in zones)

    _, ledgers = jax_dist_run()
    jax_recs = {tuple(r[:4]): r[4:] for r in ledgers["auto-top_down-hybrid"]}
    stats = CommStats()
    _dist(g, (2, 2), "sssp", "auto", "top_down", "hybrid", roots, stats)
    port = {(r.phase, r.fmt, r.collective, r.part): r for r in stats.records()}
    for key, rec in port.items():
        assert key in jax_recs, key
        nbytes, moved = jax_recs[key]
        assert (rec.nbytes, rec.moved_bytes) == (nbytes * rec.count, moved * rec.count), key
    fixed = [k for k in jax_recs
             if _zone(k[0]) in ("sssp/transpose", "sssp/values", "sssp/termination")]
    assert fixed and all(k in port for k in fixed), sorted(set(fixed) - set(port))


def test_algebra_harness_and_its_checks_on_cpu():
    """The chip run's harness at a small scale on the CPU, one device and
    the grid; and its device checks refuse a wrong answer."""
    from repro_torch.bench import algebras, graph500

    for argv in ([], ["--grid", "2x2"]):
        out = algebras.main(["--scale", "9", "--device", "cpu", *argv])
        assert set(out["runs"]) == {"sssp", "cc", "pagerank"}
        assert all(not r["failures"] for r in out["runs"].values())
    setup = graph500.build(9, device="cpu")
    roots = np.asarray(ROOTS[:2], np.int32)
    sssp = algebras.run_single(setup, "sssp", roots)
    assert not algebras.check(setup, "sssp", roots, sssp)["failures"]
    for plane, delta in ((0, 1), (1, -1)):  # lose the tight edge / relax a child
        wrong = sssp["value"].clone()
        d = wrong[plane]
        d[int(torch.nonzero((d > 0) & (d < INF))[0])] += delta
        assert algebras.check(setup, "sssp", roots, {"value": wrong})["failures"]
    cc = algebras.run_single(setup, "cc", roots[:1])
    assert not algebras.check(setup, "cc", roots[:1], cc)["failures"]
    split = cc["value"].clone()
    v = int(torch.nonzero(split[0] < torch.arange(setup.g.n, dtype=torch.int32))[0])
    split[0, v] = v  # its own label: an edge now joins two labels
    assert algebras.check(setup, "cc", roots[:1], {"value": split})["failures"]
    pr = algebras.run_single(setup, "pagerank", roots[:1])
    assert not algebras.check(setup, "pagerank", roots[:1], pr)["failures"]
    assert algebras.check(setup, "pagerank", roots[:1],
                          {"value": pr["value"] * 1.01})["failures"]
