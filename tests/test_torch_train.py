"""The port's GNN training step against the JAX package.

Distributed: the 2D train step (``gnn_dist.build_2d_train_step``) on
``SimGrid(2, 2, "cpu")`` against the reference's under ``shard_map`` in a
4-device subprocess started when the module starts, on the scale-9
Kronecker set-up of ``tests/test_dist.py`` (``chunk_multiple=256``,
``d_in`` 12, positions and targets over 16 classes from its draws,
parameters from ``PRNGKey(0)``): the loss and every gradient leaf of
``graphcast``, ``gat-cora``, ``egnn`` and ``nequip`` in fp32 and of
``graphcast`` and ``egnn`` with int8 payloads (``nequip`` asked for int8
equals its fp32 step bit for bit); ``gat-cora`` with int8 payloads,
whose loss is NaN in the reference (ROADMAP Queue 3), NaN in the port at
the same places.  The same step on ``ProcessGrid`` — 4 gloo CPU processes
on 2x2, spawned once for the module through the harness's worker
(``bench.gnn_train.proc_train``) on the refinement-4 multimesh at the
smoke widths — equals ``SimGrid``'s bit for bit: losses of every step,
forward outputs and ``pmean``ed gradients.  Single device:
``make_train_step`` (5 AdamW steps of the GraphCast smoke config on the
refinement-2 multimesh) against JAX ``make_train_step``, and 4 steps each
of EGNN and NequIP at their published widths on ``data.graphs``'
``molecule`` batch (float targets: the MSE branch); data parallel:
``make_dp_train_step`` over a 4x1 grid against JAX ``make_dp_train_step``
on ``tests/test_dist.py``'s regression, int8 with error feedback and a
plain ``pmean``, and its loss under 1e-2 after 150 steps, as there.

Tolerances.  The fp32 2D losses at ``rtol = 1e-5``; each gradient leaf at
``rtol = 1e-5`` and ``atol = 1e-5`` of the step's gradient peak (the
largest magnitude over every leaf): the float32 sums run in another order,
and a leaf whose gradient nearly cancels — GAT's attention vectors, whose
shift along a destination's edges the softmax removes — carries the
rounding of the larger terms it cancels (the port and JAX are 8e-6 of that
leaf's own peak apart there, 2e-7 of the step's).  The int8 step at
``1e-3`` of the peak (loss ``rtol = 1e-3``): a float-order flip upstream of
a quantizer can move one code by one step (scale/127 of its group), which
the following layers carry.  GAT's max pass: ``scatter_reduce``'s ``amax``
and ``torch.amax`` split a tie's gradient evenly, as ``segment_max`` and
``jnp.max`` do, and ``clamp(min=-1e30)`` passes a gradient at equality
where ``jnp.maximum`` halves it, which no finite logit reaches.  Single
device: losses at ``rtol = 1e-5``, the parameters after 5 steps at
``atol = 1e-6``; data parallel: losses at ``rtol = 1e-5``, weights at
``atol = 1e-6``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import kernels, tree
from repro_torch.bench import gnn as gnn_bench, gnn_train
from repro_torch.comm import SimGrid, procgrid
from repro_torch.comm import grid as cgrid
from repro_torch.core import csr
from repro_torch.graphgen import builder, kronecker
from repro_torch.models import gnn, gnn_dist, icosahedron
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = 1e-5
INT8_REL = 1e-3
D_IN = 12
#: the 2D configurations of tests/test_dist.py
CONFIGS = {
    "graphcast": dict(n_layers=2, d_hidden=16, d_in=D_IN, d_out=16, edge_state=False),
    "gat-cora": dict(n_layers=2, d_hidden=8, n_heads=2, d_in=D_IN, d_out=16),
    "egnn": dict(n_layers=2, d_hidden=16, d_in=D_IN, d_out=16),
    "nequip": dict(n_layers=2, d_hidden=4, n_rbf=4, d_in=D_IN, d_out=16),
}
CLASSES = {"graphcast": gnn.GraphCastConfig, "gat-cora": gnn.GATConfig,
           "egnn": gnn.EGNNConfig, "nequip": gnn.NequIPConfig}
#: the molecule shape (configs/common.py GNN_SHAPES): 128 molecules of 30
#: atoms and 64 edges, 16 features
MOLECULE = dict(n_mols=128, nodes_per=30, edges_per=64, d_feat=16)
MOLECULE_STEPS = 4
DP_STEPS = 6
#: the process grid's cases (the harness's worker, refinement 4, smoke widths)
PROC_CASES = [{"arch": "graphcast", "quantize": True}, {"arch": "graphcast", "quantize": False},
              {"arch": "gat-cora", "quantize": False}, {"arch": "egnn", "quantize": False},
              {"arch": "nequip", "quantize": False}]
PROC_SPEC = {"refine": 4, "seed": 0, "smoke": True, "layers": None, "steps": 2,
             "cases": PROC_CASES, "capture": True}

_JAX_RUN = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import csr as csrmod
from repro.graphgen import builder, kronecker
from repro.models import gnn, gnn_dist
from repro.optim import adamw
from repro.train import step as tstep
configs, d_in, dp_steps, molecule, mol_steps, out = json.loads(sys.argv[1])
from repro.configs import common as jconfigs
from repro.data import graphs as dgraphs
CLASSES = {"graphcast": gnn.GraphCastConfig, "gat-cora": gnn.GATConfig,
           "egnn": gnn.EGNNConfig, "nequip": gnn.NequIPConfig}
mesh = jax.make_mesh((2, 2), ("data", "model"))
g = builder.build_csr(kronecker.kronecker_edges(9, seed=5), n=1 << 9)
bg = csrmod.partition_2d(g, rows=2, cols=2, chunk_multiple=256)
part = bg.part
r, c, s = part.rows, part.cols, part.chunk
rng = np.random.default_rng(0)
nf = rng.normal(size=(part.n, d_in)).astype(np.float32)
pos = rng.normal(size=(part.n, 3)).astype(np.float32)
targets = rng.integers(0, 16, part.n).astype(np.int32)
res = {}
for name, kw in configs.items():
    cfg = CLASSES[name](**kw)
    params = gnn.init(cfg, jax.random.PRNGKey(0))
    for q in (False, True):
        stepf, _ = gnn_dist.build_2d_train_step(mesh, cfg, part, bg.e_cap,
                                                gnn_dist.Dist2DConfig(quantize_payload=q))
        loss, grads = stepf(params, jnp.asarray(nf.reshape(r, c, s, d_in)),
                            jnp.asarray(pos.reshape(r, c, s, 3)), jnp.asarray(bg.src_local),
                            jnp.asarray(bg.dst_local), jnp.asarray(targets.reshape(r, c, s)))
        res[f"{name}/{int(q)}/loss"] = np.asarray(loss)
        for k, x in enumerate(jax.tree.leaves(grads)):
            res[f"{name}/{int(q)}/grad{k}"] = np.asarray(x)
# make_train_step on the molecule batch at the published widths (MSE)
mb = dgraphs.molecule_batch(**molecule, seed=0)
mgraph = gnn.Graph(nf=jnp.asarray(mb.nf), src=jnp.asarray(mb.src), dst=jnp.asarray(mb.dst),
                   pos=jnp.asarray(mb.pos))
for name in ("egnn", "nequip"):
    cfg = jconfigs.get(name).model_config()
    params = jax.jit(lambda k: gnn.init(cfg, k))(jax.random.PRNGKey(3))
    for k, x in enumerate(jax.tree.leaves(params)):
        res[f"mol/{name}/param{k}"] = np.asarray(x)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50)
    stepf = jax.jit(tstep.make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b), ocfg))
    state = tstep.init_state(params)
    for i in range(mol_steps):
        state, m = stepf(state, {"graph": mgraph, "targets": jnp.asarray(mb.targets)})
        res[f"mol/{name}/loss{i}"] = np.asarray(m["loss"])
        res[f"mol/{name}/grad_norm{i}"] = np.asarray(m["grad_norm"])
    for k, x in enumerate(jax.tree.leaves(state.params)):
        res[f"mol/{name}/final{k}"] = np.asarray(x)
# the data-parallel regression of tests/test_dist.py
dmesh = jax.make_mesh((4,), ("data",))

def loss_fn(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

for compress in (True, False):
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(16,)).astype(np.float32)
    state = tstep.init_state({"w": jnp.zeros(16)}, with_ef=compress)
    ocfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0, total_steps=10_000)
    stepf = tstep.make_dp_train_step(loss_fn, ocfg, dmesh, compress=compress)
    for i in range(dp_steps):
        x = rng.normal(size=(64, 16)).astype(np.float32)
        state, m = stepf(state, {"x": jnp.asarray(x), "y": jnp.asarray(x @ w_true)})
        res[f"dp{int(compress)}/loss{i}"] = np.asarray(m["loss"])
        res[f"dp{int(compress)}/grad_norm{i}"] = np.asarray(m["grad_norm"])
        res[f"dp{int(compress)}/w{i}"] = np.asarray(state.params["w"])
np.savez(out, **res)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_train(tmp_path_factory):
    """The reference's 2D train steps and data-parallel steps, computed in
    a 4-device subprocess started when the module starts and read on first
    use; the module runs torch on one thread meanwhile."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("jax_train") / "runs.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RUN,
                             json.dumps([CONFIGS, D_IN, DP_STEPS, MOLECULE, MOLECULE_STEPS,
                                         str(out)])],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cache = {}

    def get():
        if not cache:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + stderr[-3000:]
            cache.update(np.load(out))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def kron():
    """tests/test_dist.py's set-up: the scale-9 graph on 2x2, features,
    positions and targets."""
    g = builder.build_csr(kronecker.kronecker_edges(9, seed=5), n=1 << 9)
    bg = csr.partition_2d(g, 2, 2, chunk_multiple=256)
    rng = np.random.default_rng(0)
    nf = rng.normal(size=(bg.part.n, D_IN)).astype(np.float32)
    pos = rng.normal(size=(bg.part.n, 3)).astype(np.float32)
    targets = rng.integers(0, 16, bg.part.n).astype(np.int32)
    return bg, nf, targets, pos


def _cfgs(name):
    kw = CONFIGS[name]
    return getattr(jgnn, CLASSES[name].__name__)(**kw), CLASSES[name](**kw)


def _step_2d(kron, name, quantize, grid=None):
    bg, nf, targets, pos = kron
    jcfg, cfg = _cfgs(name)
    params = gnn.params_from_numpy(jax.tree.map(np.asarray, jgnn.init(jcfg,
                                                                      jax.random.PRNGKey(0))),
                                   "cpu")
    grid = grid or SimGrid(2, 2, "cpu")
    step = gnn_dist.build_2d_train_step(cfg, bg.part,
                                        gnn_dist.Dist2DConfig(quantize_payload=quantize))
    return step(grid, params, gnn_dist.shard_nodes(grid, nf, bg.part),
                gnn_dist.shard_edges(grid, bg.src_local),
                gnn_dist.shard_edges(grid, bg.dst_local),
                gnn_dist.shard_targets(grid, targets, bg.part),
                pos=gnn_dist.shard_nodes(grid, pos, bg.part))


STEP_CASES = [("graphcast", False), ("graphcast", True), ("gat-cora", False), ("egnn", False),
              ("egnn", True), ("nequip", False)]


@pytest.mark.parametrize("name,quantize", STEP_CASES,
                         ids=[f"{n}-{'int8' if q else 'fp32'}" for n, q in STEP_CASES])
def test_2d_train_step_matches_jax(jax_train, kron, name, quantize):
    ref = jax_train()
    loss, grads = _step_2d(kron, name, quantize)
    tag = f"{name}/{int(quantize)}"
    want = [ref[f"{tag}/grad{k}"] for k in range(len(tree.leaves(grads)))]
    tol = INT8_REL if quantize else FP32_TOL
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(ref[f"{tag}/loss"]), rtol=tol)
    peak = max(np.abs(w).max() for w in want)
    for got, w in zip(tree.leaves(grads), want):
        assert got.shape == w.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), w, rtol=tol, atol=tol * peak)
    if quantize:  # it was quantized: the loss moved off the fp32 one
        assert abs(float(loss) - float(ref[f"{name}/0/loss"])) > 1e-4


def test_2d_train_step_nequip_int8_is_its_fp32_step(jax_train, kron):
    """NequIP's payload is never quantized: asked for int8, the step's loss
    and gradients equal its fp32 step bit for bit, in the port as in the
    reference; the leaves the loss does not read (the last layer's gate
    and its l>0 mixes, the l=2 mix before it) have zero gradients in both."""
    ref = jax_train()
    loss8, grads8 = _step_2d(kron, "nequip", True)
    loss, grads = _step_2d(kron, "nequip", False)
    assert float(ref["nequip/1/loss"]) == float(ref["nequip/0/loss"])
    assert torch.equal(loss8, loss)
    zero = []
    for k, (a, b) in enumerate(zip(tree.leaves(grads8), tree.leaves(grads))):
        np.testing.assert_array_equal(ref[f"nequip/1/grad{k}"], ref[f"nequip/0/grad{k}"])
        assert torch.equal(a, b)
        if not np.abs(ref[f"nequip/0/grad{k}"]).any():
            zero.append(k)
            assert not a.any()
    assert zero, "no leaf the loss does not read"


def test_2d_train_step_gat_int8_is_nan_where_jax_is(jax_train, kron):
    """The reference's int8 GAT forward is non-finite (its max pass
    quantizes the -1e30 identity of empty rows with real maxima), so its
    loss is NaN; the port's is too, and its gradients are NaN at the same
    places."""
    ref = jax_train()
    loss, grads = _step_2d(kron, "gat-cora", True)
    assert np.isnan(float(ref["gat-cora/1/loss"])) and np.isnan(float(loss))
    for k, got in enumerate(tree.leaves(grads)):
        np.testing.assert_array_equal(got.isnan().numpy(), np.isnan(ref[f"gat-cora/1/grad{k}"]))


@pytest.mark.parametrize("name", ["graphcast", "gat-cora", "egnn", "nequip"])
def test_2d_train_step_matches_single_device(kron, name):
    """The 2D gradients are the gradients of the single-device loss over the
    padded graph (the padded vertices' NLL counts in both), in the port
    alone: no factor from the loss's ``pmean`` or its transpose."""
    bg, nf, targets, pos = kron
    part = bg.part
    loss, grads = _step_2d(kron, name, False)
    r, c = part.rows, part.cols
    src = np.where(bg.src_local < part.n_c,
                   bg.src_local + (np.arange(c) * part.n_c)[None, :, None], part.n).reshape(-1)
    dst = np.where(bg.dst_local < part.n_r,
                   bg.dst_local + (np.arange(r) * part.n_r)[:, None, None], part.n).reshape(-1)
    jcfg, cfg = _cfgs(name)
    params = gnn.params_from_numpy(jax.tree.map(np.asarray, jgnn.init(jcfg,
                                                                      jax.random.PRNGKey(0))),
                                   "cpu")
    batch = {"graph": gnn.Graph(nf=torch.from_numpy(nf), src=torch.from_numpy(src),
                                dst=torch.from_numpy(dst), pos=torch.from_numpy(pos)),
             "targets": torch.from_numpy(targets)}
    one, want = tstep.value_and_grad(lambda p, b: gnn.loss_fn(cfg, p, b), params, batch)
    np.testing.assert_allclose(float(loss), float(one), rtol=FP32_TOL)
    peak = max(float(w.abs().max()) for w in tree.leaves(want))
    for got, w in zip(tree.leaves(grads), tree.leaves(want)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=FP32_TOL, atol=FP32_TOL * peak)


def test_build_2d_train_step_refuses_unported_archs(kron):
    """An unknown config raises ``TypeError`` when the step is built; EGNN
    and NequIP's steps raise ``TypeError`` naming the arch without
    positions."""
    class UnknownConfig:
        name = "schnet"

    with pytest.raises(TypeError, match="schnet"):
        gnn_dist.build_2d_train_step(UnknownConfig(), kron[0].part)
    bg, nf, targets, _ = kron
    grid = SimGrid(2, 2, "cpu")
    for name in ("egnn", "nequip"):
        _, cfg = _cfgs(name)
        step = gnn_dist.build_2d_train_step(cfg, bg.part)
        with pytest.raises(TypeError, match=name):
            step(grid, gnn.init(cfg, torch.Generator().manual_seed(0), "cpu"),
                 gnn_dist.shard_nodes(grid, nf, bg.part), gnn_dist.shard_edges(grid, bg.src_local),
                 gnn_dist.shard_edges(grid, bg.dst_local),
                 gnn_dist.shard_targets(grid, targets, bg.part))


# ---------------------------------------------------------------------------
# the same step on ProcessGrid: 4 gloo CPU processes, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proc_runs():
    """The harness's worker on 4 spawned gloo processes (one rank each) and
    the same cases on ``SimGrid`` in this process."""
    procs = procgrid.spawn(gnn_train.proc_train, 2, 2, device="cpu", args=(PROC_SPEC,),
                           timeout_s=600)
    sim = []
    for case in PROC_CASES:
        st = gnn_bench.setup(case["arch"], PROC_SPEC["refine"], (2, 2), PROC_SPEC["seed"],
                             PROC_SPEC["smoke"], "cpu")
        sim.append(gnn_train.train(st, PROC_SPEC["steps"], case["quantize"],
                                   PROC_SPEC["seed"], capture=True))
    return procs, sim


@pytest.mark.parametrize("k", range(len(PROC_CASES)),
                         ids=[f"{c['arch']}-{'int8' if c['quantize'] else 'fp32'}"
                              for c in PROC_CASES])
def test_process_grid_train_step_equals_simgrid(proc_runs, k):
    procs, sim = proc_runs
    want = sim[k]
    assert want["n_pad"] == 4096  # four 1,024-vertex chunks, every block holds edges
    for proc in procs:
        got = proc[k]
        rank = got["rank"]
        assert [s["loss"] for s in got["steps"]] == [s["loss"] for s in want["steps"]]
        assert [s["grad_norm"] for s in got["steps"]] == [s["grad_norm"] for s in want["steps"]]
        assert got["captured"]["loss"] == want["captured"]["loss"]
        np.testing.assert_array_equal(got["captured"]["out"][rank],
                                      want["captured"]["out"][rank])
        assert got["staging_s"] == 0.0  # CPU tensors: nothing to stage
    grads = procs[0][k]["captured"]["grads"]
    assert len(grads) == len(want["captured"]["grads"])
    for a, b in zip(grads, want["captured"]["grads"]):
        np.testing.assert_array_equal(a, b)
    assert procs[1][k]["captured"]["grads"] is None  # rank 0 sends them
    # the loss falls over the two AdamW steps
    assert want["steps"][1]["loss"] < want["steps"][0]["loss"]


# ---------------------------------------------------------------------------
# the grid's differentiable collectives: each backward is the transpose
# ---------------------------------------------------------------------------


def _collective_cases():
    return [("all_gather", (2, 2), cgrid.ROW_AXIS), ("all_gather", (2, 2), cgrid.COL_AXIS),
            ("all_gather", (2, 2), cgrid.ALL_AXES), ("all_to_all", (2, 2), cgrid.COL_AXIS),
            ("all_to_all", (4, 1), cgrid.ROW_AXIS), ("ppermute", (2, 2), cgrid.ALL_AXES),
            ("ppermute", (4, 1), cgrid.ROW_AXIS), ("psum", (2, 2), cgrid.ALL_AXES),
            ("psum", (2, 2), cgrid.COL_AXIS)]


@pytest.mark.parametrize("op,shape,axis", _collective_cases(),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_differentiable_collective_transposes(op, shape, axis):
    """Each ``ad_*`` collective's gradient against autograd through
    ``SimGrid``'s own tensor ops (``cat``, ``chunk``, list assignment,
    ``add``), on a random linear functional of every rank's output; the
    ``ppermute`` perms leave a rank out (it gets zeros, its input no
    gradient) and keep an identity pair."""
    grid = SimGrid(*shape, "cpu")
    gen = torch.Generator().manual_seed(3)
    k = grid.group_size(axis)
    xs = [torch.randn(2 * k, 3, generator=gen, requires_grad=True) for _ in range(grid.size)]
    perm = [(0, 0)] + [(a, a + 1) for a in range(1, k - 1)]  # member 1 receives nothing
    run = {"all_gather": (cgrid.ad_all_gather, grid.all_gather),
           "all_to_all": (cgrid.ad_all_to_all, grid.all_to_all),
           "psum": (cgrid.ad_psum, grid.psum),
           "ppermute": (lambda g, v, a: cgrid.ad_ppermute(g, v, a, perm),
                        lambda v, a: grid.ppermute(v, a, perm))}[op]
    grads = []
    for fn in (lambda v: run[0](grid, v, axis), lambda v: run[1](v, axis)):
        out = fn(xs)
        ws = [torch.randn(o.shape, generator=torch.Generator().manual_seed(p))
              for p, o in enumerate(out)]
        total = sum((o * w).sum() for o, w in zip(out, ws))
        grads.append(torch.autograd.grad(total, xs, allow_unused=True))
    for a, b in zip(*grads):
        b = torch.zeros_like(a) if b is None else b
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    if op == "ppermute":
        assert not grads[0][grid.all_groups(axis)[0][k - 1]].any()  # it sent nothing


def test_differentiable_collectives_do_not_alias():
    """An identity ``ppermute`` pair and a one-member ``psum`` return a
    copy, not the input, forward and backward; without gradients the grid's
    own collective runs (no copy)."""
    grid = SimGrid(1, 2, "cpu")
    x = [torch.ones(2, requires_grad=True), torch.ones(2, requires_grad=True)]
    out = cgrid.ad_ppermute(grid, x, cgrid.COL_AXIS, [(0, 0), (1, 1)])
    assert all(o is not a and o.data_ptr() != a.data_ptr() for o, a in zip(out, x))
    summed = cgrid.ad_psum(grid, x, cgrid.ROW_AXIS)
    assert all(o.data_ptr() != a.data_ptr() for o, a in zip(summed, x))
    g = torch.autograd.grad(sum(o.sum() for o in out + summed), x)
    assert [t.tolist() for t in g] == [[2.0, 2.0]] * 2
    with torch.no_grad():
        assert cgrid.ad_ppermute(grid, x, cgrid.COL_AXIS, [(0, 0), (1, 1)])[0] is x[0]


@pytest.mark.parametrize("shape", [(50, 7), (50, 3, 4)], ids=["2d", "3d"])
def test_gather_equals_the_indexing_form(shape):
    """``gnn._gather``'s custom backward (one ``index_add_``) against
    autograd through the reference's form ``concat([h, 0])[min(idx, n)]``:
    values and gradients equal, sentinel rows (idx >= n) zero."""
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(*shape, generator=gen, requires_grad=True)
    idx = torch.randint(0, 53, (300,), generator=gen)
    g = torch.randn(300, *shape[1:], generator=gen)
    got = gnn._gather(h, idx, 50)
    want = torch.cat([h, torch.zeros_like(h[:1])])[torch.clamp(idx, max=50)]
    assert torch.equal(got, want) and not got[idx >= 50].any()
    assert torch.equal(torch.autograd.grad(got, h, g)[0], torch.autograd.grad(want, h, g)[0])


def test_cotangent_bytes_count_every_exchange():
    """The harness's backward bytes, worked out from the shapes, equal the
    contributions of every collective the loss-and-gradient call runs, less
    the forward's (``bench.gnn.payload_bytes``) and its loss ``psum``."""
    class Counting(SimGrid):
        def __init__(self, *args):
            super().__init__(*args)
            self.sent = []

        def _count(self, xs):
            self.sent.append(sum(x.numel() for x in xs if x is not None))

        def all_gather(self, xs, *a, **kw):
            self._count(xs)
            return super().all_gather(xs, *a, **kw)

        def all_to_all(self, xs, *a, **kw):
            self._count(xs)
            return super().all_to_all(xs, *a, **kw)

        def ppermute(self, xs, *a, **kw):
            self._count(xs)
            return super().ppermute(xs, *a, **kw)

        def psum(self, xs, *a, **kw):
            self._count(xs)
            return super().psum(xs, *a, **kw)

    for arch in ("graphcast", "gat-cora", "egnn", "nequip"):
        st = gnn_bench.setup(arch, 3, (2, 2), 0, True, "cpu")
        grid = Counting(2, 2, "cpu")
        part = st.bg.part
        targets = gnn_dist.shard_targets(
            grid, gnn_train.make_targets(part.n, st.cfg.d_out, 0), part)
        gnn_dist.value_and_grad_2d(grid, st.cfg, st.params, gnn_dist.shard_nodes(grid, st.nf, part),
                                   gnn_dist.shard_edges(grid, st.bg.src_local),
                                   gnn_dist.shard_edges(grid, st.bg.dst_local), targets, part,
                                   gnn_dist.Dist2DConfig(quantize_payload=True),
                                   pos=st.pos)
        fwd = gnn_bench.payload_bytes(st.cfg, st.params, part)
        bwd = gnn_train.cotangent_bytes(st.cfg, st.params, part)
        assert len(grid.sent) == fwd["calls"] + 1 + bwd["calls"]
        assert 4 * sum(grid.sent) == fwd["fp32"] + 4 * grid.size + bwd["fp32"]
        n_params = sum(x.numel() for x in tree.leaves(st.params))
        assert bwd["grad_pmean"] == 4 * grid.size * n_params


# ---------------------------------------------------------------------------
# single device and data parallel against JAX make_train_step /
# make_dp_train_step
# ---------------------------------------------------------------------------


def test_make_train_step_matches_jax():
    """5 AdamW steps (``examples/train_gnn.py``'s optimizer) of the GraphCast
    smoke config on the refinement-2 multimesh, regressing the fields'
    rolled base as the example does: losses, step and parameters."""
    # through the registry, which loads every config module: importing one
    # module alone would leave the registry partial for later tests
    from repro.configs import common as jconfigs
    from repro_torch.configs import graphcast

    jcfg, cfg = jconfigs.get("graphcast").smoke_config(), graphcast.smoke_config()
    verts, edges = icosahedron.multimesh(2)
    rng = np.random.default_rng(0)
    base = np.stack([verts @ rng.normal(size=3) for _ in range(cfg.d_in)], 1)
    nf = (base + 0.1 * rng.normal(size=(verts.shape[0], cfg.d_in))).astype(np.float32)
    targets = np.roll(base, 1, axis=1)[:, : cfg.d_out].astype(np.float32)
    src, dst = edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32)
    params = jgnn.init(jcfg, jax.random.PRNGKey(0))
    ocfg = dict(lr=1e-3, warmup_steps=5, total_steps=50)
    jbatch = {"graph": jgnn.Graph(nf=jnp.asarray(nf), src=jnp.asarray(src),
                                  dst=jnp.asarray(dst)), "targets": jnp.asarray(targets)}
    batch = {"graph": gnn.Graph(nf=torch.from_numpy(nf), src=torch.from_numpy(src),
                                dst=torch.from_numpy(dst)),
             "targets": torch.from_numpy(targets)}
    jfn = jax.jit(jstep.make_train_step(lambda p, b: jgnn.loss_fn(jcfg, p, b),
                                        jadamw.AdamWConfig(**ocfg)))
    fn = tstep.make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b), adamw.AdamWConfig(**ocfg))
    jstate = jstep.init_state(params)
    state = tstep.init_state(gnn.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    losses = []
    for _ in range(5):
        jstate, jm = jfn(jstate, jbatch)
        state, m = fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=FP32_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=FP32_TOL)
        assert int(m["step"]) == int(jm["step"])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for a, b in zip(tree.leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["egnn", "nequip"])
def test_make_train_step_on_molecule_batch_matches_jax(jax_train, name):
    """4 AdamW steps (lr 1e-3, no warmup) of ``name`` at its published
    widths on the ``molecule`` batch (``data.graphs.molecule_batch``, float
    targets: ``loss_fn``'s MSE branch) from the reference's parameters:
    losses and gradient norms at ``rtol = 1e-5``, the parameters after the
    steps within ``1e-5`` of their peak; the loss falls, every gradient is
    finite."""
    from repro_torch.configs import common as configs
    from repro_torch.data import graphs

    ref = jax_train()
    cfg = configs.get(name).model_config()
    mb = graphs.molecule_batch(**MOLECULE, seed=0)
    assert mb.targets.dtype == np.float32 and mb.targets.shape == (mb.nf.shape[0], 1)
    batch = {"graph": gnn.Graph(nf=torch.from_numpy(mb.nf), src=torch.from_numpy(mb.src),
                                dst=torch.from_numpy(mb.dst), pos=torch.from_numpy(mb.pos)),
             "targets": torch.from_numpy(mb.targets)}
    params = gnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    _, unflatten = tree.flatten(params)  # jax.tree's leaf order
    n_leaves = len(tree.leaves(params))
    params = unflatten([torch.from_numpy(ref[f"mol/{name}/param{k}"]) for k in range(n_leaves)])
    fn = tstep.make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b),
                               adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50))
    state = tstep.init_state(params)
    losses = []
    for i in range(MOLECULE_STEPS):
        state, m = fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref[f"mol/{name}/loss{i}"]),
                                   rtol=FP32_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref[f"mol/{name}/grad_norm{i}"]),
                                   rtol=FP32_TOL)
        assert np.isfinite(float(m["grad_norm"]))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for k, a in enumerate(tree.leaves(state.params)):
        want = ref[f"mol/{name}/final{k}"]
        np.testing.assert_allclose(a.numpy(), want, rtol=0,
                                   atol=FP32_TOL * max(1.0, np.abs(want).max()))


def _dp_run(compress: bool, steps: int):
    grid = SimGrid(4, 1, "cpu")

    def loss_fn(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(16,)).astype(np.float32)
    states = grid.local(lambda p: tstep.init_state({"w": torch.zeros(16)}, with_ef=compress))
    ocfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0, total_steps=10_000)
    stepf = tstep.make_dp_train_step(loss_fn, ocfg, grid, compress=compress)
    out = []
    for _ in range(steps):
        x = rng.normal(size=(64, 16)).astype(np.float32)
        xs, ys = torch.from_numpy(x).chunk(4), torch.from_numpy(x @ w_true).chunk(4)
        states, m = stepf(states, grid.local(lambda p: {"x": xs[p], "y": ys[p]}))
        out.append((m, states))
    return out


@pytest.mark.parametrize("compress", [True, False], ids=["int8-ef", "pmean"])
def test_make_dp_train_step_matches_jax(jax_train, compress):
    ref = jax_train()
    for i, (m, states) in enumerate(_dp_run(compress, DP_STEPS)):
        tag = f"dp{int(compress)}"
        np.testing.assert_allclose(float(m["loss"]), float(ref[f"{tag}/loss{i}"]),
                                   rtol=FP32_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref[f"{tag}/grad_norm{i}"]),
                                   rtol=FP32_TOL)
        for s in states:  # the replicas stay equal; the residuals are per rank
            np.testing.assert_allclose(s.params["w"].numpy(), ref[f"{tag}/w{i}"], rtol=0,
                                       atol=1e-6)
            assert (s.ef is not None) == compress
    if compress:
        resid = [s.ef.residual["w"] for s in states]
        assert not torch.equal(resid[0], resid[1])


def test_make_dp_train_step_int8_ef_converges():
    """tests/test_dist.py's bar: the loss under 1e-2 after 150 steps."""
    kernels.reset_launches()
    m, _ = _dp_run(True, 150)[-1]
    assert float(m["loss"]) < 1e-2, float(m["loss"])
    assert not kernels.LAUNCHES  # the CPU runs the plain quantize
