"""The port's optimizer and int8 gradient compression against the JAX package.

``optim.adamw``: ``wsd_schedule`` over warmup, plateau and decay, and
``apply`` (clip, bias corrections, weight decay) over a few steps, with
the clip active and not, against JAX at fixed seeds; float32 element
arithmetic in another order (and ``b ** step`` through another ``pow``),
held at ``rtol = 1e-6`` with ``atol = 1e-7`` (``2e-6`` / ``1e-6`` for
the parameters after 4 steps, where Adam's normalised update carries the
moments' few-ulp differences).  ``optim.grad_compress``: ``compress_decompress``
and ``ef_step`` (two steps, the residual carried): the values the wire sees
equal JAX's exactly (the same codes and float32 scales), the residuals
within 1e-6 of the group's scale.  ``comm.collectives.allreduce_int8`` and
``grad_compress.dp_allreduce_int8`` on ``SimGrid(..., "cpu")`` against the
reference's under ``shard_map`` in a 4-device subprocess started when the
module starts: over the 4 ranks of a 4x1 grid, the column pairs and the
whole of a 2x2 grid.  The reduced values are held within one quantization
step of JAX's (max|group| / 127 of the re-quantized 128-value group):
XLA fuses the dequantize into the local sum of the received chunks with
fused multiply-adds, the port multiplies, then adds, so a partial sum can
differ in its last bit, which moves its group's scale by an ulp or,
rarely, one code by one.  The ledgers are equal record for record (phase,
format, collective, part, bytes, moved bytes, calls).
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

from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro_torch import tree
from repro_torch.comm import CommStats, SimGrid
from repro_torch.comm import collectives as cc
from repro_torch.comm.grid import ALL_AXES, COL_AXIS, ROW_AXIS
from repro_torch.kernels.quant import ref as qref
from repro_torch.optim import adamw, grad_compress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (grid shape, axis) of the all-reduce cases; the JAX meshes have the
#: port's axis names
AR_CASES = {"4x1-data": ((4, 1), ROW_AXIS), "2x2-model": ((2, 2), COL_AXIS),
            "2x2-all": ((2, 2), ALL_AXES)}
AR_N = 4 * 128 * 3  # values per rank: 3 groups per chunk of the 4-rank group
DP_SHAPES = {"a": (3, 5), "b": (130,)}

_JAX_RUN = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.comm import CommStats
from repro.comm import collectives as cc
from repro.optim import grad_compress as gc
cases, n, dp_shapes, out = json.loads(sys.argv[1])
res, ledgers = {}, {}

def rank_values(size, seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(size, n)) * rng.uniform(0.1, 10, size=(size, 1))).astype(np.float32)

def table(stats):
    return [[r.phase, r.fmt, r.collective, r.part, r.nbytes, r.count, r.moved_bytes]
            for r in stats.records()]

for name, ((r, c), axis) in cases.items():
    mesh = jax.make_mesh((r, c), ("data", "model"))
    axis = axis if isinstance(axis, str) else tuple(axis)
    g = r * c if isinstance(axis, tuple) else (r if axis == "data" else c)
    x = rank_values(r * c, 1, n)
    stats = CommStats()

    def local(x, axis=axis, g=g, stats=stats):
        return cc.allreduce_int8(x.reshape(-1), axis, g, stats=stats)[None, None]

    fn = jax.jit(compat.shard_map(local, mesh=mesh, in_specs=P("data", "model", None),
                                  out_specs=P("data", "model", None), check_vma=False))
    res[name] = np.asarray(fn(jnp.asarray(x.reshape(r, c, n)))).reshape(r * c, n)
    ledgers[name] = table(stats)

mesh = jax.make_mesh((4,), ("data",))
rng = np.random.default_rng(2)
grads = {k: rng.normal(size=(4, *s)).astype(np.float32) for k, s in dp_shapes.items()}
resid = {k: (0.01 * rng.normal(size=(4, *s))).astype(np.float32) for k, s in dp_shapes.items()}
stats = CommStats()

def dp_local(grads, resid):
    grads = jax.tree.map(lambda a: a[0], grads)
    state = gc.EFState(residual=jax.tree.map(lambda a: a[0], resid))
    mean, new = gc.dp_allreduce_int8(grads, state, "data", 4, stats=stats)
    return jax.tree.map(lambda a: a[None], mean), jax.tree.map(lambda a: a[None], new.residual)

fn = jax.jit(compat.shard_map(dp_local, mesh=mesh, in_specs=(P("data"), P("data")),
                              out_specs=(P("data"), P("data")), check_vma=False))
mean, new = fn(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, resid))
for k in dp_shapes:
    res[f"dp/mean/{k}"] = np.asarray(mean[k])
    res[f"dp/resid/{k}"] = np.asarray(new[k])
ledgers["dp"] = table(stats)
np.savez(out + ".npz", **res)
json.dump(ledgers, open(out + ".json", "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_collectives(tmp_path_factory):
    """The reference's all-reduces under ``shard_map``, computed in a
    4-device subprocess started when the module starts and read on first
    use; the module runs torch on one thread meanwhile."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("jax_optim") / "runs"
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    cases = {k: [list(shape), list(axis) if isinstance(axis, tuple) else axis]
             for k, (shape, axis) in AR_CASES.items()}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RUN,
                             json.dumps([cases, AR_N, DP_SHAPES, str(out)])],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cache = {}

    def get():
        if not cache:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + stderr[-3000:]
            cache.update(np.load(f"{out}.npz"))
            cache["ledgers"] = json.load(open(f"{out}.json"))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    torch.set_num_threads(saved)


def _rank_values(size, seed, n):
    """The subprocess's per-rank inputs (the same draws)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(size, n)) * rng.uniform(0.1, 10, size=(size, 1))).astype(np.float32)


def _assert_within_one_step(got, want):
    """Every value within one quantization step of its 128-value group."""
    step = np.repeat(np.abs(want.reshape(-1, qref.GROUP)).max(1) / 127, qref.GROUP)
    assert np.all(np.abs(got.reshape(-1) - want.reshape(-1)) <= 1.001 * step)


def _table(stats: CommStats) -> list:
    return [[r.phase, r.fmt, r.collective, r.part, r.nbytes, r.count, r.moved_bytes]
            for r in stats.records()]


# ---------------------------------------------------------------------------
# AdamW and the WSD schedule
# ---------------------------------------------------------------------------

CFGS = {"default": adamw.AdamWConfig(),
        "short": adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50, grad_clip=0.5,
                                   weight_decay=0.01, min_lr_frac=0.2)}


@pytest.mark.parametrize("name", list(CFGS))
def test_wsd_schedule_matches_jax(name):
    cfg = CFGS[name]
    jcfg = jadamw.AdamWConfig(**cfg.__dict__)
    for step in (0, 1, 3, 5, 6, 44, 45, 46, 49, 50, 51, 99, 100, 101, 500, 899, 900, 901,
                 950, 999, 1000, 1200):
        got = adamw.wsd_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = np.asarray(jadamw.wsd_schedule(jcfg, jnp.int32(step)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


def _tree(rng, scale=1.0):
    return {"w": [(rng.normal(size=(6, 4)) * scale).astype(np.float32),
                  (rng.normal(size=(4,)) * scale).astype(np.float32)],
            "b": (rng.normal(size=(3, 2, 2)) * scale).astype(np.float32)}


def _torch_tree(t):
    return tree.tree_map(lambda a: torch.from_numpy(np.array(a)), t)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("name", list(CFGS))
def test_adamw_apply_matches_jax(name, grad_scale):
    """Four steps of ``apply`` on the same gradients: parameters, moments,
    step; the gradient's global norm against JAX's; the clip engages at
    the larger scale."""
    cfg = CFGS[name]
    jcfg = jadamw.AdamWConfig(**cfg.__dict__)
    rng = np.random.default_rng(7)
    params = _tree(rng)
    state, jstate = adamw.init(_torch_tree(params)), jadamw.init(params)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert all(float(m.abs().max()) == 0 for m in tree.leaves(state.m))
    p, jp = _torch_tree(params), params
    for _ in range(4):
        grads = _tree(rng, grad_scale)
        gn = adamw.global_norm(_torch_tree(grads))
        np.testing.assert_allclose(gn.numpy(), np.asarray(jadamw.global_norm(grads)),
                                   rtol=1e-6)
        assert (float(gn) > cfg.grad_clip) == (grad_scale > 1)
        p, state = adamw.apply(cfg, p, _torch_tree(grads), state)
        jp, jstate = jadamw.apply(jcfg, jp, grads, jstate)
    assert int(state.step) == int(jstate.step) == 4 and state.step.dtype == torch.int32
    for mine, ref, tol in ((p, jp, (2e-6, 1e-6)), (state.m, jstate.m, (1e-6, 1e-7)),
                           (state.v, jstate.v, (1e-6, 1e-7))):
        assert jax.tree.structure(ref) == jax.tree.structure(tree.tree_map(lambda t: 0, mine))
        for a, b in zip(tree.leaves(mine), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol[0], atol=tol[1])


def test_tree_order_is_jax_order():
    t = {"z": [1, {"b": 2, "a": 3}], "a": (4, 5), "m": 6}
    assert tree.leaves(t) == jax.tree.leaves(t)
    flat, unflatten = tree.flatten(t)
    assert unflatten([x * 10 for x in flat]) == jax.tree.map(lambda x: x * 10, t)


# ---------------------------------------------------------------------------
# error feedback, compress / decompress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128,), (3, 5), (1536, 2), (7, 130)])
def test_compress_decompress_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.normal(size=shape) * 3).astype(np.float32)
    got = grad_compress.compress_decompress(torch.from_numpy(g)).numpy()
    want = np.asarray(jgc.compress_decompress(jnp.asarray(g)))
    assert got.shape == shape
    np.testing.assert_array_equal(got, want)
    flat, n = grad_compress._pad_to(torch.from_numpy(g), qref.GROUP)
    assert n == g.size and flat.numel() % qref.GROUP == 0
    scale = np.repeat(qref.quantize(flat)[1].numpy(), qref.GROUP)[:n].reshape(shape)
    assert np.all(np.abs(got - g) <= scale / 2 + 2 * np.spacing(np.abs(g)) + np.spacing(scale))


def test_ef_step_matches_jax():
    """Two error-feedback steps, the residual carried: what is sent equals
    JAX's, the residual is (g + e) - sent within float32 rounding."""
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 5), "b": [(130,), (2, 64)]}
    grads = jax.tree.map(lambda s: (rng.normal(size=s) * 2).astype(np.float32), shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
    state, jstate = grad_compress.init(_torch_tree(grads)), jgc.init(grads)
    for _ in range(2):
        sent, state = grad_compress.ef_step(_torch_tree(grads), state)
        jsent, jstate = jgc.ef_step(grads, jstate)
        for a, b in zip(tree.leaves(sent), jax.tree.leaves(jsent)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree.leaves(state.residual), jax.tree.leaves(jstate.residual)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
            assert np.abs(np.asarray(b)).max() > 0


# ---------------------------------------------------------------------------
# the int8 all-reduce over a grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(AR_CASES))
def test_allreduce_int8_matches_jax(jax_collectives, case):
    (r, c), axis = AR_CASES[case]
    grid = SimGrid(r, c, "cpu")
    x = _rank_values(r * c, 1, AR_N)
    stats = CommStats()
    got = cc.allreduce_int8(grid, [torch.from_numpy(v) for v in x], axis, stats=stats)
    ref = jax_collectives()
    want = ref[case]
    for p in range(r * c):
        assert got[p].shape == (AR_N,) and got[p].dtype == torch.float32
        _assert_within_one_step(got[p].numpy(), want[p])
    assert _table(stats) == ref["ledgers"][case]
    # the exact sum of the group, within the quantizer's two roundings
    g = grid.group_size(axis)
    for group in grid.all_groups(axis):
        exact = x[group].sum(0)
        assert np.abs(got[group[0]].numpy() - exact).max() <= (
            g + 1) * np.abs(x[group]).max() / 127
    # int8 codes + f32 scales per 128 values: 3.879x fewer bytes than fp32
    wire = sum(rec.nbytes for rec in stats.records())
    assert wire == 2 * (AR_N + 4 * AR_N // 128)
    assert round(2 * 4 * AR_N / wire, 3) == 3.879


def test_allreduce_int8_refuses_a_ragged_length():
    grid = SimGrid(4, 1, "cpu")
    with pytest.raises(ValueError):
        cc.allreduce_int8(grid, [torch.zeros(128 * 3)] * 4, ROW_AXIS)


def test_dp_allreduce_int8_matches_jax(jax_collectives):
    """``dp_allreduce_int8`` over the 4 ranks of a 4x1 grid on a two-leaf
    tree with a nonzero residual: the means within one quantization step of
    JAX's, the residuals within float32 rounding, the ledger equal (one phase per leaf,
    ``grad/allreduce[k]`` in ``jax.tree`` leaf order)."""
    ref = jax_collectives()
    rng = np.random.default_rng(2)
    grads = {k: rng.normal(size=(4, *s)).astype(np.float32) for k, s in DP_SHAPES.items()}
    resid = {k: (0.01 * rng.normal(size=(4, *s))).astype(np.float32)
             for k, s in DP_SHAPES.items()}
    grid = SimGrid(4, 1, "cpu")
    stats = CommStats()
    mean, new = grad_compress.dp_allreduce_int8(
        grid, grid.local(lambda p: {k: torch.from_numpy(v[p]) for k, v in grads.items()}),
        grid.local(lambda p: grad_compress.EFState(
            residual={k: torch.from_numpy(v[p]) for k, v in resid.items()})),
        ROW_AXIS, stats=stats)
    for k, shape in DP_SHAPES.items():
        n = int(np.prod(shape))
        for p in range(4):
            assert mean[p][k].shape == shape
            # the leaf padded to 4 x 128 values, reduced, then divided by 4
            pad = -n % (4 * qref.GROUP)
            _assert_within_one_step(np.pad(mean[p][k].numpy().reshape(-1), (0, pad)),
                                    np.pad(ref[f"dp/mean/{k}"][p].reshape(-1), (0, pad)))
            np.testing.assert_allclose(new[p].residual[k].numpy(), ref[f"dp/resid/{k}"][p],
                                       rtol=0, atol=1e-6)
    assert _table(stats) == ref["ledgers"]["dp"]
    assert [r.phase for r in stats.records()][::4] == ["grad/allreduce[0]",
                                                       "grad/allreduce[1]"]
