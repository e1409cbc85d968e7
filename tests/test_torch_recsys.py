"""The port's AutoInt recommender, its config and click-log pipeline
against the JAX package.

Weights come from the reference's ``init_params(cfg, PRNGKey(0))``,
carried across as numpy (``models.gnn.params_from_numpy``, which keeps the
int8 table's dtype); ids from the reference's click log
(``data.recsys.batch_at``, a fixed seed) or fixed numpy seeds.  Bars: the
config counts, the click log, the int8 rule and ``embedding_bag`` exact;
``forward``, ``loss_fn``, every gradient leaf, ``user_vector`` and
``retrieval_scores`` within ``TOL`` of each peak (float32 sums in another
order), at the smoke config and at the published dense widths with small
tables; five train steps within ``TRAIN_TOL`` (below).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jconfigs
from repro.data import recsys as jdata
from repro.models import recsys as jrecsys
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.configs import common as configs
from repro_torch.data import recsys as data
from repro_torch.models import recsys
from repro_torch.models.gnn import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
#: five AdamW steps (lr 3e-3): each update is lr * m / (sqrt(v) + eps), so
#: a gradient's float32 rounding moves a parameter by a few ulp of lr a step
TRAIN_TOL = 1e-5
#: the published dense widths (39 fields, d 16, 3 layers of 2 heads at 32,
#: MLP 256-128) over small tables, 64 rows a field
PUBLISHED_SMALL = dict(table_sizes=tuple([64] * 39))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(which, **kw):
    """(JAX config, port config) of ``which``: "smoke" or "published"."""
    jspec, spec = jconfigs.get("autoint"), configs.get("autoint")
    if which == "smoke":
        return (dataclasses.replace(jspec.smoke_config(), **kw),
                dataclasses.replace(spec.smoke_config(), **kw))
    kw = {**PUBLISHED_SMALL, **kw}
    return (dataclasses.replace(jspec.model_config(), **kw),
            dataclasses.replace(spec.model_config(), **kw))


_PARAMS: dict = {}


def _params(which, quant=False):
    """The reference's weights (PRNGKey 0) and the port's copy."""
    key = (which, quant)
    if key not in _PARAMS:
        jcfg, _ = _cfgs(which, table_quant=quant)
        jp = jax.jit(lambda k: jrecsys.init_params(jcfg, k))(jax.random.PRNGKey(0))
        _PARAMS[key] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[key]


def _batch(cfg, b, step=0):
    return data.batch_at(data.ClickLogConfig(table_sizes=cfg.resolved_tables(), batch=b), step)


def _gap(got, want):
    """Max abs gap over the peak of ``want``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the click log and the config
# ---------------------------------------------------------------------------


def test_click_log_byte_identical():
    src = [os.path.join(ROOT, "src", pkg, "data", "recsys.py") for pkg in ("repro", "repro_torch")]
    assert open(src[0], "rb").read() == open(src[1], "rb").read()
    for sizes, batch, seed, alpha in [((256,) * 8, 16, 0, 1.05),
                                      (recsys.AutoIntConfig().resolved_tables(), 64, 3, 1.05),
                                      ((10, 7, 1_000_000), 33, 1, 0.5)]:
        for step in (0, 1, 9):
            a = data.batch_at(data.ClickLogConfig(sizes, batch, seed, alpha), step)
            b = jdata.batch_at(jdata.ClickLogConfig(sizes, batch, seed, alpha), step)
            for k in ("ids", "labels"):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("make", ["model_config", "smoke_config"])
def test_config_counts_equal_reference(make):
    jspec, spec = jconfigs.get("autoint"), configs.get("autoint")
    assert (spec.family, spec.notes) == (jspec.family, jspec.notes)
    assert [dataclasses.asdict(s) for s in spec.shapes] == \
        [dataclasses.asdict(s) for s in jspec.shapes]
    jc, c = getattr(jspec, make)(), getattr(spec, make)()
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert c.resolved_tables() == jc.resolved_tables()
    assert (c.total_rows, c.d_interact, c.n_params()) == \
        (jc.total_rows, jc.d_interact, jc.n_params())
    offs, joffs = recsys.field_offsets(c, "cpu"), jrecsys.field_offsets(jc)
    assert str(offs.dtype).removeprefix("torch.") == jnp.dtype(joffs.dtype).name
    assert np.array_equal(offs.numpy(), np.asarray(joffs))
    if make == "model_config":
        assert (c.total_rows, c.n_params()) == (173_588_480, 2_778_125_825)
        assert c.total_rows * c.embed_dim * 4 == 11_109_662_720  # the fp32 table's bytes
    assert recsys._TABLE_SIZES == jrecsys._TABLE_SIZES


@pytest.mark.parametrize("quant", [False, True])
def test_init_params_tree_matches_reference(quant):
    """Keys, shapes and dtypes of the reference's tree; the MLP's biases are
    zeros and the int8 table holds codes in [-127, 127]."""
    for which in ("smoke", "published"):
        jc, c = _cfgs(which, table_quant=quant)
        jp = jax.eval_shape(lambda k, jc=jc: jrecsys.init_params(jc, k), jax.random.PRNGKey(0))
        p = recsys.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree.structure(jp) == jax.tree.structure(tree.tree_map(lambda t: 0, p))
        for a, b in zip(tree.leaves(p), jax.tree.leaves(jp)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).removeprefix("torch.") == jnp.dtype(b.dtype).name
        assert all(float(lyr["b"].abs().max()) == 0 for lyr in p["mlp"])
        if quant:
            assert int(p["table"].abs().max()) <= 127 and float(p["table_scale"].min()) > 0


def test_quantize_rows_is_the_reference_rule():
    """The same fp32 rows through the port's rule and the reference's
    formula (``init_params:115-117``): equal codes and scales."""
    raw = (np.random.default_rng(5).normal(size=(4096, 16)) * 0.01).astype(np.float32)
    raw[7] = 0.0  # an all-zero row takes the 1e-8 floor
    # row 9's scale is 2**-10 exactly, and two of its codes lie half-way
    raw[9] = 0.0
    raw[9, :3] = np.array([127.0, 2.5, -3.5], np.float32) * 2.0**-10
    jraw = jnp.asarray(raw)
    jscale = jnp.maximum(jnp.max(jnp.abs(jraw), axis=1), 1e-8) / 127.0
    jq = jnp.clip(jnp.round(jraw / jscale[:, None]), -127, 127).astype(jnp.int8)
    q, scale = recsys.quantize_rows(torch.from_numpy(raw.copy()))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    assert q[9, :3].tolist() == [127, 2, -4]  # half-way to even


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------


def _bag_ids(rng, b, f, k, sizes):
    ids = np.stack([rng.integers(0, s, (b, k)) for s in sizes], axis=1).astype(np.int32)
    if k > 1:  # pad some slots with -1, one bag wholly
        ids[rng.random(ids.shape) < 0.3] = -1
        ids[0, 0] = -1
    return ids


@pytest.mark.parametrize("k,mode,with_offsets", [
    (1, "sum", True), (1, "sum", False), (3, "sum", True), (3, "mean", True),
    (3, "sum", False), (3, "mean", False)])
def test_embedding_bag_matches_jax(k, mode, with_offsets):
    """Single-valued (B, F) ids and 3-slot bags padded with -1, exact."""
    rng = np.random.default_rng(11)
    sizes = (5, 17, 3, 40)
    table = rng.normal(size=(sum(sizes), 6)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    ids = _bag_ids(rng, 9, len(sizes), k, sizes if with_offsets else (sum(sizes),) * 4)
    if k == 1:
        ids = ids[..., 0]
    got = recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(offs) if with_offsets else None, mode)
    want = jrecsys.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(offs) if with_offsets else None, mode)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# forward, loss, gradients, retrieval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smoke", "published"])
def test_forward_loss_and_gradients_match_jax(which):
    jcfg, cfg = _cfgs(which)
    jp, p = _params(which)
    b = _batch(cfg, 48)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    logits = recsys.forward(cfg, p, tb["ids"])
    jlogits, (jloss, jgrads) = jax.jit(lambda q: (
        jrecsys.forward(jcfg, q, jb["ids"]),
        jax.value_and_grad(lambda r: jrecsys.loss_fn(jcfg, r, jb))(q)))(jp)
    assert logits.shape == (48,) and _gap(logits, jlogits) <= TOL

    loss, grads = tstep.value_and_grad(functools.partial(recsys.loss_fn, cfg), p, tb)
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(tree.leaves(grads))
    # w_user (the retrieval projection) is the one leaf the loss does not
    # read: zeros in both, as under jax.grad
    assert not grads["w_user"].any() and not np.asarray(jgrads["w_user"]).any()
    for k, (g, jg) in enumerate(zip(tree.leaves(grads), jflat)):
        if g is not grads["w_user"]:
            assert float(np.abs(np.asarray(jg)).max()) > 0, k
            assert _gap(g, jg) <= TOL, k
    # the table's gradient is a scatter: zero exactly on the rows no id hit
    rows = np.unique(b["ids"] + np.asarray(jrecsys.field_offsets(jcfg))[None])
    hit = np.zeros(cfg.total_rows, bool)
    hit[rows] = True
    assert not grads["table"].numpy()[~hit].any()
    assert not np.asarray(jgrads["table"])[~hit].any()


@pytest.mark.parametrize("which", ["smoke", "published"])
@pytest.mark.parametrize("quant", [False, True])
def test_user_vector_and_retrieval_match_jax(which, quant):
    jcfg, cfg = _cfgs(which, table_quant=quant)
    jp, p = _params(which, quant)
    ids = _batch(cfg, 5, step=2)["ids"]
    cand = np.random.default_rng(3).integers(0, cfg.resolved_tables()[-1], 300).astype(np.int32)
    uv = recsys.user_vector(cfg, p, torch.from_numpy(ids))
    juv = jax.jit(lambda q: jrecsys.user_vector(jcfg, q, jnp.asarray(ids)))(jp)
    assert uv.shape == (5, cfg.embed_dim) and _gap(uv, juv) <= TOL
    s = recsys.retrieval_scores(cfg, p, torch.from_numpy(ids[:1]), torch.from_numpy(cand))
    js = jax.jit(lambda q: jrecsys.retrieval_scores(jcfg, q, jnp.asarray(ids[:1]),
                                                    jnp.asarray(cand)))(jp)
    assert s.shape == (300,) and _gap(s, js) <= TOL
    if quant:
        logits = recsys.forward(cfg, p, torch.from_numpy(ids))
        jlogits = jax.jit(lambda q: jrecsys.forward(jcfg, q, jnp.asarray(ids)))(jp)
        assert _gap(logits, jlogits) <= TOL


def test_int8_table_carried_across():
    """``params_from_numpy`` keeps the int8 table (and the float32 scale);
    the dequantized lookup equals the reference's exactly."""
    jcfg, cfg = _cfgs("smoke", table_quant=True)
    jp, p = _params("smoke", True)
    assert p["table"].dtype == torch.int8 and p["table_scale"].dtype == torch.float32
    assert np.array_equal(p["table"].numpy(), np.asarray(jp["table"]))
    assert all(x.dtype == torch.float32 for x in tree.leaves(p) if x is not p["table"])
    ids = _batch(cfg, 16)["ids"]
    emb = recsys._lookup(cfg, p, torch.from_numpy(ids))
    jemb = jrecsys._lookup(jcfg, jp, jnp.asarray(ids))
    assert np.array_equal(emb.numpy(), np.asarray(jemb))


def test_train_steps_match_jax():
    """Five ``make_train_step`` steps (AdamW with WSD, the launcher's
    schedule for 5 steps) from the same weights on the same batches."""
    jcfg, cfg = _cfgs("smoke")
    jp, p = _params("smoke")
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=5)
    step = tstep.make_train_step(functools.partial(recsys.loss_fn, cfg),
                                 adamw.AdamWConfig(**opt))
    jstep_fn = jax.jit(jstep.make_train_step(functools.partial(jrecsys.loss_fn, jcfg),
                                             jadamw.AdamWConfig(**opt)))
    state, jstate = tstep.init_state(p), jstep.init_state(jp)
    for i in range(5):
        b = _batch(cfg, 32, i)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        jstate, jm = jstep_fn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            TOL * float(jm["grad_norm"])
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    flat, jflat = tree.leaves(state), jax.tree.leaves(jstate)
    assert len(flat) == len(jflat)
    for k, (a, b) in enumerate(zip(flat, jflat)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TRAIN_TOL * max(float(np.abs(np.asarray(b)).max()), 1.0),
                                   err_msg=str(k))


def test_bench_recsys_smoke_on_cpu():
    """The harness end to end at the smoke widths: every cell, the int8
    serve cells, the train cell's cut table; the counts it prints."""
    from repro_torch.bench import recsys as recsys_bench

    out = recsys_bench.main(["--device", "cpu", "--smoke", "--reps", "2"])
    assert [(r["cell"], r["table_quant"]) for r in out] == [
        ("serve_p99", False), ("serve_bulk", False), ("retrieval_cand", False),
        ("serve_p99", True), ("serve_bulk", True), ("train_batch", False)]
    cfg = configs.get("autoint").smoke_config()
    for r in out:
        assert len(r["ms"]) == 2 and r["median_ms"] > 0 and r["peak_bytes"] is None
        if r["kind"] == "retrieval":
            assert r["lookup_bytes"] == recsys_bench.SMOKE_CANDIDATES * cfg.embed_dim * 4
        else:
            assert r["lookup_bytes"] == r["batch"] * cfg.n_sparse * cfg.embed_dim * 4
    train = out[-1]
    cut = recsys_bench.config("train_batch", smoke=True)
    assert cut.resolved_tables()[:7] == (64,) * 7  # 256 / 4; the last padded to 4,096 rows
    assert train["table_rows"] == cut.total_rows and np.all(np.isfinite(train["losses"]))
    full = recsys_bench.config("train_batch")
    assert full.total_rows == 43_397_120 and full.n_sparse == 39 and not full.table_quant
