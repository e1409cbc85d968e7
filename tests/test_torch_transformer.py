"""The port's decoder-only transformer, LM configs and token pipeline
against the JAX package.

Weights come from the reference's ``init_params(cfg, PRNGKey(0))``
(jitted), carried across as numpy (``models.gnn.params_from_numpy``); token inputs
from fixed numpy seeds.  Compute is fp32 unless said.  Bars: the building
blocks within ``BLOCK_TOL`` (float32 sums in another order); the five
archs' smoke configs (forward logits and MoE aux, ``loss_fn``'s value and
every gradient leaf, twelve ``decode_step`` logits and the final cache)
within ``TOL`` of each peak, under the default ``capacity_factor`` too, so
that decode's capacity drops must fall on the same choices; bf16 compute
for the three dense archs within ``BF16_TOL`` of the peak (measured here:
1.21e-2-1.37e-2 of the peak, against 1.94e-2 between the reference's own
bf16 and fp32 logits; MoE archs are left out, since bf16 flips their
routing).  The router's ties (router weights zeroed: every gate equal)
must pick the reference's experts.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jconfigs
from repro.data import tokens as jtokens
from repro.models import transformer as jtfm
from repro_torch import tree
from repro_torch.configs import common as configs
from repro_torch.data import tokens
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gemma-2b", "minicpm-2b", "deepseek-coder-33b", "deepseek-v2-236b", "dbrx-132b"]
DENSE = ARCHS[:3]
MOE = ARCHS[3:]
BLOCK_TOL = 1e-5
TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(arch, dtype="fp32", **kw):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get(arch).smoke_config(), compute_dtype=jd, **kw),
            dataclasses.replace(configs.get(arch).smoke_config(), compute_dtype=td, **kw))


_PARAMS: dict = {}


def _params(arch):
    """The reference's smoke weights (PRNGKey 0) and the port's copy."""
    if arch not in _PARAMS:
        jcfg = jconfigs.get(arch).smoke_config()
        jp = jax.jit(lambda k: jtfm.init_params(jcfg, k))(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[arch]


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _gap(got, want):
    """Max abs gap over the peak of ``want``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _dtype_name(dt):
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


# ---------------------------------------------------------------------------
# configs and the token pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    jspec, spec = jconfigs.get(arch), configs.get(arch)
    assert (spec.family, spec.notes) == (jspec.family, jspec.notes)
    assert [dataclasses.asdict(s) for s in spec.shapes] == \
        [dataclasses.asdict(s) for s in jspec.shapes]
    for make in ("model_config", "smoke_config"):
        jc, c = getattr(jspec, make)(), getattr(spec, make)()
        assert [f.name for f in dataclasses.fields(c)] == [f.name for f in dataclasses.fields(jc)]
        for f in dataclasses.fields(jc):
            a, b = getattr(c, f.name), getattr(jc, f.name)
            if f.name in ("param_dtype", "compute_dtype"):
                assert _dtype_name(a) == _dtype_name(b), (make, f.name)
            else:
                assert a == b, (make, f.name, a, b)
        for prop in ("is_moe", "padded_vocab", "qk_head_dim", "cache_width"):
            assert getattr(c, prop) == getattr(jc, prop), (make, prop)
        assert (c.n_params(), c.n_active_params()) == (jc.n_params(), jc.n_active_params())


def test_init_params_tree_matches_reference():
    """The port's init keeps the reference's tree: keys, shapes, dtypes."""
    for arch in ARCHS:
        jc, c = jconfigs.get(arch).smoke_config(), configs.get(arch).smoke_config()
        jp = jax.eval_shape(lambda k, jc=jc: jtfm.init_params(jc, k), jax.random.PRNGKey(0))
        p = tfm.init_params(c, torch.Generator().manual_seed(0), "cpu")
        assert sorted(p) == sorted(jp) and sorted(p["layers"]) == sorted(jp["layers"])
        for k, v in [(k, v) for k, v in p.items() if k != "layers"] + list(p["layers"].items()):
            want = jp["layers"][k] if k in jp["layers"] else jp[k]
            assert tuple(v.shape) == want.shape and v.dtype == torch.float32, (arch, k)
        assert torch.equal(p["final_norm"], torch.ones(c.d_model))


def test_token_pipeline_byte_identical():
    src = [os.path.join(ROOT, "src", pkg, "data", "tokens.py") for pkg in ("repro", "repro_torch")]
    assert open(src[0], "rb").read() == open(src[1], "rb").read()
    for vocab, batch, seq, seed in [(512, 4, 33, 0), (256000, 2, 300, 7), (122753, 3, 17, 1)]:
        jcfg = jtokens.TokenPipelineConfig(vocab=vocab, batch=batch, seq_len=seq, seed=seed)
        cfg = tokens.TokenPipelineConfig(vocab=vocab, batch=batch, seq_len=seq, seed=seed)
        for step in (0, 1, 5):
            a, b = tokens.batch_at(cfg, step)["tokens"], jtokens.batch_at(jcfg, step)["tokens"]
            assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg = tokens.TokenPipelineConfig(vocab=512, batch=2, seq_len=16)
    jcfg = jtokens.TokenPipelineConfig(vocab=512, batch=2, seq_len=16)
    mine, ref = tokens.DoubleBufferedLoader(cfg, start_step=3), \
        jtokens.DoubleBufferedLoader(jcfg, start_step=3)
    try:
        for _ in range(3):
            assert np.array_equal(next(mine)["tokens"], next(ref)["tokens"])
    finally:
        mine.close()
        ref.close()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 37, 4, 32)).astype(np.float32) * 3
    w = rng.normal(size=(32,)).astype(np.float32)
    pos = rng.integers(0, 32768, size=(2, 37)).astype(np.int32)
    assert _gap(tfm.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
                jtfm.rmsnorm(jnp.asarray(x), jnp.asarray(w))) <= BLOCK_TOL
    for theta in (10000.0, 500.0):
        got = tfm.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        assert _gap(got, jtfm.rope(jnp.asarray(x), jnp.asarray(pos), theta)) <= BLOCK_TOL
    # bf16 inputs: rope computes in fp32 and rounds once
    xb = torch.from_numpy(x).bfloat16()
    got = tfm.rope(xb, torch.from_numpy(pos[:, :]), 10000.0)
    want = jtfm.rope(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(pos), 10000.0)
    assert got.dtype == torch.bfloat16 and _gap(got, want) <= 1e-2


@pytest.mark.parametrize("s,t,h,kvh,hd,hd_v,qc,kc,causal", [
    (50, 50, 4, 2, 16, 16, 16, 32, True),  # S a multiple of neither chunk, GQA groups of 2
    (96, 96, 4, 2, 16, 16, 32, 16, True),  # the reference's dense check
    (37, 37, 8, 1, 8, 8, 8, 8, True),  # MQA
    (20, 45, 3, 3, 24, 16, 8, 16, False),  # T != S, hd_v != hd (MLA's shapes), no mask
])
@pytest.mark.parametrize("logit_bytes", [1, tfm.LOGIT_BYTES])
def test_blockwise_attention_matches_jax(monkeypatch, s, t, h, kvh, hd, hd_v, qc, kc, causal,
                                         logit_bytes):
    """One q chunk a group (``logit_bytes`` 1) and every chunk at once."""
    monkeypatch.setattr(tfm, "LOGIT_BYTES", logit_bytes)
    rng = np.random.default_rng(s + t)
    q = rng.normal(size=(2, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(2, t, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(2, t, kvh, hd_v)).astype(np.float32)
    got = tfm.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  causal=causal, q_chunk=qc, kv_chunk=kc)
    want = jtfm.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, q_chunk=qc, kv_chunk=kc)
    assert _gap(got, want) <= BLOCK_TOL


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _layer0(arch):
    jp, p = _params(arch)
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            {k: v[0] for k, v in p["layers"].items()})


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", [(2, 64), (2, 40), (3, 1)])
def test_moe_ffn_matches_jax(arch, shape):
    """(2, 40) pads the 80 tokens to two groups of 64: the padding tokens'
    router logits are all zero, a tie among every expert."""
    jcfg, cfg = _cfgs(arch)
    jlp, lp = _layer0(arch)
    x = np.random.default_rng(2).normal(size=shape + (cfg.d_model,)).astype(np.float32)
    y, aux = tfm._moe_ffn(cfg, lp, torch.from_numpy(x))
    jy, jaux = jtfm._moe_ffn(jcfg, jlp, jnp.asarray(x))
    assert _gap(y, jy) <= TOL and abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


@pytest.mark.parametrize("arch", MOE)
def test_moe_router_ties_pick_the_reference_experts(arch):
    """Router weights zeroed: every gate is 1/e, so the top-k is decided by
    the tie break alone (the lower index first, as ``jax.lax.top_k``)."""
    jcfg, cfg = _cfgs(arch)
    jlp, lp = _layer0(arch)
    jlp = dict(jlp, router=jnp.zeros_like(jlp["router"]))
    lp = dict(lp, router=torch.zeros_like(lp["router"]))
    x = np.random.default_rng(3).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    y, aux = tfm._moe_ffn(cfg, lp, torch.from_numpy(x))
    jy, jaux = jtfm._moe_ffn(jcfg, jlp, jnp.asarray(x))
    assert _gap(y, jy) <= TOL and abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))
    gates = np.full((5, cfg.n_experts), 1.0 / cfg.n_experts, np.float32)
    vals, idx = tfm.top_k(torch.from_numpy(gates), cfg.top_k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(gates), cfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_top_k_matches_lax_top_k_with_bf16_ties():
    """Gates rounded to bf16 tie often; the order of every tie is the
    reference's."""
    rng = np.random.default_rng(4)
    g = np.array(jnp.asarray(rng.random((64, 160)) * 0.02, jnp.bfloat16).astype(jnp.float32))
    assert len(np.unique(g)) < g.size // 10  # ties are common
    vals, idx = tfm.top_k(torch.from_numpy(g), 6)
    jvals, jidx = jax.lax.top_k(jnp.asarray(g), 6)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


# ---------------------------------------------------------------------------
# the five archs at smoke widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(arch)
    toks = _tokens(cfg, (2, 64))
    logits, aux = tfm.forward(cfg, p, torch.from_numpy(toks))
    jbatch = {"tokens": jnp.asarray(toks)}
    (jlogits, jaux), (jloss, jgrads), jlast = jax.jit(lambda q: (
        jtfm.forward(jcfg, q, jbatch["tokens"]),
        jax.value_and_grad(lambda r: jtfm.loss_fn(jcfg, r, jbatch))(q),
        jtfm.prefill(jcfg, q, jbatch["tokens"])))(jp)
    assert logits.shape == (2, 64, cfg.padded_vocab)
    assert _gap(logits, jlogits) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * max(abs(float(jaux)), 1.0)
    # the head runs on the last position only: its storage is (B, V_pad)
    last = tfm.prefill(cfg, p, torch.from_numpy(toks))
    assert last.untyped_storage().nbytes() == 2 * cfg.padded_vocab * last.element_size()
    assert _gap(last, jlast) <= TOL and _gap(last, logits[:, -1].numpy()) <= TOL

    flat, unflatten = tree.flatten(p)
    leaves = [x.clone().requires_grad_(True) for x in flat]
    loss = tfm.loss_fn(cfg, unflatten(leaves), {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    jflat = tree.leaves(jgrads)  # jax.tree's order: dict keys sorted
    assert len(jflat) == len(grads)
    for k, (g, jg) in enumerate(zip(grads, jflat)):
        assert _gap(g, jg) <= TOL, k


@pytest.mark.parametrize("arch,capacity", [(a, None) for a in ARCHS] + [(a, 8.0) for a in MOE])
def test_decode_steps_and_cache_match_jax(arch, capacity):
    """Twelve decode steps from ``init_cache`` (2 slots, 16 positions):
    each step's logits and the final cache.  At the default capacity the
    MoE archs drop routed choices during decode (cap 1 at 2 slots), as the
    reference does; at capacity 8 (and for the dense archs) decode equals
    the teacher-forced forward."""
    kw = {} if capacity is None else {"capacity_factor": capacity}
    jcfg, cfg = _cfgs(arch, **kw)
    jp, p = _params(arch)
    seq = _tokens(cfg, (2, 12), seed=5)
    cache = tfm.init_cache(cfg, 2, 16, device="cpu")
    jcache = jtfm.init_cache(jcfg, 2, 16)
    dec = jax.jit(lambda q, c, t, pos: jtfm.decode_step(jcfg, q, c, t, pos))
    for i in range(12):
        pos = np.full(2, i, np.int32)
        logits, cache = tfm.decode_step(cfg, p, cache, torch.from_numpy(seq[:, i]),
                                        torch.from_numpy(pos))
        jlogits, jcache = dec(jp, jcache, jnp.asarray(seq[:, i]), jnp.asarray(pos))
        assert _gap(logits, jlogits) <= TOL, i
    assert _gap(cache, jcache) <= TOL
    if capacity is not None or not cfg.is_moe:
        ref, _ = tfm.forward(cfg, p, torch.from_numpy(seq))
        assert _gap(logits, ref[:, -1]) <= TOL


def test_causality_matches_jax():
    """The reference's ``test_lm_causality``, in the port and against it."""
    jcfg, cfg = _cfgs("minicpm-2b")
    jp, p = _params("minicpm-2b")
    toks = _tokens(cfg, (2, 64), seed=1)
    toks2 = toks.copy()
    toks2[:, 50] = (toks2[:, 50] + 1) % cfg.vocab
    l1, _ = tfm.forward(cfg, p, torch.from_numpy(toks))
    l2, _ = tfm.forward(cfg, p, torch.from_numpy(toks2))
    assert torch.allclose(l1[:, :50], l2[:, :50], atol=1e-6)
    assert not torch.allclose(l1[:, 50:], l2[:, 50:], atol=1e-4)
    j2, _ = jtfm.forward(jcfg, jp, jnp.asarray(toks2))
    assert _gap(l2, j2) <= TOL


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_compute_matches_jax(arch):
    """bf16 compute (the configs' own): the weights cast once
    (``cast_params``) give the reference's per-use casts; forward logits and
    one decode step within ``BF16_TOL`` of the peak."""
    jcfg, cfg = _cfgs(arch, "bf16")
    jp, p = _params(arch)
    cp = tfm.cast_params(cfg, p)
    assert cp["layers"]["wq"].dtype == torch.bfloat16 and cp["layers"]["ln1"].dtype == torch.float32
    toks = _tokens(cfg, (2, 64))
    logits, _ = tfm.forward(cfg, cp, torch.from_numpy(toks))
    assert torch.equal(logits, tfm.forward(cfg, p, torch.from_numpy(toks))[0])
    jlogits, _ = jax.jit(lambda q, t: jtfm.forward(jcfg, q, t))(jp, jnp.asarray(toks))
    assert logits.dtype == torch.bfloat16 and _gap(logits, jlogits) <= BF16_TOL
    cache = tfm.init_cache(cfg, 2, 8, device="cpu")
    got, cache = tfm.decode_step(cfg, cp, cache, torch.from_numpy(toks[:, 0]),
                                 torch.zeros(2, dtype=torch.int32))
    want, jcache = jtfm.decode_step(jcfg, jp, jtfm.init_cache(jcfg, 2, 8),
                                    jnp.asarray(toks[:, 0]), jnp.zeros(2, jnp.int32))
    assert cache.dtype == torch.bfloat16 and _gap(got, want) <= BF16_TOL
    assert _gap(cache, jcache) <= BF16_TOL
