"""The sharded serving runtime (``models.transformer_sharded``, the grid
engine ``serve.engine.GridEngine``) against the JAX package's
single-device ``prefill``, ``decode_step`` and ``Engine``.

Weights are the reference's smoke weights (``init_params(cfg,
PRNGKey(0))``) carried across by ``params_from_numpy`` and placed by
``shard_params``; compute is fp32 (bf16 in one test, against the port's
one-device bf16).  Bars: logits and the gathered cache within ``REL`` of
the reference's peak (the single-device port sits at ~1e-6 there; the grid
adds partial products and softmax pieces in another order); tokens equal;
a gloo ``ProcessGrid`` equal to ``SimGrid`` bit for bit; the dry-run's
collective bytes equal to the placement's closed form.
Decode runs 12 steps from ``init_cache`` with slot ``b`` at position ``i +
b`` over a 16-position cache, so the slots cross the ranks' range ends
(3, 7, 11) at different steps, and the MoE archs' capacity drops (a
routing group of the 4 slots, spanning the grid rows) fall as in the
reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jconfigs
from repro.models import transformer as jtfm
from repro.serve import engine as jeng
from repro_torch.bench import multicard
from repro_torch.bench import serve as serve_bench
from repro_torch.comm import SimGrid, procgrid
from repro_torch.configs import common as configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh
from repro_torch.models.gnn import params_from_numpy
from repro_torch.serve import engine as eng

ARCHS = ["gemma-2b", "minicpm-2b", "deepseek-coder-33b", "deepseek-v2-236b", "dbrx-132b"]
GRIDS = [(2, 2), (1, 4)]
REL = 1e-5
#: bf16 compute against the port's one-device bf16: the grid rounds its
#: partial products to bf16 before it sums them, so the gap is bf16's own
#: rounding noise, of the size of one device's bf16 gap to its fp32
BF16_REL = 3e-2
#: deepseek-v2-236b is left out of the bf16 test: in bf16 its router picks
#: other experts than in fp32 on one device alone (0.64 of the peak apart),
#: so its bf16 logits do not measure the grid
BF16_ARCHS = ["gemma-2b", "minicpm-2b", "deepseek-coder-33b", "dbrx-132b"]
BATCH, PROMPT, STEPS, MAX_SEQ = 4, 32, 12, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get(arch).smoke_config(), compute_dtype=jnp.float32, **kw),
            dataclasses.replace(configs.get(arch).smoke_config(), compute_dtype=torch.float32,
                                **kw))


_PARAMS: dict = {}
_REF: dict = {}


def _params(arch):
    """The reference's smoke weights (PRNGKey 0) and the port's copy."""
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        jp = jax.jit(lambda k: jtfm.init_params(jcfg, k))(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[arch]


def _inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    pos = (np.arange(STEPS)[:, None] + np.arange(BATCH)[None]).astype(np.int32)
    return toks, pos


def _reference(arch, **kw):
    """The JAX single-device prefill logits, each decode step's logits and
    the final cache."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REF:
        jcfg, cfg = _cfgs(arch, **kw)
        jp, _ = _params(arch)
        toks, pos = _inputs(cfg)
        pre = np.asarray(jax.jit(lambda q, t: jtfm.prefill(jcfg, q, t))(jp, jnp.asarray(toks)))
        dec = jax.jit(lambda q, c, t, p: jtfm.decode_step(jcfg, q, c, t, p))
        cache, steps = jtfm.init_cache(jcfg, BATCH, MAX_SEQ), []
        for i in range(STEPS):
            logits, cache = dec(jp, cache, jnp.asarray(toks[:, i]), jnp.asarray(pos[i]))
            steps.append(np.asarray(logits))
        _REF[key] = (pre, steps, np.asarray(cache))
    return _REF[key]


def _gap(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _run_sharded(cfg, params, grid, specs):
    """Prefill and 12 decode steps on ``grid`` -> (global prefill logits,
    each step's global logits, the global cache)."""
    toks, pos = _inputs(cfg)
    prm = tsh.shard_params(cfg, params, grid, specs)
    pre = tsh.assemble(grid, tsh.prefill(cfg, grid, prm, tsh.shard_rows(grid, torch.from_numpy(
        toks)), specs))
    cache = tfm.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    blocks = tsh.shard_cache(grid, cache)
    steps = []
    for i in range(STEPS):
        logits = tsh.decode_step(cfg, grid, prm, blocks,
                                 tsh.shard_rows(grid, torch.from_numpy(toks[:, i])),
                                 tsh.shard_rows(grid, torch.from_numpy(pos[i])), specs)
        steps.append(tsh.assemble(grid, logits))
    return pre, steps, cache


# ---------------------------------------------------------------------------
# prefill and decode against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["baseline", "tpserve"])
@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_jax(arch, shape, layout):
    """The catalogue's two serving layouts (FSDP x TP, and TP only) on a
    SimGrid: prefill logits, each decode step's logits and the cache (its
    blocks written in place into the global one) within ``REL`` of JAX's
    single-device functions."""
    _, cfg = _cfgs(arch)
    _, params = _params(arch)
    grid = SimGrid(*shape, "cpu")
    specs = tsh.serving_specs(cfg, grid, layout == "tpserve")
    pre, steps, cache = _run_sharded(cfg, params, grid, specs)
    want_pre, want_steps, want_cache = _reference(arch)
    assert _gap(pre, want_pre) <= REL
    for i, (got, want) in enumerate(zip(steps, want_steps)):
        assert _gap(got, want) <= REL, i
    assert _gap(cache, want_cache) <= REL


@pytest.mark.parametrize("variant", ["experttp", "moepin"])
def test_moe_variants_equal_jax(variant):
    """deepseek-v2-236b's ``experttp`` (the experts' d_ff kept over the
    rows: each row's share for the column's tokens, summed over the rows)
    and ``moepin`` (sharding pins: no value change, held against JAX's
    baseline) on a SimGrid 2x2 and a pod-folded 4x1."""
    arch = "deepseek-v2-236b"
    kw = {"expert_shard": "ff"} if variant == "experttp" else {}
    _, cfg = _cfgs(arch, **kw)
    if variant == "moepin":
        cfg = dataclasses.replace(cfg, moe_dp_axes=("data",), moe_tp_axis="model")
    _, params = _params(arch)
    want_pre, want_steps, want_cache = _reference(arch, **kw)
    for grid in (SimGrid(2, 2, "cpu"), SimGrid(4, 1, "cpu", row_fold={"pod": 2, "data": 2})):
        specs = tsh.serving_specs(cfg, grid)
        if variant == "experttp":
            assert specs["layers"]["we_down"] == (None, "model", grid.row_axes[0]
                                                  if len(grid.row_axes) == 1 else grid.row_axes,
                                                  None)
        pre, steps, cache = _run_sharded(cfg, params, grid, specs)
        assert _gap(pre, want_pre) <= REL, grid
        assert max(_gap(g, w) for g, w in zip(steps, want_steps)) <= REL, grid
        assert _gap(cache, want_cache) <= REL, grid


@pytest.mark.parametrize("shape", GRIDS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_equals_one_device_bf16(arch, shape):
    """bf16 compute on a SimGrid (FSDP x TP: each layer's weights cast
    before their gather, the embedding and the head cast, the bf16 cache
    written by the rank that owns each position) against the port's
    one-device bf16 prefill and decode on the same fp32 weights: logits and
    the gathered cache within ``BF16_REL`` of the peak, in the same dtypes;
    and the logits within ``bench.multicard``'s four-card rule,
    ``LM_BF16_RATIO`` times one device's bf16 gap to its fp32 logits."""
    _, c32 = _cfgs(arch)
    cfg = dataclasses.replace(c32, compute_dtype=torch.bfloat16)
    _, params = _params(arch)
    toks, pos = _inputs(cfg)

    def one_device(c):
        pre = tfm.prefill(c, params, torch.from_numpy(toks))
        cache, steps = tfm.init_cache(c, BATCH, MAX_SEQ, device="cpu"), []
        for i in range(STEPS):
            logits, cache = tfm.decode_step(c, params, cache, torch.from_numpy(toks[:, i]),
                                            torch.from_numpy(pos[i]))
            steps.append(logits)
        return [pre] + steps, cache

    want, want_cache = one_device(cfg)
    fp32, _ = one_device(c32)
    grid = SimGrid(*shape, "cpu")
    pre, steps, cache = _run_sharded(cfg, params, grid, tsh.serving_specs(cfg, grid))
    got = [pre] + steps
    assert (got[0].dtype, got[1].dtype, cache.dtype) == (want[0].dtype, want[1].dtype,
                                                         torch.bfloat16)
    gaps = [_gap(g, w.float()) for g, w in zip(got, want)]
    assert max(gaps) <= BF16_REL, gaps
    assert _gap(cache, want_cache.float()) <= BF16_REL
    one = max(_gap(w.float(), f) for w, f in zip(want, fp32))
    assert max(gaps) <= multicard.LM_BF16_RATIO * one, (gaps, one)


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_heads_that_do_not_divide_over_tp(kind):
    """Heads split between TP ranks (6 heads over 4 columns, 1.5 a rank;
    GQA with 2 kv heads, MLA): the placement kept, the columns gathered
    before use; prefill and decode equal the single-device port's."""
    base = dict(name=f"split-{kind}", n_layers=2, d_model=32, n_heads=6, n_kv_heads=2,
                head_dim=16, d_ff=64, vocab=256, q_chunk=16, kv_chunk=16,
                compute_dtype=torch.float32)
    if kind == "mla":
        base.update(use_mla=True, n_kv_heads=6, kv_lora_rank=16, q_lora_rank=12,
                    qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16)
    cfg = tfm.TransformerConfig(**base)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, pos = _inputs(cfg)
    want_pre = tfm.prefill(cfg, params, torch.from_numpy(toks))
    cache = tfm.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    want = []
    for i in range(STEPS):
        logits, cache = tfm.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i]),
                                        torch.from_numpy(pos[i]))
        want.append(logits)
    for shape in GRIDS:
        grid = SimGrid(*shape, "cpu")
        pre, steps, got_cache = _run_sharded(cfg, params, grid, tsh.serving_specs(cfg, grid))
        assert _gap(pre, want_pre) <= REL, shape
        assert max(_gap(g, w) for g, w in zip(steps, want)) <= REL, shape
        assert _gap(got_cache, cache) <= REL, shape


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,fold,tpserve", [
    ("deepseek-v2-236b", (2, 2), None, False), ("deepseek-v2-236b", (1, 4), None, True),
    ("dbrx-132b", (4, 1), {"pod": 2, "data": 2}, False), ("gemma-2b", (2, 2), None, True)])
def test_init_sharded_equals_shard_params(arch, shape, fold, tpserve):
    """``init_sharded`` draws the same slices as ``shard_params`` of the
    whole ``init_params`` from the same generator, each leaf a tensor of its
    own (not a view of a whole leaf), in the shapes ``shard_shape`` gives."""
    cfg = configs.get(arch).smoke_config()
    grid = SimGrid(*shape, "cpu", row_fold=fold)
    specs = tsh.serving_specs(cfg, grid, tpserve)
    whole = tfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    want = tsh.shard_params(cfg, whole, grid, specs)
    got = tsh.init_sharded(cfg, torch.Generator().manual_seed(3), grid, specs)
    mesh = tsh.grid_mesh(grid)
    for p in grid.local_ranks:
        for key in ("embed", "final_norm", "lm_head", *sorted(whole["layers"])):
            a = got[p]["layers"][key] if key in whole["layers"] else got[p][key]
            b = want[p]["layers"][key] if key in whole["layers"] else want[p][key]
            spec = specs["layers"][key] if key in whole["layers"] else specs[key]
            full = whole["layers"][key] if key in whole["layers"] else whole[key]
            assert tuple(a.shape) == meshlib.shard_shape(full.shape, spec, mesh), key
            assert torch.equal(a, b), (p, key)
            assert a.untyped_storage().nbytes() == a.numel() * a.element_size(), key


def test_specs_refuse_an_axis_off_the_grid():
    cfg = configs.get("gemma-2b").smoke_config()
    grid = SimGrid(2, 2, "cpu")
    specs = tfm.param_specs(cfg, fsdp=("pod",))
    with pytest.raises(ValueError, match="mesh axes"):
        tsh.shard_params(cfg, tfm.init_params(cfg, torch.Generator(), "cpu"), grid, specs)


# ---------------------------------------------------------------------------
# the grid engine
# ---------------------------------------------------------------------------


def _prompts(vocab, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(2, 9))).astype(np.int32)
            for _ in range(n)]


def _serve(e, prompts, max_new=4):
    module = jeng if isinstance(e, jeng.Engine) else eng
    reqs = [module.Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        e.submit(r)
    e.run_until_drained()
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_engine_equals_engines(arch):
    """Greedy: the grid engine on a SimGrid 2x2 and 1x4 gives the JAX
    ``Engine``'s tokens and the one-device engine's, its cache (gathered)
    within ``REL`` of the reference's and its positions equal.  Sampled
    (temperature 1, seed 3): the one-device engine's tokens (JAX's
    ``jax.random`` draws are not reproduced: the one-device engine's own
    tests say so)."""
    jcfg, cfg = _cfgs(arch)
    jp, params = _params(arch)
    prompts = _prompts(cfg.vocab)
    kw = dict(batch_slots=4, max_seq=48)
    je = jeng.Engine(jcfg, jp, **kw)
    want = _serve(je, prompts)
    assert _serve(eng.Engine(cfg, params, device="cpu", **kw), prompts) == want
    sampled = _serve(eng.Engine(cfg, params, temperature=1.0, seed=3, device="cpu", **kw),
                     prompts, max_new=6)
    for shape in GRIDS:
        grid = SimGrid(*shape, "cpu")
        prm = tsh.shard_params(cfg, params, grid)
        e = eng.GridEngine(cfg, prm, grid, **kw)
        assert _serve(e, prompts) == want, shape
        cache = tsh.assemble(grid, e.cache, row_dim=1, col_dim=2)
        assert _gap(cache, np.asarray(je.cache)) <= REL
        assert np.array_equal(e.pos, np.asarray(je.pos))
        hot = eng.GridEngine(cfg, prm, grid, temperature=1.0, seed=3, **kw)
        assert _serve(hot, prompts, max_new=6) == sampled, shape


def test_process_grid_equals_simgrid_bit_for_bit():
    """deepseek-v2-236b (MLA, shared and routed experts, a routing group
    spanning the rows) as 4 gloo processes on the CPU (``bench.serve.
    proc_serve``: each draws its own slices) against the same program on a
    SimGrid 2x2: tokens, every rank's cache block, last logits and prefill
    logits equal bit for bit."""
    cfg = serve_bench.config("deepseek-v2-236b", smoke=True, dtype="fp32")
    toks, _ = _inputs(cfg)
    prompts = _prompts(cfg.vocab, n=5)
    spec = {"arch": "deepseek-v2-236b", "smoke": True, "dtype": "fp32", "seed": 2, "slots": 4,
            "max_seq": 32, "max_new": 3, "prompts": [p.tolist() for p in prompts],
            "keep": True, "prefill": toks.tolist()}
    runs = procgrid.spawn(serve_bench.proc_serve, 2, 2, backend="gloo", device="cpu",
                          args=(spec,))
    grid = SimGrid(2, 2, "cpu")
    params, specs = serve_bench.model_sharded(cfg, grid, seed=2)
    res = serve_bench.serve(cfg, params, prompts, slots=4, max_seq=32, max_new=3, grid=grid,
                            specs=specs)
    pre = tsh.prefill(cfg, grid, params, tsh.shard_rows(grid, torch.from_numpy(toks)), specs)
    e = res["engine"]
    for r in runs:
        p = r["rank"]
        assert r["tokens"] == [q.out for q in res["requests"]]
        assert np.array_equal(r["cache"], e.cache[p].numpy()), p
        assert np.array_equal(r["logits"], e.logits[p].numpy()), p
        assert np.array_equal(r["prefill"], pre[p].numpy()), p


def test_agreeing_gap_stops_each_slot_where_its_inputs_part():
    """``bench.serve.agreeing_gap``: a slot's logits are compared up to the
    tick at which the two runs fed it different tokens, and no further;
    ``rows`` picks a rank's slots out of the reference and the fed tokens."""
    rng = np.random.default_rng(0)
    want = rng.normal(size=(5, 3, 7)).astype(np.float32)
    fed = rng.integers(0, 7, (5, 3)).astype(np.int32)
    got, got_fed = want.copy(), fed.copy()
    got[:, 1] += 0.01
    got_fed[3, 2] += 1  # slot 2 fed another token at tick 3 ...
    got[3:, 2] += 5.0  # ... its logits from then on are not compared
    gap, compared, pairs = serve_bench.agreeing_gap(list(got), list(got_fed), want, fed,
                                                    slice(None))
    assert (compared, pairs) == (13, 15)
    assert gap == pytest.approx(0.01 / np.abs(want).max(), rel=1e-4)
    gap, compared, pairs = serve_bench.agreeing_gap(list(got[:, 2:]), list(got_fed), want, fed,
                                                    slice(2, 3))
    assert (gap, compared, pairs) == (0.0, 3, 5)


def test_bench_serve_grid_on_cpu(capsys):
    """``bench.serve --grid`` on a SimGrid: every request finishes, and the
    tokens per second and the ranks' bytes are printed."""
    out = serve_bench.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--requests",
                            "5", "--slots", "4", "--max-new", "6", "--grid", "2x2"])
    assert out["finished"] == 5 and out["generated_tokens"] == 30 and out["grid"] == "2x2"
    text = capsys.readouterr().out
    assert "SimGrid 2x2" in text and "generated tokens/s" in text


# ---------------------------------------------------------------------------
# the dry-run's collectives
# ---------------------------------------------------------------------------


def _closed_form(shape_name: str, rows: int, cols: int) -> dict:
    """gemma-2b's collective bytes per rank under the FSDP x TP placement
    (one rank's result bytes a call, all-reduces doubled), on an R x C mesh
    where its 8 q heads divide over C and its one kv head (256 columns)
    does not: bf16 weights, each layer's TP block gathered over the rows,
    ``lm_head``'s too; the token ids gathered over the rows, the lookup
    summed over TP and handed out by an all-to-all.  Prefill: k and v
    gathered over TP, the attention and FFN outputs summed over TP.
    Decode: q | k | v gathered over TP, the softmax max (fp32) and sums
    (fp32, the values and the normalizer) combined over TP, then the
    attention and FFN outputs summed."""
    spec = configs.get("gemma-2b")
    cfg, sh = spec.model_config(), spec.shape(shape_name).params
    big_b, s = sh["global_batch"], sh["seq_len"]
    d, h, hd, ff, vp, n_l = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                             cfg.padded_vocab, cfg.n_layers)
    kvw = cfg.n_kv_heads * hd
    e, ar, b = 2, 2, big_b // rows
    layer_w = e * (2 * d * h * hd // cols + 2 * d * kvw // cols + 3 * d * ff // cols)
    head_w = e * d * vp // cols
    if shape_name == "prefill_32k":
        return {"all-gather": 4 * big_b * s + n_l * (layer_w + 2 * e * b * s * kvw) + head_w,
                "all-reduce": ar * e * big_b * s * d // rows + n_l * 2 * ar * e * b * s * d,
                "all-to-all": e * big_b * s * d // rows}
    return {"all-gather": 4 * big_b + n_l * (layer_w + e * b * (h * hd + 2 * kvw)) + head_w,
            "all-reduce": ar * e * big_b * d // rows + n_l * (
                ar * 4 * b * h + ar * 4 * b * h * (hd + 1) + 2 * ar * e * b * d),
            "all-to-all": e * big_b * d // rows}


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_dryrun_collectives_equal_the_placement(tmp_path, shape_name):
    """gemma-2b's serving cells on a (2, 2) mesh on meta: the record's
    collective bytes per kind (one layer counted, times 18, plus the
    embedding and head) equal the closed form of the placement."""
    m = meshlib.make_mesh((2, 2), ("data", "model"))
    rec = dryrun.run_cell("gemma-2b", shape_name, False, str(tmp_path), mesh=m)
    assert rec["status"] == "ok", rec.get("traceback")
    roof = rec["roofline"]
    assert roof["collective_breakdown"] == _closed_form(shape_name, 2, 2)
    assert roof["collective_bytes"] == sum(_closed_form(shape_name, 2, 2).values())
