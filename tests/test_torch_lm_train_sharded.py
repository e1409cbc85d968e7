"""The LM train step FSDP x TP over a grid (``train.step.make_sharded_train_step``,
``models.transformer_sharded.loss_fn``) against the JAX package's
single-device ``jax.value_and_grad(loss_fn)`` and ``make_train_step``.

Weights are the reference's smoke weights (``init_params(cfg,
PRNGKey(0))``) carried across by ``params_from_numpy`` and placed by
``shard_state``; compute is fp32; the batch is 4 rows of 33 tokens from a
numpy generator.  Bars: the loss, every gradient leaf (the ranks' slices
assembled by ``gather_state``) and the gradient norm within ``REL`` of the
reference's peak (the single-device port sits at ~1e-6 there; the grid
adds partial products in another order).  The first AdamW step moves a
parameter by about ``lr * sign(g)``, whose sign a sum in another order
can flip where ``|g|`` is near 0: the new parameters lie within ``REL``
of the leaf's peak where the reference's ``|g|`` exceeds ``G_FLOOR`` of
its leaf's peak, and within ``2 * lr`` elsewhere.  A gloo ``ProcessGrid``
equals ``SimGrid`` bit for bit; remat on equals remat off bit for bit;
the dry-run's collective bytes equal the placement's closed form.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jconfigs
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.bench import lm_train
from repro_torch.comm import SimGrid, procgrid
from repro_torch.comm.grid import ad_all_gather
from repro_torch.configs import common as configs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh
from repro_torch.models.gnn import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

ARCHS = ["gemma-2b", "minicpm-2b", "deepseek-coder-33b", "deepseek-v2-236b", "dbrx-132b"]
#: (rows, cols, row fold): FSDP x TP, TP only, and rows folded over
#: ("pod", "data") (one row a sequence: the MoE archs' routing groups
#: then span the rows and are routed gathered)
LAYOUTS = {"2x2": (2, 2, None), "1x4": (1, 4, None), "pod2x2x1": (4, 1, {"pod": 2, "data": 2})}
REL = 1e-5
G_FLOOR = 1e-4
BATCH, SEQ = 4, 33


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


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (BATCH, SEQ)).astype(np.int32)


_REF: dict = {}


def _reference(arch):
    """JAX on one device: the smoke weights, the loss and its gradient, the
    gradient's global norm and the state after one ``make_train_step``
    (the cells' ``AdamWConfig()``), all as numpy; ``expert_shard`` pins
    nothing on one device, so one reference serves both MoE layouts."""
    if arch not in _REF:
        jcfg, cfg = _cfgs(arch)
        jp = jax.jit(lambda k: jtfm.init_params(jcfg, k))(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(_tokens(cfg.vocab))}
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jtfm.loss_fn(jcfg, p, batch)))(jp)
        step = jax.jit(jstep.make_train_step(lambda p, b: jtfm.loss_fn(jcfg, p, b),
                                             jadamw.AdamWConfig()))
        new, metrics = step(jstep.init_state(jp), batch)
        as_np = jax.tree.map(np.asarray, (jp, grads, new.params))
        _REF[arch] = {"params": as_np[0], "grads": as_np[1], "new": as_np[2],
                      "loss": float(loss), "grad_norm": float(metrics["grad_norm"])}
    return _REF[arch]


def _state(ref):
    return tstep.init_state(params_from_numpy(ref["params"], "cpu"))


def _grid(layout):
    r, c, fold = LAYOUTS[layout]
    return SimGrid(r, c, "cpu", row_fold=fold)


def _gap(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _whole(grid, trees, specs):
    """The global tree of per-rank slice trees (``gather_state``'s)."""
    return tstep.gather_state(grid, [tstep.TrainState(params=t, opt=adamw.OptState(
        step=None, m=t, v=t)) for t in trees], specs).params


def _adamw_rule(new, want_new, g_ref, lr) -> tuple[float, float]:
    """(the largest gap over the leaf's peak where the reference's |g|
    exceeds ``G_FLOOR`` of its peak, the largest gap elsewhere over
    ``lr``)."""
    new, want_new, g_ref = (np.asarray(x, np.float32) for x in (new, want_new, g_ref))
    gap = np.abs(new - want_new)
    big = np.abs(g_ref) > G_FLOOR * np.abs(g_ref).max()
    rel = float(gap[big].max() / np.abs(want_new).max()) if big.any() else 0.0
    small = float(gap[~big].max() / lr) if (~big).any() else 0.0
    return rel, small


# ---------------------------------------------------------------------------
# the train step against JAX
# ---------------------------------------------------------------------------


def _check_step(arch, layout, **kw):
    ref = _reference(arch)
    _, cfg = _cfgs(arch, **kw)
    grid = _grid(layout)
    specs = tsh.serving_specs(cfg, grid)
    states = tstep.shard_state(cfg, grid, _state(ref), specs)
    toks = tsh.shard_rows(grid, torch.from_numpy(_tokens(cfg.vocab)))
    loss, grads, norm = tstep.sharded_value_and_grad(
        cfg, grid, specs, [s.params for s in states], toks)
    assert abs(float(loss) - ref["loss"]) <= REL * abs(ref["loss"])
    assert abs(float(norm[0]) - ref["grad_norm"]) <= REL * ref["grad_norm"]
    assert all(torch.equal(norm[p], norm[0]) for p in grid.local_ranks)
    got = _whole(grid, grads, specs)
    for g, w in zip(tree.leaves(got), tree.leaves(ref["grads"])):
        assert _gap(g, w) <= REL
    step = tstep.make_sharded_train_step(cfg, grid, specs, adamw.AdamWConfig())
    new, metrics = step(states, toks)
    assert torch.equal(metrics["loss"], loss) and torch.equal(metrics["grad_norm"], norm[0])
    assert int(metrics["step"]) == 1
    lr = float(adamw.wsd_schedule(adamw.AdamWConfig(), torch.ones((), dtype=torch.int32)))
    whole = tstep.gather_state(grid, new, specs)
    for x, w, g in zip(tree.leaves(whole.params), tree.leaves(ref["new"]),
                       tree.leaves(ref["grads"])):
        rel, small = _adamw_rule(x.numpy(), w, g, lr)
        assert rel <= REL and small <= 2.0, (rel, small)
    for m in tree.leaves(whole.opt.m):
        assert torch.isfinite(m).all()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(arch, layout):
    """The loss, every gradient leaf and the norm of the sharded step
    within ``REL`` of JAX's single-device ``value_and_grad(loss_fn)``, and
    its AdamW step within the first step's rule of JAX's
    ``make_train_step``: dense, GQA with a kv head that does not divide
    over TP, MLA, and MoE routed per row or gathered over the rows."""
    _check_step(arch, layout)


@pytest.mark.parametrize("layout", ["2x2", "pod2x2x1"])
def test_experttp_train_step_equals_jax(layout):
    """deepseek-v2-236b under ``experttp``: the experts' d_ff kept over the
    rows, their outputs summed over the rows, the aux loss not."""
    _check_step("deepseek-v2-236b", layout, expert_shard="ff")


# ---------------------------------------------------------------------------
# recomputation, serving, placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b"])
def test_remat_is_value_neutral(arch):
    """``remat`` (each layer recomputed in the backward) against no
    recomputation, on one device and on a SimGrid 2x2: the loss and every
    gradient equal bit for bit."""
    _, cfg = _cfgs(arch)
    params = params_from_numpy(_reference(arch)["params"], "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab))
    grid = SimGrid(2, 2, "cpu")
    specs = tsh.serving_specs(cfg, grid)
    runs = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        one = tstep.value_and_grad(lambda p, b: tfm.loss_fn(c, p, b), params, {"tokens": toks})
        prm = tsh.shard_params(c, params, grid, specs)
        sharded = tstep.sharded_value_and_grad(c, grid, specs, prm, tsh.shard_rows(grid, toks))
        runs.append(tree.leaves(one) + [sharded[0]] + tree.leaves(sharded[1]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_forward_unchanged_under_autograd():
    """The sharded prefill with every weight slice requiring a gradient
    (the collectives then run as the differentiable ``ad_*`` ones) gives
    the serving logits bit for bit, and its gradient flows to the slices."""
    _, cfg = _cfgs("deepseek-v2-236b")
    params = params_from_numpy(_reference("deepseek-v2-236b")["params"], "cpu")
    grid = SimGrid(2, 2, "cpu")
    specs = tsh.serving_specs(cfg, grid)
    toks = tsh.shard_rows(grid, torch.from_numpy(_tokens(cfg.vocab)))
    want = tsh.prefill(cfg, grid, tsh.shard_params(cfg, params, grid, specs), toks, specs)
    prm = [tree.tree_map(lambda x: x.detach().clone().requires_grad_(), t)
           for t in tsh.shard_params(cfg, params, grid, specs)]
    with torch.enable_grad():
        got = tsh.prefill(cfg, grid, prm, toks, specs)
        assert all(g.requires_grad for g in got)
        sum(g.sum() for g in got).backward()
    assert all(torch.equal(g.detach(), w) for g, w in zip(got, want))
    assert all(x.grad is not None for t in prm for x in tree.leaves(t))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shard_then_gather_state_round_trip(layout):
    """The reference's numpy train state (params, and m and v filled with
    other values) to each rank's slices and back: unchanged."""
    _, cfg = _cfgs("deepseek-v2-236b")
    ref = _reference("deepseek-v2-236b")
    params = params_from_numpy(ref["params"], "cpu")
    grads = params_from_numpy(ref["grads"], "cpu")
    state = tstep.TrainState(params=params, opt=adamw.OptState(
        step=torch.tensor(3, dtype=torch.int32), m=grads,
        v=tree.tree_map(lambda g: g * g, grads)), ef=None)
    grid = _grid(layout)
    specs = tsh.serving_specs(cfg, grid)
    states = tstep.shard_state(cfg, grid, state, specs)
    mesh = tsh.grid_mesh(grid)
    for s in states:
        for x, full, sp in zip(tree.leaves(s.params), tree.leaves(params),
                               meshlib.spec_leaves(specs)):
            assert tuple(x.shape) == meshlib.shard_shape(full.shape, sp, mesh)
    back = tstep.gather_state(grid, states, specs)
    assert int(back.opt.step) == 3
    for a, b in zip(tree.leaves((back.params, back.opt.m, back.opt.v)),
                    tree.leaves((state.params, state.opt.m, state.opt.v))):
        assert torch.equal(a, b)
    assert [x.numpy().tobytes() for x in tree.leaves(back.params)] == [
        np.asarray(x, np.float32).tobytes() for x in tree.leaves(ref["params"])]


def test_replicated_leaves_and_their_axes():
    """Which axes a leaf's gradient is summed over: the norms over both,
    the router (FSDP on d) over TP, MLA's ``wq_b`` / ``wkv_b`` (TP only)
    over the rows, a leaf split over both over neither."""
    cfg = configs.get("deepseek-v2-236b").smoke_config()
    grid = SimGrid(2, 2, "cpu")
    specs = tsh.serving_specs(cfg, grid)["layers"]
    assert tsh.replicated_over(grid, specs["ln1"]) == ("data", "model")
    assert tsh.replicated_over(grid, specs["router"]) == ("model",)
    assert tsh.replicated_over(grid, specs["wq_b"]) == ("data",)
    assert tsh.replicated_over(grid, specs["wkv_b"]) == ("data",)
    assert tsh.replicated_over(grid, specs["wo"]) is None
    assert tsh.replicated_over(SimGrid(1, 4, "cpu"), specs["wq_b"]) is None


# ---------------------------------------------------------------------------
# the grid's reduce-scatter and AdamW over many trees
# ---------------------------------------------------------------------------


def test_reduce_scatter_is_the_psum_slice():
    """``SimGrid.reduce_scatter`` gives the chunk of ``psum`` bit for bit,
    and ``ad_all_gather(scatter=True)``'s transpose the same cotangents as
    the psum-and-slice one."""
    rng = np.random.default_rng(0)
    grid = SimGrid(2, 3, "cpu")
    for axis in (("data",), "model", ("data", "model")):
        k = grid.group_size(axis)
        xs = [torch.from_numpy(rng.normal(size=(2 * k, 5)).astype(np.float32))
              for _ in range(grid.size)]
        got = grid.reduce_scatter(xs, axis)
        summed, idx = grid.psum(xs, axis), grid.axis_index(axis)
        assert all(torch.equal(got[p], torch.chunk(summed[p], k)[idx[p]])
                   for p in range(grid.size))
        grads = []
        for scatter in (False, True):
            leaves = [x.clone().requires_grad_() for x in xs]
            with torch.enable_grad():
                out = ad_all_gather(grid, leaves, axis, scatter=scatter)
                sum((o * (p + 1)).sum() for p, o in enumerate(out)).backward()
            grads.append([x.grad for x in leaves])
        assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_adamw_apply_many_equals_apply():
    """``adamw.apply_many`` over three trees (a grid's ranks) equals
    ``adamw.apply`` on each, bit for bit, under one given norm; ``apply``
    with ``norm`` equal to the gradient's own global norm equals ``apply``
    without it."""
    rng = np.random.default_rng(2)

    def t():
        return {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
                "b": [torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))]}

    cfg = adamw.AdamWConfig(warmup_steps=1)
    params, grads = [t() for _ in range(3)], [t() for _ in range(3)]
    states = [adamw.OptState(step=torch.tensor(2, dtype=torch.int32), m=t(),
                             v=tree.tree_map(torch.abs, t())) for _ in range(3)]
    norm = torch.tensor(1.7)
    many = adamw.apply_many(cfg, params, grads, states, norm)
    for (p, st), x, g, s in zip(many, params, grads, states):
        want_p, want_st = adamw.apply(cfg, x, g, s, norm=norm)
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves((p, st.m, st.v, st.step)),
            tree.leaves((want_p, want_st.m, want_st.v, want_st.step))))
    own = adamw.apply(cfg, params[0], grads[0], states[0])
    given = adamw.apply(cfg, params[0], grads[0], states[0],
                        norm=adamw.global_norm(grads[0]))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(own), tree.leaves(given)))


# ---------------------------------------------------------------------------
# processes, the harness, the dry-run
# ---------------------------------------------------------------------------


def test_process_grid_equals_simgrid_bit_for_bit():
    """deepseek-v2-236b (MLA, shared and routed experts, the replicated
    router and ``wq_b`` / ``wkv_b``) trained 2 steps as 4 gloo processes on
    the CPU (``bench.lm_train.proc_train``: each draws its own slices)
    against the same run on a SimGrid 2x2: each step's loss and norm, and
    every rank's new parameters, equal bit for bit."""
    case = {"arch": "deepseek-v2-236b", "smoke": True, "dtype": "fp32", "seed": 2,
            "batch": BATCH, "seq": SEQ, "steps": 2, "keep": True}
    runs = procgrid.spawn(lm_train.proc_train, 2, 2, backend="gloo", device="cpu",
                          args=({"cases": [case]},), timeout_s=300.0)
    cfg = lm_train.serve_bench.config("deepseek-v2-236b", smoke=True, dtype="fp32")
    grid = SimGrid(2, 2, "cpu")
    states, specs = lm_train.draw_sharded(cfg, grid, seed=2)
    res = lm_train.train(cfg, states, BATCH, SEQ, 2, grid=grid, specs=specs)
    for r in runs:
        got = r["cases"][0]
        assert got["loss"] == res["loss"] and got["grad_norm"] == res["grad_norm"]
        want = [x.numpy() for x in tree.leaves(res["state"][r["rank"]].params)]
        assert all(np.array_equal(a, b) for a, b in zip(got["params"], want)), r["rank"]
        assert got["collective_bytes"] == res["collective_bytes"]


def test_bench_lm_train_on_cpu(capsys):
    """``bench.lm_train --grid`` on a SimGrid: the loss falls from its
    first step, and the step time, tokens per second and the collective
    bytes by kind are printed."""
    out = lm_train.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--grid", "2x2",
                         "--dtype", "fp32", "--steps", "2"])
    assert len(out["loss"]) == 2 and all(np.isfinite(out["loss"]))
    assert set(out["collective_bytes"][0]) == {"all-gather", "all-reduce", "all-to-all",
                                               "reduce-scatter"}
    text = capsys.readouterr().out
    assert "median s a step" in text and "tokens/s" in text


def _closed_form(rows: int, cols: int) -> dict:
    """gemma-2b's ``train_4k`` collective bytes per rank under the FSDP x
    TP placement (one rank's result bytes a call, all-reduces doubled) on
    an R x C mesh where its 8 q heads divide over C and its one kv head
    does not; bf16 compute over fp32 parameters, ``remat`` on.  A layer:
    its weights' TP blocks gathered over the rows (bf16), k and v gathered
    over TP, the attention and FFN outputs summed over TP; the backward's
    recomputation gathers the weights and k, v again and sums the
    attention output again (its last saved tensor is the FFN's down
    projection's input); the backward reduce-scatters every gather (a
    weight's slice over the rows, k and v over TP) and sums the two
    outputs' cotangents over TP.  Once a step: the token ids gathered over
    the rows, the lookup summed over TP and its all-to-all over the rows,
    both again in the backward; ``lm_head`` gathered and reduce-scattered;
    the loss's ``pmax`` (fp32) and one ``psum`` of the sums and target
    logits (2 x fp32) and its transpose; the norms' gradients (fp32, 2L+1
    rows of d) summed over the grid, the norm and the loss (0-d fp32)."""
    spec = configs.get("gemma-2b")
    cfg, sh = spec.model_config(), spec.shape("train_4k").params
    big_b, s = sh["global_batch"], sh["seq_len"] - 1
    d, h, hd, ff, vp, n_l = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                             cfg.padded_vocab, cfg.n_layers)
    kvw = cfg.n_kv_heads * hd
    e, ar, b = 2, 2, big_b // rows
    layer_w = e * (2 * d * h * hd // cols + 2 * d * kvw // cols + 3 * d * ff // cols)
    kv = 2 * e * b * s * kvw
    act = ar * e * b * s * d
    head = e * d * vp // cols
    return {
        "all-gather": 4 * big_b * s + n_l * 2 * (layer_w + kv) + head,
        "reduce-scatter": n_l * (layer_w // rows + kv // cols) + head // rows,
        "all-reduce": n_l * 5 * act + 2 * ar * e * big_b * s * d // rows
        + ar * 4 * b * s * (1 + 2 + 2) + ar * 4 * (2 * n_l * d + d) + 2 * ar * 4,
        "all-to-all": 2 * e * big_b * s * d // rows,
    }


def test_dryrun_train_collectives_equal_the_placement(tmp_path):
    """gemma-2b's ``train_4k`` cell on a (2, 2) mesh on meta: the record's
    collective bytes per kind (one layer's forward, recomputation and
    backward counted, times 18, plus the rest once) equal the closed form
    of the placement."""
    m = meshlib.make_mesh((2, 2), ("data", "model"))
    rec = dryrun.run_cell("gemma-2b", "train_4k", False, str(tmp_path), mesh=m)
    assert rec["status"] == "ok", rec.get("traceback")
    roof = rec["roofline"]
    assert roof["collective_breakdown"] == _closed_form(2, 2)
    assert roof["collective_bytes"] == sum(_closed_form(2, 2).values())


def test_multicard_lm_train_case_on_cpu():
    """``bench.multicard --case lm-train`` at gemma-2b's smoke widths as 4
    gloo CPU processes: the cut-depth fp32 cases on 2x2, 1x4 and a SimGrid
    within ``LM_TRAIN_REL`` of one device (AdamW by the first step's rule),
    the bf16 case within its bound, every process's losses equal."""
    from repro_torch.bench import multicard

    out = multicard.main(["--device", "cpu", "--backend", "gloo", "--case", "lm-train",
                          "--smoke"])
    rep = out["lm_train"]
    assert not out["failures"]
    for name in ("simgrid 2x2", "2x2", "1x4"):
        assert rep[name]["grad_rel"] <= multicard.LM_TRAIN_REL
    assert len(rep["timed"]["loss"]) == 3 and rep["timed"]["collective_bytes"][0]
