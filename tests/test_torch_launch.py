"""The port's training runtime against the JAX package: checkpoints (the
same files in both directions), the step watchdog, ``resume_or_init``,
the ``launch.train`` launcher's resume, the paper's vertex sorting and
block padding, and the ``graph500`` config.

Checkpoints hold the reference's train state (``jax.tree`` leaf order), so
the bar is equality of every leaf; the launcher's killed-and-resumed run
must equal an uninterrupted one bit for bit on the CPU; the graph
functions must return byte-identical arrays.
"""

import dataclasses
import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jconfigs
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkron
from repro.models import recsys as jrecsys
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train import fault as jfault
from repro.train import step as jstep
from repro_torch import graphgen, tree
from repro_torch.configs import common as configs
from repro_torch.graphgen import builder, kronecker
from repro_torch.launch import train as launcher
from repro_torch.models import recsys
from repro_torch.models.gnn import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, fault
from repro_torch.train import step as tstep


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _state(seed=0):
    """A small port train state: params, AdamW moments after one update."""
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((3, 4), generator=gen), "layers": [
        {"b": torch.randn((5,), generator=gen)}, {"b": torch.randn((5,), generator=gen)}],
        "q": torch.randint(-127, 128, (6, 2), generator=gen, dtype=torch.int32).to(torch.int8)}
    state = tstep.init_state({k: v for k, v in params.items() if k != "q"})
    grads = tree.tree_map(torch.ones_like, state.params)
    p, opt = adamw.apply(adamw.AdamWConfig(), state.params, grads, state.opt)
    return tstep.TrainState(params={**p, "q": params["q"]},
                            opt=opt._replace(m={**opt.m, "q": torch.zeros(6, 2)},
                                             v={**opt.v, "q": torch.zeros(6, 2)}))


def _equal(a, b):
    fa, fb = tree.leaves(a), tree.leaves(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for x, y in zip(fa, fb))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    state = _state()
    d = str(tmp_path)
    assert checkpoint.latest_step(d) is None
    path = checkpoint.save(state, 7, d)
    assert os.path.basename(path) == "step_000007"
    assert sorted(os.listdir(path)) == ["MANIFEST.json", "host_0000.npz"]
    m = json.load(open(os.path.join(path, "MANIFEST.json")))
    assert (m["step"], m["status"], m["n_leaves"]) == (7, "complete", len(tree.leaves(state)))
    assert m["treedef"].startswith("TrainState(params={") and "ef=None" in m["treedef"]
    assert "int8" in m["dtypes"] and "int32" in m["dtypes"]
    back = checkpoint.restore(state, 7, d)
    assert isinstance(back, tstep.TrainState) and isinstance(back.opt, adamw.OptState)
    assert back.ef is None and _equal(back, state)
    # a torn write (no manifest, or a .tmp directory) is never the latest
    os.makedirs(os.path.join(d, "step_000009.tmp"))
    os.makedirs(os.path.join(d, "step_000011"))
    assert checkpoint.latest_step(d) == 7
    checkpoint.save(state, 12, d)
    assert checkpoint.latest_step(d) == 12
    # the wrong structure or shape is refused
    with pytest.raises(ValueError):
        checkpoint.restore(state.params, 7, d)
    bad = state._replace(params={**state.params, "w": torch.zeros(4, 3)})
    with pytest.raises(ValueError):
        checkpoint.restore(bad, 7, d)


def test_restore_sharded_elastic(tmp_path):
    """One device, or any rank count's per-rank device list (``None`` for a
    rank another process holds)."""
    state = _state(1)
    checkpoint.save(state, 3, str(tmp_path))
    one = checkpoint.restore_sharded(state, 3, str(tmp_path), torch.device("cpu"))
    assert _equal(one, state)
    ranks = checkpoint.restore_sharded(state, 3, str(tmp_path), ["cpu", None, "cpu"])
    assert len(ranks) == 3 and ranks[1] is None
    assert _equal(ranks[0], state) and _equal(ranks[2], state)
    assert ranks[0].params["w"].data_ptr() != ranks[2].params["w"].data_ptr()


def test_async_checkpointer_supersedes(tmp_path, monkeypatch):
    """While one write is on the disk, a newer snapshot replaces a queued
    one; the snapshot is taken at submit, so later changes do not reach
    it."""
    gate = threading.Event()
    saved = checkpoint.save

    def slow_save(state, step, d):
        gate.wait(10)
        return saved(state, step, d)

    monkeypatch.setattr(checkpoint, "save", slow_save)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path))
    x = {"w": torch.zeros(4)}
    ck.submit(x, 1)
    time.sleep(0.05)  # the writer has taken step 1 and waits on the gate
    ck.submit({"w": torch.full((4,), 2.0)}, 2)
    x3 = {"w": torch.full((4,), 3.0)}
    ck.submit(x3, 3)
    x3["w"].fill_(-1.0)  # after the snapshot
    gate.set()
    ck.wait()
    assert ck.written == [1, 3]
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert torch.equal(checkpoint.restore(x, 3, str(tmp_path))["w"], torch.full((4,), 3.0))
    assert not os.path.exists(os.path.join(str(tmp_path), "step_000002"))
    ck.submit({"w": torch.ones(4)}, 4)  # a new writer after the last one ended
    ck.wait()
    assert ck.written == [1, 3, 4]


def _autoint_states():
    """JAX's autoint smoke train state after one step, and the port's."""
    jcfg = jconfigs.get("autoint").smoke_config()
    jp = jax.jit(lambda k: jrecsys.init_params(jcfg, k))(jax.random.PRNGKey(0))
    opt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    ids = np.random.default_rng(0).integers(0, 256, (16, 8)).astype(np.int32)
    batch = {"ids": jnp.asarray(ids), "labels": jnp.asarray((ids[:, 0] % 2).astype(np.float32))}
    jstate, _ = jax.jit(jstep.make_train_step(
        lambda p, b: jrecsys.loss_fn(jcfg, p, b), opt))(jstep.init_state(jp), batch)
    cfg = configs.get("autoint").smoke_config()
    like = tstep.init_state(recsys.init_params(cfg, torch.Generator().manual_seed(1), device="cpu"))
    return jstate, like


def test_jax_checkpoint_restores_in_port(tmp_path):
    jstate, like = _autoint_states()
    jckpt.save(jstate, 5, str(tmp_path))
    assert checkpoint.latest_step(str(tmp_path)) == 5
    back = checkpoint.restore(like, 5, str(tmp_path))
    jflat = jax.tree.leaves(jstate)
    assert len(tree.leaves(back)) == len(jflat) == len(tree.leaves(like))
    for a, b in zip(tree.leaves(back), jflat):
        assert str(a.dtype).removeprefix("torch.") == jnp.dtype(b.dtype).name
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert int(back.opt.step) == 1 and back.ef is None


def test_port_checkpoint_restores_in_jax(tmp_path):
    jstate, like = _autoint_states()
    port_state = tstep.TrainState(
        params=params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu"),
        opt=adamw.OptState(step=torch.tensor(1, dtype=torch.int32),
                           m=params_from_numpy(jax.tree.map(np.asarray, jstate.opt.m), "cpu"),
                           v=params_from_numpy(jax.tree.map(np.asarray, jstate.opt.v), "cpu")))
    checkpoint.save(port_state, 6, str(tmp_path))
    assert jckpt.latest_step(str(tmp_path)) == 6
    back = jckpt.restore(jstate, 6, str(tmp_path))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# the watchdog and the restart policy
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


#: step durations (s): a warm-up, steady steps, two stragglers, a slow
#: drift the rolling median follows, and a window's worth more
DURATIONS = ([1.0, 1.0, 1.2, 0.9, 1.1, 1.0, 4.0, 1.0, 2.9, 3.1, 10.0]
             + [2.0 + 0.1 * i for i in range(40)] + [7.0, 30.0, 2.5])


def test_watchdog_verdicts_match_reference(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    for kw in ({}, {"straggler_factor": 2.0, "window": 8}):
        mine, ref = fault.StepWatchdog(**kw), jfault.StepWatchdog(**kw)
        verdicts = []
        for dt in DURATIONS:
            mine.start()
            ref.start()
            clock.t += dt
            verdicts.append((mine.stop(), ref.stop()))
        assert all(a == b for a, b in verdicts), verdicts
        assert mine.stragglers == ref.stragglers and mine.stragglers
        assert mine.step_idx == ref.step_idx == len(DURATIONS)
        mine.start()
        ref.start()
        clock.t += mine.hang_timeout_s - 1
        assert not mine.is_hung() and not ref.is_hung()
        clock.t += 2
        assert mine.is_hung() and ref.is_hung()
    with pytest.raises(RuntimeError):
        fault.StepWatchdog().stop()


def test_resume_or_init(tmp_path):
    calls = []

    def init():
        calls.append(1)
        return _state(2)

    d = str(tmp_path)
    state, start = fault.resume_or_init(init, d)
    assert start == 0 and _equal(state, _state(2)) and len(calls) == 1
    saved = _state(3)
    checkpoint.save(saved, 4, d)
    state, start = fault.resume_or_init(init, d)
    assert start == 5 and _equal(state, saved) and len(calls) == 2
    state, start = fault.resume_or_init(init, d, shardings="cpu")
    assert start == 5 and _equal(state, saved)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

#: per family: the arch and the launcher's size flags, kept small
LAUNCH = {"autoint": ["--batch", "32"],
          "minicpm-2b": ["--batch", "2", "--seq-len", "32"],
          "graphcast": []}


@pytest.mark.parametrize("arch", list(LAUNCH))
def test_launcher_resume_equals_uninterrupted(arch, tmp_path, capsys):
    """An uninterrupted 8-step run checkpoints steps 3 and 7; with step 7's
    checkpoint removed, as if a kill had come before it was written, the
    same command resumes at step 4 and ends on the first run's state, bit
    for bit, with the same losses for steps 4-7."""
    d = str(tmp_path)
    argv = ["--device", "cpu", "--arch", arch, "--steps", "8", "--ckpt-every", "4",
            "--log-every", "2", "--ckpt-dir", d] + LAUNCH[arch]
    whole = launcher.main(argv)
    assert whole["start_step"] == 0 and len(whole["losses"]) == 8
    assert all(np.isfinite(whole["losses"]))
    assert int(whole["state"].opt.step) == 8
    assert sorted(os.listdir(d)) == ["step_000003", "step_000007"]
    shutil.rmtree(os.path.join(d, "step_000007"))
    assert checkpoint.latest_step(d) == 3
    resumed = launcher.main(argv)
    assert resumed["start_step"] == 4 and resumed["written"][-1] == 7
    assert _equal(resumed["state"], whole["state"])
    assert resumed["losses"] == whole["losses"][4:]
    assert checkpoint.latest_step(d) == 7
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out
    assert "step     6 loss" in out and " -> " in out and "stragglers: " in out


def test_launcher_refuses_other_families():
    with pytest.raises(ValueError):
        launcher._build("graph500", 8, 16, adamw.AdamWConfig(), "cpu")


# ---------------------------------------------------------------------------
# graph functions and the graph500 config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multiple", [1, 1000, 1024, 4096])
def test_relabel_by_degree_and_block_pad_match_jax(multiple):
    """Scale-10 Kronecker graph (edgefactor 16, seed 3): every array of the
    relabeled and the padded graph byte-identical to the reference's."""
    edges = kronecker.kronecker_edges(10, 16, seed=3)
    assert np.array_equal(edges, jkron.kronecker_edges(10, 16, seed=3))
    g, jg = builder.build_csr(edges, n=1 << 10), jbuilder.build_csr(edges, n=1 << 10)
    (r, perm), (jr, jperm) = graphgen.relabel_by_degree(g), jbuilder.relabel_by_degree(jg)
    assert np.array_equal(perm, jperm) and perm.dtype == jperm.dtype
    for a, b in ((r, jr), (builder.block_pad(r, multiple), jbuilder.block_pad(jr, multiple))):
        assert (a.n, a.m_input) == (b.n, b.m_input)
        for f in ("row_ptr", "col_idx", "src", "dst"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert r.m_input == g.m_input
    assert np.all(np.diff(r.degrees()) <= 0)  # hubs first
    assert builder.block_pad(g, multiple).n % multiple == 0


def test_graph500_config_equals_reference():
    jconfigs._load_all()  # the reference loads its modules only into an empty registry
    jspec, spec = jconfigs.get("graph500"), configs.get("graph500")
    assert (spec.family, spec.notes) == (jspec.family, jspec.notes)
    assert spec.family == "graph"
    assert [dataclasses.asdict(s) for s in spec.shapes] == \
        [dataclasses.asdict(s) for s in jspec.shapes]
    for make in ("model_config", "smoke_config"):
        assert dataclasses.asdict(getattr(spec, make)()) == \
            dataclasses.asdict(getattr(jspec, make)())
    assert sorted(configs.list_archs()) == sorted(jconfigs.list_archs())
