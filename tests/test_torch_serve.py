"""The port's slot-batched decode engine against the JAX package's.

The same weights (the reference's ``init_params(cfg, PRNGKey(0))``,
carried across as numpy) and the same requests go through
``repro.serve.engine.Engine`` and ``repro_torch.serve.engine.Engine`` in
fp32: 7 requests over 3 slots for every smoke arch and for the config of
``tests/test_serve.py``, each request's greedy tokens equal and the caches
after draining within ``TOL`` of their peak (the MoE archs drop routed
choices during decode, cap 1 at 3 slots, as the reference does).  Then the
reference's own engine checks in the port (drain, greedy against the
teacher-forced forward, slot isolation) for the dense archs, sampling
(reproducible for a seed; greedy at temperature 1e-6), ``bench.serve``
end to end on the CPU, and the engine refusing to start without a card.
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
from repro_torch.bench import serve as serve_bench
from repro_torch.configs import common as configs
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import params_from_numpy
from repro_torch.serve import engine as eng

ARCHS = ["gemma-2b", "minicpm-2b", "deepseek-coder-33b", "deepseek-v2-236b", "dbrx-132b"]
DENSE = ARCHS[:3]
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _serve_test_cfgs():
    """``tests/test_serve.py``'s config, in both packages."""
    kw = dict(name="serve-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
              d_ff=64, vocab=64, q_chunk=16, kv_chunk=16)
    return (jtfm.TransformerConfig(**kw, compute_dtype=jnp.float32),
            tfm.TransformerConfig(**kw, compute_dtype=torch.float32))


def _cfgs(arch):
    if arch == "serve-test":
        return _serve_test_cfgs()
    return (dataclasses.replace(jconfigs.get(arch).smoke_config(), compute_dtype=jnp.float32),
            dataclasses.replace(configs.get(arch).smoke_config(), compute_dtype=torch.float32))


_PARAMS: dict = {}


def _params(arch):
    if arch not in _PARAMS:
        jcfg, _ = _cfgs(arch)
        jp = jax.jit(lambda k: jtfm.init_params(jcfg, k))(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[arch]


def _prompts(vocab, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(2, 9))).astype(np.int32)
            for _ in range(n)]


def _run(module, cfg, params, prompts, slots=3, max_seq=48, max_new=4, **kw):
    e = module.Engine(cfg, params, batch_slots=slots, max_seq=max_seq, **kw)
    reqs = [module.Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        e.submit(r)
    e.run_until_drained()
    return e, reqs


@pytest.mark.parametrize("arch", ARCHS + ["serve-test"])
def test_engine_equals_reference_engine(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(arch)
    prompts = _prompts(cfg.vocab)
    je, jreqs = _run(jeng, jcfg, jp, prompts)
    e, reqs = _run(eng, cfg, p, prompts, device="cpu")
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    want = np.asarray(je.cache)
    assert np.abs(e.cache.numpy() - want).max() <= TOL * np.abs(want).max()
    assert np.array_equal(e.pos, je.pos)


@pytest.mark.parametrize("arch", DENSE)
def test_engine_drains_greedy_and_isolates_slots(arch):
    """``tests/test_serve.py``'s three checks, in the port."""
    _, cfg = _cfgs(arch)
    _, p = _params(arch)
    prompts = [np.arange(2 + i) % cfg.vocab for i in range(7)]
    _, reqs = _run(eng, cfg, p, prompts, device="cpu")
    assert all(r.done and len(r.out) == 4 for r in reqs)

    prompt = np.asarray([5, 9, 13, 21], np.int32)
    _, (req,) = _run(eng, cfg, p, [prompt], slots=2, max_seq=32, max_new=3, device="cpu")
    logits, _ = tfm.forward(cfg, p, torch.from_numpy(prompt)[None])
    assert req.out[0] == int(torch.argmax(logits[0, -1]))

    solo = np.asarray([1, 2, 3], np.int32)
    _, (r_solo,) = _run(eng, cfg, p, [solo], slots=1, max_seq=32, device="cpu")
    _, reqs = _run(eng, cfg, p, [np.arange(1 + i) % cfg.vocab for i in range(3)] + [solo],
                   slots=4, max_seq=32, device="cpu")
    assert reqs[-1].out == r_solo.out


def test_engine_sampling_is_reproducible_and_greedy_at_low_temperature():
    _, cfg = _cfgs("gemma-2b")
    _, p = _params("gemma-2b")
    prompts = _prompts(cfg.vocab, n=5, seed=1)
    runs = [[r.out for r in _run(eng, cfg, p, prompts, temperature=1.0, seed=s,
                                 max_new=8, device="cpu")[1]] for s in (3, 3, 4)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    greedy = [r.out for r in _run(eng, cfg, p, prompts, max_new=8, device="cpu")[1]]
    cold = [r.out for r in _run(eng, cfg, p, prompts, temperature=1e-6, seed=3, max_new=8,
                                device="cpu")[1]]
    assert cold == greedy


def test_bench_serve_smoke_on_cpu(capsys):
    out = serve_bench.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu",
                            "--requests", "5", "--slots", "3", "--max-new", "6"])
    assert out["finished"] == 5 and out["generated_tokens"] == 30
    assert out["peak_bytes"] is None and out["card"] == "cpu"
    assert "generated tokens/s" in capsys.readouterr().out
    cfg, params = serve_bench.model("minicpm-2b", layers=1, smoke=True, device="cpu")
    assert cfg.n_layers == 1 and params["layers"]["wq"].shape[0] == 1
    assert cfg.d_model == configs.get("minicpm-2b").smoke_config().d_model
    lens = [len(x) for x in serve_bench.prompts(512, 12, 16, 256)]
    assert min(lens) >= 16 and max(lens) <= 256


def test_engine_refuses_to_start_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("serve-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.Engine(cfg, _params("serve-test")[1])
