"""LM serving harness: an arch served through the slot-batched decode engine.

The port's counterpart of ``examples/serve_lm.py``.  Builds ``--arch`` at
its published widths (``--smoke``: its smoke widths), ``--layers`` cutting
the depth and nothing else, with random weights from a ``torch.Generator``
seeded ``--seed`` (fp32 parameters; ``--dtype`` the compute dtype), makes
``--requests`` prompts from the synthetic token pipeline
(``data.tokens.batch_at``, seed 0) at lengths drawn uniformly from
``--prompt-len`` by a numpy generator seeded ``--seed``, and serves them
over ``--slots`` slots of a ``--max-seq`` cache until the engine drains,
each request asking for ``--max-new`` tokens.  What is not given comes
from the arch's serving cell (:data:`CELLS`; :data:`SMOKE_CELL` with
``--smoke``).  Every tick is timed on the
host clock; a tick ends in the engine's one host read of the sampled
tokens, so it waits for the device.  It prints the ticks, the prompt and
generated tokens, generated tokens per second, the median ms per tick, the
weights' bytes and the peak device memory, each beside the card's name and
power limit (``cpu`` on the CPU, where no device number is measured).

    python -m repro_torch.bench.serve --arch gemma-2b      # 18 layers, max_seq 32768
    python -m repro_torch.bench.serve --arch dbrx-132b     # 2 layers, max_seq 2048
    python -m repro_torch.bench.serve --arch gemma-2b --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.bench import card
from repro_torch.configs import common as configs
from repro_torch.data import tokens as tok_data
from repro_torch.models import transformer as tfm
from repro_torch.serve import engine as eng

ARCHS = ("gemma-2b", "minicpm-2b", "deepseek-coder-33b", "deepseek-v2-236b", "dbrx-132b")
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
#: the serving cells on one H100, each arch at its published widths:
#: gemma-2b at full depth over the ``decode_32k`` shape's length (its global
#: batch of 128 cut to the 8 slots one card serves); the other four at the
#: depth one card holds with their fp32 weights and a bf16 copy, over a
#: 2,048-token cache
CELLS = {
    "gemma-2b": {"layers": None, "max_seq": 32768, "requests": 12, "prompt_len": (16, 256),
                 "max_new": 32},
    "minicpm-2b": {"layers": None, "max_seq": 2048, "requests": 8, "prompt_len": (16, 64),
                   "max_new": 16},
    "deepseek-coder-33b": {"layers": 8, "max_seq": 2048, "requests": 8, "prompt_len": (16, 64),
                           "max_new": 16},
    "dbrx-132b": {"layers": 2, "max_seq": 2048, "requests": 8, "prompt_len": (16, 64),
                  "max_new": 16},
    "deepseek-v2-236b": {"layers": 2, "max_seq": 2048, "requests": 8, "prompt_len": (16, 64),
                         "max_new": 16},
}
SLOTS = 8
#: the smoke widths' serving settings
SMOKE_CELL = {"layers": None, "max_seq": 256, "requests": 12, "prompt_len": (4, 32),
              "max_new": 32}


def model(arch: str, layers: int | None = None, smoke: bool = False, dtype: str = "bf16",
          seed: int = 0, device=None) -> tuple[tfm.TransformerConfig, dict]:
    """``arch``'s config (its depth cut to ``layers``, compute ``dtype``)
    and random fp32 parameters from a generator on ``device`` seeded
    ``seed``."""
    device = resolve_device(device)
    spec = configs.get(arch)
    cfg = spec.smoke_config() if smoke else spec.model_config()
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, compute_dtype=DTYPES[dtype])
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, tfm.init_params(cfg, gen, device)


def prompts(vocab: int, n: int, lo: int, hi: int, seed: int = 0) -> list[np.ndarray]:
    """``n`` prompts of the synthetic language (``batch_at`` step 0, seed 0)
    at lengths drawn uniformly from ``[lo, hi]``."""
    toks = tok_data.batch_at(tok_data.TokenPipelineConfig(vocab=vocab, batch=n, seq_len=hi), 0)
    lens = np.random.default_rng(seed).integers(lo, hi + 1, size=n)
    return [toks["tokens"][i, :ln] for i, ln in enumerate(lens)]


def weight_bytes(params, engine_params) -> tuple[int, int]:
    """Bytes of the parameters, and of the engine's compute-dtype copy (its
    leaves that are not the parameters' own tensors)."""
    own, cast = tree.leaves(params), tree.leaves(engine_params)
    return (sum(x.numel() * x.element_size() for x in own),
            sum(c.numel() * c.element_size() for p, c in zip(own, cast) if c is not p))


def serve(cfg, params, prompt_list, slots: int = 8, max_seq: int = 512, max_new: int = 32,
          temperature: float = 0.0, seed: int = 0, device=None) -> dict:
    """Serve ``prompt_list`` until the engine drains -> the requests, the
    ticks' ms, the tokens and the peak device memory (None on the CPU)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    e = eng.Engine(cfg, params, batch_slots=slots, max_seq=max_seq, temperature=temperature,
                   seed=seed, device=device)
    reqs = [eng.Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompt_list)]
    for r in reqs:
        e.submit(r)
    tick_ms = []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        if e.tick() == 0 and not e.pending:
            break
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        if len(tick_ms) > 100_000:
            raise RuntimeError("engine did not drain")
    wall_s = time.perf_counter() - t0
    generated = sum(len(r.out) for r in reqs)
    return {
        "requests": reqs, "engine": e, "ticks": len(tick_ms), "tick_ms": tick_ms,
        "wall_s": wall_s, "prompt_tokens": int(sum(len(p) for p in prompt_list)),
        "generated_tokens": generated, "tokens_per_s": generated / wall_s,
        "median_tick_ms": float(np.median(tick_ms)) if tick_ms else 0.0,
        "peak_bytes": torch.cuda.max_memory_allocated() if device.type == "cuda" else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b", choices=ARCHS)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (default: the cell's, CELLS)")
    ap.add_argument("--slots", type=int, default=SLOTS)
    ap.add_argument("--max-seq", type=int, default=None, help="cache length (the cell's)")
    ap.add_argument("--requests", type=int, default=None, help="(the cell's)")
    ap.add_argument("--prompt-len", default=None, help="lo-hi (the cell's)")
    ap.add_argument("--max-new", type=int, default=None, help="(the cell's)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke widths")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cell = SMOKE_CELL if args.smoke else CELLS[args.arch]
    max_seq = args.max_seq or cell["max_seq"]
    n_req = args.requests or cell["requests"]
    max_new = args.max_new or cell["max_new"]
    lo, hi = map(int, args.prompt_len.split("-")) if args.prompt_len else cell["prompt_len"]
    device = resolve_device(args.device)
    cfg, params = model(args.arch, args.layers or cell["layers"], args.smoke, args.dtype,
                        args.seed, device)
    res = serve(cfg, params, prompts(cfg.vocab, n_req, lo, hi, args.seed), args.slots,
                max_seq, max_new, args.temperature, args.seed, device)
    where = card(device)
    weights, copy = weight_bytes(params, res["engine"].params)
    cache = res["engine"].cache
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "compute_dtype": args.dtype, "slots": args.slots, "max_seq": max_seq,
           "requests": n_req, "max_new": max_new, "ticks": res["ticks"],
           "prompt_tokens": res["prompt_tokens"], "generated_tokens": res["generated_tokens"],
           "tokens_per_s": res["tokens_per_s"], "median_tick_ms": res["median_tick_ms"],
           "wall_s": res["wall_s"], "weight_bytes": weights,
           "compute_copy_bytes": copy,
           "cache_bytes": cache.numel() * cache.element_size(), "peak_bytes": res["peak_bytes"],
           "finished": sum(r.done for r in res["requests"]), "card": where}
    peak = ("not measured (CPU)" if res["peak_bytes"] is None
            else f"{res['peak_bytes'] / 2**30:.2f} GiB")
    print(f"# {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model}, {args.dtype} compute, "
          f"{args.slots} slots, max_seq {max_seq}, {n_req} requests of "
          f"{lo}-{hi} prompt tokens, max_new {max_new}, on {where}")
    print(f"ticks {res['ticks']}, prompt tokens {res['prompt_tokens']}, generated "
          f"{res['generated_tokens']}, {out['finished']}/{n_req} finished on {where}")
    print(f"generated tokens/s {res['tokens_per_s']:.2f}, median ms per tick "
          f"{res['median_tick_ms']:.3f}, wall {res['wall_s']:.3f} s on {where}")
    print(f"weights {weights:,} B (fp32) + compute copy {out['compute_copy_bytes']:,} B, cache "
          f"{out['cache_bytes']:,} B, peak memory {peak} on {where}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
