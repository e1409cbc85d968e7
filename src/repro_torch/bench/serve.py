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

With ``--grid RxC`` the same requests are served by the grid engine
(:class:`repro_torch.serve.engine.GridEngine`, the weights placed FSDP x TP
by ``param_specs``): on a ``SimGrid``
(every rank on the one device), or with ``--procs nccl|gloo`` as R*C
processes (:func:`repro_torch.comm.procgrid.spawn`; under nccl rank p on
``cuda:p``), each drawing only its own slices of the weights
(``init_sharded``, the same values as the one-device model's).  The
processes' figures are rank 0's ticks and every rank's peak memory.

    python -m repro_torch.bench.serve --arch gemma-2b      # 18 layers, max_seq 32768
    python -m repro_torch.bench.serve --arch dbrx-132b     # 2 layers, max_seq 2048
    python -m repro_torch.bench.serve --arch gemma-2b --smoke --device cpu
    python -m repro_torch.bench.serve --arch gemma-2b --smoke --device cpu --grid 2x2
    python -m repro_torch.bench.serve --arch deepseek-coder-33b --layers 62 --grid 1x4 --procs nccl
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
from repro_torch.comm import SimGrid, procgrid
from repro_torch.configs import common as configs
from repro_torch.data import tokens as tok_data
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh
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


def config(arch: str, layers: int | None = None, smoke: bool = False,
           dtype: str = "bf16") -> tfm.TransformerConfig:
    """``arch``'s config, its depth cut to ``layers``, compute ``dtype``."""
    spec = configs.get(arch)
    cfg = spec.smoke_config() if smoke else spec.model_config()
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, compute_dtype=DTYPES[dtype])


def model(arch: str, layers: int | None = None, smoke: bool = False, dtype: str = "bf16",
          seed: int = 0, device=None) -> tuple[tfm.TransformerConfig, dict]:
    """``arch``'s config (:func:`config`) and random fp32 parameters from
    a generator on ``device`` seeded ``seed``."""
    device = resolve_device(device)
    cfg = config(arch, layers, smoke, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cfg, tfm.init_params(cfg, gen, device)


def model_sharded(cfg: tfm.TransformerConfig, grid, seed: int = 0):
    """The local ranks' slices of :func:`model`'s parameters on ``grid``
    (the same values, drawn on the grid's device), and their specs."""
    specs = tsh.serving_specs(cfg, grid)
    gen = torch.Generator(device=grid.device).manual_seed(seed)
    return tsh.init_sharded(cfg, gen, grid, specs), specs


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
          temperature: float = 0.0, seed: int = 0, device=None, keep_logits: bool = False,
          grid=None, specs=None, log_every: int = 0) -> dict:
    """Serve ``prompt_list`` until the engine drains -> the requests, the
    ticks' ms, the tokens and the peak device memory (None on the CPU).
    With ``grid``, ``params`` are its ranks' slices and the grid engine
    serves.  ``keep_logits`` keeps each tick's (B, V_pad) logits on the host
    (a grid's: its first local rank's rows) and the (B,) tokens the tick
    fed; ``log_every`` prints the ticks and seconds so far every that many
    ticks."""
    device = resolve_device(device if grid is None else grid.device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    if grid is None:
        e = eng.Engine(cfg, params, batch_slots=slots, max_seq=max_seq,
                       temperature=temperature, seed=seed, device=device)
    else:
        e = eng.GridEngine(cfg, params, grid, specs, batch_slots=slots, max_seq=max_seq,
                           temperature=temperature, seed=seed)
    reqs = [eng.Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompt_list)]
    for r in reqs:
        e.submit(r)
    tick_ms, logits, fed = [], [], []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        feeding = e._next_tok.copy()
        if e.tick() == 0 and not e.pending:
            break
        tick_ms.append((time.perf_counter() - t1) * 1e3)
        if log_every and len(tick_ms) % log_every == 0:
            print(f"  {len(tick_ms)} ticks in {time.perf_counter() - t0:.1f} s", flush=True)
        if keep_logits:
            x = e.logits if grid is None else e.logits[grid.local_ranks[0]]
            logits.append(x.float().cpu().numpy())
            fed.append(feeding)
        if len(tick_ms) > 100_000:
            raise RuntimeError("engine did not drain")
    wall_s = time.perf_counter() - t0
    generated = sum(len(r.out) for r in reqs)
    return {
        "requests": reqs, "engine": e, "ticks": len(tick_ms), "tick_ms": tick_ms,
        "wall_s": wall_s, "prompt_tokens": int(sum(len(p) for p in prompt_list)),
        "generated_tokens": generated, "tokens_per_s": generated / wall_s,
        "median_tick_ms": float(np.median(tick_ms)) if tick_ms else 0.0,
        "peak_bytes": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                       else None),
        "logits": logits, "fed": fed,
    }


def agreeing_gap(logits: list, fed: list, want_logits, want_fed, rows: slice) -> tuple:
    """The largest gap of a run's per-tick logits (``rows`` of the slots)
    to a reference's, over the reference's peak, each slot compared up to
    the tick at which the two runs first fed it different tokens (past it
    its inputs differ; the schedule does not depend on the tokens) ->
    (gap, (tick, slot) pairs compared, pairs in all)."""
    n = min(len(logits), len(want_logits))
    got = np.stack(logits[:n])
    want = np.asarray(want_logits[:n], np.float32)[:, rows]
    same = np.cumprod(np.stack(fed[:n])[:, rows] == np.asarray(want_fed[:n])[:, rows], 0) > 0
    gap = float(np.abs(got - want).max(-1)[same].max()) if same.any() else float("inf")
    return gap / float(np.abs(want_logits).max()), int(same.sum()), same.size


def kernel_class(name: str) -> str:
    """A CUDA kernel of a decode tick: NCCL's, a matrix product's, or the
    rest (elementwise, reductions, copies)."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    return "gemm" if any(k in low for k in ("gemm", "gemv", "cutlass", "sm90_xmma")) else "other"


def primed(cfg, params, grid, specs, prompts, kw, ticks: int) -> eng.GridEngine:
    """A fresh grid engine given ``prompts`` and ticked ``ticks`` times."""
    e = eng.GridEngine(cfg, params, grid, specs, batch_slots=kw["slots"], max_seq=kw["max_seq"])
    for r, p in enumerate(prompts):
        e.submit(eng.Request(rid=r, prompt=p, max_new=kw["max_new"]))
    for _ in range(ticks):
        e.tick()
    return e


def traced_ticks(cfg, params, grid, specs, prompts, kw, n: int) -> dict | None:
    """``n`` ticks of a fresh grid engine serving ``prompts`` after 4
    untraced ones, traced by ``torch.profiler`` on rank 0 (every rank runs
    the ticks): the wall ms a tick and the device ms a tick by
    :func:`kernel_class`; None on the other ranks."""
    e = primed(cfg, params, grid, specs, prompts, kw, 4)
    if grid.local_ranks[0] != 0:
        for _ in range(n):
            e.tick()
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(grid.device)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            e.tick()
        torch.cuda.synchronize(grid.device)
    wall = (time.perf_counter() - t0) * 1e3 / n
    ms: dict[str, float] = {}
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count:
            k = kernel_class(ev.key)
            ms[k] = ms.get(k, 0.0) + ev.self_device_time_total / 1e3 / n
            launches += ev.count
    return {"ticks": n, "wall_ms": wall, "device_ms": ms, "kernels_per_tick": launches / n}


def launch_us(device, n: int = 2000) -> float:
    """The host's microseconds to launch one tiny kernel (``n`` in-place
    adds of one element, the card drained before and after): what a
    host-bound tick costs a kernel in this process."""
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return dt / n * 1e6


#: the runs :func:`proc_serve` may serve after the timed one, each held
#: against a one-device reference: compute dtype and float32 matmul precision
VARIANTS = {"tf32": ("fp32", "high"), "bf16": ("bf16", "highest")}


def held_run(cfg, params, prompts, kw, ref: str, rows: slice, precision: str = "highest") -> dict:
    """``prompts`` served once more with the float32 matmul ``precision``
    (``"high"``: TF32), its tokens and :func:`agreeing_gap` against the
    reference ``ref`` (an ``.npz`` of the one-device engine's ``logits``
    and ``fed`` a tick)."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        res = serve(cfg, params, prompts, keep_logits=True, **kw)
    finally:
        torch.set_float32_matmul_precision(saved)
    with np.load(ref) as want:
        gap, compared, pairs = agreeing_gap(res["logits"], res["fed"], want["logits"],
                                            want["fed"], rows)
        ticks = len(want["fed"])
    return {"tokens": [r.out for r in res["requests"]], "ticks": res["ticks"], "ref_ticks": ticks,
            "logit_gap": gap, "compared": compared, "pairs": pairs}


def proc_serve(grid, spec: dict) -> dict:
    """One process of a grid (:func:`repro_torch.comm.procgrid.spawn`):
    ``spec["arch"]`` (``layers``, ``smoke``, ``dtype``, ``seed``) drawn as
    this rank's slices, ``spec["prompts"]`` served
    by the grid engine (``slots``, ``max_seq``, ``max_new``,
    ``temperature``), after ``spec["warmup"]`` ticks of the same requests
    on a throwaway engine (rank 0 prints its progress every
    ``spec["log_every"]`` ticks).  With ``spec["reference"]`` (an ``.npz``
    of the one-device engine's ``logits``, a (B, V_pad) block a tick, and
    the ``fed`` tokens) each tick's logits of this rank's slots are held
    against it (:func:`agreeing_gap`).  ``spec["variants"]``: (name of
    :data:`VARIANTS`, reference ``.npz``) pairs, each served after the
    timed run on the same weights and held against its reference
    (:func:`held_run`).  Returns the rank's figures (on a card
    :func:`launch_us` before the timed run), its requests' tokens, the gaps,
    (``spec["trace"]``, on a card) :func:`traced_ticks` on rank 0, and
    (``spec["keep"]``) its cache block and last logits as numpy arrays, and with
    ``spec["prefill"]`` (token ids (B, S)) its block of the sharded
    prefill's logits."""
    cfg = config(spec["arch"], spec.get("layers"), spec.get("smoke", False),
                 spec.get("dtype", "bf16"))
    t0 = time.perf_counter()
    params, specs = model_sharded(cfg, grid, spec.get("seed", 0))
    cuda = grid.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(grid.device)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(grid.device) if cuda else None
    loud = spec.get("log_every", 0) if grid.local_ranks[0] == 0 else 0
    if loud:
        print(f"  rank 0 of {grid}: drew its weights in {init_s:.1f} s", flush=True)
    prompts = [np.asarray(x, np.int32) for x in spec["prompts"]]
    kw = dict(slots=spec["slots"], max_seq=spec["max_seq"], max_new=spec["max_new"],
              temperature=spec.get("temperature", 0.0), seed=spec.get("seed", 0), grid=grid,
              specs=specs)
    if spec.get("warmup"):
        primed(cfg, params, grid, specs, prompts, kw, spec["warmup"])
        if loud:
            print(f"  rank 0: {spec['warmup']} warm-up ticks done", flush=True)
    ref = spec.get("reference")
    host_us = launch_us(grid.device) if cuda else None
    res = serve(cfg, params, prompts, keep_logits=ref is not None, log_every=loud, **kw)
    p = grid.local_ranks[0]
    out = {"rank": p, "device": str(grid.device), "init_s": init_s, "init_peak_bytes": init_peak,
           "tokens": [r.out for r in res["requests"]], "launch_us": host_us,
           **{k: res[k] for k in ("ticks", "tick_ms", "wall_s", "prompt_tokens",
                                  "generated_tokens", "tokens_per_s", "median_tick_ms",
                                  "peak_bytes")}}
    b = kw["slots"] // grid.rows
    rows = slice((p // grid.cols) * b, (p // grid.cols + 1) * b)
    if ref is not None:
        with np.load(ref) as want:
            out["logit_gap"], out["compared"], out["pairs"] = agreeing_gap(
                res["logits"], res["fed"], want["logits"], want["fed"], rows)
            out["ref_ticks"] = len(want["fed"])
    out["variants"] = {}
    for name, vref in spec.get("variants", ()):
        dtype, precision = VARIANTS[name]
        vcfg = dataclasses.replace(cfg, compute_dtype=DTYPES[dtype])
        out["variants"][name] = held_run(vcfg, params, prompts, kw, vref, rows, precision)
    if spec.get("trace") and cuda:
        out["trace"] = traced_ticks(cfg, params, grid, specs, prompts, kw, spec["trace"])
    if spec.get("keep"):
        out["cache"] = res["engine"].cache[p].cpu().numpy()
        out["logits"] = res["engine"].logits[p].cpu().numpy()
    if spec.get("prefill") is not None:
        toks = torch.as_tensor(np.asarray(spec["prefill"], np.int32), device=grid.device)
        out["prefill"] = tsh.prefill(cfg, grid, params, tsh.shard_rows(grid, toks),
                                     specs)[p].cpu().numpy()
    return out


def rank_bytes(tree_) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(tree_))


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
    ap.add_argument("--grid", default=None, help="RxC: serve on a grid (FSDP rows x TP columns)")
    ap.add_argument("--procs", default=None, choices=["gloo", "nccl"],
                    help="the grid as R*C processes over this backend (default: a SimGrid)")
    args = ap.parse_args(argv)

    cell = SMOKE_CELL if args.smoke else CELLS[args.arch]
    max_seq = args.max_seq or cell["max_seq"]
    n_req = args.requests or cell["requests"]
    max_new = args.max_new or cell["max_new"]
    lo, hi = map(int, args.prompt_len.split("-")) if args.prompt_len else cell["prompt_len"]
    layers = args.layers or cell["layers"]
    if args.procs and not args.grid:
        ap.error("--procs needs --grid")
    cfg = config(args.arch, layers, args.smoke, args.dtype)
    prompt_list = prompts(cfg.vocab, n_req, lo, hi, args.seed)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "compute_dtype": args.dtype, "slots": args.slots, "max_seq": max_seq,
           "requests": n_req, "max_new": max_new, "grid": args.grid, "procs": args.procs}
    if args.procs:
        shape = tuple(int(k) for k in args.grid.split("x"))
        spec = {"arch": args.arch, "layers": layers, "smoke": args.smoke, "dtype": args.dtype,
                "seed": args.seed, "slots": args.slots,
                "max_seq": max_seq, "max_new": max_new, "temperature": args.temperature,
                "prompts": [x.tolist() for x in prompt_list]}
        runs = procgrid.spawn(proc_serve, *shape, backend=args.procs, device=args.device,
                              args=(spec,))
        res = runs[0]
        where = (f"{shape[0] * shape[1]} processes over {args.procs} on "
                 + ("the CPU" if args.device == "cpu" else
                    "; ".join(sorted({card(r["device"]) for r in runs}))))
        same = all(r["tokens"] == res["tokens"] for r in runs)
        out.update({k: res[k] for k in ("ticks", "prompt_tokens", "generated_tokens",
                                        "tokens_per_s", "median_tick_ms", "wall_s")},
                   peak_bytes=[r["peak_bytes"] for r in runs], init_s=[r["init_s"] for r in runs],
                   finished=sum(len(t) == max_new for t in res["tokens"]),
                   ranks_agree=same, card=where)
        if not same:
            raise SystemExit("serve: the processes picked different tokens")
        sizes = ""
    else:
        device = resolve_device(args.device)
        if args.grid:
            grid = SimGrid(*(int(k) for k in args.grid.split("x")), device)
            params, specs = model_sharded(cfg, grid, args.seed)
        else:
            grid = specs = None
            params = model(args.arch, layers, args.smoke, args.dtype, args.seed, device)[1]
        res = serve(cfg, params, prompt_list, args.slots, max_seq, max_new, args.temperature,
                    args.seed, device, grid=grid, specs=specs)
        where = card(device) + (f", SimGrid {args.grid}" if grid else "")
        e = res["engine"]
        if grid is None:
            weights, copy = weight_bytes(params, e.params)
            cache = e.cache.numel() * e.cache.element_size()
        else:  # every rank's, summed
            weights = sum(rank_bytes(x) for x in params)
            copy = sum(weight_bytes(x, y)[1] for x, y in zip(params, e.params))
            cache = sum(rank_bytes(x) for x in e.cache)
        out.update({k: res[k] for k in ("ticks", "prompt_tokens", "generated_tokens",
                                        "tokens_per_s", "median_tick_ms", "wall_s",
                                        "peak_bytes")},
                   weight_bytes=weights, compute_copy_bytes=copy, cache_bytes=cache,
                   finished=sum(r.done for r in res["requests"]), card=where)
        sizes = (f"weights {weights:,} B (fp32) + compute copy {copy:,} B, cache {cache:,} B, ")
    peaks = out["peak_bytes"] if isinstance(out["peak_bytes"], list) else [out["peak_bytes"]]
    peak = ("not measured (CPU)" if peaks[0] is None
            else ", ".join(f"{x / 2**30:.2f} GiB" for x in peaks))
    print(f"# {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model}, {args.dtype} compute, "
          f"{args.slots} slots, max_seq {max_seq}, {n_req} requests of "
          f"{lo}-{hi} prompt tokens, max_new {max_new}"
          + (f", grid {args.grid}" if args.grid else "")
          + f", on {where}")
    print(f"ticks {out['ticks']}, prompt tokens {out['prompt_tokens']}, generated "
          f"{out['generated_tokens']}, {out['finished']}/{n_req} finished on {where}")
    print(f"generated tokens/s {out['tokens_per_s']:.2f}, median ms per tick "
          f"{out['median_tick_ms']:.3f}, wall {out['wall_s']:.3f} s on {where}")
    print(f"{sizes}peak memory {peak} on {where}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
