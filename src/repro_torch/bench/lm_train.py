"""LM training harness: an arch's train step on one device, or FSDP x TP
over a grid as the ``train_4k`` cells place it.

The counterpart of ``examples/train_lm.py`` and of ``launch/cells.py``'s
LM ``train`` cell.  Builds ``--arch`` at its published widths
(``--smoke``: its smoke widths), ``--layers`` cutting the depth and
nothing else, with random fp32 parameters from a ``torch.Generator``
seeded ``--seed`` and ``--dtype`` the compute dtype, and trains it
``--steps`` steps with AdamW (the cells' ``AdamWConfig()``) on
``--batch`` rows of ``--seq`` tokens of the synthetic token pipeline
(``data.tokens.batch_at``, seed 0, step k the k-th batch; each row ``seq -
1`` next-token targets, as the reference's ``loss_fn`` reads them).

Without ``--grid`` one device runs :func:`repro_torch.train.step.make_train_step`.
With ``--grid RxC`` the parameters, ``m`` and ``v`` are placed by
``param_specs`` (FSDP over the grid rows, TP over the columns) and the
batch over the rows (``shard_rows``), and
:func:`repro_torch.train.step.make_sharded_train_step` runs on a
``SimGrid`` (every rank on the one device), or with ``--procs gloo|nccl``
as R*C processes (:func:`repro_torch.comm.procgrid.spawn`; under nccl rank
p on ``cuda:p``), each drawing only its own slices of the weights
(``init_sharded``, the one-device model's values).

Each step is timed on the host clock and ends in a host read of its loss,
so it waits for the device.  It prints each step's loss and gradient
norm, the median seconds a step after the first (the warm-up), tokens a
second at that median, the peak device memory a card, and each process's
(a ``SimGrid``'s first rank's) collective bytes of one step by kind
(:func:`repro_torch.launch.roofline.count_collectives`: one rank's result
bytes, all-reduces doubled), beside the card's name and power limit.

    python -m repro_torch.bench.lm_train --smoke --device cpu
    python -m repro_torch.bench.lm_train --smoke --device cpu --grid 2x2 [--procs gloo]
    python -m repro_torch.bench.lm_train --arch gemma-2b --layers 18 --batch 8 \\
        --grid 2x2 --procs nccl --dtype bf16            # four cards
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.bench import card
from repro_torch.bench import serve as serve_bench
from repro_torch.comm import SimGrid, procgrid
from repro_torch.data import tokens as tok_data
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

#: the ``train_4k`` cells' sequence; their global batch of 256 is cut to
#: what the run's cards hold
SEQ = 4096
BATCH = 8
STEPS = 3
#: the smoke widths' run
SMOKE = {"batch": 4, "seq": 65, "steps": 3}


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products without TF32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def token_rows(cfg: tfm.TransformerConfig, batch: int, seq: int, step: int) -> np.ndarray:
    """The ``step``-th (batch, seq) int32 batch of the synthetic pipeline."""
    pipe = tok_data.TokenPipelineConfig(vocab=cfg.vocab, batch=batch, seq_len=seq)
    return tok_data.batch_at(pipe, step)["tokens"]


def draw_sharded(cfg: tfm.TransformerConfig, grid, seed: int = 0) -> tuple[list, dict]:
    """The local ranks' train states (their slices of ``init_params(cfg,
    Generator(seed))`` on the grid's device, zero moments) and the specs."""
    specs = tsh.serving_specs(cfg, grid)
    gen = torch.Generator(device=grid.device).manual_seed(seed)
    params = tsh.init_sharded(cfg, gen, grid, specs)
    return grid.local(lambda p: tstep.init_state(params[p])), specs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: tfm.TransformerConfig, state, batch: int, seq: int, steps: int, device=None,
          grid=None, specs=None, log: bool = False) -> dict:
    """``steps`` steps from ``state`` (one device's :class:`TrainState`, or
    with ``grid`` the local ranks' list) on batches 0, 1, ... -> the new
    state, each step's seconds, loss and gradient norm, the collective
    bytes of the last step (``grid``: this process's first rank) and the
    peak device memory (None on the CPU)."""
    device = resolve_device(device if grid is None else grid.device)
    opt_cfg = adamw.AdamWConfig()
    if grid is None:
        step = tstep.make_train_step(lambda p, b: tfm.loss_fn(cfg, p, b), opt_cfg)
    else:
        step = tstep.make_sharded_train_step(cfg, grid, specs, opt_cfg)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    secs, losses, norms, coll = [], [], [], None
    for k in range(steps):
        toks = torch.as_tensor(token_rows(cfg, batch, seq, k), device=device)
        counting = roofline.count_collectives(grid) if grid is not None and k == steps - 1 \
            else None
        t0 = time.perf_counter()
        if grid is None:
            state, metrics = step(state, {"tokens": toks})
        elif counting is None:
            state, metrics = step(state, tsh.shard_rows(grid, toks))
        else:
            with counting as counted:
                state, metrics = step(state, tsh.shard_rows(grid, toks))
            coll = dict(counted.per_op)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
        norms.append(float(metrics["grad_norm"]))
        if log:
            print(f"  step {k}: loss {losses[-1]:.6f} grad norm {norms[-1]:.6f} "
                  f"{secs[-1]:.3f} s", flush=True)
    return {"state": state, "step_s": secs, "loss": losses, "grad_norm": norms,
            "median_step_s": float(np.median(secs[1:] if len(secs) > 1 else secs)),
            "tokens_per_step": batch * (seq - 1), "collective_bytes": coll,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None}


def traced_step(cfg, grid, specs, states, batch: int, seq: int, k: int) -> dict | None:
    """One more step (batch ``k``) on every process, traced by
    ``torch.profiler`` on rank 0: its wall ms and device ms by kernel class
    (NCCL's, matrix products', the rest) and NCCL's share of the device
    time; None on the other ranks."""
    step = tstep.make_sharded_train_step(cfg, grid, specs, adamw.AdamWConfig())
    toks = tsh.shard_rows(grid, torch.as_tensor(token_rows(cfg, batch, seq, k),
                                                device=grid.device))
    if grid.local_ranks[0] != 0:
        float(step(states, toks)[1]["loss"])
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _sync(grid.device)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        float(step(states, toks)[1]["loss"])
        _sync(grid.device)
    wall = (time.perf_counter() - t0) * 1e3
    ms: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count:
            k_ = serve_bench.kernel_class(ev.key)
            ms[k_] = ms.get(k_, 0.0) + ev.self_device_time_total / 1e3
    total = sum(ms.values())
    return {"wall_ms": wall, "device_ms": ms,
            "nccl_share": ms.get("nccl", 0.0) / total if total else None}


def reference_grads(cfg: tfm.TransformerConfig, params, tokens: torch.Tensor, path: str) -> dict:
    """The one-device loss, gradient and global norm of ``params`` on
    ``tokens``, the gradient tree saved to ``path`` (CPU tensors, read by
    the processes through ``mmap``) -> the loss, norm and each leaf's peak
    |gradient|."""
    loss, grads = tstep.value_and_grad(lambda p, b: tfm.loss_fn(cfg, p, b), params,
                                       {"tokens": tokens})
    norm = adamw.global_norm(grads)
    peaks = [float(g.abs().max()) for g in tree.leaves(grads)]
    torch.save(tree.tree_map(lambda g: g.cpu(), grads), path)
    return {"loss": float(loss), "grad_norm": float(norm), "peaks": peaks, "path": path}


def held_against(cfg: tfm.TransformerConfig, grid, specs, states, tokens: torch.Tensor,
                 ref: dict) -> dict:
    """The sharded loss, gradient slices and norm of ``states`` on
    ``tokens`` against the one-device reference (:func:`reference_grads`),
    and one AdamW step of each local rank's slices against the one-device
    step's on the same slices (the reference gradient through
    ``adamw.apply``, elementwise, so equal to the slice of the one-device
    step's result).  Returns the loss's and the norm's relative gaps, the
    largest gradient gap over its leaf's peak, and the AdamW rule's
    reading: the largest gap over the leaf's peak where the reference's
    |gradient| exceeds 1e-4 of its peak, and the largest gap over the
    learning rate elsewhere (the first step moves by about ``lr *
    sign(g)``, whose sign a sum in another order can flip near 0)."""
    loss, grads, norm = tstep.sharded_value_and_grad(
        cfg, grid, specs, grid.local(lambda p: states[p].params), tsh.shard_rows(grid, tokens))
    want = torch.load(ref["path"], mmap=True)
    spec_list = meshlib.spec_leaves(specs)
    opt_cfg = adamw.AdamWConfig()
    lr = float(adamw.wsd_schedule(opt_cfg, torch.ones((), dtype=torch.int32)))
    ref_norm = torch.tensor(ref["grad_norm"], dtype=torch.float32, device=grid.device)
    out = {"loss_rel": abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
           "norm_rel": abs(float(norm[grid.local_ranks[0]]) - ref["grad_norm"])
           / ref["grad_norm"], "grad_rel": 0.0, "param_rel": 0.0, "param_lr": 0.0}
    for p in grid.local_ranks:
        mine = adamw.apply(opt_cfg, states[p].params, grads[p], states[p].opt, norm=norm[p])[0]
        for k, (g, w, sp, x, new) in enumerate(zip(
                tree.leaves(grads[p]), tree.leaves(want), spec_list,
                tree.leaves(states[p].params), tree.leaves(mine))):
            w = tsh.shard_leaf(w, sp, grid, p).to(grid.device)
            peak = ref["peaks"][k]
            out["grad_rel"] = max(out["grad_rel"], float((g - w).abs().max()) / peak)
            one = adamw.apply(opt_cfg, [x], [w], adamw.init([x]), norm=ref_norm)[0][0]
            gap = (new - one).abs()
            big = w.abs() > 1e-4 * peak
            x_peak = float(x.abs().max()) or 1.0
            if big.any():
                out["param_rel"] = max(out["param_rel"], float(gap[big].max()) / x_peak)
            if (~big).any():
                out["param_lr"] = max(out["param_lr"], float(gap[~big].max()) / lr)
    return out


def proc_train(grid, spec: dict) -> dict:
    """One process of a grid (:func:`repro_torch.comm.procgrid.spawn`):
    each case of ``spec["cases"]`` in turn, on this grid or, for a case
    whose ``shape`` differs, on a new ``ProcessGrid`` of the same
    processes.  A case draws ``arch`` (``layers``, ``smoke``, ``dtype``,
    ``seed``) as this rank's slices, then with ``reference`` (a
    :func:`reference_grads` dict) holds the first batch's step against it
    (:func:`held_against`), with ``loss_only`` returns the first batch's
    loss and norm, and otherwise trains ``steps`` steps (:func:`train`),
    with ``trace`` one more traced on rank 0 (:func:`traced_step`), with
    ``keep`` returning the rank's new params as numpy arrays.
    Returns this rank, its card and each case's figures."""
    from repro_torch.comm.procgrid import ProcessGrid

    out = {"rank": grid.local_ranks[0], "device": str(grid.device), "cases": []}
    for case in spec["cases"]:
        shape = tuple(case.get("shape", (grid.rows, grid.cols)))
        pg = grid if shape == (grid.rows, grid.cols) else ProcessGrid(*shape,
                                                                     device=grid.device)
        cfg = serve_bench.config(case["arch"], case.get("layers"), case.get("smoke", False),
                                 case.get("dtype", "bf16"))
        t0 = time.perf_counter()
        states, specs = draw_sharded(cfg, pg, case.get("seed", 0))
        _sync(pg.device)
        rec = {"init_s": time.perf_counter() - t0, "shape": list(shape),
               "rank": pg.local_ranks[0]}
        toks = torch.as_tensor(token_rows(cfg, case["batch"], case["seq"], 0), device=pg.device)
        if case.get("reference"):
            with no_tf32():
                rec.update(held_against(cfg, pg, specs, states, toks, case["reference"]))
        elif case.get("loss_only"):
            loss, _, norm = tstep.sharded_value_and_grad(
                cfg, pg, specs, pg.local(lambda p: states[p].params), tsh.shard_rows(pg, toks))
            rec.update(loss=float(loss), grad_norm=float(norm[pg.local_ranks[0]]))
        else:
            res = train(cfg, states, case["batch"], case["seq"], case["steps"], grid=pg,
                        specs=specs, log=case.get("log", False) and pg.local_ranks[0] == 0)
            states = res.pop("state")
            rec.update(res)
            if case.get("keep"):  # this rank's new params, for a bit-for-bit check
                rec["params"] = [x.cpu().numpy()
                                 for x in tree.leaves(states[pg.local_ranks[0]].params)]
            if case.get("trace") and pg.device.type == "cuda":
                rec["trace"] = traced_step(cfg, pg, specs, states, case["batch"], case["seq"],
                                           case["steps"])
        del states
        if pg.device.type == "cuda":
            torch.cuda.empty_cache()
        out["cases"].append(rec)
    return out


def _gib(x) -> str:
    return "not measured (CPU)" if x is None else f"{x / 2**30:.2f} GiB"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b", choices=serve_bench.ARCHS)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--batch", type=int, default=None, help=f"rows a step ({BATCH})")
    ap.add_argument("--seq", type=int, default=None, help=f"tokens a row ({SEQ})")
    ap.add_argument("--steps", type=int, default=None, help=f"({STEPS})")
    ap.add_argument("--dtype", default="bf16", choices=sorted(serve_bench.DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke widths")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--grid", default=None, help="RxC: FSDP rows x TP columns")
    ap.add_argument("--procs", default=None, choices=["gloo", "nccl"],
                    help="the grid as R*C processes over this backend (default: a SimGrid)")
    args = ap.parse_args(argv)
    if args.procs and not args.grid:
        ap.error("--procs needs --grid")
    base = SMOKE if args.smoke else {"batch": BATCH, "seq": SEQ, "steps": STEPS}
    batch, seq = args.batch or base["batch"], args.seq or base["seq"]
    steps = args.steps or base["steps"]
    cfg = serve_bench.config(args.arch, args.layers, args.smoke, args.dtype)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "compute_dtype": args.dtype, "batch": batch, "seq": seq, "steps": steps,
           "grid": args.grid, "procs": args.procs}
    if args.procs:
        shape = tuple(int(k) for k in args.grid.split("x"))
        case = {"arch": args.arch, "layers": args.layers, "smoke": args.smoke,
                "dtype": args.dtype, "seed": args.seed, "batch": batch, "seq": seq,
                "steps": steps, "log": True}
        runs = procgrid.spawn(proc_train, *shape, backend=args.procs, device=args.device,
                              args=({"cases": [case]},))
        recs = [r["cases"][0] for r in runs]
        res = recs[0]
        where = (f"{shape[0] * shape[1]} processes over {args.procs} on "
                 + ("the CPU" if args.device == "cpu" else
                    "; ".join(sorted({card(r["device"]) for r in runs}))))
        out.update({k: res[k] for k in ("loss", "grad_norm", "step_s", "median_step_s",
                                        "tokens_per_step")},
                   peak_bytes=[r["peak_bytes"] for r in recs],
                   collective_bytes=[r["collective_bytes"] for r in recs],
                   ranks_agree=all(r["loss"] == res["loss"] for r in recs), card=where)
        if not out["ranks_agree"]:
            raise SystemExit("lm_train: the processes' losses differ")
    else:
        device = resolve_device(args.device)
        if args.grid:
            grid = SimGrid(*(int(k) for k in args.grid.split("x")), device)
            state, specs = draw_sharded(cfg, grid, args.seed)
        else:
            grid = specs = None
            gen = torch.Generator(device=device).manual_seed(args.seed)
            state = tstep.init_state(tfm.init_params(cfg, gen, device))
        res = train(cfg, state, batch, seq, steps, device, grid=grid, specs=specs, log=True)
        where = card(device) + (f", SimGrid {args.grid}" if grid else "")
        out.update({k: res[k] for k in ("loss", "grad_norm", "step_s", "median_step_s",
                                        "tokens_per_step")},
                   peak_bytes=[res["peak_bytes"]], collective_bytes=[res["collective_bytes"]],
                   card=where)
    out["tokens_per_s"] = out["tokens_per_step"] / out["median_step_s"]
    print(f"# {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model}, {args.dtype} compute, "
          f"{batch} rows of {seq} tokens, {steps} steps"
          + (f", grid {args.grid}" if args.grid else "") + f", on {where}")
    print(f"loss {[round(x, 6) for x in out['loss']]}, grad norm "
          f"{[round(x, 6) for x in out['grad_norm']]} on {where}")
    print(f"median s a step {out['median_step_s']:.4f} (after the first), tokens/s "
          f"{out['tokens_per_s']:.1f}, steps {[round(x, 4) for x in out['step_s']]} s on {where}")
    print(f"peak memory a card {', '.join(_gib(x) for x in out['peak_bytes'])} on {where}")
    if args.grid:
        for k, c in enumerate(out["collective_bytes"]):
            print(f"collective bytes of the last step, process {k}: {c}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
