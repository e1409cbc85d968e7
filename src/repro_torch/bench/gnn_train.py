"""2D GNN training harness: the 2D train step (straight-through int8
payloads for GraphCast) and AdamW (WSD) on the multimesh, on a simulated
grid or as one process per rank.

The counterpart of ``examples/train_gnn.py`` and of ``launch/cells.py``'s
``graph_train_2d`` cell (``gnn_dist.build_2d_train_step``, int8 payloads
for ``graphcast``, fp32 for ``egnn`` and ``nequip``: :data:`INT8_ARCHS`).
It reuses :mod:`repro_torch.bench.gnn`'s set-up — the refinement-r
multimesh partitioned onto an R x C grid, the synthetic fields, the
positions and parameters from ``--seed`` — and adds integer targets over
``d_out`` classes made from the same seed (cross-entropy, as the
reference's 2D step computes it), and trains ``--arch`` as the cell does.
GraphCast's depth is cut to :data:`LAYERS` (4: the saved activations of 16
full-width layers exceed one card); EGNN and NequIP keep theirs.  After
one uncounted warm-up step (loss and gradients, no update), each of
``--steps`` steps runs, each part timed with device synchronization:

* forward + backward: :func:`repro_torch.models.gnn_dist.value_and_grad_2d`
  (the loss ``pmean``ed over the grid, each rank's gradients through the
  grid's transposed collectives);
* the gradient ``pmean`` over the grid (``comm.grid.pmean_trees``);
* AdamW (:func:`repro_torch.optim.adamw.apply`, the WSD warmup of
  ``examples/train_gnn.py``: lr 1e-3, 5 warmup steps).

It reports each step's loss and times; the forward's payload bytes int8
and fp32 (:func:`repro_torch.bench.gnn.payload_bytes`) and the backward's
fp32 cotangent bytes and the gradient mean's (:func:`cotangent_bytes`),
counted from the shapes; the peak device memory; and, with ``--procs``,
each process's staging seconds (host copies of gloo's CUDA tensors).

    python -m repro_torch.bench.gnn_train                # graphcast, 4 layers, refinement 6, 2x2
    python -m repro_torch.bench.gnn_train --arch nequip  # egnn, nequip (fp32 payloads)
    python -m repro_torch.bench.gnn_train --procs 4      # the 2x2 grid as 4 processes (gloo)
    python -m repro_torch.bench.gnn_train --device cpu --refine 2 --smoke [--arch egnn]

On ``SimGrid`` the R*C ranks run on one card one after another; under
``--procs`` the R*C processes share the one card and exchange through host
memory (gloo).  Neither is a multi-card figure.  Matrix products are
float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch import kernels, tree
from repro_torch.bench import distributed
from repro_torch.bench import gnn as gnn_bench
from repro_torch.comm.grid import Grid, pmean_trees
from repro_torch.models import gnn_dist
from repro_torch.optim import adamw

LAYERS = 4  # 16 full-width layers' saved activations need ~118 GB (PERF.md)
ARCHS = ("graphcast", "egnn", "nequip")
#: the archs whose 2D cell trains with int8 payloads (launch/cells.py:349
#: also names gat-cora, whose int8 loss is NaN in the reference)
INT8_ARCHS = ("graphcast",)


def arch_layers(arch: str) -> int | None:
    """The depth the harness trains ``arch`` at: :data:`LAYERS` for
    GraphCast, the published depth (``None``) otherwise."""
    return LAYERS if arch == "graphcast" else None


def opt_config(steps: int) -> adamw.AdamWConfig:
    """``examples/train_gnn.py``'s AdamW: lr 1e-3 after 5 warmup steps,
    over at least 50 steps (so that a short run stays in the warmup)."""
    return adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=max(steps, 50))


def make_targets(n: int, classes: int, seed: int) -> np.ndarray:
    """Integer targets in [0, classes) for the n (padded) vertices."""
    return np.random.default_rng([seed, 1]).integers(0, classes, n).astype(np.int64)


def cotangent_bytes(cfg, params, part) -> dict:
    """One backward's fp32 exchanges, from the shapes, as
    :func:`repro_torch.bench.gnn.payload_bytes` counts the forward's: every
    rank's contribution to every transposed collective.  Per aggregation
    pass, (s, d) to the transpose's ``ppermute``, the (R s, d) and (C s, d)
    cotangents of the two all-gathers to their reduce-scatters (summed over
    the group), and (c, s, dm) to the all-to-all; one float to the loss
    ``psum``'s transpose.  ``grad_pmean`` is the gradient mean's: every
    parameter, in fp32, from every rank."""
    s, r, c = part.chunk, part.rows, part.cols
    ranks = r * c
    sent = [n for d, dm in gnn_bench.exchange_passes(cfg, params)
            for n in (s * d, r * s * d, c * s * d, c * s * dm)] + [1]
    n_params = sum(x.numel() for x in tree.leaves(params))
    return {"fp32": ranks * 4 * sum(sent), "calls": len(sent),
            "grad_pmean": ranks * 4 * n_params}


@contextlib.contextmanager
def deterministic():
    """While active, PyTorch takes its deterministic kernels: on the card
    ``index_add_`` (the segment sums and the gathers' backward) sums in a
    fixed order instead of by atomics, so that two runs of the same
    arithmetic, in one process or in several, agree bit for bit.  They are
    slower; the harness times nothing under them."""
    mode, warn = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(st: gnn_bench.GnnSetup, steps: int, quantize: bool, seed: int = 0,
          warmup: int = 1, capture: bool = False) -> dict:
    """``warmup`` uncounted loss-and-gradient calls, then ``steps`` train
    steps from ``st.params``, each part timed.  Returns the per-step
    records, the bytes, the peak memory, the staging seconds and the
    counted steps' kernel launches; with ``capture``, the first counted
    step's loss, the local ranks' forward outputs and (where rank 0 is
    local) the ``pmean``ed gradient leaves, as host arrays."""
    grid, part, dev = st.grid, st.bg.part, st.grid.device
    targets = gnn_dist.shard_targets(grid, make_targets(part.n, st.cfg.d_out, seed), part)
    dcfg = gnn_dist.Dist2DConfig(quantize_payload=quantize)
    cfg_opt = opt_config(steps)
    r0 = grid.local_ranks[0]

    def value_and_grad(params):
        return gnn_dist.value_and_grad_2d(grid, st.cfg, params, st.h_own, st.src_l,
                                          st.dst_l, targets, part, dcfg, pos=st.pos)

    params, opt = st.params, adamw.init(st.params)
    for _ in range(warmup):
        value_and_grad(params)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    staging0 = grid.staging_s
    kernels.reset_launches()
    records, captured = [], None
    for k in range(steps):
        t0 = time.perf_counter()
        loss, grads, out = value_and_grad(params)
        _sync(dev)
        t1 = time.perf_counter()
        mean = pmean_trees(grid, grads)[r0]
        _sync(dev)
        t2 = time.perf_counter()
        if capture and k == 0:
            captured = {"loss": float(loss),
                        "out": [None if o is None else o.cpu().numpy() for o in out],
                        "grads": ([g.cpu().numpy() for g in tree.leaves(mean)]
                                  if 0 in grid.local_ranks else None)}
        del grads, out
        params, opt = adamw.apply(cfg_opt, params, mean, opt)
        _sync(dev)
        t3 = time.perf_counter()
        records.append({"loss": float(loss), "grad_norm": float(adamw.global_norm(mean)),
                        "fwd_bwd_s": t1 - t0, "pmean_s": t2 - t1, "adamw_s": t3 - t2,
                        "step_s": t3 - t0})
    launches = dict(kernels.LAUNCHES)
    fwd = gnn_bench.payload_bytes(st.cfg, st.params, part)
    bwd = cotangent_bytes(st.cfg, st.params, part)
    return {
        "arch": st.cfg.name, "refine": st.refine, "n": st.n, "m": int(st.edges.shape[0]),
        "grid": [grid.rows, grid.cols], "chunk": part.chunk, "n_pad": part.n,
        "e_cap": int(st.bg.e_cap), "layers": getattr(st.cfg, "n_layers", None),
        "d_hidden": st.cfg.d_hidden, "d_in": st.cfg.d_in, "d_out": st.cfg.d_out,
        "quantize": quantize, "steps": records,
        "fwd_int8_bytes": fwd["int8"], "fwd_fp32_bytes": fwd["fp32"],
        "bwd_fp32_bytes": bwd["fp32"], "grad_pmean_bytes": bwd["grad_pmean"],
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "staging_s": grid.staging_s - staging0, "launches": launches,
        "rank": r0 if len(grid.local_ranks) == 1 else None, "captured": captured,
    }


def proc_train(grid: Grid, spec: dict) -> list:
    """One process of a grid running ``spec``'s cases (``arch``,
    ``quantize``, optionally ``deterministic``) on the multimesh of
    ``spec["refine"]``: :func:`train` with ``spec``'s steps, seed, widths,
    depth and warm-up calls (``spec["warmup"]``, default 1), under
    :func:`deterministic` where the case asks.  Module-level, so that it
    pickles for ``procgrid.spawn``."""
    setups: dict[str, gnn_bench.GnnSetup] = {}
    out = []
    for case in spec["cases"]:
        if case["arch"] not in setups:
            setups[case["arch"]] = gnn_bench.setup(case["arch"], spec["refine"], grid,
                                                   spec["seed"], spec["smoke"],
                                                   layers=spec["layers"])
        with deterministic() if case.get("deterministic") else contextlib.nullcontext():
            out.append(train(setups[case["arch"]], spec["steps"], case["quantize"],
                             spec["seed"], warmup=spec.get("warmup", 1),
                             capture=spec.get("capture", False)))
    return out


def _print(res: dict, where: str) -> None:
    mib = "not measured" if res["peak_bytes"] is None else f"{res['peak_bytes'] / 2**20:,.1f} MiB"
    print(f"# {res['arch']} {res['layers']} layers d_hidden {res['d_hidden']} on the "
          f"refinement-{res['refine']} multimesh (n={res['n']:,}, m={res['m']:,}) over a "
          f"{res['grid'][0]}x{res['grid'][1]} grid (chunk {res['chunk']:,}, e_cap "
          f"{res['e_cap']:,}), payload {'int8' if res['quantize'] else 'fp32'}: {where}")
    for k, r in enumerate(res["steps"]):
        print(f"step {k + 1}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6e}  "
              f"{r['step_s']:.4f} s (forward+backward {r['fwd_bwd_s']:.4f}, pmean "
              f"{r['pmean_s']:.4f}, AdamW {r['adamw_s']:.4f})")
    print(f"bytes per step: forward int8 {res['fwd_int8_bytes']:,} vs fp32 "
          f"{res['fwd_fp32_bytes']:,} ({res['fwd_fp32_bytes'] / res['fwd_int8_bytes']:.3f}x); "
          f"backward fp32 {res['bwd_fp32_bytes']:,}; gradient pmean fp32 "
          f"{res['grad_pmean_bytes']:,}; peak device memory {mib}")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="graphcast", choices=ARCHS)
    ap.add_argument("--refine", type=int, default=6)
    ap.add_argument("--grid", default="2x2", help="R x C of the grid")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke widths")
    ap.add_argument("--procs", type=int, default=0,
                    help="run one process per rank (R*C of them, gloo) instead of a SimGrid")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rows, cols = distributed.parse_grid(args.grid)
    quantize = args.arch in INT8_ARCHS
    layers = arch_layers(args.arch)
    spec = {"refine": args.refine, "seed": args.seed, "smoke": args.smoke, "layers": layers,
            "steps": args.steps, "cases": [{"arch": args.arch, "quantize": quantize}]}
    dev = torch.device("cuda" if args.device is None else args.device)
    on = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    if args.procs:
        from repro_torch.comm import procgrid

        if args.procs != rows * cols:
            ap.error(f"--procs {args.procs} does not match the {args.grid} grid's "
                     f"{rows * cols} ranks")
        results = [r[0] for r in procgrid.spawn(proc_train, rows, cols, device=args.device,
                                                 args=(spec,))]
        where = (f"{args.procs} processes on {'one card' if dev.type == 'cuda' else 'the CPU'} "
                 f"over gloo ({on})")
    else:
        st = gnn_bench.setup(args.arch, args.refine, (rows, cols), args.seed, args.smoke,
                             args.device, layers)
        results = [train(st, args.steps, quantize, args.seed)]
        where = f"{rows * cols} ranks simulated on one device ({on})"
    res = results[0]
    _print(res, where)
    if args.procs:
        step_s = sum(r["step_s"] for r in res["steps"])
        print(f"staging through host memory, per process: "
              f"{[round(r['staging_s'], 4) for r in results]} s of {step_s:.4f} s of steps "
              f"(share {max(r['staging_s'] for r in results) / step_s:.4f}); peak device "
              f"memory per process {[r['peak_bytes'] for r in results]}")
    for r in results:
        r.pop("captured")
    print(json.dumps({"where": where, "results": results}))
    return results


if __name__ == "__main__":
    main()
