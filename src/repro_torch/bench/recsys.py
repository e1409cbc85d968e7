"""AutoInt serving and training harness: the ``RECSYS_SHAPES`` cells.

AutoInt (``configs/autoint.py``) at its published widths: 39 sparse
fields, ``embed_dim`` 16, 3 interaction layers of 2 heads at d 32, an MLP
of 256 and 128, and the full fused table of 173,588,480 rows (11.1 GB in
fp32), random weights from a ``torch.Generator`` on the device seeded
``--seed``.  Batches come from the Zipf click-log generator
(``data.recsys.batch_at``, seed 0, one step per timed call, made before
the timing).  The cells
(:data:`CELLS`, from ``configs.common.RECSYS_SHAPES``):

* ``serve_p99`` (512) and ``serve_bulk`` (262,144): :func:`recsys.forward`
  under ``torch.inference_mode``, in fp32 and again with the int8 table
  (``table_quant``, 2.78 GB of rows and a 0.69 GB float32 scale);
* ``retrieval_cand``: one query against 1,000,000 candidates of the last
  field (:func:`recsys.retrieval_scores`); the published config gives that
  field 724 rows, so the candidate ids, drawn uniformly by a numpy
  generator seeded ``--seed``, repeat;
* ``train_batch`` (65,536): :func:`train.step.make_train_step` over
  ``loss_fn`` with AdamW.  Each of the 13 table sizes is cut by 4 (43.4M
  rows, 2.78 GB): the functional AdamW holds ~13 table-sized fp32 arrays
  at its peak (parameters, the dense gradient of the gather, m, v, their
  new values and temporaries), which the full table's 11.1 GB would take
  past the card's 80 GB.

Each cell prints the ms per batch (the median of ``--reps`` calls after one
warm-up, each call synchronized and timed on the host clock), samples per
second (candidates per second for retrieval), the lookup bytes (``B*F*d*4``;
``N*d*4`` for retrieval, as the reference's ``launch/cells.py`` counts
them) and the peak device memory, beside the card's name and power limit
(``cpu`` on the CPU, where no device number is measured).  ``--smoke`` takes
the smoke config and :data:`SMOKE_BATCH`.

    python -m repro_torch.bench.recsys                 # every cell, fp32 and int8 serving
    python -m repro_torch.bench.recsys --cells serve_bulk retrieval_cand
    python -m repro_torch.bench.recsys --device cpu --smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bench import card
from repro_torch.configs import common as configs
from repro_torch.data import recsys as click_data
from repro_torch.models import recsys
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

#: the four cells of ``RECSYS_SHAPES``; ``table_div`` cuts each table size
CELLS = {s.name: {"kind": s.kind, **s.params} for s in configs.RECSYS_SHAPES}
CELLS["train_batch"]["table_div"] = 4
#: the cells served again with the int8 table
QUANT_CELLS = ("serve_p99", "serve_bulk")
#: the batches (and candidates) at the smoke widths
SMOKE_BATCH = {"train_batch": 256, "serve_p99": 64, "serve_bulk": 1024, "retrieval_cand": 1}
SMOKE_CANDIDATES = 4096


def config(cell: str, smoke: bool = False, quant: bool = False) -> recsys.AutoIntConfig:
    """AutoInt's config for ``cell``: the published one (``smoke``: the
    smoke one), its table sizes cut by the cell's ``table_div``, int8 table
    with ``quant``."""
    spec = configs.get("autoint")
    cfg = spec.smoke_config() if smoke else spec.model_config()
    div = CELLS[cell].get("table_div", 1)
    if div > 1:
        sizes = cfg.table_sizes or tuple(recsys._TABLE_SIZES[i % len(recsys._TABLE_SIZES)]
                                         for i in range(cfg.n_sparse))
        cfg = dataclasses.replace(cfg, table_sizes=tuple(max(s // div, 1) for s in sizes))
    return dataclasses.replace(cfg, table_quant=quant)


def model(cfg: recsys.AutoIntConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a generator on ``device`` seeded ``seed``."""
    device = resolve_device(device)
    return recsys.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                              device=device)


def batch(cfg: recsys.AutoIntConfig, size: int, step: int = 0, device=None) -> dict:
    """The click log's batch ``step`` (seed 0) of ``size`` rows on ``device``."""
    device = resolve_device(device)
    b = click_data.batch_at(click_data.ClickLogConfig(table_sizes=cfg.resolved_tables(),
                                                      batch=size), step)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def candidates(cfg: recsys.AutoIntConfig, n: int, seed: int = 0, device=None) -> torch.Tensor:
    """``n`` candidate ids of the last field, uniform (numpy, ``seed``)."""
    ids = np.random.default_rng(seed).integers(0, cfg.resolved_tables()[-1], n, dtype=np.int32)
    return torch.from_numpy(ids).to(resolve_device(device))


def lookup_bytes(cfg: recsys.AutoIntConfig, cell: str, size: int, n_cand: int = 0) -> int:
    """The gathered fp32 bytes, as ``launch/cells.py`` counts them."""
    if CELLS[cell]["kind"] == "retrieval":
        return n_cand * cfg.embed_dim * 4
    return size * cfg.n_sparse * cfg.embed_dim * 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, reps: int, device) -> list[float]:
    """ms of each of ``reps`` calls of ``fn(i)`` after one warm-up call
    ``fn(0)``, each synchronized, on the host clock."""
    device = torch.device(device)
    fn(0)
    out = []
    for i in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn(i + 1)
        _sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def cell_fn(cfg, params, cell: str, size: int, n_cand: int, reps: int, device, seed: int = 0):
    """``fn(i)`` running the cell's call on its ``i``-th batch, the
    ``reps + 1`` batches made beforehand; each call's output (a train step's
    metrics) is appended to ``fn.outs``.  Returns ``fn`` and its samples per
    call.  Nothing here refers to ``fn`` itself: a reference cycle would
    keep the table alive after the caller drops it, until Python's cycle
    collector happens to run."""
    kind = CELLS[cell]["kind"]
    if kind == "retrieval":
        ids = batch(cfg, 1, 0, device)["ids"]
        cand = candidates(cfg, n_cand, seed, device)

        def call(i):
            with torch.inference_mode():
                return recsys.retrieval_scores(cfg, params, ids, cand)
        samples = n_cand
    else:
        batches = [batch(cfg, size, i, device) for i in range(reps + 1)]
        samples = size
    if kind == "serve":
        def call(i):
            with torch.inference_mode():
                return recsys.forward(cfg, params, batches[i]["ids"])
    elif kind == "train":
        step = tstep.make_train_step(functools.partial(recsys.loss_fn, cfg),
                                     adamw.AdamWConfig())
        state = [tstep.init_state(params)]

        def call(i):
            state[0], metrics = step(state[0], batches[i])
            return metrics
    outs = []

    def fn(i):
        outs.append(call(i))

    fn.outs = outs
    return fn, samples


def run_cell(cfg, params, cell: str, size: int, n_cand: int = 0, reps: int = 5, device=None,
             seed: int = 0) -> dict:
    """Time ``cell`` -> ms per batch (each and median), samples per second,
    lookup bytes, peak device memory (None on the CPU), whether every output
    was finite (a train cell: its losses and gradient norms, listed)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fn, samples = cell_fn(cfg, params, cell, size, n_cand, reps, device, seed)
    ms = timed(fn, reps, device)
    med = float(np.median(ms))
    out = {"cell": cell, "kind": CELLS[cell]["kind"], "batch": size,
           "n_candidates": n_cand or None, "table_rows": cfg.total_rows,
           "table_quant": cfg.table_quant, "ms": ms, "median_ms": med,
           "samples_per_s": samples / (med / 1e3),
           "lookup_bytes": lookup_bytes(cfg, cell, size, n_cand),
           "peak_bytes": torch.cuda.max_memory_allocated() if device.type == "cuda" else None}
    if CELLS[cell]["kind"] == "train":
        out["losses"] = [float(m["loss"]) for m in fn.outs]
        out["grad_norms"] = [float(m["grad_norm"]) for m in fn.outs]
        out["finite"] = bool(np.all(np.isfinite(out["losses"] + out["grad_norms"])))
    else:
        out["finite"] = all(bool(torch.isfinite(o).all()) for o in fn.outs)
    del fn
    return out


def describe(r: dict, where: str) -> str:
    peak = ("not measured (CPU)" if r["peak_bytes"] is None
            else f"{r['peak_bytes'] / 2**30:.2f} GiB")
    what = "candidates" if r["kind"] == "retrieval" else "samples"
    size = f"{r['n_candidates']:,} candidates" if r["kind"] == "retrieval" \
        else f"batch {r['batch']:,}"
    return (f"{r['cell']} ({'int8' if r['table_quant'] else 'fp32'} table, "
            f"{r['table_rows']:,} rows, {size}): median {r['median_ms']:.3f} ms per batch "
            f"({', '.join(f'{x:.3f}' for x in r['ms'])}), {r['samples_per_s']:,.0f} {what}/s, "
            f"lookup {r['lookup_bytes']:,} B, peak {peak} on {where}")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS), choices=list(CELLS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="the smoke config and batches")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    where = card(device)
    runs = []  # (config, cells): one table on the device at a time
    full = [c for c in args.cells if "table_div" not in CELLS[c]]
    if full:
        runs.append((config(full[0], args.smoke), full))
    if any(c in QUANT_CELLS for c in args.cells):
        runs.append((config("serve_p99", args.smoke, quant=True),
                     [c for c in args.cells if c in QUANT_CELLS]))
    if "train_batch" in args.cells:
        runs.append((config("train_batch", args.smoke), ["train_batch"]))
    out = []
    for cfg, cells in runs:
        params = model(cfg, args.seed, device)
        for cell in cells:
            size = SMOKE_BATCH[cell] if args.smoke else CELLS[cell]["batch"]
            n_cand = (SMOKE_CANDIDATES if args.smoke else CELLS[cell].get("n_candidates", 0)) \
                if CELLS[cell]["kind"] == "retrieval" else 0
            r = run_cell(cfg, params, cell, size, n_cand, args.reps, device, args.seed)
            r["card"] = where
            print(describe(r, where))
            out.append(r)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
