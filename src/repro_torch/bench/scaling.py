"""Paper Fig 7.1/7.2: strong and weak scaling of the distributed BFS over
simulated grids.

The port's counterpart of ``benchmarks/scaling.py``: the Baseline (``raw``)
against the compressed wire (``auto``) over growing grids, time per BFS
and TEPS, in one process.  Each grid is a
:class:`~repro_torch.comm.SimGrid` whose ranks all run on one device, one
after another: a line is R*C ranks simulated on one card, not a multi-card
figure, and more ranks means more (smaller) calls on the same card.  The
bytes the wires would move are in :mod:`repro_torch.bench.distributed`'s
ledger and :mod:`repro_torch.bench.bfs_comm`.

    python -m repro_torch.bench.scaling --strong-scale 20 --weak-base-scale 18
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bench import card
from repro_torch.comm import SimGrid
from repro_torch.core import csr as csrmod
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.core import validate
from repro_torch.graphgen import builder, kronecker

STRONG_GRIDS = ((1, 1), (1, 2), (2, 2), (2, 4))
#: weak scaling: the problem grows with the grid (scale + 2 per 4x ranks)
WEAK_GRIDS = (((1, 1), 0), ((2, 2), 2))
MODES = ("raw", "auto")
#: timed calls per grid and mode, after one warm-up call
REPS = 3
#: the Kronecker seed of the reference's graphs
SEED = 3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_one(g, rows: int, cols: int, mode: str, device=None) -> dict:
    """One hub-root BFS of ``g`` on a ``rows`` x ``cols`` grid under ``mode``
    (the reference's configuration: ``top_down``, ``coo``): a warm-up call,
    then the mean of REPS timed calls."""
    dev = resolve_device(device)
    grid = SimGrid(rows, cols, dev)
    bg = csrmod.partition_2d(g, rows=rows, cols=cols)
    cfg = dbfs.DistBFSConfig(mode=mode)
    fn = dbfs.build_bfs(grid, bg, cfg)
    blocks = dbfs.shard_blocked(grid, bg, cfg)
    root = np.int32(np.argmax(g.degrees()))
    parent, _, depth = fn(*blocks, root)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(REPS):
        parent, _, depth = fn(*blocks, root)
    _sync(dev)
    dt = (time.perf_counter() - t0) / REPS
    te = validate.traversed_edges(g, parent[: g.n].cpu().numpy())
    return {"rows": rows, "cols": cols, "ranks": rows * cols, "mode": mode,
            "policy": cfg.policy, "expand": cfg.expand, "time_s": dt, "teps": te / dt,
            "depth": int(depth), "traversed_edges": int(te)}


def run(strong_scale: int = 13, weak_base_scale: int = 11, device=None) -> list[dict]:
    """The strong study (``strong_scale`` over STRONG_GRIDS) and the weak
    study (WEAK_GRIDS from ``weak_base_scale``), every mode of MODES on each
    grid; one graph per scale, built once."""
    graphs: dict[int, builder.CSRGraph] = {}

    def graph(scale):
        if scale not in graphs:
            graphs[scale] = builder.build_csr(kronecker.kronecker_edges(scale, seed=SEED),
                                              n=1 << scale)
        return graphs[scale]

    plan = [("strong", shape, strong_scale) for shape in STRONG_GRIDS]
    plan += [("weak", shape, weak_base_scale + up) for shape, up in WEAK_GRIDS]
    out = []
    for study, (r, c), scale in plan:
        for mode in MODES:
            rec = run_one(graph(scale), r, c, mode, device)
            out.append({"study": study, "scale": scale, **rec})
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strong-scale", type=int, default=13)
    ap.add_argument("--weak-base-scale", type=int, default=11)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = run(args.strong_scale, args.weak_base_scale, dev)
    print(f"# every grid's ranks simulated on one device, one after another ({card(dev)}): "
          "not a multi-card figure")
    print("study,grid,scale,mode,time_s,TEPS,depth,traversed_edges")
    for r in rows:
        print(f"{r['study']},{r['rows']}x{r['cols']},{r['scale']},{r['mode']},"
              f"{r['time_s']:.4f},{r['teps']:.3e},{r['depth']},{r['traversed_edges']}")
    print(json.dumps({"card": card(dev), "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
