"""Distributed Graph500 harness on a simulated grid (paper Alg. 4).

The port's counterpart of ``examples/distributed_bfs.py`` plus the Graph500
run: the spec's Kronecker graph and valid-root sample (as
:mod:`repro_torch.bench.graph500`), a 2D partition onto an R x C
:class:`~repro_torch.comm.SimGrid` whose ranks all live on one device,
``build_bfs`` in batches of ``--batch`` roots, every tree validated on the
host, harmonic-mean TEPS, and the per-phase, per-format byte ledger.

    python -m repro_torch.bench.distributed --grid 2x2 --mode auto \\
        --policy direction_opt --expand hybrid --scale 22 --batch 8 --roots 16

Every rank runs on the same card, one after another: the TEPS is that of R*C
ranks simulated on one card, not a multi-card figure, and the ledger counts
the bytes the exchanges would move between cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time

import numpy as np
import torch

from repro_torch.bench import graph500, teps
from repro_torch.comm import CommStats, SimGrid
from repro_torch.core import csr
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.graphgen import builder


@dataclasses.dataclass
class DistSetup:
    """A graph, its 2D partition and the per-rank blocks on the grid."""

    g: builder.CSRGraph
    bg: csr.BlockedGraph
    grid: SimGrid
    expand: str
    blocks: tuple  # shard_blocked's per-rank lists
    partition_s: float
    containers_s: float


def parse_grid(text: str) -> tuple[int, int]:
    r, c = (int(x) for x in text.lower().split("x"))
    return r, c


def setup(g: builder.CSRGraph, grid: SimGrid, expand: str = "hybrid") -> DistSetup:
    """Partition ``g`` onto ``grid`` and move every rank's block containers."""
    t0 = time.perf_counter()
    bg = csr.partition_2d(g, grid.rows, grid.cols)
    t1 = time.perf_counter()
    blocks = dbfs.shard_blocked(grid, bg, dbfs.DistBFSConfig(expand=expand))
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    return DistSetup(g=g, bg=bg, grid=grid, expand=expand, blocks=blocks,
                     partition_s=t1 - t0, containers_s=time.perf_counter() - t1)


def _sync(grid: SimGrid) -> None:
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)


def search(st: DistSetup, roots: np.ndarray, batch: int = 8, mode: str = "auto",
           policy: str = "direction_opt", validate_trees: bool = True) -> dict:
    """Kernel 2 over ``roots`` in batches of ``batch`` sources on the grid,
    then per-tree validation and TEPS.  ``stats`` holds each batch's
    ledger, ``trees`` each batch's host (parent, level) planes."""
    if len(roots) % batch:
        raise ValueError(f"{len(roots)} roots is not a multiple of batch {batch}")
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=st.expand)
    n = st.g.n
    times, trees, depths, ledgers = [], [], [], []
    for lo in range(0, len(roots), batch):
        ledgers.append(CommStats())
        fn = dbfs.build_bfs(st.grid, st.bg, cfg, stats=ledgers[-1])
        _sync(st.grid)
        t0 = time.perf_counter()
        parent, level, depth = fn(*st.blocks, roots[lo:lo + batch])
        _sync(st.grid)
        times.append(time.perf_counter() - t0)
        depths.append(depth)
        trees.append((parent[:, :n].cpu().numpy(), level[:, :n].cpu().numpy()))
    out = {"n_roots": len(roots), "batch": batch, "mode": mode, "policy": policy,
           "expand": st.expand, "grid": f"{st.grid.rows}x{st.grid.cols}",
           "depths": depths, "trees": trees, "stats": ledgers}
    out.update(graph500.verdicts(st.g, roots, trees, times, batch, validate_trees))
    return out


def zone_bytes(ledgers) -> dict[str, dict[str, int]]:
    """phase -> format -> bytes moved over links by all ranks together, over
    a list of ledgers (per-plane sub-zones ``@p{k}`` folded into their
    phase)."""
    out: dict[str, dict[str, int]] = {}
    for stats in ledgers:
        for r in stats.records():
            zone = re.sub(r"@p\d+$", "", r.phase)
            out.setdefault(zone, {})
            out[zone][r.fmt] = out[zone].get(r.fmt, 0) + r.grid_moved_bytes
    return out


def print_ledger(ledgers) -> None:
    for zone, fmts in sorted(zone_bytes(ledgers).items()):
        total = sum(fmts.values())
        parts = ", ".join(f"{f} {b:,}" for f, b in sorted(fmts.items()))
        print(f"  {zone:18s} {total:>14,} B  ({parts})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default="2x2", help="R x C, e.g. 2x2")
    ap.add_argument("--mode", default="auto", choices=["raw", "bitmap", "auto"])
    ap.add_argument("--policy", default="direction_opt",
                    choices=["top_down", "bottom_up", "direction_opt"])
    ap.add_argument("--expand", default="hybrid", choices=["coo", "ell", "hybrid", "auto"])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    grid = SimGrid(*parse_grid(args.grid), device=args.device)
    g, gen_s, k1_s = graph500.generate(args.scale, args.edgefactor, args.seed)
    st = setup(g, grid, args.expand)
    roots = teps.valid_roots(g, args.roots, seed=2)
    search(st, roots[: args.batch], args.batch, args.mode, args.policy,
           validate_trees=False)  # untimed warm-up, as the single-device harness
    out = search(st, roots, args.batch, args.mode, args.policy, not args.no_validate)
    on = (torch.cuda.get_device_name(0) if grid.device.type == "cuda" else "cpu")
    print(f"# distributed Graph500 scale={args.scale} grid={args.grid} mode={args.mode} "
          f"policy={args.policy} expand={st.expand} batch={args.batch}: "
          f"{grid.size} ranks simulated on one device ({on})")
    print(f"generation {gen_s:.3f}s  Kernel1 {k1_s:.3f}s  partition {st.partition_s:.3f}s  "
          f"containers {st.containers_s:.3f}s  BFS {out['bfs_s']:.3f}s  "
          f"validation {out['validation_s']:.3f}s")
    print(f"valid trees: {out['n_valid']}/{out['n_roots']}  TEPS harmonic mean "
          f"({grid.size} ranks simulated on one device): {out['teps_harmonic_mean']:.6e}")
    print("bytes over links, all ranks, by phase and format:")
    print_ledger(out["stats"])
    summary = {k: v for k, v in out.items()
               if k not in ("teps", "traversed_edges", "trees", "stats")}
    summary.update(scale=args.scale, device=on, ledger=zone_bytes(out["stats"]))
    print(json.dumps(summary))
    if out["validated"] and out["n_valid"] != out["n_roots"]:
        raise SystemExit(f"invalid BFS trees: {out['failures']}")
    return out


if __name__ == "__main__":
    main()
