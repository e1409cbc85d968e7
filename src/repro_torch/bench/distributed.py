"""Distributed Graph500 harness (paper Alg. 4) on an R x C grid.

The port's counterpart of ``examples/distributed_bfs.py`` plus the Graph500
run: the spec's Kronecker graph and valid-root sample (as
:mod:`repro_torch.bench.graph500`), a 2D partition onto an R x C grid,
``build_bfs`` in batches of ``--batch`` roots, every tree validated on the
host, harmonic-mean TEPS, and the per-phase, per-format byte ledger.

    python -m repro_torch.bench.distributed --grid 2x2 --mode auto \\
        --policy direction_opt --expand hybrid --scale 22 --batch 8 --roots 16

By default the grid is a :class:`~repro_torch.comm.SimGrid`: every rank on
the same card, one after another, so the TEPS is that of R*C ranks
simulated on one card.  ``--procs R*C`` runs one process per rank instead
(:class:`~repro_torch.comm.procgrid.ProcessGrid`, ``--backend gloo`` or
``nccl``): each process builds the same graph from the seed, partitions it
and keeps its own block; the trees are gathered and validated on rank 0,
and the processes' ledgers are merged.  Under gloo the ranks may share one
card and exchange through host memory (the staging time is reported);
under nccl rank p runs on ``cuda:p``, a card of its own, and the header
names each process's card.  Either way the ledger counts the bytes the
exchanges would move between cards.  ``--betweenness``
prints the 5 most central vertices of the last batch's trees
(:func:`repro_torch.core.centrality.tree_betweenness`, on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time

import numpy as np
import torch

from repro_torch.bench import cards, graph500, teps
from repro_torch.comm import CommStats, SimGrid
from repro_torch.comm.grid import Grid
from repro_torch.core import csr
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.core.centrality import tree_betweenness
from repro_torch.graphgen import builder


@dataclasses.dataclass
class DistSetup:
    """A graph, its 2D partition and the per-rank blocks on the grid."""

    g: builder.CSRGraph
    bg: csr.BlockedGraph
    grid: Grid
    expand: str
    blocks: tuple  # shard_blocked's per-rank lists
    partition_s: float
    containers_s: float


def parse_grid(text: str) -> tuple[int, int]:
    r, c = (int(x) for x in text.lower().split("x"))
    return r, c


def setup(g: builder.CSRGraph, grid: Grid, expand: str = "hybrid",
          chunk_multiple: int = 1024) -> DistSetup:
    """Partition ``g`` onto ``grid`` (chunks a multiple of
    ``chunk_multiple``) and move the local ranks' block containers."""
    t0 = time.perf_counter()
    bg = csr.partition_2d(g, grid.rows, grid.cols, chunk_multiple=chunk_multiple)
    t1 = time.perf_counter()
    blocks = dbfs.shard_blocked(grid, bg, dbfs.DistBFSConfig(expand=expand))
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    return DistSetup(g=g, bg=bg, grid=grid, expand=expand, blocks=blocks,
                     partition_s=t1 - t0, containers_s=time.perf_counter() - t1)


def _sync(grid: Grid) -> None:
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)


def _start(grid: Grid) -> float:
    """Line the processes of a grid up and start a timed call."""
    _sync(grid)
    grid.barrier()
    return time.perf_counter()


def _merge(grid: Grid, times: list[float], ledgers: list) -> tuple[list[float], list]:
    """Each call's slowest process and the merged ledgers (a grid of one
    process per rank); as they are on a grid that holds every rank."""
    if len(grid.local_ranks) == grid.size:
        return times, ledgers
    times = [max(ts) for ts in zip(*grid.gather_objects(times))]
    return times, [s.gather(grid) for s in ledgers]


def search(st: DistSetup, roots: np.ndarray, batch: int = 8, mode: str = "auto",
           policy: str = "direction_opt", validate_trees: bool = True) -> dict:
    """Kernel 2 over ``roots`` in batches of ``batch`` sources on the grid,
    then per-tree validation and TEPS.  ``stats`` holds each batch's
    ledger, ``trees`` each batch's host (parent, level) planes.  On a grid
    of one process per rank every process runs the batches, a batch's time
    is its slowest process's, the ledgers are merged, and only rank 0
    validates the trees and computes TEPS (the other ranks' results have
    no verdict keys)."""
    if len(roots) % batch:
        raise ValueError(f"{len(roots)} roots is not a multiple of batch {batch}")
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=st.expand,
                             row_axes=st.grid.row_axes)
    n = st.g.n
    times, trees, depths, ledgers = [], [], [], []
    for lo in range(0, len(roots), batch):
        ledgers.append(CommStats())
        fn = dbfs.build_bfs(st.grid, st.bg, cfg, stats=ledgers[-1])
        t0 = _start(st.grid)
        parent, level, depth = fn(*st.blocks, roots[lo:lo + batch])
        _sync(st.grid)
        times.append(time.perf_counter() - t0)
        depths.append(depth)
        trees.append((parent[:, :n].cpu().numpy(), level[:, :n].cpu().numpy()))
    times, ledgers = _merge(st.grid, times, ledgers)
    out = {"n_roots": len(roots), "batch": batch, "mode": mode, "policy": policy,
           "expand": st.expand, "grid": f"{st.grid.rows}x{st.grid.cols}",
           "depths": depths, "trees": trees, "stats": ledgers, "batch_s": times}
    if 0 in st.grid.local_ranks:
        out.update(graph500.verdicts(st.g, roots, trees, times, batch, validate_trees))
    return out


def run_case(st: DistSetup, roots, mode: str = "auto", policy: str = "direction_opt",
             algebra: str = "bfs", max_levels: int = 1024) -> dict:
    """One batch of ``algebra`` from ``roots`` on the grid -> the value and
    level planes over the first ``n`` vertices (on the grid's device), the
    level count, the seconds (the slowest process's), the merged ledger and
    the staging seconds of a process grid (0 elsewhere)."""
    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=st.expand,
                             algebra=algebra, max_levels=max_levels,
                             row_axes=st.grid.row_axes)
    stats = CommStats()
    fn = dbfs.build_bfs(st.grid, st.bg, cfg, stats=stats)
    staged = st.grid.staging_s
    t0 = _start(st.grid)
    value, level, depth = fn(*st.blocks, np.asarray(roots, np.int32))
    _sync(st.grid)
    (dt,), (stats,) = _merge(st.grid, [time.perf_counter() - t0], [stats])
    n = st.g.n
    return {"value": value[:, :n], "level": level[:, :n], "n_levels": depth,
            "batch_s": dt, "stats": stats, "staging_s": st.grid.staging_s - staged}


def proc_cases(grid: Grid, spec: dict) -> dict:
    """One process of a grid running ``spec``'s cases: the Kronecker graph
    of ``spec["scale"]`` (edgefactor 16, seed 1) partitioned onto the grid
    (``hybrid`` containers), then, for each ``spec["cases"]`` entry
    (``mode``, ``policy``, ``algebra``, and ``roots`` where a case has its
    own), one batch from ``spec["roots"]``; ``spec["warmup"]`` cases run
    first and uncounted.  Returns this process's kernel launches over the
    counted cases and each case's :func:`run_case` output (the planes as
    host arrays, on rank 0 only)."""
    from repro_torch import kernels

    st = setup(graph500.generate(spec["scale"])[0], grid)
    for case in spec.get("warmup", ()):
        run_case(st, spec["roots"], **case)
    kernels.reset_launches()
    cases = []
    for case in spec["cases"]:
        case = dict(case)
        out = run_case(st, case.pop("roots", spec["roots"]), **case)
        for key in ("value", "level"):
            out[key] = out[key].cpu().numpy() if 0 in grid.local_ranks else None
        cases.append(out)
    return {"rank": grid.local_ranks[0], "launches": dict(kernels.LAUNCHES),
            "cases": cases}


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


def ledger_views(ledgers) -> dict:
    """The :class:`~repro_torch.comm.CommStats` views of a list of ledgers,
    summed: one rank's bytes per phase (all-reduces doubled) and moved per
    phase, bytes per collective kind, and the two totals."""
    out = {"per_phase": {}, "per_phase_moved": {}, "per_op": {}, "total_bytes": 0,
           "total_moved_bytes": 0}
    for stats in ledgers:
        for view in ("per_phase", "per_phase_moved", "per_op"):
            for key, v in getattr(stats, view)().items():
                out[view][key] = out[view].get(key, 0) + v
        out["total_bytes"] += stats.total_bytes
        out["total_moved_bytes"] += stats.total_moved_bytes
    return out


def print_ledger(ledgers) -> None:
    for zone, fmts in sorted(zone_bytes(ledgers).items()):
        total = sum(fmts.values())
        parts = ", ".join(f"{f} {b:,}" for f, b in sorted(fmts.items()))
        print(f"  {zone:18s} {total:>14,} B  ({parts})")


def top_central(parents, levels, g, device, k: int = 5) -> list[dict]:
    """The ``k`` most central vertices of a batch's (B, n) trees by
    :func:`tree_betweenness` on ``device``."""
    bc = tree_betweenness(torch.as_tensor(parents, device=device),
                          torch.as_tensor(levels, device=device), g.n)
    order = torch.sort(bc, descending=True, stable=True).indices[:k].cpu().tolist()
    deg = g.degrees()
    return [{"vertex": v, "degree": int(deg[v]), "centrality": float(bc[v])} for v in order]


def device_name(device: torch.device) -> str:
    """``device`` and, for a card, its name."""
    if device.type != "cuda":
        return str(device)
    return f"{device} ({torch.cuda.get_device_name(device)})"


def harness(grid: Grid, args) -> dict:
    """The harness of :func:`main` on ``grid``, in this process: generation,
    partition, an untimed warm-up batch, the timed batches, and the
    betweenness of the last batch.  On a grid of one process per rank only
    rank 0 returns the results (with every process's staging seconds and
    device); the other ranks return ``{}``."""
    g, gen_s, k1_s = graph500.generate(args.scale, args.edgefactor, args.seed)
    st = setup(g, grid, args.expand)
    roots = teps.valid_roots(g, args.roots, seed=2)
    search(st, roots[: args.batch], args.batch, args.mode, args.policy,
           validate_trees=False)  # untimed warm-up, as the single-device harness
    staged = grid.staging_s
    out = search(st, roots, args.batch, args.mode, args.policy, not args.no_validate)
    staging = grid.gather_objects(grid.staging_s - staged)
    devices = grid.gather_objects(device_name(grid.device))
    if 0 not in grid.local_ranks:
        return {}
    out.update(generation_s=gen_s, kernel1_s=k1_s, partition_s=st.partition_s,
               containers_s=st.containers_s, staging_s=staging, devices=devices)
    if args.betweenness:
        out["central"] = top_central(*out["trees"][-1], g, grid.device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", default="2x2", help="R x C, e.g. 2x2")
    ap.add_argument("--mode", default="auto", choices=["raw", "bitmap", "auto", "btfly"])
    ap.add_argument("--policy", default="direction_opt",
                    choices=["top_down", "bottom_up", "direction_opt"])
    ap.add_argument("--expand", default="hybrid", choices=["coo", "ell", "hybrid", "auto"])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--betweenness", action="store_true",
                    help="print the 5 most central vertices of the last batch's trees")
    ap.add_argument("--procs", type=int, default=0,
                    help="run one process per rank (R*C of them) instead of a SimGrid")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the process group's backend with --procs")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    rows, cols = parse_grid(args.grid)
    if args.procs:
        from repro_torch.comm import procgrid

        if args.procs != rows * cols:
            ap.error(f"--procs {args.procs} does not match the {args.grid} grid's "
                     f"{rows * cols} ranks")
        out = procgrid.spawn(harness, rows, cols, backend=args.backend, device=args.device,
                             args=(args,))[0]
        devices = sorted(set(out["devices"]))
        on = "; ".join(devices)
        where = (f"{args.procs} processes on {len(devices)} card(s) over {args.backend}"
                 if "cuda" in on else f"{args.procs} processes on the CPU over {args.backend}")
    else:
        grid = SimGrid(rows, cols, device=args.device)
        out = harness(grid, args)
        on = torch.cuda.get_device_name(0) if grid.device.type == "cuda" else "cpu"
        where = f"{grid.size} ranks simulated on one device"
    print(f"# distributed Graph500 scale={args.scale} grid={args.grid} mode={args.mode} "
          f"policy={args.policy} expand={args.expand} batch={args.batch}: {where} ({on})")
    if "cuda" in on:
        print("cards (nvidia-smi name, power limit): " + "; ".join(cards()))
    print(f"generation {out['generation_s']:.3f}s  Kernel1 {out['kernel1_s']:.3f}s  "
          f"partition {out['partition_s']:.3f}s  containers {out['containers_s']:.3f}s  "
          f"BFS {out['bfs_s']:.3f}s  validation {out['validation_s']:.3f}s")
    if args.procs and "cuda" in on and args.backend == "gloo":
        print(f"staging through host memory, per process: "
              f"{[round(x, 4) for x in out['staging_s']]} s of {out['bfs_s']:.4f} s of "
              f"batches (share {max(out['staging_s']) / out['bfs_s']:.4f})")
    print(f"valid trees: {out['n_valid']}/{out['n_roots']}  TEPS harmonic mean "
          f"({where}): {out['teps_harmonic_mean']:.6e}")
    print("bytes over links, all ranks, by phase and format:")
    print_ledger(out["stats"])
    views = ledger_views(out["stats"])
    print(f"one rank's bytes: {views['total_bytes']:,} B (all-reduces doubled), "
          f"{views['total_moved_bytes']:,} B over links; by collective {views['per_op']}")
    if args.betweenness:
        print(f"betweenness over the last batch's {args.batch} trees "
              "(tree-dependency approximation):")
        for c in out["central"]:
            print(f"  vertex {c['vertex']:>8d}  degree {c['degree']:>6d}  "
                  f"centrality {c['centrality']:,.0f}")
    summary = {k: v for k, v in out.items()
               if k not in ("teps", "traversed_edges", "trees", "stats")}
    summary.update(scale=args.scale, device=on, where=where, ledger=zone_bytes(out["stats"]),
                   ledger_views=views)
    print(json.dumps(summary))
    if out["validated"] and out["n_valid"] != out["n_roots"]:
        raise SystemExit(f"invalid BFS trees: {out['failures']}")
    return out


if __name__ == "__main__":
    main()
