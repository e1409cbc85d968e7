"""Frontier-algebra harness: SSSP, CC and PageRank on one device and on a
simulated grid.

The port's counterpart of ``scripts/algebra_smoke.py`` at Graph500 size:
the spec's Kronecker graph (:mod:`repro_torch.bench.graph500`), each
algebra through ``bfs(algebra=)`` on one device and ``build_bfs`` on an
R x C :class:`~repro_torch.comm.SimGrid`, every batch timed with device
synchronization, and checks that need no host oracle loop:

* SSSP: a shortest-path certificate per root, on the device in int64 —
  ``dist[root] = 0``; no edge can be relaxed (``dist[v] <= dist[u] + w``
  for every edge with ``dist[u] < INF``, so no unreached vertex has a
  reached neighbour); every reached ``v != root`` has an edge where
  equality holds.  With weights >= 1 this proves the distances exact.
* CC: labels are constant along every edge, ``label[v] <= v`` and
  ``label[label[v]] == label[v]``.
* PageRank: the L1 distance to a float64 power iteration on the device
  with the ``pagerank`` algebra's conventions (:func:`power_iteration`).

    python -m repro_torch.bench.algebras --scale 22
    python -m repro_torch.bench.algebras --scale 22 --grid 2x2

Every rank of a grid runs on the same card, one after another: its times
are those of R*C ranks simulated on one card, and its ledger counts the
bytes the exchanges would move between cards.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.bench import distributed, graph500, teps
from repro_torch.comm import SimGrid
from repro_torch.core import algebra as algebra_mod
from repro_torch.core import bfs as bfsmod

INF = algebra_mod.INF
ALGEBRAS = ("sssp", "cc", "pagerank")
#: roots per algebra: SSSP batches B sources; CC and PageRank compute one
#: root-independent answer, so one plane
BATCH = {"sssp": 8, "cc": 1, "pagerank": 1}
MAX_LEVELS = {"sssp": 1024, "cc": 1024, "pagerank": 256}
POLICY = "top_down"  # the algebras' direction on both drivers
#: PageRank's bound against the float64 iteration: each side stops at an L1
#: step residual of 1e-4, which leaves up to tol * d / (1 - d) ~ 5.7e-4 of
#: tail on each, plus float32 rounding
PAGERANK_L1 = 2e-3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_single(setup: graph500.Graph500Setup, algebra: str, roots) -> dict:
    """One batch of ``algebra`` on one device -> its value and level planes
    (on the device), level count and seconds."""
    dev = setup.device
    _sync(dev)
    t0 = time.perf_counter()
    res = bfsmod.bfs(setup.src, setup.dst, np.asarray(roots, np.int32), setup.g.n,
                     policy=POLICY, max_levels=MAX_LEVELS[algebra], expand=setup.expand,
                     device=dev, block=setup.block, algebra=algebra)
    _sync(dev)
    return {"value": res.parent, "level": res.level, "n_levels": res.n_levels,
            "batch_s": time.perf_counter() - t0}


def run_grid(st: distributed.DistSetup, algebra: str, roots, mode: str = "auto") -> dict:
    """One batch of ``algebra`` on the grid (``distributed.run_case`` with
    this harness's policy and level cap)."""
    return distributed.run_case(st, roots, mode=mode, policy=POLICY, algebra=algebra,
                                max_levels=MAX_LEVELS[algebra])


def sssp_certificate(src: torch.Tensor, dst: torch.Tensor, n: int, roots,
                     dist: torch.Tensor, max_weight: int = 31) -> list[str]:
    """Check the shortest-path certificate of every plane of ``dist`` (B, n)
    over the stored (symmetric) edges; returns the failures."""
    s64, d64 = src.to(torch.int64), dst.to(torch.int64)
    valid = (s64 < n) & (d64 < n)
    s64, d64 = s64[valid], d64[valid]
    w = algebra_mod.edge_weight(s64, d64, max_weight).to(torch.int64)
    failures = []
    for k, root in enumerate(np.asarray(roots).tolist()):
        d = dist[k].to(torch.int64)
        du, dv = d[s64], d[d64]
        reached_u = du < INF
        if int(d[root]) != 0:
            failures.append(f"root {root}: dist[root] = {int(d[root])}")
        relaxable = reached_u & (dv > du + w)
        if bool(relaxable.any()):
            failures.append(f"root {root}: {int(relaxable.sum())} edges can still "
                            "be relaxed")
        tight = torch.zeros(n, dtype=torch.bool, device=d.device)
        tight[d64[reached_u & (dv == du + w)]] = True
        need = (d < INF) & (d > 0)
        if bool((need & ~tight).any()):
            failures.append(f"root {root}: {int((need & ~tight).sum())} reached "
                            "vertices without a tight edge")
        if bool(((d < 0) | ((d == 0) & (torch.arange(n, device=d.device) != root))).any()):
            failures.append(f"root {root}: a vertex other than the root at distance <= 0")
    return failures


def cc_certificate(src: torch.Tensor, dst: torch.Tensor, n: int,
                   label: torch.Tensor) -> list[str]:
    """Labels constant along every edge, ``label[v] <= v`` and labels that
    label themselves; returns the failures."""
    s64, d64 = src.to(torch.int64), dst.to(torch.int64)
    valid = (s64 < n) & (d64 < n)
    lab = label.to(torch.int64)
    failures = []
    if bool((lab[s64[valid]] != lab[d64[valid]]).any()):
        failures.append("an edge joins two labels")
    if bool((lab > torch.arange(n, device=lab.device)).any()):
        failures.append("a label above its vertex id")
    if bool((lab[lab] != lab).any()):
        failures.append("a label that is not its own label")
    return failures


def power_iteration(src: torch.Tensor, dst: torch.Tensor, n: int,
                    damping: float = 0.85, tol: float = 1e-4,
                    max_iter: int = 500) -> tuple[torch.Tensor, int]:
    """Float64 PageRank on the device with the ``pagerank`` algebra's (and
    ``reference_pagerank``'s) conventions: 1/n start, dangling mass not
    redistributed, stop at L1 step residual <= ``tol``.  Returns the ranks
    and the iterations run."""
    s64, d64 = src.to(torch.int64), dst.to(torch.int64)
    valid = (s64 < n) & (d64 < n)
    s64, d64 = s64[valid], d64[valid]
    deg = torch.zeros(n, dtype=torch.float64, device=src.device)
    deg.index_add_(0, s64, torch.ones_like(s64, dtype=torch.float64))
    v = torch.full((n,), 1.0 / n, dtype=torch.float64, device=src.device)
    for it in range(1, max_iter + 1):
        contrib = torch.where(deg > 0, v / deg.clamp(min=1), 0.0)
        nxt = torch.full_like(v, (1.0 - damping) / n)
        nxt.index_add_(0, d64, damping * contrib[s64])
        done = float((nxt - v).abs().sum()) <= tol
        v = nxt
        if done:
            return v, it
    return v, max_iter


def check(setup: graph500.Graph500Setup, algebra: str, roots, out: dict,
          pagerank_n: int | None = None) -> dict:
    """The device checks of one algebra's result; ``failures`` is empty when
    it passed.  ``pagerank_n`` is the vertex count PageRank ran over (a
    grid's padded ``part.n``; default the graph's)."""
    n = setup.g.n
    if algebra == "sssp":
        return {"failures": sssp_certificate(setup.src, setup.dst, n, roots, out["value"])}
    if algebra == "cc":
        return {"failures": cc_certificate(setup.src, setup.dst, n, out["value"][0])}
    ref, iters = power_iteration(setup.src, setup.dst, pagerank_n or n)
    l1 = float((out["value"][0, :n].to(torch.float64) - ref[:n]).abs().sum())
    return {"failures": [] if l1 <= PAGERANK_L1 else [f"L1 {l1} > {PAGERANK_L1}"],
            "l1_to_float64": l1, "float64_iterations": iters}



def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--grid", default=None, help="R x C, e.g. 2x2 (default: one device)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    setup = graph500.build(args.scale, args.edgefactor, args.seed, "hybrid", args.device)
    roots = teps.valid_roots(setup.g, 64, seed=2)
    st = None
    if args.grid:
        st = distributed.setup(setup.g, SimGrid(*distributed.parse_grid(args.grid),
                                                device=setup.device), "hybrid")
    on = (torch.cuda.get_device_name(0) if setup.device.type == "cuda" else "cpu")
    where = f"grid {args.grid} ({st.grid.size} ranks simulated on one device)" if st \
        else "one device"
    summary = {"scale": args.scale, "device": on, "grid": args.grid, "policy": POLICY,
               "runs": {}}
    for algebra in ALGEBRAS:
        batch = roots[: BATCH[algebra]]
        out = run_grid(st, algebra, batch) if st else run_single(setup, algebra, batch)
        verdict = check(setup, algebra, batch, out, st.bg.part.n if st else None)
        row = {"roots": batch.tolist(), "n_levels": out["n_levels"],
               "batch_s": out["batch_s"],
               **{k: v for k, v in verdict.items() if k != "failures"},
               "failures": verdict["failures"]}
        if st:
            row["ledger"] = distributed.zone_bytes([out["stats"]])
        summary["runs"][algebra] = row
        print(f"{algebra} on {where} ({on}): {out['n_levels']} levels, "
              f"{out['batch_s']:.4f} s for B={len(batch)}; checks "
              f"{'passed' if not verdict['failures'] else verdict['failures']}")
    print(json.dumps(summary))
    bad = {a: r["failures"] for a, r in summary["runs"].items() if r["failures"]}
    if bad:
        raise SystemExit(f"algebra checks failed: {bad}")
    return summary


if __name__ == "__main__":
    main()
