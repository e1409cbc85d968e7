"""Single-device Graph500 harness (paper Algorithm 1) on the port.

The single-device counterpart of ``examples/graph500_benchmark.py``:
untimed generation -> timed Kernel 1 (CSR construction) -> expansion
containers moved to the card -> Kernel 2: ``n_roots`` searches from the
spec's valid-root sample (seed 2), ``batch`` sources per ``bfs()`` call
through ``direction_opt`` + ``hybrid`` -> per-tree Graph500 validation
-> harmonic-mean TEPS.

    python -m repro_torch.bench.graph500 --scale 22

All BFS batches run first, timed one by one (a batch ends in
``torch.cuda.synchronize()``); the trees are validated afterwards on the
host, in parallel threads, so validation never overlaps a timed batch.
Per source, a batch's time is dt/B — the TEPS statistic stays
per-search, as the spec defines it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bench import teps
from repro_torch.core import bfs as bfsmod
from repro_torch.core import expand as expand_mod
from repro_torch.core import validate
from repro_torch.graphgen import builder, kronecker


@dataclasses.dataclass
class Graph500Setup:
    """A generated graph, its Kernel-1 CSR and its containers on ``device``."""

    scale: int
    edgefactor: int
    g: builder.CSRGraph
    src: torch.Tensor  # (m,) int32 on device: the degree vector's input
    dst: torch.Tensor
    block: expand_mod.LocalBlock
    expand: str
    device: torch.device
    split_k: int | None  # hybrid slab width (None for other backends)
    slab_edges: int  # edges on the ELL slab
    residue_edges: int  # edges left in the COO residue
    generation_s: float
    kernel1_s: float
    containers_s: float


def generate(scale: int, edgefactor: int = 16, seed: int = 1):
    """Untimed generation and the timed Kernel 1 -> (graph, generation
    seconds, Kernel-1 seconds)."""
    t0 = time.perf_counter()
    edges = kronecker.kronecker_edges(scale, edgefactor, seed=seed)
    t1 = time.perf_counter()
    g = builder.build_csr(edges, n=1 << scale)
    return g, t1 - t0, time.perf_counter() - t1


def build(scale: int, edgefactor: int = 16, seed: int = 1, expand: str = "hybrid",
          device=None) -> Graph500Setup:
    """Generate, build the CSR (Kernel 1) and move the containers."""
    g, generation_s, kernel1_s = generate(scale, edgefactor, seed)
    return place(g, expand, device, edgefactor, generation_s, kernel1_s)


def place(g: builder.CSRGraph, expand: str = "hybrid", device=None, edgefactor: int = 16,
          generation_s: float = 0.0, kernel1_s: float = 0.0) -> Graph500Setup:
    """Move the containers of a built graph to ``device``."""
    dev = resolve_device(device)
    scale = g.n.bit_length() - 1
    t2 = time.perf_counter()
    backend = expand_mod.resolve(expand)
    extra = backend.graph_arrays(g.src, g.dst, g.n)
    block = expand_mod.block_from_arrays(expand, g.src, g.dst, extra, g.n, dev)
    src = torch.as_tensor(g.src, device=dev)
    dst = torch.as_tensor(g.dst, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    split_k = slab = None
    if block.nbr is not None:
        slab = int((extra[0] < g.n).sum())
        split_k = int(extra[0].shape[1]) if backend.name == "hybrid" else None
    residue = int((block.src < g.n).sum()) if block.src.numel() else 0
    return Graph500Setup(
        scale=scale, edgefactor=edgefactor, g=g, src=src, dst=dst, block=block,
        expand=backend.name, device=dev, split_k=split_k,
        slab_edges=slab or 0, residue_edges=residue,
        generation_s=generation_s, kernel1_s=kernel1_s, containers_s=t3 - t2,
    )


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_tree(g, parent, root, level):
    v = validate.validate_bfs_tree(g, parent, root, level)
    return v, validate.traversed_edges(g, parent)


def search(setup: Graph500Setup, roots: np.ndarray, batch: int = 8,
           policy: str = "direction_opt", validate_trees: bool = True) -> dict:
    """Kernel 2 over ``roots`` in batches of ``batch`` sources, then per-tree
    validation; returns the timings, the verdicts and the TEPS statistic."""
    if len(roots) % batch:
        raise ValueError(f"{len(roots)} roots is not a multiple of batch {batch}")
    g, dev = setup.g, setup.device
    times, trees, depths = [], [], []
    for lo in range(0, len(roots), batch):
        chunk = roots[lo : lo + batch]
        _sync(dev)
        t0 = time.perf_counter()
        res = bfsmod.bfs(setup.src, setup.dst, chunk, g.n, policy=policy,
                         expand=setup.expand, device=dev, block=setup.block)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        depths.append(res.n_levels)
        trees.append((res.parent.cpu().numpy(), res.level.cpu().numpy()))
    return {"n_roots": len(roots), "batch": batch, "policy": policy,
            "expand": setup.expand, "depths": depths,
            **verdicts(g, roots, trees, times, batch, validate_trees)}


def verdicts(g, roots: np.ndarray, trees, times, batch: int,
             validate_trees: bool = True) -> dict:
    """Validate every tree on the host (threads) and compute TEPS.

    ``trees[k]`` is batch k's host (parent, level) planes over the first
    ``g.n`` vertices and ``times[k]`` its seconds; a search's time is its
    batch's divided by ``batch``."""
    t0 = time.perf_counter()
    jobs = [(trees[i // batch][0][i % batch], int(roots[i]), trees[i // batch][1][i % batch])
            for i in range(len(roots))]
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        if validate_trees:
            checked = list(ex.map(lambda j: _check_tree(g, *j), jobs))
        else:
            checked = [(None, te) for te in
                       ex.map(lambda j: validate.traversed_edges(g, j[0]), jobs)]
    validation_s = time.perf_counter() - t0

    failures = [(int(roots[i]), v.failures) for i, (v, _) in enumerate(checked)
                if v is not None and not v.ok]
    teps_list = [te / (times[i // batch] / batch) for i, (_, te) in enumerate(checked)]
    return {
        "batch_s": times,
        "bfs_s": sum(times),
        "validation_s": validation_s,
        "validated": validate_trees,
        "n_valid": len(roots) - len(failures) if validate_trees else None,
        "failures": failures[:4],
        "traversed_edges": [int(te) for _, te in checked],
        "teps": teps_list,
        "teps_harmonic_mean": teps.harmonic_mean(teps_list),
    }


def run(scale: int, edgefactor: int = 16, seed: int = 1, n_roots: int = 64,
        batch: int = 8, policy: str = "direction_opt", expand: str = "hybrid",
        validate_trees: bool = True, device=None) -> dict:
    """Build the graph, warm up on the first batch (untimed), search."""
    setup = build(scale, edgefactor, seed, expand, device)
    roots = teps.valid_roots(setup.g, n_roots, seed=2)
    bfsmod.bfs(setup.src, setup.dst, roots[:batch], setup.g.n, policy=policy,
               expand=setup.expand, device=setup.device, block=setup.block)
    out = search(setup, roots, batch, policy, validate_trees)
    out.update(summary(setup))
    return out


def summary(setup: Graph500Setup) -> dict:
    """The graph's shape and the set-up phases' times."""
    return {
        "scale": setup.scale,
        "edgefactor": setup.edgefactor,
        "n": setup.g.n,
        "m_stored": setup.g.m,
        "m_input": setup.g.m_input,
        "split_k": setup.split_k,
        "slab_edges": setup.slab_edges,
        "residue_edges": setup.residue_edges,
        "generation_s": setup.generation_s,
        "kernel1_s": setup.kernel1_s,
        "containers_s": setup.containers_s,
        "device": str(setup.device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--roots", type=int, default=64, help="spec says 64")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--policy", default="direction_opt",
                    choices=["top_down", "bottom_up", "direction_opt"])
    ap.add_argument("--expand", default="hybrid",
                    choices=["coo", "ell", "hybrid", "auto"])
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    out = run(args.scale, args.edgefactor, args.seed, args.roots, args.batch,
              args.policy, args.expand, not args.no_validate, args.device)
    if out["device"].startswith("cuda"):
        out["device_name"] = torch.cuda.get_device_name(0)
    print(f"# Graph500 scale={out['scale']} edgefactor={out['edgefactor']} "
          f"m={out['m_stored']:,} policy={out['policy']} expand={out['expand']} "
          f"batch={out['batch']} on {out.get('device_name', out['device'])}")
    print(f"generation {out['generation_s']:.3f}s  Kernel1 {out['kernel1_s']:.3f}s  "
          f"containers {out['containers_s']:.3f}s  BFS {out['bfs_s']:.3f}s  "
          f"validation {out['validation_s']:.3f}s")
    print(f"valid trees: {out['n_valid']}/{out['n_roots']}  "
          f"TEPS harmonic mean: {out['teps_harmonic_mean']:.6e}")
    print(json.dumps({k: v for k, v in out.items() if k not in ("teps", "traversed_edges")}))
    if out["validated"] and out["n_valid"] != out["n_roots"]:
        raise SystemExit(f"invalid BFS trees: {out['failures']}")
    return out


if __name__ == "__main__":
    main()
