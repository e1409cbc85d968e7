"""Paper Fig 5.2 / Table 5.3 on the port: the statistical profile of the
transmitted frontiers.

The port's counterpart of ``benchmarks/frontier_stats.py``.  One BFS runs
on the device (``bfs_levels``); each level's vertex ids come from one host
copy of the levels, and each level's size from the density oracle's
``local_count`` on the device (one width-1 pack and one
``popcount_blocks`` launch a level), which must equal the number of ids.
Per level: the size and density, the direction the oracle's alpha/beta
hysteresis picks on that count (paper §3.1: the statistic that picks the
wire also picks push or pull), the empirical entropy of the ids and of
their gaps, the mean and largest gap, and the skewness of the ids.

    python -m repro_torch.bench.frontier_stats [--scale 14] [--root 0] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm import codecs
from repro_torch.core import bfs as bfsmod
from repro_torch.core import traversal
from repro_torch.graphgen import builder, kronecker, zipf


def profile(src, dst, n: int, m: int, root: int = 0, max_levels: int = 32, device=None,
            **bfs_kw) -> dict:
    """The per-level profile of a BFS from ``root`` over a symmetric edge
    list: ``{"n", "m", "root", "n_levels", "levels": [...]}``, one entry a
    level of two or more vertices.  ``bfs_kw`` go to ``bfs_levels``
    (``policy``, ``expand``, ``block``); every policy and backend gives the
    same levels.  Raises if a level's device count differs from its ids."""
    dev = resolve_device(device)
    res, _ = bfsmod.bfs_levels(src, dst, root, n, max_levels=max_levels, device=dev,
                               **bfs_kw)
    lv = res.level.cpu().numpy()
    oracle = traversal.DensityOracle(n)
    use_bu = torch.zeros((), dtype=torch.bool, device=dev)
    out = {"n": n, "m": m, "root": int(root), "n_levels": res.n_levels, "levels": []}
    for level in range(1, res.n_levels + 1):
        ids = np.nonzero(lv == level)[0].astype(np.uint32)
        count = oracle.local_count(res.level == level)
        use_bu = oracle.next_direction(count, use_bu)
        host_count, host_bu = torch.stack([count, use_bu.to(torch.int32)]).tolist()
        if host_count != ids.size:
            raise AssertionError(f"level {level}: the device count {host_count} differs "
                                 f"from the {ids.size} ids")
        if ids.size < 2:
            continue
        gaps = codecs.delta_encode(ids)
        mean = ids.mean()
        std = ids.std()
        skew = float(((ids - mean) ** 3).mean() / (std**3 + 1e-12))
        out["levels"].append(
            {
                "level": level,
                "count": int(ids.size),
                "density": ids.size / n,
                "direction": "bottom_up" if host_bu else "top_down",
                "id_entropy_bits": zipf.empirical_entropy_bits(ids),
                "gap_entropy_bits": zipf.empirical_entropy_bits(gaps),
                "mean_gap": float(gaps[1:].mean()) if gaps.size > 1 else 0.0,
                "max_gap": int(gaps.max()),
                "skewness": skew,
            }
        )
    return out


def run(scale: int = 14, seed: int = 1, root: int = 0, max_levels: int = 32,
        device=None) -> dict:
    """The profile of the Graph500 Kronecker graph of ``scale`` (edgefactor
    16) from ``root``, under the reference's defaults (``top_down``,
    ``coo``)."""
    g = builder.build_csr(kronecker.kronecker_edges(scale, seed=seed), n=1 << scale)
    out = profile(g.src, g.dst, g.n, g.m, root, max_levels, device)
    return {"scale": scale, **out}


def rows(r: dict) -> list[str]:
    """The profile as the reference's CSV lines (header first)."""
    lines = ["level,count,density,direction,id_H_bits,gap_H_bits,mean_gap,max_gap,skewness"]
    for lv in r["levels"]:
        lines.append(f"{lv['level']},{lv['count']},{lv['density']:.4f},{lv['direction']},"
                     f"{lv['id_entropy_bits']:.2f},{lv['gap_entropy_bits']:.2f},"
                     f"{lv['mean_gap']:.1f},{lv['max_gap']},{lv['skewness']:.4f}")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--root", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    r = run(args.scale, root=args.root, device=args.device)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# scale={r['scale']} n={r['n']} m={r['m']} root={r['root']} "
          f"levels={r['n_levels']} (counts by local_count on {where})")
    print("\n".join(rows(r)))
    return r


if __name__ == "__main__":
    main()
