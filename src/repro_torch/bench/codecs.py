"""Paper Tables 5.4/5.5 on the port: the codec comparison (ratio, bits per
integer, compression and decompression speed).

The port's counterpart of ``benchmarks/codecs.py``, over two data sets as
in the paper:

* the sorted vertex ids of one frontier of a BFS run on the device over a
  Graph500 Kronecker graph (Table 5.4; the paper measured a uniform,
  slightly skewed stream of ~15-bit entropy), and
* a Zipf-skewed inverted-index-like stream (Table 5.5, the TREC-GOV2
  analog).

The codecs are the host codecs of :mod:`repro_torch.comm.codecs`, resolved
by name through the factory (:mod:`repro_torch.comm.registry`).  They run
on the host CPU, as in the reference: the C/D speeds (millions of integers
a second) are host CPU times, and the printout names that CPU.

    python -m repro_torch.bench.codecs [--scale 14] [--root 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import platform
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.comm import codecs, registry
from repro_torch.core import bfs as bfsmod
from repro_torch.graphgen import builder, kronecker, zipf


def host_cpu() -> str:
    """The host CPU the C/D speeds are measured on: its model name from
    ``/proc/cpuinfo``, or, where that reads ``unknown``, its vendor, family
    and model numbers; and the CPU count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("vendor_id", "cpu family", "model", "model name") and key not in info:
                    info[key] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown" and "vendor_id" in info:
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} model "
                f"{info.get('model', '?')}")
    elif name == "unknown":
        name = platform.processor() or platform.machine()
    return f"{name}, {os.cpu_count()} CPUs"


def frontier_ids(src, dst, n: int, root: int = 0, level: int = 3, device=None,
                 **bfs_kw) -> np.ndarray:
    """The sorted vertex ids at distance ``level`` from ``root``, from a BFS
    on ``device``; ``bfs_kw`` go to ``bfs`` (``policy``, ``expand``,
    ``block``: every choice gives the same levels)."""
    res = bfsmod.bfs(src, dst, root, n, device=resolve_device(device), **bfs_kw)
    return np.nonzero(res.level.cpu().numpy() == level)[0].astype(np.uint32)


def extract_frontier_stream(scale: int = 14, level: int = 3, seed: int = 1, root: int = 0,
                            device=None) -> np.ndarray:
    """Run a real BFS and extract the sorted vertex ids of one frontier."""
    g = builder.build_csr(kronecker.kronecker_edges(scale, seed=seed), n=1 << scale)
    return frontier_ids(g.src, g.dst, g.n, root, level, device)


def bench_codec(codec: codecs.Codec, values: np.ndarray, repeat: int = 3):
    blob = codec.encode(values)
    t0 = time.perf_counter()
    for _ in range(repeat):
        codec.encode(values)
    enc_s = (time.perf_counter() - t0) / repeat
    t0 = time.perf_counter()
    for _ in range(repeat):
        codec.decode(blob, values.size)
    dec_s = (time.perf_counter() - t0) / repeat
    bits_per_int = len(blob) * 8 / values.size
    return {
        "codec": codec.name,
        "ratio_pct": 100.0 * len(blob) / (values.size * 4),
        "bits_per_int": bits_per_int,
        "c_speed_mis": values.size / enc_s / 1e6,
        "d_speed_mis": values.size / dec_s / 1e6,
    }


def zipf_index_stream(n_zipf: int = 200_000) -> np.ndarray:
    """Table 5.5's stream: the sorted distinct values of ``n_zipf`` Zipf
    draws (alpha 1.2, seed 0)."""
    return np.sort(np.unique(zipf.zipf_stream(n_zipf, alpha=1.2, seed=0))).astype(np.uint32)


def run(scale: int = 14, n_zipf: int = 200_000, root: int = 0, device=None,
        frontier: np.ndarray | None = None, repeat: int = 3) -> list[dict]:
    """The reference's rows: the frontier's gap entropy, then every codec on
    the frontier (level 3 of the scale-``scale`` graph from ``root``,
    unless ``frontier`` is given) and on the Zipf index stream."""
    rows = []
    if frontier is None:
        frontier = extract_frontier_stream(scale=scale, root=root, device=device)
    gaps = codecs.delta_encode(frontier)
    h = zipf.empirical_entropy_bits(gaps)
    rows.append({"codec": f"H(x)_gaps={h:.2f}bit", "dataset": "frontier"})
    for name in registry.available_codecs():
        c = registry.make_codec(name)
        if name == "bitmap" and frontier.size == 0:
            continue
        r = bench_codec(c, frontier, repeat)
        r["dataset"] = "frontier"
        rows.append(r)
    stream = zipf_index_stream(n_zipf)
    for name in registry.available_codecs():
        c = registry.make_codec(name)
        r = bench_codec(c, stream, repeat)
        r["dataset"] = "zipf-index"
        rows.append(r)
    return rows


def csv_lines(rows: list[dict]) -> list[str]:
    """The rows as the reference's CSV (header first); the speeds are host
    CPU times."""
    lines = ["codec,dataset,ratio_pct,bits_per_int,c_speed_MI/s,d_speed_MI/s"]
    for r in rows:
        if "ratio_pct" in r:
            lines.append(f"{r['codec']},{r['dataset']},{r['ratio_pct']:.2f},"
                         f"{r['bits_per_int']:.2f},{r['c_speed_mis']:.1f},"
                         f"{r['d_speed_mis']:.1f}")
        else:
            lines.append(f"{r['codec']},{r['dataset']},,,,")
    return lines


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--root", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    frontier = extract_frontier_stream(args.scale, root=args.root, device=dev)
    rows = run(frontier=frontier)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# frontier: scale={args.scale} level=3 root={args.root} {frontier.size} ids "
          f"(BFS on {where}); zipf-index: {zipf_index_stream().size} values")
    print(f"# C/D speeds: host CPU {host_cpu()}")
    print("\n".join(csv_lines(rows)))
    return rows


if __name__ == "__main__":
    main()
