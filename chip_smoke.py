#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's single-device Graph500 BFS path on one NVIDIA card:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. holds every kernel against its plain PyTorch version on the card, for
   exact equality, at ragged small shapes and at the main path's own
   shapes (B=8 planes of the scale-S graph, its hybrid slab, a real
   frontier and unreached plane), and times kernel and plain version;
4. runs the Graph500 harness (scale S, edgefactor 16, seed 1, 64 valid
   roots in batches of 8, ``direction_opt`` + ``hybrid``, every tree
   validated) with the launch counts zeroed just before and read just
   after; every kernel of the path must have launched;
5. cross-checks at scale 16: ``top_down``, ``bottom_up`` and
   ``direction_opt`` on the card and ``direction_opt`` on the CPU give
   bit-identical parents, levels and level counts.

    python3 chip_smoke.py [--scale 22]

It exits non-zero, printing no result, when CUDA is unavailable or the
repo's package is missing.  The last two lines before the final one are
the per-kernel JSON line and the card's name and power limit; the final
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

CHECK_SCALE = 16  # the cross-check's graph, small enough for the CPU run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores: the
#                        published 32-bit scalar rate the integer ops are held to
REPLACES = {
    "pack": "src/repro/kernels/bitpack/bitpack.py:50",
    "popcount_planes": "src/repro/kernels/popcount/popcount.py:50",
    "spmv_min_planes": "src/repro/kernels/spmv/spmv.py:171",
    "spmv_pull_min_planes": "src/repro/kernels/spmv/pull.py:89",
}
SOURCES = {
    "pack": "src/repro_torch/kernels/csrc/bitpack.cu",
    "popcount_planes": "src/repro_torch/kernels/csrc/popcount.cu",
    "spmv_min_planes": "src/repro_torch/kernels/csrc/spmv.cu",
    "spmv_pull_min_planes": "src/repro_torch/kernels/csrc/spmv.cu",
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


def expect(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {what}")


def check_ragged() -> None:
    """Exact kernel-vs-plain agreement on small ragged shapes."""
    import torch
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref
    from repro_torch.kernels.popcount import ops as pc_ops, ref as pc_ref
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    for n in (1, 1000, 5000, 9216):
        for b in bp_ref.B_CLASSES:
            vals = torch.randint(0, 2**b if b < 31 else 2**31 - 1, (3, n),
                                 generator=gen, device=dev, dtype=torch.int64)
            vals = vals.to(torch.int32)
            expect(same(bp_ops.pack_planes(vals, b), bp_ref.pack_planes(vals, b)), ('pack', n, b))
        bits = torch.rand((3, n), generator=gen, device=dev) < 0.3
        expect(same(bp_ops.pack_planes(bits, 1), bp_ref.pack_planes(bits, 1)), ('pack bool', n))
        expect(same(bp_ops.pack_planes(bits.to(torch.uint8), 1), bp_ref.pack_planes(bits, 1)),
               ('pack uint8', n))
    words = torch.randint(-2**31, 2**31 - 1, (5, 1500), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    expect(same(pc_ops.popcount_planes(words), pc_ref.popcount_planes(words)), 'popcount_planes')
    expect(same(pc_ops.popcount_words(words), pc_ref.popcount_words(words)), 'popcount_words')
    for n_rows, k, planes in ((3001, 13, 11), (1024, 8, 8), (77, 1, 3)):
        n_real = 4500
        n_cols = n_real + (-n_real) % 1024
        nbr = torch.randint(0, n_real, (n_rows, k), generator=gen, device=dev,
                            dtype=torch.int32)
        nbr[torch.rand((n_rows, k), generator=gen, device=dev) < 0.3] = n_real
        f = bp_ops.pack_planes(torch.rand((planes, n_real), generator=gen, device=dev) < 0.2, 1)
        u = bp_ops.pack_planes(torch.rand((planes, n_rows), generator=gen, device=dev) < 0.5, 1)
        expect(same(sp_ops.spmv_min_planes(nbr, f, n_cols),
                    sp_ref.spmv_min_planes(nbr, f, n_cols)), ("push", n_rows, k, planes))
        expect(same(sp_ops.spmv_pull_min_planes(nbr, f, u, n_cols),
                    sp_ref.spmv_pull_min_planes(nbr, f, u, n_cols)), ("pull", n_rows, k, planes))
    torch.cuda.synchronize()


def main_shape_rows(setup, roots) -> dict:
    """Kernel vs plain version at the main path's shapes: B=8 planes of the
    graph, its slab, and the frontier/unreached planes of a real batch at
    its densest level (timed) and at level 1 (a sparse frontier)."""
    import torch
    from repro_torch.core import bfs as bfsmod
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref
    from repro_torch.kernels.popcount import ops as pc_ops, ref as pc_ref
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    n = setup.g.n
    nbr = setup.block.nbr
    res = bfsmod.bfs(setup.src, setup.dst, roots, n, policy="direction_opt",
                     expand="hybrid", device="cuda", block=setup.block)
    level = res.level
    sizes = torch.stack([(level == d).sum() for d in range(1, res.n_levels + 1)])
    dense = int(sizes.argmax()) + 1
    n_cp = bp_ref.chunk_pad(n)
    rows = {}
    for d in sorted({1, dense}):
        frontier = level == d
        unreached = (level < 0) | (level > d)
        f = bp_ops.pack_planes(frontier, 1)
        u = bp_ops.pack_planes(unreached, 1)
        checks = {
            "pack": (lambda: bp_ops.pack_planes(frontier, 1),
                     lambda: bp_ref.pack_planes(frontier, 1)),
            "popcount_planes": (lambda: pc_ops.popcount_planes(f),
                                lambda: pc_ref.popcount_planes(f)),
            "spmv_min_planes": (lambda: sp_ops.spmv_min_planes(nbr, f, n_cp),
                                lambda: sp_ref.spmv_min_planes(nbr, f, n_cp)),
            "spmv_pull_min_planes": (lambda: sp_ops.spmv_pull_min_planes(nbr, f, u, n_cp),
                                     lambda: sp_ref.spmv_pull_min_planes(nbr, f, u, n_cp)),
        }
        for name, (kern, plain) in checks.items():
            a, b = kern(), plain()
            torch.cuda.synchronize()
            expect(same(a, b), (name, "level", d))
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            if d != dense:
                continue
            planes, r = frontier.shape[0], nbr.shape[0]
            wf, wu = f.shape[1], u.shape[1]
            k = nbr.shape[1]
            if name == "pack":
                nbytes, ops_n = planes * n + planes * wf * 4, 2 * planes * n_cp
            elif name == "popcount_planes":
                nbytes, ops_n = planes * wf * 4 + planes * 4, 2 * planes * wf
            elif name == "spmv_min_planes":
                nbytes = r * k * 4 + planes * wf * 4 + planes * r * 4
                ops_n = 4 * r * k * planes
            else:  # pull: only rows still unreached in some plane read the slab
                live = int(unreached.any(dim=0).sum())
                probes = int(unreached.sum())
                nbytes = live * k * 4 + planes * (wf + wu) * 4 + planes * r * 4
                ops_n = 4 * probes * k
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_n / ALU_OPS_PER_S * 1e3
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": None,
                "max_abs_err": err,
                "ms": time_ms(kern, 50), "plain_ms": time_ms(plain, 5),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None,
                "shape": {"planes": planes, "n": n, "slab": list(nbr.shape),
                          "level": d, "frontier": int(frontier.sum()),
                          "unreached": int(unreached.sum())},
            }
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.bench import graph500, teps
    from repro_torch.core import bfs as bfsmod

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib, log = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f}s -> {lib.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    check_ragged()
    print("ragged shapes: pack (b=1..32, bool/uint8/int32), popcount_planes, "
          "popcount_words, spmv push/pull: exact")

    setup = graph500.build(args.scale, 16, 1, "hybrid", "cuda")
    info = graph500.summary(setup)
    print(f"graph: scale {args.scale} n={info['n']:,} m_stored={info['m_stored']:,} "
          f"K={info['split_k']} slab_edges={info['slab_edges']:,} "
          f"residue_edges={info['residue_edges']:,} "
          f"({100 * info['residue_edges'] / info['m_stored']:.2f}% in the COO residue)")
    print(f"phases: generation {info['generation_s']:.3f}s kernel1 "
          f"{info['kernel1_s']:.3f}s containers {info['containers_s']:.3f}s")
    roots = teps.valid_roots(setup.g, 64, seed=2)

    rows = main_shape_rows(setup, roots[:8])
    for r in rows.values():
        print(f"kernel {r['name']}: exact at {r['shape']}; {r['ms'] * 1e3:.2f} us vs plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}) on {card}")

    kernels.reset_launches()
    out = graph500.search(setup, roots, batch=8, policy="direction_opt")
    launches = dict(kernels.LAUNCHES)
    levels = sum(out["depths"])
    print(f"phases: bfs {out['bfs_s']:.3f}s validation {out['validation_s']:.3f}s "
          f"(batches {[round(t, 4) for t in out['batch_s']]}, depths {out['depths']})")
    print(f"launches on the main path ({levels} levels over {len(out['depths'])} batches): "
          f"{launches}")
    missing = [k for k in REPLACES if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing}")
    if out["n_valid"] != out["n_roots"]:
        raise AssertionError(f"invalid trees: {out['failures']}")
    print(f"Graph500 scale {args.scale}: {out['n_valid']}/{out['n_roots']} trees valid, "
          f"TEPS harmonic mean {out['teps_harmonic_mean']:.6e} on {card}")

    small = graph500.build(CHECK_SCALE, 16, 1, "hybrid", "cuda")
    small_cpu = graph500.build(CHECK_SCALE, 16, 1, "hybrid", "cpu")
    sroots = teps.valid_roots(small.g, 8, seed=2)
    results = {}
    for policy in ("top_down", "bottom_up", "direction_opt"):
        r = bfsmod.bfs(small.src, small.dst, sroots, small.g.n, policy=policy,
                       expand="hybrid", device="cuda", block=small.block)
        results[f"cuda/{policy}"] = (r.parent.cpu(), r.level.cpu(), r.n_levels)
    r = bfsmod.bfs(small_cpu.src, small_cpu.dst, sroots, small_cpu.g.n,
                   policy="direction_opt", expand="hybrid", device="cpu",
                   block=small_cpu.block)
    results["cpu/direction_opt"] = (r.parent, r.level, r.n_levels)
    base = results["cpu/direction_opt"]
    for key, (parent, level, depth) in results.items():
        if not (same(parent, base[0]) and same(level, base[1]) and depth == base[2]):
            raise AssertionError(f"{key} differs from cpu/direction_opt at scale "
                                 f"{CHECK_SCALE}")
    print(f"cross-check scale {CHECK_SCALE}: {sorted(results)} identical "
          f"(parents, levels, n_levels={base[2]})")

    for name, r in rows.items():
        r["launches"] = launches[name]
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
