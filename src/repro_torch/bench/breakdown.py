"""Paper Fig 7.3: the time of each zone of one BFS level, and the local
expansion per level and backend.

The port's counterpart of ``benchmarks/breakdown.py``.  :func:`run` times
each zone of one level of the 2D algorithm on block (0, 0) of the
partition, on real data: the local expansion (push and pull), the column
wire's pack and unpack (delta + PFOR16 id stream), the row wire's pack and
unpack (the id stream with its global-parent payload, and the found-bitmap
+ packed-parent floor of the butterfly stages), the bitmap pack and the
frontier compaction.  The share of wire bytes per zone comes from the host
replay (:mod:`repro_torch.bench.bfs_comm`); no link is timed.
:func:`expansion_breakdown` times each expansion backend's push and pull
at every level of the hub-root BFS on block (0, 0), with the reference's
pure-ELL slab budget.

Times are CUDA-event times on the card (host launch cost included) and
carry the card's name and power limit; on ``--device cpu`` they are host
times and say so.

    python -m repro_torch.bench.breakdown --scale 22 [--grid 2x2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bench import bfs_comm, card, mean_us
from repro_torch.comm import butterfly
from repro_torch.comm.formats import (INF, BitmapParentFormat, IdStreamFormat, IdStreamSpec,
                                      pack_bitmap)
from repro_torch.core import csr as csrmod
from repro_torch.core import expand as expand_mod
from repro_torch.core import validate
from repro_torch.core.algebra import width_class
from repro_torch.graphgen import builder, kronecker
from repro_torch.kernels.bitpack import ops as bp

#: the level :func:`run` times (the reference's): the hub root's second ring
ZONE_LEVEL = 2
#: the Kronecker seeds of the reference: the zone graph (:func:`run`,
#: :func:`wire_share`) and the expansion graph (:func:`expansion_breakdown`)
ZONE_SEED, EXPANSION_SEED = 3, 1
#: the expansion backend whose push and pull :func:`run` times
ZONE_EXPAND = "hybrid"

#: pure-ELL slab budget: hub blocks whose container would exceed this are
#: recorded as skipped (the affordability cliff the hybrid split is for)
ELL_SLAB_BUDGET_BYTES = 1 << 28


def _graph(scale: int, seed: int, g=None):
    return g if g is not None else builder.build_csr(
        kronecker.kronecker_edges(scale, seed=seed), n=1 << scale)


def _block00(backend, bg, dev):
    """Block (0, 0) of ``bg`` in ``backend``'s containers, on ``dev``."""
    part = bg.part
    extra = tuple(a[0, 0] for a in backend.block_arrays(bg))
    return backend.local_block(bg.src_local[0, 0], bg.dst_local[0, 0], extra, part.n_r,
                               part.n_c, dev)


def run(scale: int = 13, rows: int = 2, cols: int = 2, device=None, repeats: int = 10,
        g=None) -> dict:
    """Zone -> microseconds per call at level ZONE_LEVEL of the hub-root BFS
    on block (0, 0) of the ZONE_SEED graph (or ``g``): the expansion
    through ZONE_EXPAND and the wire codecs
    at the level's own streams (the column stream of the owned chunk 0 and
    the row stream block (0, 0) sends chunk 0, each capped at the largest
    bucket's 65,536 ids)."""
    dev = resolve_device(device)
    g = _graph(scale, ZONE_SEED, g)
    bg = csrmod.partition_2d(g, rows=rows, cols=cols)
    part = bg.part
    s = part.chunk
    root = int(np.argmax(g.degrees()))
    level = np.full(part.n, -1, np.int64)
    level[: g.n] = validate.reference_bfs(g, root)
    backend = expand_mod.resolve(ZONE_EXPAND)
    blk = _block00(backend, bg, dev)
    f_col = torch.as_tensor(level[: part.n_c] == ZONE_LEVEL, device=dev)[None]
    un = torch.as_tensor((level[: part.n_r] > ZONE_LEVEL) | (level[: part.n_r] < 0),
                         device=dev)[None]
    # block (0, 0)'s candidates for chunk 0 (column 0: local ids are global)
    cand = backend.push_planes(blk, f_col)[:, :s].contiguous()

    cap = min(s, 1 << 16)
    col_fmt = IdStreamFormat(IdStreamSpec(cap))
    row_fmt = IdStreamFormat(IdStreamSpec(cap), payload_width=width_class(part.n))
    col_ids, col_count = bp.compact_ids(f_col[:, :s], s, fill=s)
    col_count = torch.clamp(col_count, max=cap)
    row_ids, row_count = bp.compact_ids(cand < INF, s, fill=s)
    row_count = torch.clamp(row_count, max=cap)
    par = torch.gather(cand, 1, torch.clamp(row_ids[:, :cap], 0, s - 1).to(torch.int64))
    col_words, col_meta = col_fmt.pack(col_ids, col_count)
    row_words, row_meta = row_fmt.pack(row_ids, row_count, payload=par)
    _, floor = butterfly.row_wire(s, part.n)
    floor_words = floor.pack(cand) if isinstance(floor, BitmapParentFormat) else None

    zones = {
        f"localExpansion(push,{ZONE_EXPAND})": lambda: backend.push_planes(blk, f_col),
        f"localExpansion(pull,{ZONE_EXPAND})": lambda: backend.pull_planes(blk, f_col, un),
        "columnPack(delta+PFOR16)": lambda: col_fmt.pack(col_ids, col_count),
        "columnUnpack(+cumsum)": lambda: col_fmt.unpack(col_words, col_meta, fill=s),
        f"rowPack(delta+PFOR16+p{row_fmt.payload_width})":
            lambda: row_fmt.pack(row_ids, row_count, payload=par),
        "rowUnpack(+cumsum)": lambda: row_fmt.unpack(row_words, row_meta, fill=s),
        "bitmapPack": lambda: pack_bitmap(f_col[:, :s]),
        "frontierCompact": lambda: bp.compact_ids(f_col[:, :s], s, fill=s),
    }
    if floor_words is not None:
        zones[f"rowPack({floor.name})"] = lambda: floor.pack(cand)
        zones[f"rowUnpack({floor.name})"] = lambda: floor.unpack(floor_words)
    return {
        "scale": scale, "rows": rows, "cols": cols, "block": [0, 0], "root": root,
        "level": ZONE_LEVEL, "chunk": s, "expand": ZONE_EXPAND,
        "frontier": int(f_col.sum()), "column_ids": int(col_count.sum()),
        "row_candidates": int((cand < INF).sum()),
        "card": card(dev), "timer": "cuda events" if dev.type == "cuda" else "host clock",
        "zones_us": {name: mean_us(fn, repeats, dev) for name, fn in zones.items()},
    }


def wire_share(scale: int = 13, rows: int = 2, cols: int = 2, g=None) -> dict:
    """Zone -> share of the packed wire's bytes over a whole ``direction_opt``
    BFS from the hub root of the ZONE_SEED graph (or ``g``): the host
    replay's Table 7.4 zones, the direct row plan, and the butterfly row
    bytes beside the direct ones."""
    policy = "direction_opt"
    g = _graph(scale, ZONE_SEED, g)
    prebuilt = (g, csrmod.partition_2d(g, rows=rows, cols=cols).part,
                validate.reference_bfs(g, int(np.argmax(g.degrees()))))
    stats, _, _, levels = bfs_comm.simulate_zones(scale, rows, cols, policy=policy,
                                                  prebuilt=prebuilt)
    packed = {zone: fmts["packed"] for zone, fmts in stats.per_phase_fmt().items()}
    total = sum(packed.values())
    return {"policy": policy, "packed_bytes": packed,
            "share": {zone: b / total for zone, b in packed.items()},
            "row_bytes_btfly": sum(d["row_bytes_btfly"] for d in levels)}


def expansion_breakdown(scale: int = 15, rows: int = 2, cols: int = 2, repeats: int = 5,
                        device=None) -> dict:
    """Per-level local-expansion time of each backend (coo / ell / hybrid)
    on block (0, 0) of the EXPANSION_SEED graph: the hub-root BFS replayed
    level by level, each
    backend's push and pull of the real frontier timed.  A pure-ELL slab
    above ELL_SLAB_BUDGET_BYTES is recorded as skipped with its size."""
    dev = resolve_device(device)
    g = _graph(scale, EXPANSION_SEED)
    bg = csrmod.partition_2d(g, rows=rows, cols=cols)
    part = bg.part
    root = int(np.argmax(g.degrees()))
    level = validate.reference_bfs(g, root)
    level_pad = np.full(part.n, -1, level.dtype)
    level_pad[: g.n] = level
    col_slice = level_pad[: part.n_c]  # block (0, 0) reads column slice 0
    row_slice = level_pad[: part.n_r]
    out = {"scale": scale, "rows": rows, "cols": cols, "block": [0, 0], "root": root,
           "backends": {}, "card": card(dev),
           "timer": "cuda events" if dev.type == "cuda" else "host clock"}
    for name in expand_mod.BACKENDS:
        backend = expand_mod.resolve(name)
        if name == "ell":
            # the width ell_blocked would allocate (the max over all blocks)
            k = csrmod.ell_slab_width(bg)
            slab_bytes = rows * cols * part.n_r * k * 4
            if slab_bytes > ELL_SLAB_BUDGET_BYTES:
                out["backends"][name] = {
                    "skipped": f"pure-ELL slab would be {slab_bytes} bytes "
                    f"(k={k} from the hub rows) — the cliff hybrid avoids",
                    "slab_bytes": slab_bytes,
                }
                continue
        blk = _block00(backend, bg, dev)
        levels = []
        for lv in range(int(level.max())):
            f_col = torch.as_tensor(col_slice == lv, device=dev)[None]
            un = torch.as_tensor((row_slice > lv) | (row_slice < 0), device=dev)[None]
            levels.append({
                "level": lv, "frontier": int(np.sum(col_slice == lv)),
                "push_us": mean_us(lambda: backend.push_planes(blk, f_col), repeats, dev),
                "pull_us": mean_us(lambda: backend.pull_planes(blk, f_col, un), repeats, dev),
            })
        entry = {"levels": levels}
        info = backend.describe(bg)
        if info:
            entry["split_k"] = info[0]["split_k"]
            entry["padding_ratio"] = info[0]["padding_ratio"]
        out["backends"][name] = entry
    return out


def print_zones(res: dict) -> None:
    print(f"# zones of level {res['level']} on block (0,0), scale {res['scale']} "
          f"{res['rows']}x{res['cols']} (chunk {res['chunk']}, frontier {res['frontier']}, "
          f"row candidates {res['row_candidates']}): {res['timer']} us per call on "
          f"{res['card']}")
    print("zone,us_per_call")
    for k, v in res["zones_us"].items():
        print(f"{k},{v:.2f}")


def print_expansion(compute: dict) -> None:
    print(f"# local expansion per level, block (0,0): {compute.get('timer', 'wall')} us "
          f"per call on {compute.get('card', '?')}")
    print("backend,level,frontier,push_us,pull_us")
    for name, entry in compute["backends"].items():
        if "skipped" in entry:
            print(f"{name},skipped,,{entry['skipped']!r},")
            continue
        for d in entry["levels"]:
            print(f"{name},{d['level']},{d['frontier']},"
                  f"{d['push_us']:.1f},{d['pull_us']:.1f}")


def print_share(share: dict) -> None:
    print(f"# share of the packed wire's bytes per zone ({share['policy']}, host replay, "
          f"direct row plan; butterfly row bytes {share['row_bytes_btfly']:,})")
    print("zone,packed_bytes,share")
    for zone, b in share["packed_bytes"].items():
        print(f"{zone},{b},{share['share'][zone]:.4f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--grid", default="2x2", help="R x C, e.g. 2x2")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    rows, cols = (int(x) for x in args.grid.lower().split("x"))
    g = _graph(args.scale, ZONE_SEED)  # the zones' graph, shared with the wire share
    res = {"zones": run(args.scale, rows, cols, args.device, g=g),
           "compute": expansion_breakdown(args.scale, rows, cols, device=args.device),
           "share": wire_share(args.scale, rows, cols, g=g)}
    print_zones(res["zones"])
    print_expansion(res["compute"])
    print_share(res["share"])
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
