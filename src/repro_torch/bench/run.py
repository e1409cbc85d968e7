"""Run the port's benchmarks at reduced size, one CSV block per paper table,
and write the BENCH_comm document.

The port's counterpart of ``benchmarks/run.py``: the codec study (Tables
5.4/5.5), the frontier profile (Fig 5.2 / Table 5.3), the host byte replay
(Tables 7.4/7.5), the zone and expansion breakdown (Fig 7.3), the Graph500
TEPS row, and with ``--full`` the scaling study (Fig 7.1/7.2).  The
document (the reference's BENCH_comm.json layout: per-zone, per-format
bytes of the replay, per-level directions, the multi-source batch section,
the expansion times and the TEPS row) goes to ``--bench-json``, and
:mod:`repro_torch.bench.check_comm` checks it at the end.

    python -m repro_torch.bench.run [--full] [--skip scaling] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch import resolve_device
from repro_torch.bench import (bfs_comm, breakdown, card, check_comm, codecs, frontier_stats,
                               graph500, scaling)
from repro_torch.core import csr as csrmod

DEFAULT_JSON = os.path.join("build", "BENCH_comm_torch.json")


def bench_comm_size(full: bool) -> tuple[int, int, int]:
    """(scale, rows, cols) of the replay and the expansion breakdown."""
    return (17, 4, 4) if full else (15, 2, 2)


def teps_row(scale: int = 13, n_roots: int = 8, device=None) -> dict:
    """The Graph500 Kernel-2 row: harmonic-mean TEPS over the spec's
    valid-root sample, every tree validated, one batch of ``n_roots``."""
    out = graph500.run(scale, n_roots=n_roots, batch=n_roots, device=device)
    return {"scale": scale, "n": out["n"], "m_input": out["m_input"],
            "kernel1_s": out["kernel1_s"], "n_roots": n_roots,
            "teps_harmonic_mean": out["teps_harmonic_mean"],
            "mean_time_s": out["bfs_s"] / n_roots, "validated": out["validated"],
            "n_valid": out["n_valid"], "card": card(device)}


def bench_comm_doc(scale: int, rows: int, cols: int, table: list[dict], policy_levels: dict,
                   batch: dict, compute: dict | None = None, teps: dict | None = None) -> dict:
    """The BENCH_comm document of the replay's results at ``scale`` on a
    ``rows`` x ``cols`` grid (the reference's layout); the batch section's
    totals ride the table as ``zone="total"`` rows, single-source rows carry
    ``batch=1``."""
    n, chunk = csrmod.padded_geometry(1 << scale, rows, cols)
    table = [dict(r) for r in table]
    for r in table:
        r.setdefault("batch", 1)
    for policy, entry in batch["policies"].items():
        for plan, d in entry["plans"].items():
            table.append({"policy": policy, "zone": "total", "format": "packed",
                          "plan": plan, "batch": d["batch"], "bytes": d["total_bytes"],
                          "bytes_per_source": d["bytes_per_source"],
                          "b1_total_bytes": d["b1_total_bytes"]})
    return {"benchmark": "bfs_comm", "scale": scale, "rows": rows, "cols": cols,
            "chunk": chunk, "n": n, "policies": list(bfs_comm.POLICIES),
            "plans": list(bfs_comm.PLANS), "table": table,
            "policy_levels": policy_levels or {}, "batch": batch,
            "compute": compute or {}, "teps": teps or {}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="paper-closer sizes (slow)")
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--bench-json", default=DEFAULT_JSON,
                    help="where to write the BENCH_comm document")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))
    scale, rows, cols = bench_comm_size(args.full)
    box: dict = {}  # what the suites hand the document

    def bfs_comm_suite() -> None:
        prebuilt = bfs_comm.build_replay_graph(scale, rows, cols)
        table, policy_levels = bfs_comm.run(scale, rows, cols, prebuilt=prebuilt)
        bfs_comm.print_table(table)
        bfs_comm.print_levels(policy_levels)
        batch = bfs_comm.run_batch(scale, rows, cols, prebuilt=prebuilt)
        bfs_comm.print_batch(batch)
        box["replay"] = (table, policy_levels, batch)

    def breakdown_suite() -> None:
        breakdown.print_zones(breakdown.run(device=dev))
        box["compute"] = breakdown.expansion_breakdown(scale, rows, cols, device=dev)
        breakdown.print_expansion(box["compute"])

    def teps_suite() -> None:
        box["teps"] = teps_row(device=dev)
        r = box["teps"]
        print("scale,n,m_input,kernel1_s,n_roots,TEPS_harmonic,mean_time_s,validated")
        print(f"{r['scale']},{r['n']},{r['m_input']},{r['kernel1_s']:.3f},"
              f"{r['n_roots']},{r['teps_harmonic_mean']:.3e},{r['mean_time_s']:.4f},"
              f"{r['validated']}  ({r['card']})")

    suites = [
        ("codecs (Tables 5.4/5.5)", lambda: codecs.main(["--device", dev])),
        ("frontier_stats (Fig 5.2 / Table 5.3)", lambda: frontier_stats.main(["--device", dev])),
        ("bfs_comm (Tables 7.4/7.5)", bfs_comm_suite),
        ("breakdown (Fig 7.3 + expansion backends)", breakdown_suite),
        ("teps (§2.6.3)", teps_suite),
    ]
    if args.full:
        suites.append(("scaling (Fig 7.1/7.2)", lambda: scaling.main(["--device", dev])))

    failures = []
    for name, fn in suites:
        if name.split(" ")[0] in args.skip:
            continue
        print(f"\n===== {name} =====")
        t0 = time.time()
        try:
            fn()
            print(f"# done in {time.time() - t0:.1f}s")
        except Exception:  # noqa: BLE001
            failures.append(name)
            traceback.print_exc()
    # the document takes the suite's replay; a skipped or failed bfs_comm
    # is not re-run here
    if "bench-json" not in args.skip and "replay" in box:
        try:
            doc = bench_comm_doc(scale, rows, cols, *box["replay"],
                                 compute=box.get("compute"), teps=box.get("teps"))
            os.makedirs(os.path.dirname(args.bench_json) or ".", exist_ok=True)
            with open(args.bench_json, "w") as f:
                json.dump(doc, f, indent=2)
            print(f"# wrote {args.bench_json} ({len(doc['table'])} rows)")
            n_stages, n_batch = check_comm.verify(args.bench_json)
            print(f"BENCH BTFLY BYTE MODEL OK ({n_stages} stage entries checked)")
            print(f"BENCH BATCH MODEL OK ({n_batch} batch entries checked, B={doc['batch']['B']})")
        except (Exception, SystemExit):  # noqa: BLE001
            failures.append("bench-json")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"benchmark failures: {failures}")
    print("\nALL BENCHMARKS OK")


if __name__ == "__main__":
    main()
