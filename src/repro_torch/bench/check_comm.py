"""Verify a BENCH_comm document's staged butterfly volumes against the
static byte model, and the multi-source batch acceptance invariant.

The port's copy of ``scripts/check_bench_comm.py`` as a module: it checks
a document (a dict, or the path of its JSON file) that
:mod:`repro_torch.bench.run` wrote from the host replay
:mod:`repro_torch.bench.bfs_comm`, and prices value-payload ledger records.

    python -m repro_torch.bench.check_comm [build/BENCH_comm_torch.json]

Every ``btfly_stages`` entry the host replay logged must satisfy

    bytes == senders * subchunks * stage_unit_bytes(s, n, fmt, b=batch)

up to one packing chunk of padding per subchunk-plane — the stage formats
are static-geometry wire formats, so any larger disagreement means the
replay and the device wire plan have diverged (the exact contamination the
butterfly-vs-alltoall comparison must not carry).  Also re-checks that the
per-level ``row_bytes_btfly`` totals equal the sum of their stages and that
the table's btfly row equals the per-level sum.

The ``batch`` section adds the multi-source invariant: ``bytes_per_source``
at B>1 must sit strictly below the B=1 total of the same packed-wire model
for both row-phase plans on the policies whose wire actually amortizes
(top_down's id-stream headers; direction_opt's shared degree psum + mixed
wires).  Pure bottom_up's direct pull wire is density-independent per
plane — every component scales linearly — so it is held to non-strict
(no regression) instead.
"""

from __future__ import annotations

import json
import sys

from repro_torch.comm import butterfly

#: slack per subchunk-plane: one 1024-value packing chunk of u32 words
PAD_BYTES = 4 * 1024

#: policies whose batched packed wire must be STRICTLY cheaper per source
STRICT_BATCH_POLICIES = ("top_down", "direction_opt")


def value_unit_bytes(fmt: str, collective: str, s: int, r: int, c: int) -> int:
    """Static per-plane wire bytes of a value-payload record (the frontier-
    algebra axis: SSSP distances, CC labels, PageRank mass).

    ``values``: the per-level value gather — the transpose ppermute moves
    one owned chunk (s int32 words); the column all-gather replicates it
    across the r grid rows (r*s words, per-device result-shape
    convention).  ``dense-i32``: the dense int32 row combine ships one
    chunk per row peer (all-to-all over c columns) or one chunk per
    butterfly stage (ppermute).  Both are density-independent, so the
    model is exact — any disagreement with a replayed ledger is drift.
    """
    if fmt == "values":
        return 4 * (r * s if collective == "all-gather" else s)
    if fmt == "dense-i32":
        return 4 * (c * s if collective == "all-to-all" else s)
    raise KeyError(f"not a value-payload format: {fmt}")


def check_value_records(records, s: int, r: int, c: int) -> int:
    """Price every value-payload record of a CommStats ledger against the
    static model.  Exits non-zero on any drift; returns entries checked."""
    n_checked = 0
    for rec in records:
        if rec.fmt not in ("values", "dense-i32"):
            continue
        model = value_unit_bytes(rec.fmt, rec.collective, s, r, c) * rec.count
        if rec.nbytes != model:
            raise SystemExit(
                f"{rec.phase}: {rec.fmt} {rec.collective} ledger {rec.nbytes} B "
                f"vs static model {model} B (s={s}, r={r}, c={c})"
            )
        n_checked += 1
    return n_checked


def _check_stage(e: dict, s: int, n: int, ctx: str = "") -> None:
    zone = e.get("zone", "row")
    if zone == "row-pull":
        zone = "row"  # the pull butterfly rides the same row wire
    b = e.get("batch", 1)
    unit = butterfly.stage_unit_bytes(s, n, e["fmt"], zone=zone, b=b)
    model = e["senders"] * e["subchunks"] * unit
    tol = e["senders"] * e["subchunks"] * b * PAD_BYTES
    if abs(e["bytes"] - model) > tol:
        where = " ".join(
            [ctx] + [f"{k}={e[k]}" for k in ("grid_row", "level", "zone")
                     if k in e]
        ).strip()
        raise SystemExit(
            f"{where} stage {e['stage']}: replayed {e['bytes']} B vs model "
            f"{model} B (fmt={e['fmt']}, batch={b}, tol={tol})"
        )


def check(doc: dict) -> int:
    s, n = doc["chunk"], doc["n"]
    n_checked = 0
    for policy, levels in doc["policy_levels"].items():
        total = 0
        for d in levels:
            level_sum = 0
            for e in d["btfly_stages"]:
                _check_stage(e, s, n, ctx=f"{policy} level {d['level']}")
                level_sum += e["bytes"]
                n_checked += 1
            if level_sum != d["row_bytes_btfly"]:
                raise SystemExit(
                    f"{policy} level {d['level']}: stage sum {level_sum} != "
                    f"row_bytes_btfly {d['row_bytes_btfly']}"
                )
            total += level_sum
        table_rows = [
            r for r in doc["table"]
            if r["policy"] == policy and r.get("plan") == "btfly"
            and r.get("batch", 1) == 1
        ]
        assert table_rows, f"no btfly table row for policy {policy}"
        if table_rows[0]["bytes"] != total:
            raise SystemExit(
                f"{policy}: table btfly bytes {table_rows[0]['bytes']} != "
                f"staged sum {total}"
            )
    return n_checked


def check_batch(doc: dict) -> int:
    """Multi-source section: staged byte model + the per-source invariant."""
    batch = doc.get("batch")
    assert batch, "BENCH_comm.json lacks the multi-source batch section"
    s, n = doc["chunk"], doc["n"]
    n_checked = 0
    for policy, entry in batch["policies"].items():
        for e in entry.get("btfly_stages", ()):
            _check_stage(e, s, n, ctx=f"batch {policy}")
            n_checked += 1
        for plan, d in entry["plans"].items():
            per_src, b1 = d["bytes_per_source"], d["b1_total_bytes"]
            if policy in STRICT_BATCH_POLICIES and not per_src < b1:
                raise SystemExit(
                    f"batch {policy}/{plan}: bytes_per_source {per_src} not "
                    f"strictly below the B=1 total {b1} — the shared-header/"
                    "consensus amortization regressed"
                )
            if per_src > b1:
                raise SystemExit(
                    f"batch {policy}/{plan}: bytes_per_source {per_src} "
                    f"exceeds the B=1 total {b1}"
                )
            print(f"batch B={d['batch']} {policy}/{plan}: "
                  f"{per_src:.0f} B/source vs {b1} B at B=1")
            n_checked += 1
    return n_checked


def verify(doc) -> tuple[int, int]:
    """Check a document (a dict, or the path of its JSON file): the staged
    byte model and the batch section.  Raises ``SystemExit`` on drift;
    returns the stage and batch entries checked."""
    if not isinstance(doc, dict):
        with open(doc) as f:
            doc = json.load(f)
    assert "btfly" in doc.get("plans", ()), "the document lacks the btfly plan"
    return check(doc), check_batch(doc)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "build/BENCH_comm_torch.json"
    with open(path) as f:
        doc = json.load(f)
    n, nb = verify(doc)
    print(f"BENCH BTFLY BYTE MODEL OK ({n} stage entries checked)")
    print(f"BENCH BATCH MODEL OK ({nb} batch entries checked, "
          f"B={doc['batch']['B']})")


if __name__ == "__main__":
    main()
