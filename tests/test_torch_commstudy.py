"""The port's communication study against the reference: the host byte
replay (``repro_torch.bench.bfs_comm`` against ``benchmarks.bfs_comm``,
Tables 7.4/7.5 with the butterfly's stage log), the document check
(``repro_torch.bench.check_comm`` against ``scripts/check_bench_comm.py``),
the emitter (``repro_torch.bench.run``), the expansion breakdown
(``repro_torch.bench.breakdown`` against ``benchmarks.breakdown``, Fig 7.3)
and the scaling study (``repro_torch.bench.scaling``, Fig 7.1/7.2), all on
the CPU.  The reference modules are numpy on the host except the
breakdown's, which runs JAX on the CPU."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

from benchmarks import bfs_comm as jbfs_comm
from benchmarks import breakdown as jbreakdown
from repro.comm import threshold as jthreshold
from repro_torch.bench import bfs_comm, breakdown, check_comm, scaling
from repro_torch.bench import run as bench_run
from repro_torch.comm import threshold
from repro_torch.core import validate
from repro_torch.graphgen import builder, kronecker
from scripts import check_bench_comm as jcheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def replays() -> dict:
    """(scale, rows, cols) -> (port, reference) ``run`` and ``run_batch``
    results, each pair from one prebuilt graph."""
    out = {}
    for scale, r, c in ((12, 2, 2), (12, 4, 4), (15, 2, 2)):
        mine = bfs_comm.build_replay_graph(scale, r, c)
        ref = jbfs_comm.build_replay_graph(scale, r, c)
        out[(scale, r, c)] = (
            (bfs_comm.run(scale, r, c, prebuilt=mine), bfs_comm.run_batch(scale, r, c,
                                                                          prebuilt=mine)),
            (jbfs_comm.run(scale, r, c, prebuilt=ref), jbfs_comm.run_batch(scale, r, c,
                                                                           prebuilt=ref)))
    return out


@pytest.mark.parametrize("size", [(12, 2, 2), (12, 4, 4), (15, 2, 2)],
                         ids=["s12-2x2", "s12-4x4", "s15-2x2"])
def test_replay_equals_reference(replays, size):
    """Tables 7.4/7.5 rows, the per-level directions and bytes, the btfly
    stage logs, and the multi-source batch section: equal, key for key."""
    (table, levels), batch = replays[size][0]
    (jtable, jlevels), jbatch = replays[size][1]
    assert table == jtable
    assert levels == jlevels
    assert batch == jbatch
    assert {r["plan"] for r in table} == {"alltoall", "btfly"}
    stages = [e for lv in levels.values() for d in lv for e in d["btfly_stages"]]
    assert stages and {e["stage"] for e in stages} <= {"0", "1", "fold", "unfold"}


def test_replay_pieces_equal_reference():
    """The replay's building blocks: the graph, the per-sender candidate
    split, host bucketing and pricing, and the stage replays at C = 3."""
    g, part, level = bfs_comm.build_replay_graph(11, 2, 3)
    jg, jpart, jlevel = jbfs_comm.build_replay_graph(11, 2, 3)
    assert g.src.tobytes() == jg.src.tobytes() and g.dst.tobytes() == jg.dst.tobytes()
    assert dataclasses.astuple(part) == dataclasses.astuple(jpart)
    assert level.tobytes() == jlevel.tobytes()
    owner = np.minimum(np.arange(part.n) // part.chunk, part.rows * part.cols - 1)
    for lv in range(int(level.max())):
        for bu in (False, True):
            mine, n_cand = bfs_comm._sender_split_streams(level, lv, bu, g, part, owner)
            ref, j_cand = jbfs_comm._sender_split_streams(jlevel, lv, bu, jg, jpart, owner)
            assert n_cand == j_cand and mine.keys() == ref.keys()
            assert all(np.array_equal(mine[k], ref[k]) for k in mine)
    rng = np.random.default_rng(3)
    s, n = 8192, 1 << 16
    ladder, floor = bfs_comm.butterfly.row_wire(s, n)
    jladder, jfloor = jbfs_comm.butterfly.row_wire(s, n)
    streams = {(j, k): np.sort(rng.choice(s, size=int(rng.integers(0, 3000)), replace=False))
               for j in range(3) for k in range(3)}
    for b in (1, 4):
        planes = streams if b == 1 else {k: [v] * b for k, v in streams.items()}
        assert (bfs_comm._btfly_row_stage_replay(planes, 3, ladder, floor, b=b)
                == jbfs_comm._btfly_row_stage_replay(planes, 3, jladder, jfloor, b=b))
        chunks = [streams[(0, k)] if b == 1 else [streams[(0, k)]] * b for k in range(3)]
        assert (bfs_comm._btfly_unreached_stage_replay(chunks, s, 3, ladder, b=b)
                == jbfs_comm._btfly_unreached_stage_replay(chunks, s, 3, jladder, b=b))
    for ids in (np.arange(0), np.arange(0, s, 7), np.arange(0, s, 1)):
        assert bfs_comm._host_bucket(ladder, ids) == jbfs_comm._host_bucket(jladder, ids)
        assert (bfs_comm._packed_wire_bytes(ladder, ids)
                == jbfs_comm._packed_wire_bytes(jladder, ids))


def test_threshold_link_model_equals_reference():
    mine, ref = threshold.ThresholdPolicy(), jthreshold.ThresholdPolicy()
    for n_ints in (100, 4096, 1 << 20):
        for ratio in (1.0, 1.7, 8.0):
            for same_host in (False, True):
                assert (mine.modeled_speedup(n_ints, ratio, same_host)
                        == ref.modeled_speedup(n_ints, ratio, same_host))


_POLICIES = {
    "default": ({}, None),
    "min1024": ({"min_ints": 1024}, None),
    "cpu_on_ici": ({"codec_speed_mips": 3200, "codec_dspeed_mips": 4700}, None),
    "creek": (None, "paper_creek"),
}


@pytest.mark.parametrize("name", sorted(_POLICIES))
def test_threshold_gate_equals_reference(name):
    """should_compress, modeled_speedup and _times over a grid of
    (n_ints, ratio, same_host), the cases of tests/test_codecs.py among
    them (100 and 2**20 ints, ratios 2 and 8, both links)."""
    kw, ctor = _POLICIES[name]
    if ctor:
        port = getattr(threshold.ThresholdPolicy, ctor)()
        ref = getattr(jthreshold.ThresholdPolicy, ctor)()
    else:
        port, ref = threshold.ThresholdPolicy(**kw), jthreshold.ThresholdPolicy(**kw)
    assert port == threshold.ThresholdPolicy(**{f: getattr(ref, f) for f in (
        "min_ints", "same_host_bandwidth_gBps", "link_bandwidth_gBps",
        "codec_speed_mips", "codec_dspeed_mips")})
    for n in (0, 100, 1023, 1024, 4095, 4096, 65536, 1 << 20, 1 << 26):
        for ratio in (1.0, 1.5, 2.0, 4.0, 8.0, 32.0):
            for same_host in (False, True):
                assert port.should_compress(n, ratio, same_host) == ref.should_compress(
                    n, ratio, same_host)
                assert port._times(n, ratio, same_host) == ref._times(n, ratio, same_host)
                if n:
                    assert port.modeled_speedup(n, ratio, same_host) == ref.modeled_speedup(
                        n, ratio, same_host)


@pytest.fixture(scope="module")
def doc(replays) -> dict:
    """The BENCH_comm document of the scale-15 2x2 replay."""
    (table, levels), batch = replays[(15, 2, 2)][0]
    return bench_run.bench_comm_doc(15, 2, 2, table, levels, batch)


def test_document_equals_committed_reference(doc):
    """The port's document holds what the reference's committed
    ``BENCH_comm.json`` holds (its replay sections and geometry)."""
    with open(os.path.join(ROOT, "BENCH_comm.json")) as f:
        ref = json.load(f)
    for key in ("benchmark", "scale", "rows", "cols", "chunk", "n", "policies", "plans",
                "table", "policy_levels", "batch"):
        assert doc[key] == ref[key], key


def test_check_comm_passes_and_equals_reference(doc, tmp_path):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(doc))
    counts = check_comm.verify(str(path))
    assert counts == check_comm.verify(doc) == (jcheck.check(doc), jcheck.check_batch(doc))
    assert counts[0] > 0 and counts[1] > 0
    check_comm.main([str(path)])


def test_check_comm_fails_on_a_stage_off_by_a_chunk(doc):
    """A batch stage off by one 1024-value chunk beyond its slack fails; one
    at the edge of the slack passes.  A single-source stage off by a chunk
    breaks its level's sum."""
    e = doc["batch"]["policies"]["top_down"]["btfly_stages"][0]
    tol = e["senders"] * e["subchunks"] * e.get("batch", 1) * check_comm.PAD_BYTES
    for delta, ok in ((tol, True), (tol + check_comm.PAD_BYTES, False)):
        bad = copy.deepcopy(doc)
        bad["batch"]["policies"]["top_down"]["btfly_stages"][0]["bytes"] += delta
        if ok:
            check_comm.verify(bad)
        else:
            with pytest.raises(SystemExit, match="stage"):
                check_comm.verify(bad)
            with pytest.raises(SystemExit, match="stage"):
                jcheck.check_batch(bad)
    bad = copy.deepcopy(doc)
    level = next(d for d in bad["policy_levels"]["top_down"] if d["btfly_stages"])
    level["btfly_stages"][0]["bytes"] += check_comm.PAD_BYTES
    with pytest.raises(SystemExit, match="row_bytes_btfly"):
        check_comm.verify(bad)
    bad = copy.deepcopy(doc)
    bad["plans"] = ["alltoall"]
    with pytest.raises(AssertionError):
        check_comm.verify(bad)


def test_value_pricing_equals_reference():
    for fmt, coll in (("values", "all-gather"), ("values", "collective-permute"),
                      ("dense-i32", "all-to-all"), ("dense-i32", "collective-permute")):
        assert (check_comm.value_unit_bytes(fmt, coll, 4096, 2, 3)
                == jcheck.value_unit_bytes(fmt, coll, 4096, 2, 3))
    with pytest.raises(KeyError):
        check_comm.value_unit_bytes("bitmap", "all-gather", 4096, 2, 2)


def test_emitter_writes_a_checked_document(tmp_path):
    """``python -m repro_torch.bench.run`` with only the replay: the
    document goes where ``--bench-json`` says and passes the check."""
    path = tmp_path / "out" / "bench.json"
    bench_run.main(["--device", "cpu", "--bench-json", str(path),
                    "--skip", "codecs", "frontier_stats", "breakdown", "teps"])
    doc = json.loads(path.read_text())
    assert doc["plans"] == ["alltoall", "btfly"] and doc["compute"] == {}
    assert check_comm.verify(doc)[0] > 0


def _untimed(compute: dict) -> dict:
    out = {k: v for k, v in compute.items() if k not in ("card", "timer")}
    out["backends"] = {
        name: {**e, "levels": [{k: v for k, v in d.items() if not k.endswith("_us")}
                               for d in e.get("levels", [])]}
        for name, e in compute["backends"].items()}
    return out


def test_expansion_breakdown_equals_reference(monkeypatch):
    """Every field but the times; and the pure-ELL slab skip, with the budget
    lowered below scale 10's slab in both modules."""
    for budget in (breakdown.ELL_SLAB_BUDGET_BYTES, 1 << 16):
        monkeypatch.setattr(breakdown, "ELL_SLAB_BUDGET_BYTES", budget)
        monkeypatch.setattr(jbreakdown, "ELL_SLAB_BUDGET_BYTES", budget)
        mine = breakdown.expansion_breakdown(10, 2, 2, repeats=1, device="cpu")
        ref = jbreakdown.expansion_breakdown(10, 2, 2, repeats=1)
        assert _untimed(mine) == _untimed(ref)
        assert mine["card"] == "cpu" and mine["timer"] == "host clock"
        assert ("skipped" in mine["backends"]["ell"]) == (budget == 1 << 16)
    assert all(d["push_us"] > 0 and d["pull_us"] > 0
               for d in mine["backends"]["hybrid"]["levels"])


def test_breakdown_zones_and_wire_share():
    """The zones and the wire share on the reference's zone graph (seed 3)."""
    res = breakdown.run(11, 2, 2, device="cpu", repeats=1)
    assert res["frontier"] > 0 and res["row_candidates"] > 0
    assert len(res["zones_us"]) == 10 and all(v > 0 for v in res["zones_us"].values())
    share = breakdown.wire_share(11, 2, 2)
    assert abs(sum(share["share"].values()) - 1) < 1e-12
    stats, *_ = jbfs_comm.simulate_zones(11, 2, 2, seed=3, policy="direction_opt")
    assert share["packed_bytes"] == {z: f["packed"] for z, f in stats.per_phase_fmt().items()}


def test_scaling_depth_and_edges_agree_across_grids():
    """Every grid and mode of the study, and the butterfly plan on each
    strong grid, traverse the same tree from the hub root: equal depth and
    traversed edges at each scale, the host reference's."""
    rows = scaling.run(10, 9, device="cpu")
    assert {(r["rows"], r["cols"]) for r in rows} == {(1, 1), (1, 2), (2, 2), (2, 4)}
    assert {r["mode"] for r in rows} == set(scaling.MODES)
    g10 = builder.build_csr(kronecker.kronecker_edges(10, seed=scaling.SEED), n=1 << 10)
    rows += [{"scale": 10, **scaling.run_one(g10, r, c, "btfly", "cpu")}
             for r, c in scaling.STRONG_GRIDS]
    for scale in {r["scale"] for r in rows}:
        g = builder.build_csr(kronecker.kronecker_edges(scale, seed=3), n=1 << scale)
        level = validate.reference_bfs(g, int(np.argmax(g.degrees())))
        got = {(r["depth"], r["traversed_edges"]) for r in rows if r["scale"] == scale}
        assert len(got) == 1
        depth, edges = got.pop()
        assert depth == level.max() + 1 and edges > 0
    assert all(r["time_s"] > 0 and r["teps"] > 0 for r in rows)
