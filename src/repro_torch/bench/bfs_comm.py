"""Paper Tables 7.4/7.5: per-zone communication volume before and after
compression, and the modelled communication-time reduction, per traversal
policy (direction optimization, paper §3.1) and per row-phase plan.

The port's counterpart of ``benchmarks/bfs_comm.py`` (numpy only, on the
host).  It replays a real multi-rank BFS level by level, accumulating the
exact bytes each zone would move under each wire format AND each traversal
policy in a :class:`repro_torch.comm.CommStats`; the byte arithmetic lives
in the wire formats (:mod:`repro_torch.comm.formats`), not here:

  zones: vertexBroadcast / columnCommunication / rowCommunication /
         predecessorReduction  (the paper's instrumented regions, §4.2.1)

  formats: raw 32-bit ids (Baseline), dense bitmap, bucketed PFOR16 packed
           (the device's static-shape codec), and the variable-length
           BP128+delta host codec (the paper's S4-BP128).

  policies: top_down (push all-to-all row phase), bottom_up (pull:
            found-bitmap + bit-packed parents, plus the unreached-bitmap
            all-gather folded into rowCommunication), direction_opt (per-
            level switch on the shared density oracle, with the alpha the
            device driver derives from the bucket ladder).

  plans: alltoall (the direct row exchange) against btfly (ButterFly BFS:
         log2(C) staged ppermute rounds whose merged stream is re-bucketed
         per hop; the replay mirrors the device's stage schedule
         (:mod:`repro_torch.comm.butterfly`), logs each stage's consensus
         format, and its bytes must reconcile with the static byte model,
         which :mod:`repro_torch.bench.check_comm` enforces).

The row phase buckets each (sender column, destination chunk) stream
separately and takes the max over the grid row, the device's pmax
consensus, NOT the union stream per owner chunk, which underestimates both
the counts and the consensus escalation.

The time reduction (Table 7.5's analog) uses the threshold policy's link
model: compress + transmit + decompress at the modelled codec speeds
against a plain transmit.  These are modelled times, not measurements.

    python -m repro_torch.bench.bfs_comm [--scale 17] [--grid 4x4]
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from repro_torch.comm import (BitmapFormat, BitmapParentFormat, CommStats, DenseFormat,
                              RawIdFormat)
from repro_torch.comm import butterfly, codecs, threshold
from repro_torch.comm.formats import plane_wire_bytes
from repro_torch.comm.ladder import BucketLadder
from repro_torch.core import bfs as bfs_core
from repro_torch.core import csr as csrmod
from repro_torch.core import traversal, validate
from repro_torch.core.distributed_bfs import parent_width_class
from repro_torch.graphgen import builder, kronecker

ZONES = (
    "vertexBroadcast",
    "columnCommunication",
    "rowCommunication",
    "predecessorReduction",
)
FORMATS = ("raw", "bitmap", "packed", "bp128d")
#: exchange plans of the row phase: the direct ALLTOALLV and the staged
#: butterfly (log2(C) ppermute rounds, merged stream re-bucketed per hop)
PLANS = ("alltoall", "btfly")
POLICIES = tuple(traversal.POLICIES)


def _next_direction(oracle: traversal.DensityOracle, count: int, use_bu: bool,
                    m_f=None, m_u=None, growing=None) -> bool:
    """The device oracle's next direction for one plane, from host values."""
    def t(x):
        return None if x is None else torch.tensor(x)

    return bool(oracle.next_direction(torch.tensor(count, dtype=torch.int32),
                                      torch.tensor(use_bu), m_f=t(m_f), m_u=t(m_u),
                                      growing=t(growing)))


def _host_bucket(ladder: BucketLadder, ids: np.ndarray) -> int:
    """The ladder's bucket for one sorted id stream (host mirror of
    ``BucketLadder.bucket_for`` — smallest spec whose id and exception
    capacities both fit)."""
    count = ids.size
    exc = int((codecs.delta_encode(ids.astype(np.uint32)) >> 16 > 0).sum()) if count else 0
    for i, spec in enumerate(ladder.specs):
        if count <= spec.cap and exc <= spec.exc_cap:
            return i
    return len(ladder.specs)


def _bucket_wire(ladder: BucketLadder, bucket: int, floor_fmt=None, b: int = 1):
    """(format name, wire bytes of all ``b`` planes) of one subchunk at
    ``bucket`` — dense floors scale linearly, id streams share the plane
    header (:func:`repro_torch.comm.plane_wire_bytes`)."""
    if bucket < len(ladder.specs):
        fmt = ladder.formats()[bucket]
        return fmt.name, plane_wire_bytes(fmt, b)
    if floor_fmt is not None:
        return floor_fmt.name, plane_wire_bytes(floor_fmt, b)
    return "bitmap", b * 4 * ladder.floor_words


def _packed_wire_bytes(ladder: BucketLadder, ids: np.ndarray) -> int:
    """Wire bytes of one packed stream under the ladder's bucket choice."""
    return _bucket_wire(ladder, _host_bucket(ladder, ids))[1]


def _btfly_row_stage_replay(streams, cols: int, ladder: BucketLadder,
                            floor_fmt, b: int = 1):
    """Host replay of the butterfly row phase over ONE grid row.

    ``streams[(j, k)]``: for ``b == 1``, the sorted local candidate ids
    sender column ``j`` holds for the row's ``k``-th destination chunk; for
    a multi-source batch, a length-``b`` list of per-plane id arrays.
    Mirrors the device schedule exactly — fold, log2(P) pairwise stages,
    unfold — including the per-stage row-wide format consensus (max bucket
    over every subchunk AND plane on the wire that stage) and the per-plane
    union-merge that the next stage re-buckets.  Stage bytes price all
    planes at the shared-header plane wire
    (:func:`repro_torch.comm.butterfly.stage_unit_bytes` with ``b``).
    Returns (total bytes, stage log)."""
    sched = butterfly.ButterflySchedule(cols)
    p, extra, slots = sched.p, sched.extra, sched.slots
    empty = np.empty(0, np.int64)

    def planes_of(j, q):
        v = streams.get((j, q))
        if v is None:
            return [empty] * b
        return [v] if b == 1 and not isinstance(v, list) else v

    def leaf_streams(j):
        rows_ = {}
        for r in range(p):
            rows_[(r, 0)] = planes_of(j, r)
            if slots == 2:
                rows_[(r, 1)] = (
                    planes_of(j, p + r) if r < extra else [empty] * b
                )
        return rows_

    state = {j: leaf_streams(j) for j in range(cols)}
    total = 0
    log = []

    def do_exchange(label, sends):
        """sends: list of (src, dst, [leaf keys]) — consensus + merge."""
        nonlocal total
        blocks = {src: [state[src][key] for key in keys] for src, dst, keys in sends}
        bucket = max(
            (_host_bucket(ladder, ids) for blk in blocks.values()
             for planes in blk for ids in planes),
            default=0,
        )
        fmt, unit = _bucket_wire(ladder, bucket, floor_fmt, b=b)
        n_sub = len(sends[0][2])
        assert all(len(keys) == n_sub for _, _, keys in sends)
        nbytes = len(sends) * n_sub * unit
        total += nbytes
        entry = {"stage": label, "fmt": fmt, "senders": len(sends),
                 "subchunks": n_sub, "bytes": nbytes}
        if b > 1:
            entry["batch"] = b
        log.append(entry)
        merged = {}
        for src, dst, keys in sends:
            for key in keys:
                merged.setdefault(dst, {})[key] = [
                    np.union1d(d, s_)
                    for d, s_ in zip(state[dst][key], state[src][key])
                ]
        for dst, upd in merged.items():
            state[dst].update(upd)

    all_leaves = [(r, sl) for r in range(p) for sl in range(slots)]
    if extra:
        do_exchange(
            "fold", [(p + e, e, all_leaves) for e in range(extra)]
        )
    for t in range(sched.n_stages):
        m = 1 << t
        sends = []
        for j in range(p):
            send_rows = [((j ^ m) & (2 * m - 1)) + 2 * m * i
                         for i in range(sched.stage_blocks(t))]
            keys = [(r, sl) for r in send_rows for sl in range(slots)]
            sends.append((j, j ^ m, keys))
        do_exchange(str(t), sends)
    if extra:
        do_exchange(
            "unfold", [(e, p + e, [(e, 1)]) for e in range(extra)]
        )
    return total, log


def _btfly_unreached_stage_replay(chunk_ids, s: int, cols: int,
                                  ladder: BucketLadder, b: int = 1):
    """Host replay of the staged unreached all-gather over one grid row.

    ``chunk_ids[k]``: sorted local unreached ids of the row's ``k``-th
    chunk (a length-``b`` list of per-plane arrays when batched).  The
    doubling block keeps chunk identity, so per-subchunk buckets never
    change — only the block size per stage does."""
    sched = butterfly.ButterflySchedule(cols)
    p, extra, slots = sched.p, sched.extra, sched.slots
    bitmap = BitmapFormat(s)
    empty = np.empty(0, np.int64)

    def leaf_planes(r, sl):
        q = r if sl == 0 else p + r
        if sl == 1 and r >= extra:
            return [empty] * b
        v = chunk_ids[q]
        return [v] if b == 1 and not isinstance(v, list) else v

    total = 0
    log = []

    def do_exchange(label, n_senders, leaf_sets):
        nonlocal total
        bucket = max(
            (_host_bucket(ladder, ids) for leaves in leaf_sets
             for r, sl in leaves for ids in leaf_planes(r, sl)),
            default=0,
        )
        fmt, unit = _bucket_wire(ladder, bucket, bitmap, b=b)
        n_sub = len(leaf_sets[0])
        nbytes = n_senders * n_sub * unit
        total += nbytes
        entry = {"stage": label, "fmt": fmt, "senders": n_senders,
                 "subchunks": n_sub, "bytes": nbytes}
        if b > 1:
            entry["batch"] = b
        log.append(entry)

    if extra:
        do_exchange("fold", extra, [[(e, 1)] for e in range(extra)])
    for t in range(sched.n_stages):
        blk = 1 << t
        sets = []
        for j in range(p):
            start = (j >> t) << t
            sets.append([(start + i, sl) for i in range(blk)
                         for sl in range(slots)])
        do_exchange(str(t), p, sets)
    if extra:
        all_leaves = [(r, sl) for r in range(p) for sl in range(slots)]
        do_exchange("unfold", extra, [all_leaves for _ in range(extra)])
    return total, log


def build_replay_graph(scale: int, rows: int, cols: int, seed: int = 1):
    """Graph + partition + reference levels, shared across policy replays
    (the dominant cost — built once, not once per policy)."""
    g = builder.build_csr(kronecker.kronecker_edges(scale, seed=seed), n=1 << scale)
    bg = csrmod.partition_2d(g, rows=rows, cols=cols)
    root = int(np.argmax(g.degrees()))
    level = validate.reference_bfs(g, root)
    return g, bg.part, level


def _sender_split_streams(level_vec, lv, bu, g, part, owner):
    """Candidate streams of one source plane at one level, split by sender.

    The exchanged stream is the *candidate* set — every destination with a
    frontier neighbor (pull levels: unreached destinations only) — split per
    SENDER grid column, the granularity the device buckets on before its
    grid-row pmax consensus (the union stream per owner chunk underestimates
    both the counts and the consensus).  Shared by the single-source and the
    multi-source replays so the two byte models cannot drift.

    Returns ``({(grid row, sender col, owner chunk) -> local ids},
    candidate count before the pull mask)``.
    """
    empty = np.empty(0, np.int64)
    e_mask = level_vec[g.src] == lv
    esrc, edst = g.src[e_mask], g.dst[e_mask]
    n_cand = int(np.unique(edst).size) if edst.size else 0
    if bu:
        un_mask = (level_vec[edst] > lv) | (level_vec[edst] < 0)
        esrc, edst = esrc[un_mask], edst[un_mask]
    key = (esrc // part.n_c) * part.n + edst
    pairs = np.unique(key) if key.size else empty
    p_col, p_dst = pairs // part.n, pairs % part.n
    p_q = owner[p_dst] if p_dst.size else empty
    # pairs are sorted by (sender col, dst), so (sender col, chunk) groups
    # are contiguous runs: one searchsorted-style split, no per-pair loop
    group = p_col * (part.rows * part.cols) + p_q
    cuts = np.flatnonzero(np.diff(group)) + 1
    streams = {}
    if pairs.size:
        for start, stop in zip(np.r_[0, cuts], np.r_[cuts, pairs.size]):
            jc, q = int(p_col[start]), int(p_q[start])
            streams[(q // part.cols, jc, q)] = p_dst[start:stop] - q * part.chunk
    return streams, n_cand


def simulate_zones(
    scale: int = 17, rows: int = 4, cols: int = 4, seed: int = 1,
    policy: str = "top_down", prebuilt=None,
):
    """Host replay of the 2D BFS communication under one traversal policy.

    Returns (stats, g, part, directions): a filled CommStats whose phases
    are the paper's zones and fmts the four wire formats, plus the
    per-level direction/byte log that makes the policy dimension visible
    in BENCH_comm.json.  ``prebuilt`` (from :func:`build_replay_graph`)
    skips the graph/reference rebuild."""
    g, part, level = prebuilt or build_replay_graph(scale, rows, cols, seed)
    s = part.chunk
    wp = parent_width_class(part.n_c)
    ladder = BucketLadder.default(s)  # column (membership vs 1-bit floor)
    row_ladder = BucketLadder.default(s, floor_words=s, payload_width=wp)
    # the butterfly's row wire: global-parent payload class + its dense
    # floor (found-bitmap + packed parents) — the same geometry the device
    # plan builds, so stage formats reconcile with the static byte model
    bt_ladder, bt_floor = butterfly.row_wire(s, part.n)
    # the SAME oracle the device driver uses: direction flips where the row
    # ladder's sparse capacities run out
    oracle = traversal.DensityOracle(part.n, alpha=traversal.ladder_alpha(s, wp))

    stats = CommStats()
    raw_col = RawIdFormat(s)
    bitmap = BitmapFormat(s)
    dense = DenseFormat(s)
    bmp_parent = BitmapParentFormat(s, wp) if wp < 32 else None
    bp = codecs.BP128(delta=True)
    for fmt in FORMATS:  # root broadcast: 8 bytes to every rank, any format
        stats.add("vertexBroadcast", fmt, "all-gather", 8 * rows * cols)
    max_level = int(level.max())
    owner = np.minimum(np.arange(part.n) // s, rows * cols - 1)
    level_pad = np.full(part.n, -1, level.dtype)
    level_pad[: g.n] = level
    deg = g.degrees()  # anticipatory oracle: Beamer m_f from the degree dot

    use_bu = policy == "bottom_up"  # host mirror of the carry's use_bu flag
    directions = []
    for lv in range(max_level):
        frontier = np.nonzero(level == lv)[0]
        if policy == "top_down":
            bu = False
        elif policy == "bottom_up":
            bu = True
        else:
            bu = use_bu
        # --- column phase: each owner rank all-gathers its chunk's frontier
        # to the R-1 other ranks in its grid column (direction-independent)
        for q in range(rows * cols):
            ids = frontier[owner[frontier] == q] - q * s
            n_recv = rows - 1
            stats.add("columnCommunication", "raw", "all-gather",
                      raw_col.wire_bytes * n_recv)
            stats.add("columnCommunication", "bitmap", "all-gather",
                      bitmap.wire_bytes * n_recv)
            stats.add("columnCommunication", "packed", "all-gather",
                      _packed_wire_bytes(ladder, ids) * n_recv)
            blob = bp.encode(ids.astype(np.uint32)) if ids.size else b""
            stats.add("columnCommunication", "bp128d", "all-gather",
                      len(blob) * n_recv)
        # --- row phase: push exchanges candidate (id, parent) subchunks to
        # owners; pull exchanges found-bitmap + packed parents and folds in
        # the unreached-bitmap all-gather over the grid row.  Candidate-set
        # sizing and the per-sender split live in _sender_split_streams
        # (the new frontier alone badly underestimates dense levels, where
        # most of the graph neighbors the frontier).
        streams, n_cand = _sender_split_streams(level, lv, bu, g, part, owner)

        nxt = np.nonzero(level == lv + 1)[0]
        n_senders = cols - 1
        row_bytes = {f: 0 for f in FORMATS}
        empty = np.empty(0, np.int64)
        if not bu:
            for i in range(rows):
                # grid-row consensus: every rank in the row packs at the
                # bucket of the row's worst (sender, destination) stream
                bkt = max(
                    _host_bucket(row_ladder, streams.get((i, jc, i * cols + k), empty))
                    for jc in range(cols) for k in range(cols)
                )
                unit = _bucket_wire(row_ladder, bkt)[1]
                for k in range(cols):
                    q = i * cols + k
                    row_bytes["raw"] += dense.wire_bytes * n_senders
                    row_bytes["bitmap"] += dense.wire_bytes * n_senders  # parents stay dense
                    row_bytes["packed"] += unit * n_senders
                    for jc in range(cols):
                        if jc == k:
                            continue  # own subchunk never crosses a link
                        ids = streams.get((i, jc, q), empty)
                        blob = bp.encode(ids.astype(np.uint32)) if ids.size else b""
                        row_bytes["bp128d"] += len(blob) + 2 * ids.size
        else:
            # per-chunk cost is density-independent, so no per-rank split is
            # needed: baseline stays uncompressed (dense candidates + raw-id
            # unreached gather); compressed formats ride the pull wire
            n_chunks = rows * cols
            bu_wire = (bmp_parent.wire_bytes if bmp_parent else dense.wire_bytes)
            row_bytes["raw"] = (dense.wire_bytes + raw_col.wire_bytes) * n_senders * n_chunks
            for f in ("bitmap", "packed", "bp128d"):
                row_bytes[f] = (bu_wire + bitmap.wire_bytes) * n_senders * n_chunks
        for f in FORMATS:
            stats.add("rowCommunication", f, "all-to-all", row_bytes[f])

        # --- butterfly plan: staged replay of the same candidate streams —
        # per-stage union-merge + re-bucket, plus the staged unreached
        # gather at pull levels
        btfly_bytes = 0
        btfly_stages = []
        for i in range(rows):
            row_streams = {
                (jc, k): streams.get((i, jc, i * cols + k), empty)
                for jc in range(cols) for k in range(cols)
            }
            t, slog = _btfly_row_stage_replay(row_streams, cols, bt_ladder, bt_floor)
            btfly_bytes += t
            for entry in slog:
                btfly_stages.append({"grid_row": i, **entry})
            if bu:
                # padding vertices (>= g.n) stay unreached on device and ride
                # the wire too — include them so buckets match the device
                un_ids = [
                    np.nonzero((level_pad[q * s:(q + 1) * s] > lv)
                               | (level_pad[q * s:(q + 1) * s] < 0))[0]
                    for q in range(i * cols, (i + 1) * cols)
                ]
                t, slog = _btfly_unreached_stage_replay(un_ids, s, cols, ladder)
                btfly_bytes += t
                for entry in slog:
                    btfly_stages.append({"grid_row": i, "zone": "unreached", **entry})

        directions.append(
            {
                "level": lv,
                "direction": "bottom_up" if bu else "top_down",
                "frontier": int(frontier.size),
                "density": frontier.size / part.n,
                "candidates": n_cand,
                "row_bytes_packed": row_bytes["packed"],
                "row_bytes_btfly": btfly_bytes,
                "btfly_stages": btfly_stages,
            }
        )
        # next level's direction from the new frontier's count plus the
        # anticipatory m_f/m_u edge signals — the same psum'd update the
        # device driver threads through the carry (direction_opt only; the
        # fixed policies never consult the oracle)
        m_f = m_u = growing = None
        if policy == "direction_opt":
            m_f = int(deg[level == lv + 1].sum())
            m_u = int(deg[(level < 0) | (level > lv + 1)].sum())
            growing = nxt.size > frontier.size
        use_bu = _next_direction(oracle, nxt.size, bool(use_bu), m_f=m_f, m_u=m_u,
                                 growing=growing)

    # predecessor reduction: one dense pass at the end (uncompressed in the
    # paper too — its Table 7.4 shows 0% there)
    for fmt in FORMATS:
        stats.add("predecessorReduction", fmt, "all-gather", 4 * part.n)
    return stats, g, part, directions


#: batch width of the multi-source bench section (the B=4 acceptance row)
BATCH_B = 4


def batch_roots(g, n_roots: int) -> np.ndarray:
    """The ``B`` highest-degree hub roots (one convention for the whole
    repo: :func:`repro_torch.core.bfs.hub_roots`)."""
    return bfs_core.hub_roots(g.degrees(), n_roots)


def simulate_batch(
    scale: int, rows: int, cols: int, n_src: int,
    policy: str = "direction_opt", seed: int = 1, graph=None,
    level_cache=None,
):
    """Host replay of the MULTI-SOURCE packed-wire communication model.

    Replays one batched BFS with ``n_src`` source planes level by level,
    mirroring the device driver: per-plane directions from the shared
    oracle (including the anticipatory Beamer ``m_f`` signal), one bucket
    consensus per exchange taken as the max over every plane, and plane
    wire pricing from :func:`repro_torch.comm.plane_wire_bytes` (dense floors
    linear, id-stream headers shared).  Returns a dict with per-plan totals
    for the two row-phase plans plus the shared zones, in cluster-total
    bytes — the same convention :func:`simulate_zones` uses — so
    ``bytes_per_source`` at B=4 is directly comparable with a B=1 replay of
    the same model.
    """
    g = graph or builder.build_csr(
        kronecker.kronecker_edges(scale, seed=seed), n=1 << scale
    )
    n_pad, _ = csrmod.padded_geometry(g.n, rows, cols)
    part = csrmod.Partition2D(n=n_pad, n_orig=g.n, rows=rows, cols=cols)
    s = part.chunk
    ranks = rows * cols
    b = n_src
    roots = batch_roots(g, b)
    if level_cache is None:
        level_cache = {}
    levels = [
        level_cache.setdefault(int(r), validate.reference_bfs(g, int(r)))
        for r in roots
    ]
    dpad = np.zeros(part.n, np.int64)  # degree vector at padded geometry
    dpad[: g.n] = g.degrees()
    wp = parent_width_class(part.n_c)
    col_ladder = BucketLadder.default(s)
    row_ladder = BucketLadder.default(s, floor_words=s, payload_width=wp)
    bt_ladder, bt_floor = butterfly.row_wire(s, part.n)
    un_ladder, _ = butterfly.unreached_wire(s)
    oracle = traversal.DensityOracle(part.n, alpha=traversal.ladder_alpha(s, wp))
    bitmap = BitmapFormat(s)
    bmp_parent = BitmapParentFormat(s, wp) if wp < 32 else DenseFormat(s)
    owner = np.minimum(np.arange(part.n) // s, ranks - 1)
    level_pad = [np.full(part.n, -1, lv.dtype) for lv in levels]
    for k, lv in enumerate(levels):
        level_pad[k][: g.n] = lv
    adaptive = policy == "direction_opt"
    max_level = max(int(lv.max()) for lv in levels)
    empty = np.empty(0, np.int64)

    zones = {
        # one broadcast carries all B roots (4 bytes each) to every rank
        "broadcast": 4 * b * ranks,
        "column": 0, "row": {"alltoall": 0, "btfly": 0}, "transpose": 0,
        "termination": 0, "degree": 0, "consensus": {"alltoall": 0, "btfly": 0},
        "reduction": 4 * part.n * b,
    }
    btfly_stages = []
    if adaptive:
        # the anticipatory oracle's one-time owned-degree psum (grid-row
        # all-reduce of n_r ints, HLO-doubled), shared by every plane
        zones["degree"] = 8 * part.n_r * ranks

    use_bu = [policy == "bottom_up"] * b
    for lv in range(max_level):
        frontiers = [np.nonzero(lp == lv)[0] for lp in level_pad]
        act = [f.size > 0 for f in frontiers]
        if policy == "top_down":
            bu = [False] * b
        elif policy == "bottom_up":
            bu = [True] * b
        else:
            bu = list(use_bu)
        # --- transpose: all B planes ride one (B, s)-bool permute per rank
        zones["transpose"] += b * s * ranks
        # --- termination psum: (B,) counts (+ m_f/m_u planes when adaptive)
        zones["termination"] += (3 if adaptive else 1) * 8 * b * ranks
        # --- column phase: per owner chunk, bucket = max over planes
        for q in range(ranks):
            plane_ids = [
                f[owner[f] == q] - q * s if a else empty
                for f, a in zip(frontiers, act)
            ]
            bkt = max(_host_bucket(col_ladder, ids) for ids in plane_ids)
            unit = _bucket_wire(col_ladder, bkt, bitmap, b=b)[1]
            zones["column"] += unit * (rows - 1)
        if col_ladder.specs:
            for plan in ("alltoall", "btfly"):
                zones["consensus"][plan] += 8 * cols  # one per column group
        # --- row phase: the same per-sender candidate split as the
        # single-source replay (_sender_split_streams), keyed per plane and
        # routed to the wire of each plane's direction
        push_streams = {}
        pull_streams = {}
        un_ids = None
        for k in range(b):
            if not act[k]:
                continue
            streams_k, _ = _sender_split_streams(
                level_pad[k], lv, bu[k], g, part, owner
            )
            target = pull_streams if bu[k] else push_streams
            for site, ids in streams_k.items():
                target.setdefault(site, {})[k] = ids
        push_active = any(a and not d for a, d in zip(act, bu))
        pull_active = any(a and d for a, d in zip(act, bu))

        def plane_list(streams, i, jc, q):
            per = streams.get((i, jc, q), {})
            return [per.get(k, empty) for k in range(b)]

        n_senders = cols - 1
        if push_active:
            # direct plan: one consensus per grid row, every chunk pays the
            # row's worst (sender, destination, plane) bucket
            for i in range(rows):
                bkt = max(
                    _host_bucket(row_ladder, ids)
                    for jc in range(cols) for kq in range(cols)
                    for ids in plane_list(push_streams, i, jc, i * cols + kq)
                )
                unit = _bucket_wire(row_ladder, bkt, b=b)[1]
                zones["row"]["alltoall"] += unit * n_senders * cols
            zones["consensus"]["alltoall"] += 8 * rows
            # butterfly plan: staged replay of the same plane streams
            for i in range(rows):
                row_streams = {
                    (jc, kq): plane_list(push_streams, i, jc, i * cols + kq)
                    for jc in range(cols) for kq in range(cols)
                }
                t, slog = _btfly_row_stage_replay(
                    row_streams, cols, bt_ladder, bt_floor, b=b
                )
                zones["row"]["btfly"] += t
                zones["consensus"]["btfly"] += 8 * len(slog)
                for entry in slog:
                    btfly_stages.append({"grid_row": i, "level": lv, **entry})
        if pull_active:
            # pull wire is density-independent: every plane pays the
            # found-bitmap + packed-parent unit plus the unreached gather
            pull_unit = plane_wire_bytes(bmp_parent, b)
            gather_unit = plane_wire_bytes(bitmap, b)
            zones["row"]["alltoall"] += (pull_unit + gather_unit) * n_senders * ranks
            un_ids = [
                [
                    np.nonzero(
                        ((level_pad[k][q * s:(q + 1) * s] > lv)
                         | (level_pad[k][q * s:(q + 1) * s] < 0))
                        if bu[k] and act[k]
                        else np.zeros(s, bool)
                    )[0]
                    for k in range(b)
                ]
                for q in range(ranks)
            ]
            for i in range(rows):
                row_streams = {
                    (jc, kq): plane_list(pull_streams, i, jc, i * cols + kq)
                    for jc in range(cols) for kq in range(cols)
                }
                t, slog = _btfly_row_stage_replay(
                    row_streams, cols, bt_ladder, bt_floor, b=b
                )
                zones["row"]["btfly"] += t
                zones["consensus"]["btfly"] += 8 * len(slog)
                for entry in slog:
                    btfly_stages.append(
                        {"grid_row": i, "level": lv, "zone": "row-pull", **entry}
                    )
                t, slog = _btfly_unreached_stage_replay(
                    un_ids[i * cols:(i + 1) * cols], s, cols, un_ladder, b=b
                )
                zones["row"]["btfly"] += t
                zones["consensus"]["btfly"] += 8 * len(slog)
                for entry in slog:
                    btfly_stages.append(
                        {"grid_row": i, "level": lv, "zone": "unreached", **entry}
                    )
        # --- next level's per-plane direction: the same psum'd signals the
        # device threads through the carry
        for k in range(b):
            nxt = np.nonzero(level_pad[k] == lv + 1)[0]
            m_f = m_u = growing = None
            if adaptive:
                nxt_mask = level_pad[k] == lv + 1
                un_mask = (level_pad[k] < 0) | (level_pad[k] > lv + 1)
                m_f = int(dpad[nxt_mask].sum())
                m_u = int(dpad[un_mask].sum())
                growing = nxt.size > frontiers[k].size
            use_bu[k] = _next_direction(oracle, nxt.size, bool(use_bu[k]), m_f=m_f,
                                        m_u=m_u, growing=growing)

    shared = (zones["broadcast"] + zones["column"] + zones["transpose"]
              + zones["termination"] + zones["degree"] + zones["reduction"])
    plans = {}
    for plan in ("alltoall", "btfly"):
        total = shared + zones["row"][plan] + zones["consensus"][plan]
        plans[plan] = {
            "row_bytes": zones["row"][plan],
            "consensus_bytes": zones["consensus"][plan],
            "total_bytes": total,
            "bytes_per_source": total / b,
        }
    return {
        "B": b,
        "policy": policy,
        "roots": [int(r) for r in roots],
        "zones": {k: v for k, v in zones.items() if k not in ("row", "consensus")},
        "plans": plans,
        "btfly_stages": btfly_stages,
    }


def split_phase(phase: str) -> tuple[str, str | None]:
    """A ledger phase -> (zone, butterfly stage or None), the per-plane
    ``@p{k}`` suffix dropped."""
    m = re.fullmatch(r"(.*?)(?:\[btfly:(\w+)\])?(?:@p\d+)?", phase)
    return m.group(1), m.group(2)


def device_terms(stats: CommStats, rows: int, cols: int, alg: str = "bfs") -> dict:
    """A device ledger (the :class:`CommStats` that ``build_bfs`` filled, one
    batch on a ``rows`` x ``cols`` grid) in :func:`simulate_batch`'s
    conventions: cluster totals, link bytes for the column and row zones
    (``grid_moved_bytes``), result bytes for the transpose (self-sends
    included), all-reduces doubled for the termination and degree zones,
    and the bucket consensus doubled once per communicator group (the rank
    total over the group size: ``rows`` for the column, ``cols`` for the
    row zones), the column's and the row's together as the replay counts
    them.  ``stages`` sums the butterfly's stage zones per (zone, stage,
    format).

    The replay prices the levels that discover vertices: the device run it
    is compared with stops there (``max_levels``), since its last level
    finds nothing."""
    def zone(name):
        return [r for r in stats.records() if split_phase(r.phase)[0] == f"{alg}/{name}"]

    payload = ("row", "row-pull", "unreached")
    stages: dict = {}
    for r in stats.records():
        name, stage = split_phase(r.phase)
        if stage is not None and r.part != "bucket":
            key = (name.removeprefix(f"{alg}/"), stage, r.fmt)
            stages[key] = stages.get(key, 0) + r.grid_moved_bytes
    return {
        "column": sum(r.grid_moved_bytes for r in zone("column") if r.part != "bucket"),
        "transpose": sum(r.grid_bytes for r in zone("transpose")),
        "termination": sum(2 * r.grid_bytes for r in zone("termination")),
        "degree": sum(2 * r.grid_bytes for r in zone("degree")),
        "row_bytes": sum(r.grid_moved_bytes for z in payload for r in zone(z)
                         if r.part != "bucket"),
        "consensus_bytes": sum(2 * r.grid_bytes // size for z, size in
                               (("column", rows),) + tuple((z, cols) for z in payload)
                               for r in zone(z) if r.part == "bucket"),
        "stages": stages,
    }


def replay_terms(rep: dict, plan: str, s: int) -> dict:
    """:func:`simulate_batch`'s result for ``plan`` (``alltoall`` or
    ``btfly``) in the terms of :func:`device_terms`.  The replay charges a
    consensus to every butterfly stage, also to an unreached stage whose
    ladder has no sparse bucket (s < 65,536), where the device has a single
    branch and no consensus: those 8 bytes a grid row and stage are taken
    off here."""
    out = {k: rep["zones"][k] for k in ("column", "transpose", "termination", "degree")}
    out["row_bytes"] = rep["plans"][plan]["row_bytes"]
    out["consensus_bytes"] = rep["plans"][plan]["consensus_bytes"]
    stages: dict = {}
    if plan == "btfly":
        for e in rep["btfly_stages"]:
            key = (e.get("zone", "row"), e["stage"], e["fmt"])
            stages[key] = stages.get(key, 0) + e["bytes"]
        if not butterfly.unreached_wire(s)[0].specs:
            out["consensus_bytes"] -= 8 * sum(e.get("zone") == "unreached"
                                              for e in rep["btfly_stages"])
    out["stages"] = stages
    return out


def run_batch(scale: int = 15, rows: int = 2, cols: int = 2,
              n_src: int = BATCH_B, prebuilt=None):
    """Batched-vs-single packed-wire comparison for BENCH_comm.json.

    For each policy: a B=``n_src`` multi-source replay and the B=1 replay
    of the SAME model (same root = the argmax-degree hub), per row-phase
    plan.  The acceptance invariant — ``bytes_per_source`` at B=4 strictly
    below the B=1 total, for both plans — is enforced by
    :mod:`repro_torch.bench.check_comm`.  ``prebuilt`` (from
    :func:`build_replay_graph`) shares the graph AND the hub root's
    reference levels with the single-source replay suite.
    """
    cache = {}  # root -> reference levels, shared by every replay of g
    if prebuilt is not None:
        g, _, hub_level = prebuilt
        cache[int(np.argmax(g.degrees()))] = hub_level
    else:
        g = builder.build_csr(
            kronecker.kronecker_edges(scale, seed=1), n=1 << scale
        )
    out = {"B": n_src, "policies": {}}
    for policy in POLICIES:
        batched = simulate_batch(scale, rows, cols, n_src, policy=policy,
                                 graph=g, level_cache=cache)
        single = simulate_batch(scale, rows, cols, 1, policy=policy,
                                graph=g, level_cache=cache)
        entry = {"roots": batched["roots"], "zones": batched["zones"],
                 "plans": {}}
        for plan in ("alltoall", "btfly"):
            entry["plans"][plan] = {
                "batch": n_src,
                "row_bytes": batched["plans"][plan]["row_bytes"],
                "total_bytes": batched["plans"][plan]["total_bytes"],
                "bytes_per_source": batched["plans"][plan]["bytes_per_source"],
                "b1_total_bytes": single["plans"][plan]["total_bytes"],
            }
        entry["btfly_stages"] = batched["btfly_stages"]
        out["policies"][policy] = entry
    return out


def run(scale: int = 17, rows: int = 4, cols: int = 4, prebuilt=None):
    """-> (table rows with a ``policy`` key, per-policy per-level log)."""
    pol = threshold.ThresholdPolicy()
    table = []
    policy_levels = {}
    prebuilt = prebuilt or build_replay_graph(scale, rows, cols)
    for policy in POLICIES:
        stats, g, part, directions = simulate_zones(
            scale, rows, cols, policy=policy, prebuilt=prebuilt
        )
        policy_levels[policy] = directions
        zones = stats.per_phase_fmt()

        def add_row(zone, fmt, b, raw, plan="alltoall"):
            red = 100.0 * (1 - b / raw) if raw else 0.0
            speedup = pol.modeled_speedup(
                max(raw / 4, 1), ratio=max(raw / max(b, 1), 1.0)
            )
            table.append(
                {
                    "policy": policy,
                    "zone": zone,
                    "format": fmt,
                    "plan": plan,
                    "bytes": b,
                    "reduction_pct": red,
                    "modeled_time_reduction_pct": 100.0 * (1 - 1 / speedup)
                    if (fmt, plan) != ("raw", "alltoall")
                    else 0.0,
                }
            )

        for zone in ZONES:
            fmts = zones[zone]
            raw = fmts["raw"]
            for fmt in FORMATS:
                add_row(zone, fmt, fmts[fmt], raw)
        # the butterfly plan re-compresses per stage; only the row phase
        # differs from the direct plan (column/broadcast zones are shared)
        add_row(
            "rowCommunication",
            "packed",
            sum(d["row_bytes_btfly"] for d in directions),
            zones["rowCommunication"]["raw"],
            plan="btfly",
        )
    return table, policy_levels


def print_table(table: list[dict]) -> None:
    print("policy,zone,format,plan,bytes,data_reduction_pct,modeled_time_reduction_pct")
    for r in table:
        print(f"{r['policy']},{r['zone']},{r['format']},{r['plan']},{r['bytes']},"
              f"{r['reduction_pct']:.2f},{r['modeled_time_reduction_pct']:.2f}")


def print_batch(batch: dict) -> None:
    print(f"# multi-source batch (B={batch['B']}): packed-wire bytes per "
          "source vs the single-source total of the same model")
    print("policy,plan,batch,total_bytes,bytes_per_source,b1_total_bytes")
    for policy, entry in batch["policies"].items():
        for plan, d in entry["plans"].items():
            print(f"{policy},{plan},{d['batch']},{d['total_bytes']},"
                  f"{d['bytes_per_source']:.1f},{d['b1_total_bytes']}")


def print_levels(policy_levels: dict[str, list[dict]]) -> None:
    print("# per-level direction + packed row bytes (direct and butterfly)")
    print("policy,level,direction,frontier,density,row_bytes_packed,row_bytes_btfly")
    for policy, directions in policy_levels.items():
        for d in directions:
            print(f"{policy},{d['level']},{d['direction']},{d['frontier']},"
                  f"{d['density']:.4f},{d['row_bytes_packed']},{d['row_bytes_btfly']}")


def main(argv=None) -> tuple[list[dict], dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=17)
    ap.add_argument("--grid", default="4x4", help="R x C, e.g. 4x4")
    ap.add_argument("--batch", action="store_true",
                    help=f"also the multi-source section (B={BATCH_B})")
    args = ap.parse_args(argv)
    rows, cols = (int(x) for x in args.grid.lower().split("x"))
    prebuilt = build_replay_graph(args.scale, rows, cols)
    table, policy_levels = run(args.scale, rows, cols, prebuilt=prebuilt)
    print(f"# host replay, scale {args.scale}, {rows}x{cols} grid: bytes summed over the "
          "grid (numpy on the host; no device time)")
    print_table(table)
    print_levels(policy_levels)
    if args.batch:
        print_batch(run_batch(args.scale, rows, cols, prebuilt=prebuilt))
    return table, policy_levels


if __name__ == "__main__":
    main()
