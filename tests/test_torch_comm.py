"""The port's communication plane against ``repro.comm``: wire-format words
and geometry, bucket ladders, and the adaptive collectives on a simulated
grid, all on the CPU with inputs made from a seed with numpy."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import formats as jformats
from repro.comm import ladder as jladder
from repro.comm.butterfly import width_class as jwidth_class
from repro_torch.comm import SimGrid, collectives, engine, formats, grid, ladder
from repro_torch.comm.stats import CommStats
from repro_torch.core.algebra import INF, width_class

SIZES = (4096, 32768, 1 << 20)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)).astype(np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _ladders(s):
    """Every ladder the BFS builds at chunk width s: the column ladder and
    row ladders at the payload classes of a 1- to 4-column grid."""
    out = [("column", {})]
    for cols in (1, 2, 4):
        pw = jwidth_class(s * cols)
        out.append((f"row-p{pw}", {"floor_words": s, "payload_width": pw}))
    return out


def _sorted_stream(rng, s, count, cap, exceptions=0):
    """``count`` distinct ascending ids in [0, s), ``exceptions`` of whose
    gaps reach 2**16 (s must allow it), padded with ``s`` to ``cap``."""
    if exceptions:
        jumps = np.sort(rng.choice(np.arange(1, count), exceptions, replace=False))
        gaps = rng.integers(1, 3, size=count)
        gaps[jumps] = (1 << 16) + rng.integers(0, 100, size=exceptions)
        ids = np.cumsum(gaps) - 1
        assert ids[-1] < s
    else:
        ids = np.sort(rng.choice(s, count, replace=False))
    out = np.full(cap, s, np.int32)
    out[:count] = ids
    return out


def test_ladder_geometry_matches_jax():
    for s in SIZES:
        for _, kw in _ladders(s):
            ours, ref = ladder.BucketLadder.default(s, **kw), jladder.BucketLadder.default(s, **kw)
            assert [x.cap for x in ours.specs] == [x.cap for x in ref.specs]
            assert [x.exc_cap for x in ours.specs] == [x.exc_cap for x in ref.specs]
            assert (ours.floor_words, ours.n_branches) == (ref.floor_words, ref.n_branches)
            for i in range(ours.n_branches):
                assert ours.words_for_branch(i) == ref.words_for_branch(i)
            for a, b in zip(ours.formats(), ref.formats()):
                assert (a.name, a.data_words, a.wire_bytes) == (b.name, b.data_words,
                                                                 b.wire_bytes)
                for planes in (1, 2, 8):
                    assert formats.plane_wire_bytes(a, planes) == \
                        jformats.plane_wire_bytes(b, planes)
            rng = np.random.default_rng(s)
            counts = rng.integers(0, s, size=64).astype(np.int32)
            excs = rng.integers(0, 9000, size=64).astype(np.int32)
            np.testing.assert_array_equal(
                ours.bucket_for(torch.from_numpy(counts), torch.from_numpy(excs)).numpy(),
                np.asarray(ref.bucket_for(jnp.asarray(counts), jnp.asarray(excs))))
    assert [x.cap for x in ladder.BucketLadder.default(1 << 20).specs] == [4096, 16384]
    assert ladder.BucketLadder.default(32768).specs == ()
    for n in (1, 2, 1000, 1 << 14, (1 << 14) + 1, 1 << 21, 1 << 30):
        assert width_class(n) == jwidth_class(n)


def test_dense_format_geometry_matches_jax():
    for s in SIZES:
        pairs = [(formats.BitmapFormat(s), jformats.BitmapFormat(s)),
                 (formats.RawIdFormat(s), jformats.RawIdFormat(s)),
                 (formats.DenseFormat(s), jformats.DenseFormat(s))]
        pairs += [(formats.BitmapParentFormat(s, w), jformats.BitmapParentFormat(s, w))
                  for w in (1, 8, 16)]
        for a, b in pairs:
            assert (a.name, a.data_words, a.meta_words, a.wire_bytes) == \
                (b.name, b.data_words, b.meta_words, b.wire_bytes)
            for planes in (1, 3, 8):
                assert formats.plane_wire_bytes(a, planes) == jformats.plane_wire_bytes(b, planes)
        assert formats.plane_meta_words(1) == 2 and formats.plane_meta_words(4) == 4


@pytest.mark.parametrize("s", SIZES)
def test_id_stream_words_and_meta_match_jax(s):
    """Every spec of every ladder at s: pack_id_stream (with exceptions
    where s allows gaps >= 2**16) and the parent payload equal JAX's words
    and meta, and unpack round-trips."""
    rng = np.random.default_rng(s + 1)
    specs = {spec.cap: spec for _, kw in _ladders(s)
             for spec in jladder.BucketLadder.default(s, **kw).specs}
    specs.setdefault(1024, jformats.IdStreamSpec(1024))
    for cap, jspec in sorted(specs.items()):
        spec = formats.IdStreamSpec(cap)
        for count in (0, 1, cap // 3, cap):
            jumps = min(12, count - 1) if s > 1 << 17 and count > 1 else 0
            ids = _sorted_stream(rng, s, count, cap, exceptions=jumps)
            exc = int((np.diff(ids[:count], prepend=0) >= 1 << 16).sum())
            assert exc >= jumps
            j_words, j_meta = jformats.pack_id_stream(jnp.asarray(ids), jnp.int32(count), jspec)
            words, meta = formats.pack_id_stream(torch.from_numpy(ids)[None],
                                                 torch.tensor([count]), spec)
            np.testing.assert_array_equal(_u32(words[0]), np.asarray(j_words))
            np.testing.assert_array_equal(meta[0].numpy(), np.asarray(j_meta))
            assert int(meta[0, 1]) == exc
            back, cnt = formats.unpack_id_stream(words, meta, spec, fill=s)
            np.testing.assert_array_equal(back[0].numpy(), ids)
            assert int(cnt[0]) == count
            for pw in (16, 32):
                payload = rng.integers(0, 2**pw - 1, size=cap, dtype=np.int64)
                fmt, jfmt = formats.IdStreamFormat(spec, pw), jformats.IdStreamFormat(jspec, pw)
                jw, _ = jfmt.pack(jnp.asarray(ids), jnp.int32(count),
                                  payload=jnp.asarray(payload.astype(np.uint32)))
                w, m = fmt.pack(torch.from_numpy(ids)[None], torch.tensor([count]),
                                payload=_i32(payload)[None])
                np.testing.assert_array_equal(_u32(w[0]), np.asarray(jw))
                u_ids, u_cnt, u_pay = fmt.unpack(w, m, fill=s)
                np.testing.assert_array_equal(u_ids[0].numpy(), ids)
                assert int(u_cnt[0]) == count
                np.testing.assert_array_equal(_u32(u_pay[0])[:count],
                                              payload[:count].astype(np.uint32))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("pw", [1, 8, 16])
def test_bitmap_parent_and_bitmap_pack_match_jax(s, pw):
    rng = np.random.default_rng(s + pw)
    prop = rng.integers(0, 2**pw, size=s).astype(np.int32)
    prop[rng.random(s) < 0.6] = INF
    fmt, jfmt = formats.BitmapParentFormat(s, pw), jformats.BitmapParentFormat(s, pw)
    words = fmt.pack(torch.from_numpy(prop))
    np.testing.assert_array_equal(_u32(words), np.asarray(jfmt.pack(jnp.asarray(prop))))
    found, local = fmt.unpack(words)
    np.testing.assert_array_equal(found.numpy(), prop < INF)
    np.testing.assert_array_equal(np.where(prop < INF, local.numpy(), INF), prop)
    bits = prop < INF
    bw = formats.pack_bitmap(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(bw), np.asarray(jformats.pack_bitmap(jnp.asarray(bits))))
    np.testing.assert_array_equal(formats.unpack_bitmap(bw).numpy(), bits)


def test_plane_meta_and_raw_ids_match_jax():
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 1 << 16, size=16).astype(np.int32)
    excs = rng.integers(0, 8192, size=16).astype(np.int32)
    packed = formats.pack_plane_meta(torch.from_numpy(counts), torch.from_numpy(excs))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jformats.pack_plane_meta(jnp.asarray(counts),
                                                            jnp.asarray(excs))))
    c, e = formats.unpack_plane_meta(packed)
    np.testing.assert_array_equal(c.numpy(), counts)
    np.testing.assert_array_equal(e.numpy(), excs)
    bits = rng.random(4096) < 0.1
    ids, meta = formats.RawIdFormat(4096).pack(torch.from_numpy(bits))
    j_ids, j_meta = jformats.RawIdFormat(4096).pack(jnp.asarray(bits))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(meta.numpy(), np.asarray(j_meta))
    u, cnt = formats.RawIdFormat(4096).unpack(ids, meta, fill=4096)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jformats.RawIdFormat(4096).unpack(j_ids, j_meta, 4096)[0]))
    assert int(cnt) == int(bits.sum())


def test_grid_collectives_follow_lax_semantics():
    g = SimGrid(2, 3, "cpu")
    assert g.groups("data") == [[0, 3], [1, 4], [2, 5]]
    assert g.groups(("model",)) == [[0, 1, 2], [3, 4, 5]]
    assert g.axis_index(("data", "model")) == list(range(6))
    xs = [torch.full((3, 2), p) for p in range(6)]
    gathered = g.all_gather(xs, "model")
    assert torch.equal(gathered[4], torch.cat([xs[3], xs[4], xs[5]]))
    a2a = g.all_to_all([torch.arange(3) + 10 * p for p in range(6)], "model")
    assert a2a[1].tolist() == [1, 11, 21] and a2a[5].tolist() == [32, 42, 52]
    assert g.psum(xs, "data")[1][0, 0] == 1 + 4
    assert g.pmax(xs, ("data", "model"))[0][0, 0] == 5
    perm = g.ppermute(xs, "model", [(0, 1), (1, 1)])
    assert perm[1][0, 0] == 1 and int(perm[0].abs().sum()) == 0 and int(perm[2].sum()) == 0
    with pytest.raises(ValueError):
        g.groups(("pod", "data"))
    with pytest.raises(RuntimeError):
        if not torch.cuda.is_available():
            SimGrid(2, 2)
        else:
            raise RuntimeError("a card is present")


def _zone_bytes(stats: CommStats, phase: str) -> dict:
    out = {}
    for r in stats.records():
        if re.sub(r"@p\d+$", "", r.phase) == phase:
            key = (r.fmt, r.collective, r.part)
            out[key] = out.get(key, 0) + r.nbytes
    return out


@pytest.mark.parametrize("counts", [(300, 4000), (4097, 20), (16385, 9000)],
                         ids=["pfor16-4096", "pfor16-16384", "bitmap"])
def test_allgather_membership_planes_branches_2rank(counts):
    """s = 2**20, B = 2 on a 2-rank grid: densities on each of the column
    ladder's three branches.  The result is the concatenated input exactly
    and the ledger holds the JAX formats' geometry."""
    s, b, gsz = 1 << 20, 2, 2
    g = SimGrid(gsz, 1, "cpu")
    rng = np.random.default_rng(sum(counts))
    bits = []
    for p in range(gsz):
        plane = np.zeros((b, s), bool)
        for k in range(b):
            plane[k, rng.choice(s, counts[(p + k) % 2], replace=False)] = True
        bits.append(plane)
    lad = ladder.BucketLadder.default(s)
    stats = CommStats()
    got = collectives.allgather_membership_planes(
        [torch.from_numpy(x) for x in bits], g, "data", lad, stats=stats)
    want = np.concatenate(bits, axis=1)
    for p in range(gsz):
        np.testing.assert_array_equal(got[p].numpy(), want)
    jlad = jladder.BucketLadder.default(s)
    bucket = max(int(np.asarray(jlad.bucket_for(jnp.int32(c), jnp.int32(0)))) for c in counts)
    if bucket < len(jlad.specs):
        fmt = jlad.formats()[bucket]
        expect = {(fmt.name, "all-gather", "words"): gsz * b * fmt.data_words * 4,
                  (fmt.name, "all-gather", "meta"): gsz * b * 4,
                  ("consensus", "all-reduce", "bucket"): 4}
    else:
        expect = {("bitmap", "all-gather", "words"): gsz * b * jformats.BitmapFormat(s).wire_bytes,
                  ("consensus", "all-reduce", "bucket"): 4}
    assert _zone_bytes(stats, "bfs/column") == expect
    single = collectives.allgather_membership(
        [torch.from_numpy(x[0]) for x in bits], g, "data", lad, stats=CommStats())
    np.testing.assert_array_equal(single[0].numpy(), want[0])


@pytest.mark.parametrize("count", [1000, 10000, 40000, 200000],
                         ids=["pfor16-4096", "pfor16-16384", "pfor16-65536", "dense"])
def test_alltoall_min_candidates_planes_branches_2rank(count):
    """s = 2**20, B = 2 on a 1x2 grid (n_c = s, 32-bit parent payload):
    each branch of the row ladder against a plain min over senders, with the
    JAX geometry's bytes; the single-source form agrees on plane 0."""
    s, b, c = 1 << 20, 2, 2
    n_c = s
    g = SimGrid(1, c, "cpu")
    rng = np.random.default_rng(count)
    props = []
    for j in range(c):
        prop = np.full((b, c, s), INF, np.int32)
        for k in range(b):
            for d in range(c):
                idx = rng.choice(s, count // (1 + k + d), replace=False)
                prop[k, d, idx] = j * n_c + rng.integers(0, n_c, size=idx.size)
        props.append(prop)
    pw = width_class(n_c)
    lad = ladder.BucketLadder.default(s, floor_words=s, payload_width=pw)
    stats = CommStats()
    got = collectives.alltoall_min_candidates_planes(
        [torch.from_numpy(x) for x in props], g, "model", lad, stats=stats, n_c=n_c)
    for a in range(c):
        want = np.min(np.stack([props[j][:, a, :] for j in range(c)]), axis=0)
        np.testing.assert_array_equal(got[a].numpy(), want)
    jlad = jladder.BucketLadder.default(s, floor_words=s, payload_width=pw)
    bucket = int(np.asarray(jlad.bucket_for(jnp.int32(count), jnp.int32(0))))
    if bucket < len(jlad.specs):
        fmt = jlad.formats()[bucket]
        expect = {(fmt.name, "all-to-all", "words"): c * b * fmt.data_words * 4,
                  (fmt.name, "all-to-all", "meta"): c * b * 4,
                  ("consensus", "all-reduce", "bucket"): 4}
    else:
        expect = {("dense-i32", "all-to-all", "words"): c * b * s * 4,
                  ("consensus", "all-reduce", "bucket"): 4}
    assert _zone_bytes(stats, "bfs/row") == expect
    single_stats = CommStats()
    single = collectives.alltoall_min_candidates(
        [torch.from_numpy(x[0]) for x in props], g, "model", lad, stats=single_stats,
        n_c=n_c)
    np.testing.assert_array_equal(single[0].numpy(), got[0][0].numpy())
    if bucket < len(jlad.specs):  # the single-source sideband is two words
        assert _zone_bytes(single_stats, "bfs/row")[(fmt.name, "all-to-all", "meta")] == c * 8


def test_engine_records_per_group_dispatch_and_moved_bytes():
    """Groups that pick different buckets each run their own branch; the
    ledger counts one rank's bytes per call and the grid totals per rank."""
    g = SimGrid(2, 2, "cpu")
    stats = CommStats()
    ex = engine.AdaptiveExchange("t/x", g, "model", None, stats)
    ran = []

    def branch(k):
        def run(gs):
            ran.append((k, gs))
            return ex.all_gather([torch.zeros(4, dtype=torch.int32)] * 4, fmt=f"f{k}",
                                 groups=gs)
        return run

    ex.dispatch([torch.tensor(v, dtype=torch.int32) for v in (0, 1, 0, 0)],
                [branch(0), branch(1)])
    assert ran == [(0, [[2, 3]]), (1, [[0, 1]])]
    recs = {(r.fmt, r.part): r for r in stats.records()}
    assert recs[("consensus", "bucket")].grid_bytes == 16
    assert recs[("consensus", "bucket")].moved_bytes == 4
    assert recs[("f1", "words")].nbytes == 32 and recs[("f1", "words")].grid_moved_bytes == 32
    perm_stats = CommStats()
    ex2 = engine.AdaptiveExchange("t/p", g, grid.ALL_AXES, None, perm_stats)
    ex2.ppermute([torch.zeros(8, dtype=torch.bool)] * 4, [(0, 0), (1, 2), (2, 1), (3, 3)],
                 fmt="membership")
    (rec,) = perm_stats.records()
    assert (rec.nbytes, rec.moved_bytes, rec.grid_bytes) == (8, 4, 32)


@pytest.mark.parametrize("mode", ["raw", "bitmap", "auto"])
def test_plan_results_are_contiguous(mode):
    """Every wire plan's per-rank results feed the pack and ELL kernels,
    which take contiguous tensors only."""
    from repro_torch.comm import registry

    g = SimGrid(2, 2, "cpu")
    s, b = 4096, 3
    rng = np.random.default_rng(11)
    bits = [torch.from_numpy(rng.random((b, s)) < 0.01) for _ in range(4)]
    prop = [torch.from_numpy(np.where(rng.random((b, 2, s)) < 0.01, j * 2 * s, INF)
                             .astype(np.int32)) for j in (0, 1, 0, 1)]
    plan = registry.wire_plan(mode)
    outs = [plan.build_column(s, g, "data", b=b)(bits),
            plan.build_unreached(s, g, "model", b=b)(bits),
            plan.build_row(s, g, "model", 2 * s, 16, b=b)(prop),
            plan.build_row_bu(s, g, "model", 2 * s, 16, b=b)(
                [torch.where(x < INF, x % (2 * s), INF) for x in prop])]
    for got in outs:
        assert all(x.is_contiguous() for x in got)
