"""The port's butterfly wire plan against the reference: the stage geometry
and the static byte model (``repro_torch.comm.butterfly`` against
``repro.comm.butterfly``), the staged builders on a simulated grid against
a dense all-to-all min and a plain concatenation, and the ledger's views
(``CommStats.add`` and its per-phase, per-format and per-op sums) against
``repro.comm.CommStats``.  The whole ``build_bfs(mode="btfly")`` is held
against JAX in ``tests/test_torch_dist.py`` and ``tests/test_torch_algebra.py``.
Inputs come from fixed numpy seeds."""

import re

import numpy as np
import pytest
import torch

from repro.comm import CommStats as JCommStats
from repro.comm import butterfly as jbutterfly
from repro_torch.comm import CommStats, SimGrid, butterfly
from repro_torch.comm.formats import INF
from repro_torch.comm.grid import COL_AXIS
from repro_torch.core.algebra import ALGEBRAS

#: (s, n): chunk widths with and without sparse buckets (the threshold's
#: 4,096-value minimum), payload classes 16 and 32
WIRES = [(1024, 4096), (4096, 16384), (8192, 65536), (8192, 1 << 17), (1 << 20, 1 << 22)]


@pytest.mark.parametrize("c", range(1, 9))
def test_schedule_equals_jax(c):
    mine, ref = butterfly.ButterflySchedule(c), jbutterfly.ButterflySchedule(c)
    for attr in ("p", "extra", "slots", "n_stages"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    for t in range(ref.n_stages):
        assert mine.stage_perm(t) == ref.stage_perm(t)
        assert mine.stage_blocks(t) == ref.stage_blocks(t)
    assert mine.fold_perm() == ref.fold_perm() and mine.unfold_perm() == ref.unfold_perm()
    assert [mine.leaf_of_chunk(q) for q in range(c)] == [ref.leaf_of_chunk(q) for q in range(c)]


def _ladder(ladder):
    return (ladder.s, tuple(sp.cap for sp in ladder.specs), ladder.floor_words,
            ladder.payload_width, tuple(f.name for f in ladder.formats()))


@pytest.mark.parametrize("s,n", WIRES)
def test_wires_and_stage_bytes_equal_jax(s, n):
    """``row_wire`` (id class and an overridden value class),
    ``unreached_wire`` and ``stage_unit_bytes`` of every format of both
    zones at B in {1, 4}."""
    for width in (None, 32):
        (lm, fm), (lr, fr) = butterfly.row_wire(s, n, width), jbutterfly.row_wire(
            s, n, payload_width=width)
        assert _ladder(lm) == _ladder(lr)
        assert (fm.name, fm.data_words, fm.wire_bytes) == (fr.name, fr.data_words,
                                                           fr.wire_bytes)
    (lm, fm), (lr, fr) = butterfly.unreached_wire(s), jbutterfly.unreached_wire(s)
    assert _ladder(lm) == _ladder(lr) and fm.name == fr.name
    for zone, wire in (("row", butterfly.row_wire(s, n)), ("unreached", (lm, fm))):
        names = [f.name for f in wire[0].formats()] + [wire[1].name]
        for name in names:
            for b in (1, 4):
                assert (butterfly.stage_unit_bytes(s, n, name, zone=zone, b=b)
                        == jbutterfly.stage_unit_bytes(s, n, name, zone=zone, b=b)), (
                    zone, name, b)
    with pytest.raises(KeyError):
        butterfly.stage_unit_bytes(s, n, "lz4")
    with pytest.raises(KeyError):
        butterfly.stage_unit_bytes(s, n, "bitmap", zone="column")


def _candidates(rng, b, c, s, n, density, local: int | None = None):
    """(b, c, s) int32 candidates: ids in [0, n) (or [0, local)) at
    ``density``, INF elsewhere."""
    hi = n if local is None else local
    vals = rng.integers(0, hi, size=(b, c, s))
    keep = rng.random((b, c, s)) < density
    return torch.as_tensor(np.where(keep, vals, INF).astype(np.int32))


def _fmts(stats: CommStats) -> set:
    return {(re.sub(r"@p\d+$", "", r.phase), r.fmt) for r in stats.records()
            if r.part != "bucket"}


# (grid rows, C, s, n_c, b, densities per grid row): class-16 payloads
# (bitmap+p16 floor) and class-32 ones (n_c * C > 65,536: dense int32 floor);
# per-row densities make the groups pick different branches
ROW_CASES = [
    (1, 2, 4096, 8192, 1, (0.001,)),
    (1, 2, 4096, 8192, 4, (0.9,)),
    (1, 3, 4096, 4096, 4, (0.003,)),
    (1, 3, 4096, 4096, 1, (0.6,)),
    (1, 4, 4096, 4096, 4, (0.002,)),
    (1, 4, 4096, 4096, 1, (0.5,)),
    (2, 3, 4096, 4096, 4, (0.002, 0.7)),
    (1, 2, 4096, 40000, 4, (0.001,)),
    (1, 3, 4096, 40000, 1, (0.8,)),
    (2, 4, 4096, 40000, 4, (0.7, 0.001)),
]


@pytest.mark.parametrize("to_global", [False, True])
@pytest.mark.parametrize("rows,c,s,n_c,b,densities", ROW_CASES)
def test_row_exchange_equals_dense_min(rows, c, s, n_c, b, densities, to_global):
    """Every rank's staged result equals the min over its grid row of the
    candidates for its chunk; pull candidates (``to_global``) are
    column-local and globalized first.  The inputs stay unchanged (the
    grid's ppermute shares tensors between ranks), and the ledger shows the
    wire each density should take."""
    rng = np.random.default_rng(1000 * c + 10 * b + rows)
    grid = SimGrid(rows, c, "cpu")
    n = n_c * c
    prop = [_candidates(rng, b, c, s, n, densities[q // c], local=n_c if to_global else None)
            for q in range(grid.size)]
    before = [x.clone() for x in prop]
    stats = CommStats()
    fn = butterfly.build_row_exchange(s, grid, COL_AXIS, n_c, b=b, to_global=to_global,
                                      stats=stats)
    out = fn(prop)
    col = grid.axis_index(COL_AXIS)
    for q in range(grid.size):
        assert torch.equal(prop[q], before[q])
        row = [x for x in range(grid.size) if x // c == q // c]
        glob = [torch.where(prop[x] < INF, col[x] * n_c + prop[x], INF) if to_global
                else prop[x] for x in row]
        want = torch.stack([g[:, col[q]] for g in glob]).amin(dim=0)
        assert out[q].dtype == torch.int32 and torch.equal(out[q], want), q
    ladder, floor = butterfly.row_wire(s, n)
    fmts = {f for _, f in _fmts(stats)}
    assert floor.name == ("dense-i32" if n > 65536 else "bitmap+p16")
    if max(densities) > 0.3:
        assert floor.name in fmts, fmts
    if min(densities) < 0.01:
        assert fmts & {f.name for f in ladder.formats()}, fmts
    stages = {p for p, _ in _fmts(stats)}
    sched = butterfly.ButterflySchedule(c)
    want = {f"bfs/row[btfly:{t}]" for t in range(sched.n_stages)}
    if sched.extra:
        want |= {"bfs/row[btfly:fold]", "bfs/row[btfly:unfold]"}
    assert stages == want


@pytest.mark.parametrize("c", [2, 3, 4])
def test_row_exchange_sum_algebra(c):
    """PageRank's sum: dense int32 blocks a stage, add-merged; the result is
    the sum over the grid row within float32 reassociation."""
    rng = np.random.default_rng(c)
    alg = ALGEBRAS["pagerank"]
    grid = SimGrid(1, c, "cpu")
    s, b = 1024, 2
    vals = [torch.as_tensor(rng.random((b, c, s), dtype=np.float32)) for _ in range(c)]
    stats = CommStats()
    out = butterfly.build_row_exchange(s, grid, COL_AXIS, s, b=b, stats=stats, alg=alg)(
        [alg.enc(v) for v in vals])
    for j in range(c):
        want = torch.stack([v[:, j] for v in vals]).sum(dim=0)
        torch.testing.assert_close(alg.dec(out[j]), want, rtol=1e-6, atol=1e-6)
    assert {f for _, f in _fmts(stats)} == {"dense-i32"}


@pytest.mark.parametrize("c,b,densities", [(2, 1, (0.001, 0.002)), (3, 4, (0.5, 0.001)),
                                           (4, 4, (0.002, 0.9)), (5, 1, (0.3, 0.004)),
                                           (4, 1, (0.0, 1.0)), (3, 1, (0.0, 0.001))])
def test_unreached_gather_equals_concatenation(c, b, densities):
    """Every rank of a grid row ends with the row's membership in chunk
    order (its own chunk included); the two grid rows pick their own
    wires (s = 65,536: the membership ladder's smallest chunk with a sparse
    bucket, cap 1,024)."""
    rng = np.random.default_rng(17 * c + b)
    s = 65536
    grid = SimGrid(2, c, "cpu")
    bits = [torch.as_tensor(rng.random((b, s)) < densities[q // c]) for q in range(grid.size)]
    stats = CommStats()
    out = butterfly.build_unreached_gather(s, grid, COL_AXIS, b=b, stats=stats)(bits)
    for q in range(grid.size):
        i = q // c
        want = torch.cat([bits[i * c + j] for j in range(c)], dim=1)
        assert out[q].dtype == torch.bool and torch.equal(out[q], want), q
    fmts = {f for _, f in _fmts(stats)}
    assert ("bitmap" in fmts) == (max(densities) > 0.01), fmts
    assert "pfor16[1024]" in fmts, fmts


def test_single_column_passes_through():
    grid = SimGrid(2, 1, "cpu")
    prop = [torch.full((2, 1, 1024), 5, dtype=torch.int32) for _ in range(2)]
    out = butterfly.build_row_exchange(1024, grid, COL_AXIS, 1024, b=2,
                                       to_global=True)(prop)
    assert all(torch.equal(x, torch.full((2, 1024), 5, dtype=torch.int32)) for x in out)
    bits = [torch.ones((2, 1024), dtype=torch.bool)] * 2
    assert butterfly.build_unreached_gather(1024, grid, COL_AXIS, b=2)(bits) == bits


def test_commstats_views_equal_jax():
    """``add`` and the views over what it accumulated: per phase (HLO and
    moved), per phase and format, per op, the totals."""
    rng = np.random.default_rng(5)
    mine, ref = CommStats(), JCommStats()
    kinds = ("all-gather", "all-to-all", "all-reduce", "collective-permute")
    for _ in range(60):
        args = (f"zone{rng.integers(3)}", f"fmt{rng.integers(4)}",
                kinds[rng.integers(len(kinds))], int(rng.integers(1, 10_000)))
        part = ("words", "meta")[rng.integers(2)]
        count = int(rng.integers(1, 4))
        mine.add(*args, part=part, count=count)
        ref.add(*args, part=part, count=count)
    assert mine.per_phase() == ref.per_phase()
    assert mine.per_phase_moved() == ref.per_phase_moved()
    assert mine.per_phase_fmt() == ref.per_phase_fmt()
    assert mine.per_op() == ref.per_op()
    assert (mine.total_bytes, mine.total_moved_bytes) == (ref.total_bytes,
                                                          ref.total_moved_bytes)
    assert ([(r.phase, r.fmt, r.collective, r.part, r.nbytes, r.count) for r in mine.records()]
            == [(r.phase, r.fmt, r.collective, r.part, r.nbytes, r.count)
                for r in ref.records()])
    with pytest.raises(AssertionError):
        mine.add("zone", "fmt", "broadcast", 4)
