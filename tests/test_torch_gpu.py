"""Tests that need the card: each CUDA kernel against its plain PyTorch
version, the BFS on the card against the BFS on the CPU, and the LM
serving path and AutoInt (no kernel of their own) on the card against the
CPU.  They import no JAX, so they run where the card is:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card they skip (decided in the fixture, not at import)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.comm import CommStats, SimGrid
from repro_torch.core import bfs, csr
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.graphgen import builder, kronecker
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.bitpack import ref as bp_ref
from repro_torch.kernels.spmv import ops as sp_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    """Exact agreement at the smoke script's ragged shapes (B > 8 planes
    takes a second pass of the ELL kernel), and each wrapper counts its
    launches."""
    import chip_smoke

    kernels.reset_launches()
    chip_smoke.check_ragged()
    for name in ("pack", "unpack", "popcount_planes", "popcount_blocks", "popcount_words",
                 "frontier_mask", "spmv_min_planes", "spmv_pull_min_planes", "spmv_min",
                 "spmv_pull_min", "gspmm_min_planes"):
        assert kernels.LAUNCHES[name] > 0, name
    nbr = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    f = bp_ops.pack_planes(torch.ones((1, 4), dtype=torch.bool, device=cuda), 1)
    with pytest.raises(ValueError):  # a mixed-device call raises, it does not fall back
        sp_ops.spmv_min_planes(nbr.cpu(), f, bp_ref.chunk_pad(4))


@pytest.mark.gpu
def test_launch_stream_is_the_current_stream(cuda):
    """``kernels.current_stream`` (the raw handle every launch takes) is
    ``torch.cuda.current_stream().cuda_stream``, on the default stream and
    inside a side stream, and a kernel launched inside the side stream runs
    there: its output is ready once that stream is synchronized."""
    assert kernels.current_stream() == torch.cuda.current_stream().cuda_stream
    assert kernels.current_stream(cuda) == torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(cuda)
    words = torch.randint(-2**31, 2**31 - 1, (8, 65536), device=cuda,
                          dtype=torch.int64).to(torch.int32)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        assert kernels.current_stream() == side.cuda_stream != torch.cuda.default_stream(
            cuda).cuda_stream
        got = bp_ops.unpack_planes(words, 1)
    side.synchronize()
    assert torch.equal(got, bp_ref.unpack_planes(words, 1))


@pytest.mark.gpu
def test_pack_and_popcount_routes_match_plain_on_card(cuda):
    """The pack and popcount_planes inputs of ``chip_smoke.check_ragged``
    (plane views 1 byte or 1 word into their storage, n = 0..15 mod 16, w =
    0..3 mod 4, w = 0, all-ones words, uint8 bytes of 2, B in {1, 3, 8, 17})
    take both routes (16-byte vectors and scalars) exactly."""
    import chip_smoke
    from repro_torch.kernels.popcount import ops as pc_ops
    from repro_torch.kernels.popcount import ref as pc_ref

    gen = torch.Generator(device=cuda).manual_seed(1)
    packs = chip_smoke.pack_ragged_inputs(gen, cuda)
    counts = chip_smoke.popcount_ragged_inputs(gen, cuda)
    assert {kernels.vec_rows(v) for _, v, b in packs if b < 32} == {0, 1}
    assert {kernels.vec_rows(w) for _, w in counts} == {0, 1}
    for label, vals, b in packs:
        assert torch.equal(bp_ops.pack_planes(vals, b), bp_ref.pack_planes(vals, b)), label
    for label, words in counts:
        assert torch.equal(pc_ops.popcount_planes(words), pc_ref.popcount_planes(words)), label
    ones = dict(counts)["all-ones B=17"]
    assert pc_ops.popcount_planes(ones).tolist() == [32 * ones.shape[1]] * 17


@pytest.mark.gpu
def test_popcount_planes_is_one_launch_on_card(cuda):
    """Each popcount_planes call launches one kernel and nothing else (no
    fill of its output) at the oracle's main shape."""
    from repro_torch.kernels.popcount import ops as pc_ops

    words = torch.randint(-2**31, 2**31 - 1, (8, 131072), device=cuda,
                          dtype=torch.int64).to(torch.int32)
    pc_ops.popcount_planes(words)  # the stream's ticket words are made once
    kernels.reset_launches()
    pc_ops.popcount_planes(words)
    assert dict(kernels.LAUNCHES) == {"popcount_planes": 1}
    _, by_kernel = kernels.device_ms(lambda: pc_ops.popcount_planes(words), reps=5)
    assert len(by_kernel) == 1 and next(iter(by_kernel)).startswith(
        "popcount_planes"), by_kernel


@pytest.mark.gpu
def test_popcount_planes_streams_keep_their_own_tickets(cuda):
    """Counts on two streams at once stay exact: each stream has its own
    ticket words, left 0 after every call."""
    from repro_torch.kernels.popcount import ops as pc_ops
    from repro_torch.kernels.popcount import ref as pc_ref

    words = torch.randint(-2**31, 2**31 - 1, (8, 131072), device=cuda,
                          dtype=torch.int64).to(torch.int32)
    want = pc_ref.popcount_planes(words)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for s in streams:
        with torch.cuda.stream(s):
            outs.append([pc_ops.popcount_planes(words) for _ in range(50)])
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for got in outs for o in got)
    keys = {(words.device, s.cuda_stream) for s in streams}
    assert keys <= pc_ops._SCRATCH.keys()
    assert all(int(pc_ops._SCRATCH[k].abs().sum()) == 0 for k in keys)


@pytest.mark.gpu
def test_popcount_blocks_routes_match_plain_on_card(cuda):
    """popcount_blocks at the smoke script's ragged inputs (W = 1, 7, 1,500,
    3 x 1,024 + 3, views one word into their storage) and at whole blocks
    (one block, the scale-22 and scale-26 planes), on both routes, exactly;
    one launch a call."""
    import chip_smoke
    from repro_torch.kernels.popcount import ops as pc_ops
    from repro_torch.kernels.popcount import ref as pc_ref

    gen = torch.Generator(device=cuda).manual_seed(2)
    cases = chip_smoke.blocks_ragged_inputs(gen, cuda)
    for w in (1024, 131072, 2097152):
        cases.append((f"w={w}", torch.randint(-2**31, 2**31 - 1, (w,), generator=gen,
                                              device=cuda, dtype=torch.int64).to(torch.int32)))
    assert {int(w.data_ptr() % 16 == 0) for _, w in cases} == {0, 1}
    for label, words in cases:
        kernels.reset_launches()
        got = pc_ops.popcount_blocks(words)
        assert kernels.LAUNCHES["popcount_blocks"] == 1, label
        assert torch.equal(got, pc_ref.popcount_blocks(words)), label
    ones = dict(cases)["all-ones w=4100"]
    assert pc_ops.popcount_blocks(ones).tolist() == [32 * 1024] * 4 + [32 * 4]


@pytest.mark.gpu
def test_local_count_and_frontier_study_on_card(cuda):
    """local_count on the card equals the bit sums; the frontier and codec
    study on the card equal the CPU run (sizes, directions, entropies,
    ratios), and each level launched popcount_blocks."""
    import chip_smoke
    from repro_torch.bench import codecs as bench_codecs
    from repro_torch.bench import frontier_stats

    chip_smoke.check_local_count()
    kernels.reset_launches()
    on_card = frontier_stats.run(scale=10, device=cuda)
    assert kernels.LAUNCHES["popcount_blocks"] >= on_card["n_levels"]
    assert on_card == frontier_stats.run(scale=10, device="cpu")
    rows = [bench_codecs.run(scale=10, n_zipf=20_000, device=dev) for dev in (cuda, "cpu")]
    assert [(r["codec"], r.get("ratio_pct")) for r in rows[0]] == [
        (r["codec"], r.get("ratio_pct")) for r in rows[1]]


@pytest.mark.gpu
def test_spmv_cases_match_plain_on_card(cuda):
    """The frontier mask, ELL push/pull and value-gather kernels against
    their plain versions, exactly, on every ``chip_smoke.SPMV_CASES`` input
    (1 to 17 planes, K from 1 to 64, unsorted and all-sentinel rows, empty
    and full frontiers, every row reached, offset slab views); the cases
    take both slab loads (16-byte vectors and scalars); a B-plane call
    launches the mask kernel and then its ELL kernel, a one-plane call the
    ELL kernel alone."""
    import chip_smoke

    chip_smoke.check_spmv_cases(cuda)
    vec = set()
    for i in range(len(chip_smoke.SPMV_CASES)):
        nbr = chip_smoke.spmv_case_tensors(chip_smoke.spmv_case(i), cuda)[0]
        vec.add(kernels.vec_rows(nbr))
    assert vec == {0, 1}
    labels = [c[0] for c in chip_smoke.SPMV_CASES]
    nbr, f, u, _, n_cols = chip_smoke.spmv_case_tensors(
        chip_smoke.spmv_case(labels.index("B=9 K=8")), cuda)
    for call, name in ((lambda: sp_ops.spmv_min_planes(nbr, f, n_cols), "spmv_min_planes"),
                       (lambda: sp_ops.spmv_pull_min_planes(nbr, f, u, n_cols),
                        "spmv_pull_min_planes")):
        kernels.reset_launches()
        call()
        assert dict(kernels.LAUNCHES) == {"frontier_mask": 1, name: 1}
    kernels.reset_launches()
    sp_ops.spmv_min(nbr, f[0], n_cols)
    sp_ops.spmv_pull_min(nbr, f[0], u[0], n_cols)
    assert dict(kernels.LAUNCHES) == {"spmv_min": 1, "spmv_pull_min": 1}


@pytest.mark.gpu
def test_frontier_mask_ragged_matches_plain_on_card(cuda):
    """The frontier mask kernel against its plain version, exactly, at B in
    {1, 2, 7, 8, 9, 16, 17} over 1, 3, 5 and 9 chunks (no multiple of 4,096
    columns), and on all-zero and all-set words; one launch a call."""
    import chip_smoke
    from repro_torch.kernels.spmv import ref as sp_ref

    gen = torch.Generator(device=cuda).manual_seed(2)
    cases = chip_smoke.mask_ragged_inputs(gen, cuda)
    assert {f.shape[0] for _, f in cases} == {1, *chip_smoke.HELPER_PLANES}
    for label, f in cases:
        kernels.reset_launches()
        got = sp_ops.frontier_mask(f)
        assert dict(kernels.LAUNCHES) == {"frontier_mask": 1}, label
        assert torch.equal(got, sp_ref.frontier_mask(f)), label
    mask = sp_ops.frontier_mask(dict(cases)["all-set B=9"])
    assert mask[0].eq(255).all() and mask[1].eq(1).all()


@pytest.mark.gpu
def test_interleave_values_ragged_matches_plain_on_card(cuda):
    """The interleave kernel against its plain version, exactly, on
    ``chip_smoke.interleave_ragged_inputs`` (B in {2, 7, 8, 9, 16, 17}, n_x
    equal to, below and above n_cols, ragged widths, random / all-zero /
    all-set masks, x and the mask as misaligned views), both routes taken;
    written into an output pre-filled with a sentinel, every column whose
    mask byte is 0 keeps the sentinel, and an all-zero mask writes nothing."""
    import chip_smoke
    from repro_torch.kernels.spmv import ref as sp_ref

    gen = torch.Generator(device=cuda).manual_seed(3)
    cases = chip_smoke.interleave_ragged_inputs(gen, cuda)
    assert {sp_ops.interleave_vec(x, m) for _, x, m in cases} == {0, 1}
    kernels.reset_launches()
    for label, x, m in cases:
        want = sp_ref.interleave_values(x, m)
        written = chip_smoke.interleaved_columns(m, x.shape[1]) > 0
        xi = torch.full(want.shape, chip_smoke.SENTINEL, dtype=torch.int32, device=cuda)
        sp_ops._interleave_into(x, m, xi)
        assert torch.equal(xi[written], want[written]), label
        assert bool((xi[~written] == chip_smoke.SENTINEL).all()), label
        if label.startswith("all-zero"):
            assert not written.any() and bool((xi == chip_smoke.SENTINEL).all()), label
    assert dict(kernels.LAUNCHES) == {"interleave_values": len(cases)}


@pytest.mark.gpu
def test_interleave_values_all_set_is_the_transpose_on_card(cuda):
    """At an all-set mask the kernel writes every column, and its output is
    the plane transpose ``x.view(g, 8, n_x).transpose(1, 2)`` (the library
    call chip_smoke.py times beside it); planes past B read INF."""
    from repro_torch.kernels.spmv import ref as sp_ref

    for planes, n_x in ((8, 8192), (16, 4100), (9, 1001)):
        x = torch.randint(0, 2**31 - 1, (planes, n_x), device=cuda, dtype=torch.int32)
        groups = -(-planes // 8)
        full = torch.full((groups, n_x), 255, dtype=torch.uint8, device=cuda)
        padded = torch.nn.functional.pad(x, (0, 0, 0, 8 * groups - planes), value=sp_ref.INF)
        want = padded.view(groups, 8, n_x).transpose(1, 2)
        assert torch.equal(sp_ops.interleave_values(x, full), want), (planes, n_x)


@pytest.mark.gpu
def test_gspmm_value_layouts_agree_on_card(cuda):
    """The value gather reads the same answer from both value layouts, on
    every ``chip_smoke.SPMV_CASES`` input with more than one plane: push
    with the plane-interleaved copy (the wrapper's choice, whose helper
    leaves the columns with a zero mask byte unwritten) and with the values
    as they are, for both ops and nonzero bases."""
    import chip_smoke
    from repro_torch.kernels.spmv import ref as sp_ref

    for i in range(len(chip_smoke.SPMV_CASES)):
        case = chip_smoke.spmv_case(i)
        nbr, f, _, x, n_cols = chip_smoke.spmv_case_tensors(case, cuda)
        if f.shape[0] == 1:
            continue
        for op in ("copy", "minplus"):
            base = chip_smoke.SPMV_BASES[1]
            mw = chip_smoke.SPMV_MAX_WEIGHT
            want = sp_ref.gspmm_min_planes(nbr, f, x, n_cols, op, mw, *base)
            for interleaved in (True, False):
                got = sp_ops._gather(nbr, f, x, None, n_cols, op, mw, *base,
                                     interleaved=interleaved)
                assert torch.equal(got, want), (case["label"], op, interleaved)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["top_down", "bottom_up", "direction_opt"])
@pytest.mark.parametrize("expand", ["coo", "ell", "hybrid"])
def test_bfs_on_card_matches_cpu(cuda, policy, expand):
    g = builder.build_csr(kronecker.kronecker_edges(12, seed=1), n=1 << 12)
    roots = np.array([0, 7, 100, 4000], np.int32)
    on_card = bfs.bfs(g.src, g.dst, roots, g.n, policy=policy, expand=expand, device=cuda)
    on_cpu = bfs.bfs(g.src, g.dst, roots, g.n, policy=policy, expand=expand, device="cpu")
    assert torch.equal(on_card.parent.cpu(), on_cpu.parent)
    assert torch.equal(on_card.level.cpu(), on_cpu.level)
    assert on_card.n_levels == on_cpu.n_levels


@pytest.mark.gpu
def test_distributed_on_card_matches_cpu(cuda):
    """auto + direction_opt + hybrid on a simulated 2x2 grid: the card's
    parents, levels, depth and byte ledger equal the CPU run's, and the
    path launched the unpack kernel."""
    g = builder.build_csr(kronecker.kronecker_edges(12, seed=1), n=1 << 12)
    bg = csr.partition_2d(g, 2, 2)
    cfg = dbfs.DistBFSConfig(mode="auto", policy="direction_opt", expand="hybrid")
    roots = np.array([0, 7, 100, 4000], np.int32)
    runs = {}
    for dev in (cuda, "cpu"):
        grid = SimGrid(2, 2, dev)
        stats = CommStats()
        kernels.reset_launches()
        parent, level, depth = dbfs.build_bfs(grid, bg, cfg, stats=stats)(
            *dbfs.shard_blocked(grid, bg, cfg), roots)
        runs[str(dev)] = (parent.cpu(), level.cpu(), depth, stats.table(),
                          dict(kernels.LAUNCHES))
    card, cpu = runs[str(cuda)], runs["cpu"]
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    assert card[2] == cpu[2] and card[3] == cpu[3]
    assert card[4].get("unpack", 0) > 0 and not cpu[4]


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["copy", "minplus"])
def test_gspmm_kernel_matches_plain_on_card(cuda, op):
    """The value-gather kernel against its plain version, push and pull,
    9 planes (two passes), nonzero bases, values near INF, n_x < n_cols."""
    from repro_torch.core import algebra
    from repro_torch.kernels.spmv import ref as sp_ref

    gen = torch.Generator(device=cuda).manual_seed(1)
    n_rows, k, planes, n_real = 5000, 11, 9, 7000
    n_cols = bp_ref.chunk_pad(n_real)
    nbr = torch.randint(0, n_real, (n_rows, k), generator=gen, device=cuda, dtype=torch.int32)
    f = bp_ops.pack_planes(torch.rand((planes, n_real), generator=gen, device=cuda) < 0.2, 1)
    u = bp_ops.pack_planes(torch.rand((planes, n_rows), generator=gen, device=cuda) < 0.5, 1)
    x = torch.randint(0, 2**31 - 1, (planes, n_real - 10), generator=gen, device=cuda,
                      dtype=torch.int64).to(torch.int32)
    x[:, ::3] = algebra.INF - 5
    alg = algebra.SsspAlgebra(max_weight=17) if op == "minplus" else algebra.CcAlgebra()
    kernels.reset_launches()
    for uw in (None, u):
        got = sp_ops.gspmm_planes(nbr, f, x, n_cols, alg, row_base=70000, col_base=3000,
                                  u_words=uw)
        want = sp_ref.gspmm_min_planes(nbr, f, x, n_cols, op, 17, 70000, 3000, uw)
        assert torch.equal(got, want)
    assert kernels.LAUNCHES["gspmm_min_planes"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["sssp", "cc", "pagerank"])
def test_algebras_on_card_match_cpu(cuda, alg):
    """Scale 12, hybrid: each algebra on the card equals the CPU run, on one
    device and on a simulated 2x2 grid under auto (PageRank's float32 sums
    within 1e-5 relative: the card adds in another order)."""
    g = builder.build_csr(kronecker.kronecker_edges(12, seed=1), n=1 << 12)
    roots = np.array([0, 7, 100, 4000], np.int32)
    bg = csr.partition_2d(g, 2, 2)
    cfg = dbfs.DistBFSConfig(mode="auto", policy="top_down", expand="hybrid", algebra=alg,
                             max_levels=256)
    runs = {}
    for dev in (cuda, "cpu"):
        one = bfs.bfs(g.src, g.dst, roots, g.n, expand="hybrid", device=dev, algebra=alg,
                      max_levels=256)
        grid = SimGrid(2, 2, dev)
        value, level, _ = dbfs.build_bfs(grid, bg, cfg)(*dbfs.shard_blocked(grid, bg, cfg),
                                                       roots)
        runs[str(dev)] = (one.parent.cpu(), one.level.cpu(), value.cpu(), level.cpu())
    card, cpu = runs[str(cuda)], runs["cpu"]
    for a, b in zip(card, cpu):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        elif alg != "pagerank":
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_unpack_kernel_matches_plain_on_card(cuda):
    """unpack_planes at every width on the smoke script's ragged inputs (1
    to 8 planes, 70,000 planes -- past the 65,535 of a y grid dimension --
    and a words view one word into its storage, the scalar-load route at
    b > 1) equals the plain version exactly; one launch a call below b = 32,
    none at b = 32 (the words themselves)."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(6)
    cases = chip_smoke.unpack_ragged_inputs(gen, cuda)
    assert {w.shape[0] for _, w, _ in cases} >= {1, 3, 8, 70_000}
    assert {w.storage_offset() for _, w, _ in cases} == {0, 1}
    kernels.reset_launches()
    for label, words, b in cases:
        got = bp_ops.unpack_planes(words, b)
        assert got.dtype == (torch.bool if b == 1 else torch.int32), label
        assert torch.equal(got, bp_ref.unpack_planes(words, b)), label
        if b == 32:
            assert got is words, label
    assert dict(kernels.LAUNCHES) == {"unpack": sum(b < 32 for _, _, b in cases)}
    words = torch.zeros((2, 1024), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # not whole chunks: raises, no fallback
        bp_ops.unpack_planes(words[:, :16].contiguous(), 1)


@pytest.mark.gpu
def test_quantize_kernel_matches_plain_on_card(cuda):
    """The int8 block-quantize kernel against its plain version exactly on
    the smoke script's ragged and half-way inputs (N = 128, N off 1024, an
    all-zero group, NaN and +/-inf groups, 0.5 / 1.5 / 2.5 at scale 1.0) and
    at 1, 3, 7, 9 and 4,097 groups (not multiples of the G groups a warp
    takes a step, every third value 0); a misaligned input raises; each call on a CUDA tensor
    launches the kernel."""
    import chip_smoke
    from repro_torch.kernels.quant import ops as q_ops
    from repro_torch.kernels.quant import ref as q_ref

    kernels.reset_launches()
    chip_smoke.check_quantize_ragged()
    # 10 inputs, then the non-finite and the ties again; the misaligned one raises
    assert kernels.LAUNCHES["quantize"] == 12
    gen = torch.Generator(device=cuda).manual_seed(4)
    for groups in (1, 3, 7, 9, 4097):  # tails of the G groups a warp takes a step
        x = torch.randn(128 * groups, generator=gen, device=cuda) * 10.0 ** (groups % 5 - 2)
        x[::3] = 0.0  # zeros take the kernel's own route round the division
        (q, s), (qr, sr) = q_ops.quantize(x), q_ref.quantize(x)
        assert torch.equal(q, qr) and torch.equal(s, sr), groups
        assert (q.dtype, q.shape, s.dtype, s.shape) == (
            torch.int8, (128 * groups,), torch.float32, (groups,))
    assert kernels.LAUNCHES["quantize"] == 17
    x = torch.zeros(256, device=cuda)
    with pytest.raises(ValueError):  # not a multiple of 128: raises, no fallback
        q_ops.quantize(x[:200])
    with pytest.raises(TypeError):  # float64 is not taken
        q_ops.quantize(x.double())


@pytest.mark.gpu
@pytest.mark.parametrize("refine", [2, 4])
@pytest.mark.parametrize("arch", ["graphcast", "gat-cora", "egnn", "nequip"])
def test_gnn_forward_on_card_matches_cpu(cuda, arch, refine):
    """The smoke widths on the multimesh over a 2x2 grid (refinement 2: one
    block holds every edge; 4: all four blocks do): the card's fp32 2D and
    single-device forwards equal the CPU's within float32 reassociation
    (1e-5 of the output's peak); the int8 forward launches the quantize
    kernel on the card, except NequIP's, whose payload stays fp32."""
    from repro_torch.bench import gnn as gnn_bench
    from repro_torch.models import gnn_dist

    runs = {}
    for dev in (cuda, "cpu"):
        st = gnn_bench.setup(arch, refine=refine, smoke=True, device=dev)
        kernels.reset_launches()
        q = gnn_bench.forward_2d(st, True)
        launched = kernels.LAUNCHES["quantize"]
        runs[str(dev)] = (gnn_bench.forward_2d(st, False).cpu(),
                          gnn_bench.forward_single(st).cpu(), q.cpu(), launched)
    card, cpu = runs[str(cuda)], runs["cpu"]
    for a, b in zip(card[:2], cpu[:2]):
        peak = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * peak)
    assert torch.isfinite(card[2]).all() or arch == "gat-cora"
    assert (card[3] > 0) == (arch not in gnn_dist.FP32_PAYLOAD) and cpu[3] == 0


@pytest.mark.gpu
def test_nequip_int8_is_its_fp32_forward_on_card(cuda):
    """NequIP asked for int8 on the card (smoke widths, refinement 4, 2x2):
    no quantize launch, and its output equals the fp32 forward's bit for
    bit under deterministic kernels (``chip_smoke.nequip_int8_check``)."""
    import chip_smoke
    from repro_torch.bench import gnn as gnn_bench

    st = gnn_bench.setup("nequip", refine=4, smoke=True, device=cuda)
    assert chip_smoke.nequip_int8_check(st) == (True, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["egnn", "nequip"])
def test_equivariance_on_card(cuda, arch):
    """Rotating (EGNN: and shifting) the positions on the card leaves the
    single-device and 2D outputs within ``chip_smoke.EQUIV_REL`` of their
    peak, and EGNN's coordinates move with the rotation and shift
    (``chip_smoke.equivariance_gaps``; smoke widths, refinement 4)."""
    import chip_smoke
    from repro_torch.bench import gnn as gnn_bench

    st = gnn_bench.setup(arch, refine=4, smoke=True, device=cuda)
    gaps = chip_smoke.equivariance_gaps(st)
    assert set(gaps) == ({"single", "2d", "coords"} if arch == "egnn" else {"single", "2d"})
    assert max(gaps.values()) <= chip_smoke.EQUIV_REL, gaps


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["egnn", "nequip"])
def test_molecule_train_step_on_card_matches_cpu(cuda, arch):
    """Two ``make_train_step`` steps on the molecule batch at the published
    widths (MSE on float targets): the card's losses and gradient norms
    equal the CPU's within 1e-5."""
    import chip_smoke
    from repro_torch.configs import common as configs
    from repro_torch.data import graphs
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    cfg = configs.get(arch).model_config()
    mb = graphs.molecule_batch(*chip_smoke.MOLECULE, seed=0)
    runs = []
    for dev in (cuda, "cpu"):
        batch = {"graph": gnn.Graph(*(torch.from_numpy(x).to(dev)
                                      for x in (mb.nf, mb.src, mb.dst, mb.pos))),
                 "targets": torch.from_numpy(mb.targets).to(dev)}
        fn = tstep.make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b),
                                   adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50))
        state = tstep.init_state(gnn.init(cfg, torch.Generator().manual_seed(0), dev))
        out = []
        for _ in range(2):
            state, m = fn(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(out)
    np.testing.assert_allclose(np.array(runs[0]), np.array(runs[1]), rtol=1e-5)


@pytest.mark.gpu
def test_gat_int8_nonfinite_on_card_matches_cpu(cuda):
    """GAT's int8 2D forward on the scale-9 Kronecker graph of the CPU tests
    (2 layers, 2 heads, parameters from seed 0) has NaN outputs, as the
    reference's has (ROADMAP Queue 3): the quantize kernel meets NaN and inf
    payloads on the way.  The card's outputs are NaN and inf exactly where
    the CPU's are, and the others agree within 1e-3 of the peak (one int8
    step moved by a float-order flip upstream)."""
    from repro_torch.models import gnn, gnn_dist

    g = builder.build_csr(kronecker.kronecker_edges(9, seed=5), n=1 << 9)
    bg = csr.partition_2d(g, 2, 2, chunk_multiple=256)
    cfg = gnn.GATConfig(n_layers=2, d_hidden=8, n_heads=2, d_in=12, d_out=16)
    nf = np.random.default_rng(0).normal(size=(bg.part.n, 12)).astype(np.float32)
    outs = []
    for dev in (cuda, "cpu"):
        grid = SimGrid(2, 2, dev)
        params = gnn.init(cfg, torch.Generator().manual_seed(0), dev)
        out = gnn_dist.forward_2d(grid, cfg, params, gnn_dist.shard_nodes(grid, nf, bg.part),
                                  gnn_dist.shard_edges(grid, bg.src_local),
                                  gnn_dist.shard_edges(grid, bg.dst_local), bg.part,
                                  gnn_dist.Dist2DConfig(quantize_payload=True))
        outs.append(torch.stack(out).cpu())
    card, cpu = outs
    finite = cpu.isfinite()
    assert not finite.all()
    assert torch.equal(card.isnan(), cpu.isnan()) and torch.equal(card.isinf(), cpu.isinf())
    peak = float(cpu[finite].abs().max())
    torch.testing.assert_close(card[finite], cpu[finite], rtol=0, atol=1e-3 * peak)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 2), (2, 3)])
def test_btfly_on_card_equals_auto(cuda, shape):
    """Scale 16, four valid roots: the butterfly plan's trees equal the
    direct plan's under every policy on the card (C = 2: one stage; C = 3:
    fold, one stage, unfold), and the stage zones are in its ledger.  Chunks
    are 4,096-multiples: at 2x3 the default 1,024-multiple chunk (11,264)
    gives bucket capacities that are no 1,024-multiple, which the ladder
    (as the reference's) refuses."""
    from repro_torch.bench import teps

    g = builder.build_csr(kronecker.kronecker_edges(16, seed=1), n=1 << 16)
    bg = csr.partition_2d(g, *shape, chunk_multiple=4096)
    grid = SimGrid(*shape, cuda)
    roots = teps.valid_roots(g, 4, seed=2)
    blocks = dbfs.shard_blocked(grid, bg, dbfs.DistBFSConfig(expand="hybrid"))
    for policy in ("top_down", "bottom_up", "direction_opt"):
        runs = {}
        for mode in ("auto", "btfly"):
            stats = CommStats()
            cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand="hybrid")
            runs[mode] = dbfs.build_bfs(grid, bg, cfg, stats=stats)(*blocks, roots)
        (pa, la, da), (pb, lb, db) = runs["auto"], runs["btfly"]
        assert torch.equal(pa, pb) and torch.equal(la, lb) and da == db, policy
        zones = {r.phase.split("@")[0] for r in stats.records()}
        assert "bfs/row[btfly:0]" in zones or "bfs/row-pull[btfly:0]" in zones, zones
        if shape[1] == 3:
            assert any(z.endswith("[btfly:fold]") for z in zones), zones


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["top_down", "bottom_up", "direction_opt"])
def test_btfly_ledger_on_card_equals_replay(cuda, policy):
    """Scale 16, 2x2, B=4 hub roots: the card's btfly ledger equals the
    port's host replay (``bench.bfs_comm.simulate_batch``) zone for zone
    and stage for stage, in the replay's conventions."""
    from repro_torch.bench import bfs_comm
    from repro_torch.core import validate

    scale, r, c, b = 16, 2, 2, 4
    g = builder.build_csr(kronecker.kronecker_edges(scale, seed=1), n=1 << scale)
    roots = bfs.hub_roots(g.degrees(), b)
    depth = max(int(validate.reference_bfs(g, int(x)).max()) for x in roots)
    rep = bfs_comm.simulate_batch(scale, r, c, b, policy=policy, graph=g)
    grid = SimGrid(r, c, cuda)
    bg = csr.partition_2d(g, r, c)
    cfg = dbfs.DistBFSConfig(mode="btfly", policy=policy, expand="hybrid", max_levels=depth)
    stats = CommStats()
    dbfs.build_bfs(grid, bg, cfg, stats=stats)(*dbfs.shard_blocked(grid, bg, cfg), roots)
    got = bfs_comm.device_terms(stats, r, c)
    assert got == bfs_comm.replay_terms(rep, "btfly", bg.part.chunk) and got["stages"]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["auto", "btfly"])
def test_process_grid_on_card_equals_simgrid(cuda, mode):
    """Four processes on the one card over gloo (CUDA tensors staged through
    host memory): the same planes, level count and merged ledger as
    SimGrid on the card; the staged transport reports its copies' time,
    and every worker launched the distributed path's kernels."""
    from repro_torch.bench import distributed as dist_bench, graph500
    from repro_torch.comm import procgrid

    scale, roots = 16, [3, 17, 1000, 12345]
    cases = [{"mode": mode, "policy": "direction_opt"}]
    procs = procgrid.spawn(dist_bench.proc_cases, 2, 2, device="cuda", timeout_s=300,
                           args=({"scale": scale, "roots": roots, "cases": cases},))
    st = dist_bench.setup(graph500.generate(scale, 16, 1)[0], SimGrid(2, 2, cuda), "hybrid")
    want = dist_bench.run_case(st, roots, **cases[0])
    np.testing.assert_array_equal(procs[0]["cases"][0]["value"], want["value"].cpu().numpy())
    np.testing.assert_array_equal(procs[0]["cases"][0]["level"], want["level"].cpu().numpy())
    for proc in procs:
        got = proc["cases"][0]
        assert got["n_levels"] == want["n_levels"]
        assert got["stats"].table() == want["stats"].table()
        assert got["staging_s"] > 0
        for name in ("pack", "unpack", "popcount_planes", "spmv_min_planes"):
            assert proc["launches"].get(name, 0) > 0, (proc["rank"], name)


@pytest.mark.gpu
def test_tree_betweenness_on_card_equals_cpu(cuda):
    """One index_add_ a level on the card gives the CPU's float64 sums."""
    from repro_torch.core.centrality import tree_betweenness

    g = builder.build_csr(kronecker.kronecker_edges(14, seed=1), n=1 << 14)
    res = bfs.bfs(g.src, g.dst, np.asarray([3, 17, 1000, 12345], np.int32), g.n,
                  policy="direction_opt", expand="hybrid", device=cuda)
    got = tree_betweenness(res.parent, res.level, g.n)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), tree_betweenness(res.parent.cpu(), res.level.cpu(), g.n))


@pytest.mark.gpu
def test_ste_quant_backward_on_card(cuda):
    """The straight-through quantizer on the card: its forward equals the
    CPU's (the kernel is exact against the plain version), its backward
    hands the cotangent through unchanged, and it launches the kernel."""
    from repro_torch.models import gnn_dist

    x = torch.randn(37, 9, generator=torch.Generator().manual_seed(5)) * 4
    w = torch.randn(37, 9, generator=torch.Generator().manual_seed(6))
    outs = []
    for dev in (cuda, "cpu"):
        xd = x.to(dev).requires_grad_(True)
        kernels.reset_launches()
        y = gnn_dist._ste_quant(xd)
        (y * w.to(dev)).sum().backward()
        assert torch.equal(xd.grad.cpu(), w)
        outs.append((y.detach().cpu(), kernels.LAUNCHES["quantize"]))
    assert torch.equal(outs[0][0], outs[1][0]) and not torch.equal(outs[0][0], x)
    assert outs[0][1] == 1 and outs[1][1] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axis", [((4, 1), "data"), ((2, 2), ("data", "model"))])
def test_allreduce_int8_on_card_matches_cpu(cuda, shape, axis):
    """The int8 all-reduce on the card against the CPU: every value within
    one quantization step of its group (the local sum of the received
    chunks may round apart), the ledgers equal record for record, two
    quantize launches a rank on the card."""
    from repro_torch.comm import collectives as cc

    gen = torch.Generator().manual_seed(9)
    xs = [torch.randn(4 * 128 * 5, generator=gen) * (p + 1) for p in range(4)]
    runs = []
    for dev in (cuda, "cpu"):
        grid = SimGrid(*shape, dev)
        stats = CommStats()
        kernels.reset_launches()
        out = cc.allreduce_int8(grid, [x.to(dev) for x in xs], axis, stats=stats)
        runs.append(([o.cpu() for o in out], stats.table(), kernels.LAUNCHES["quantize"]))
    (card, card_table, launched), (cpu, cpu_table, _) = runs
    assert card_table == cpu_table and launched == 2 * 4
    for a, b in zip(card, cpu):
        step = (b.reshape(-1, 128).abs().amax(1) / 127).repeat_interleave(128)
        assert bool(((a - b).abs() <= 1.001 * step).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,quantize", [("graphcast", False), ("graphcast", True),
                                           ("gat-cora", False), ("egnn", False), ("egnn", True),
                                           ("nequip", False)])
def test_train_step_on_card_matches_cpu(cuda, arch, quantize):
    """The 2D train step (the harness's ``train``, one step, refinement 4,
    smoke widths, 2x2) on the card against the CPU: the loss and every
    ``pmean``ed gradient within 1e-5 of the gradients' peak in fp32 (the
    card's index_add_ sums in another order), 1e-3 with int8 payloads (a
    code can flip by one step); the int8 step launches quantize on the card
    only."""
    from repro_torch.bench import gnn as gnn_bench, gnn_train

    runs = []
    for dev in (cuda, "cpu"):
        st = gnn_bench.setup(arch, refine=4, smoke=True, device=dev)
        runs.append(gnn_train.train(st, 1, quantize, warmup=0, capture=True))
    card, cpu = runs
    tol = 1e-3 if quantize else 1e-5
    assert abs(card["captured"]["loss"] - cpu["captured"]["loss"]) <= tol * abs(
        cpu["captured"]["loss"])
    peak = max(float(np.abs(g).max()) for g in cpu["captured"]["grads"])
    for a, b in zip(card["captured"]["grads"], cpu["captured"]["grads"]):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * peak)
    assert (card["launches"].get("quantize", 0) > 0) == quantize
    assert not cpu["launches"]


LM_ARCHS = ["gemma-2b", "minicpm-2b", "deepseek-coder-33b", "deepseek-v2-236b", "dbrx-132b"]
#: fp32 (TF32 off) decode on the card against the CPU: the same products
#: in other orders, over the logits' peak
LM_FP32_REL = 1e-4


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serving_on_card_matches_cpu(cuda, no_tf32, arch):
    """Smoke widths, fp32 compute: 12 decode steps from ``init_cache``
    (logits and cache) and the forward on the card within ``LM_FP32_REL``
    of the CPU's; the engine's greedy tokens (7 requests over 3 slots) equal
    the CPU's for the dense archs."""
    from repro_torch import tree
    from repro_torch.bench import serve as serve_bench
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import engine as eng

    cfg, params = serve_bench.model(arch, smoke=True, dtype="fp32", device="cpu")
    on_card = tree.tree_map(lambda x: x.to(cuda), params)
    seq = np.random.default_rng(5).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    runs = []
    for dev, p in (("cpu", params), (cuda, on_card)):
        cache = tfm.init_cache(cfg, 2, 16, device=dev)
        steps = []
        for i in range(12):
            lg, cache = tfm.decode_step(cfg, p, cache, torch.from_numpy(seq[:, i]).to(dev),
                                        torch.full((2,), i, device=dev))
            steps.append(lg.cpu())
        runs.append((torch.stack(steps), tfm.forward(cfg, p, torch.from_numpy(seq).to(dev))[0]
                     .cpu(), cache.cpu()))
    for want, got in zip(*runs):
        assert float((got - want).abs().max()) <= LM_FP32_REL * float(want.abs().max())
    if not cfg.is_moe:
        outs = []
        for dev, p in (("cpu", params), (cuda, on_card)):
            e = eng.Engine(cfg, p, batch_slots=3, max_seq=48, device=dev)
            reqs = [eng.Request(rid=i, prompt=pr, max_new=4)
                    for i, pr in enumerate(serve_bench.prompts(cfg.vocab, 7, 2, 8))]
            for r in reqs:
                e.submit(r)
            e.run_until_drained()
            outs.append([r.out for r in reqs])
        assert outs[0] == outs[1]


@pytest.mark.gpu
def test_router_top_k_ties_on_card(cuda):
    """The router's top-k keeps the lower expert first among equal gates on
    the card as on the CPU (all-equal gates, and gates rounded to bf16)."""
    from repro_torch.models import transformer as tfm

    gen = torch.Generator().manual_seed(0)
    for gates in (torch.full((5, 160), 1 / 160), torch.full((3, 16), 0.25),
                  (torch.rand((64, 160), generator=gen) * 0.02).bfloat16().float()):
        for k in (2, 4, 6):
            v_cpu, i_cpu = tfm.top_k(gates, k)
            v_card, i_card = tfm.top_k(gates.to(cuda), k)
            assert torch.equal(i_card.cpu(), i_cpu) and torch.equal(v_card.cpu(), v_cpu)
    assert tfm.top_k(torch.zeros(1, 8, device=cuda), 3)[1].tolist() == [[0, 1, 2]]


#: AutoInt on the card against the CPU in fp32 (TF32 off): the same
#: products in other orders, over each output's peak
RECSYS_FP32_REL = 1e-5


def _recsys_cfgs():
    from repro_torch.configs import common as configs

    spec = configs.get("autoint")
    return {"smoke": spec.smoke_config(),
            "published": dataclasses.replace(spec.model_config(), table_sizes=(64,) * 39)}


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["smoke", "published"])
@pytest.mark.parametrize("quant", [False, True])
def test_recsys_on_card_matches_cpu(cuda, no_tf32, which, quant):
    """``embedding_bag`` (single ids and 3-slot bags padded with -1, sum
    and mean) exact; ``forward``, ``user_vector`` and ``retrieval_scores``
    within ``RECSYS_FP32_REL`` of the CPU's, the weights drawn on the CPU
    and copied."""
    from repro_torch import tree
    from repro_torch.bench import recsys as recsys_bench
    from repro_torch.models import recsys

    cfg = dataclasses.replace(_recsys_cfgs()[which], table_quant=quant)
    params = recsys.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = tree.tree_map(lambda x: x.to(cuda), params)
    ids = recsys_bench.batch(cfg, 64, 0, "cpu")["ids"]
    cand = recsys_bench.candidates(cfg, 1000, 0, "cpu")
    rng = np.random.default_rng(4)
    bags = torch.from_numpy(np.where(rng.random((16, cfg.n_sparse, 3)) < 0.3, -1,
                                     rng.integers(0, 64, (16, cfg.n_sparse, 3))).astype(np.int32))
    offs = recsys.field_offsets(cfg, "cpu")
    outs = []
    for dev, p in (("cpu", params), (cuda, on_card)):
        o = recsys.field_offsets(cfg, dev)
        outs.append([recsys.forward(cfg, p, ids.to(dev)).cpu(),
                     recsys.user_vector(cfg, p, ids[:4].to(dev)).cpu(),
                     recsys.retrieval_scores(cfg, p, ids[:1].to(dev), cand.to(dev)).cpu()]
                    + [recsys.embedding_bag(p["table"], x.to(dev), o, mode).cpu()
                       for x in (ids, bags) for mode in ("sum", "mean")])
    for k, (want, got) in enumerate(zip(*outs)):
        if k < 3:
            assert torch.isfinite(got).all()
            assert float((got - want).abs().max()) <= RECSYS_FP32_REL * float(want.abs().max()), k
        else:
            assert torch.equal(got, want), k
    assert torch.equal(outs[0][3], params["table"][(ids + offs[None]).long()])


@pytest.mark.gpu
def test_recsys_launcher_resume_on_card(cuda, tmp_path):
    """``launch.train`` for autoint on the card: with the newest checkpoint
    of an uninterrupted 8-step run removed, as if killed before writing it,
    the same command resumes at step 4 and ends on that run's state bit for
    bit (deterministic kernels: the gather's backward sums in a fixed
    order)."""
    import shutil

    from repro_torch import tree
    from repro_torch.bench.gnn_train import deterministic
    from repro_torch.launch import train as launcher

    argv = ["--arch", "autoint", "--steps", "8", "--ckpt-every", "4", "--batch", "64",
            "--ckpt-dir", str(tmp_path)]
    with deterministic():
        whole = launcher.main(argv)
        shutil.rmtree(tmp_path / "step_000007")
        resumed = launcher.main(argv)
    assert resumed["start_step"] == 4 and resumed["losses"] == whole["losses"][4:]
    a, b = tree.leaves(resumed["state"]), tree.leaves(whole["state"])
    assert all(x.is_cuda for x in a) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_id_stream_helpers_match_plain_on_card(cuda):
    """``pack_sorted_ids`` / ``unpack_sorted_ids`` (through the pack and
    unpack kernels) and ``compact_ids`` on the card, bit for bit against
    their plain versions at every width class and ``chip_smoke``'s ragged
    counts; the round trip gives back the stream."""
    import chip_smoke

    kernels.reset_launches()
    n = chip_smoke.check_id_streams()
    assert n == (len(bp_ref.B_CLASSES) + 2) * len(chip_smoke.ID_STREAM_COUNTS)
    # b = 32 is the identity on the bit pattern and launches nothing
    widths = len(bp_ref.B_CLASSES) - 1
    assert kernels.LAUNCHES["pack"] == kernels.LAUNCHES["unpack"] == widths * len(
        chip_smoke.ID_STREAM_COUNTS)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 16])
def test_id_stream_words_on_card_are_the_plain_words(cuda, b):
    """A stream at a ragged count, its count a CUDA tensor: the card's words
    are ``ref``'s on the CPU, and ``compressed_words`` long."""
    rng = np.random.default_rng(b)
    ids = np.zeros(4096, np.int32)
    ids[:1500] = np.cumsum(rng.integers(0, 1 << b, 1500))
    t = torch.from_numpy(ids)
    words = bp_ops.pack_sorted_ids(t.to(cuda), torch.tensor(1500, device=cuda), b)
    assert words.shape == (bp_ops.compressed_words(4096, b),)
    assert torch.equal(words.cpu(), bp_ref.pack_sorted_ids(t, 1500, b))
    back = bp_ops.unpack_sorted_ids(words, torch.tensor(1500, device=cuda), b, fill=-1)
    assert torch.equal(back.cpu(), bp_ref.unpack_sorted_ids(words.cpu(), 1500, b, fill=-1))
