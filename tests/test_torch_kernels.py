"""Port kernels vs the JAX package's Pallas kernels (interpret mode) and
their oracles.  On the CPU every port wrapper runs its plain PyTorch
version; the CUDA kernels themselves are held against those versions on
the card (``tests/test_torch_gpu.py`` and ``chip_smoke.py``)."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke

from repro.kernels.bitpack import bitpack as jbitpack
from repro.kernels.bitpack import ops as jbp_ops
from repro.kernels.bitpack import ref as jbp_ref
from repro.kernels.popcount import ops as jpc_ops
from repro.kernels.popcount import popcount as jpopcount
from repro.kernels.popcount import ref as jpc_ref
from repro.kernels.spmv import ops as jsp_ops
from repro.kernels.spmv import pull as jpull
from repro.kernels.spmv import spmv as jspmv
from repro_torch import kernels
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.bitpack import ref as bp_ref
from repro_torch.kernels.popcount import ops as pc_ops
from repro_torch.kernels.popcount import ref as pc_ref
from repro_torch.kernels.spmv import ops as sp_ops
from repro_torch.kernels.spmv import ref as sp_ref


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))


def _values(rng, shape, b):
    return rng.integers(0, 2**b, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("b", bp_ref.B_CLASSES)
@pytest.mark.parametrize("n", [1024, 4096, 12288])
def test_pack_matches_jax(b, n):
    rng = np.random.default_rng(31 * b + n)
    vals = _values(rng, n, b)
    expect = np.asarray(jbp_ref.pack(jnp.asarray(vals), b))
    np.testing.assert_array_equal(_u32(bp_ops.pack(_i32(vals), b)), expect)
    if n % jbitpack.VALS_PER_BLOCK == 0:
        pallas = jbitpack.pack_pallas(jnp.asarray(vals), b, interpret=True)
        np.testing.assert_array_equal(np.asarray(pallas), expect)


@pytest.mark.parametrize("b", bp_ref.B_CLASSES)
def test_pack_planes_matches_jax(b):
    rng = np.random.default_rng(b)
    vals = _values(rng, (3, 2048), b)
    expect = np.asarray(jbp_ops.pack_planes(jnp.asarray(vals), b))
    np.testing.assert_array_equal(_u32(bp_ops.pack_planes(_i32(vals), b)), expect)


def _offset_copy(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of ``t`` starting ``elems`` elements into its storage."""
    buf = torch.zeros(t.numel() + elems, dtype=t.dtype)
    buf[elems:] = t.reshape(-1)
    return buf[elems:].view(t.shape)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 1000, 1025, 2055, 4096, 4111, 5000])
def test_pack_planes_ragged_bool_is_zero_padded_pack(n, offset):
    """Ragged bool planes pack as the reference packs their zero-padded
    uint32 copy (expand.py:72-76), which the port never materializes; n
    takes 0, 1, 7, 8 and 15 (mod 16), and ``offset`` hands the planes over
    as a view one element into its storage."""
    rng = np.random.default_rng(n)
    bits = rng.random((4, n)) < 0.4
    padded = np.zeros((4, n + (-n) % 1024), np.uint32)
    padded[:, :n] = bits
    expect = np.asarray(jbp_ops.pack_planes(jnp.asarray(padded), 1))
    for planes in (torch.from_numpy(bits), torch.from_numpy(bits.astype(np.uint8))):
        planes = _offset_copy(planes, offset)
        assert planes.storage_offset() == offset and planes.is_contiguous()
        np.testing.assert_array_equal(_u32(bp_ops.pack_planes(planes, 1)), expect)


@pytest.mark.parametrize("byte", [2, 3, 128, 255])
def test_pack_planes_nonzero_byte_is_member(byte):
    """At b=1 a uint8 plane packs as membership, as the kernel packs it: a
    nonzero byte is a 1, the same words JAX packs from the 0/1 planes."""
    rng = np.random.default_rng(byte)
    bits = rng.random((3, 2055)) < 0.4
    padded = np.zeros((3, 3072), np.uint32)
    padded[:, :2055] = bits
    expect = np.asarray(jbp_ops.pack_planes(jnp.asarray(padded), 1))
    planes = torch.from_numpy(bits.astype(np.uint8) * np.uint8(byte))
    np.testing.assert_array_equal(_u32(bp_ops.pack_planes(planes, 1)), expect)


@pytest.mark.parametrize("dtype,n,offset,vec", [
    # pack over bool / uint8 planes: each plane 16-byte aligned iff n % 16 == 0
    (torch.bool, 4096, 0, 1), (torch.bool, 4112, 0, 1), (torch.bool, 4097, 0, 0),
    (torch.bool, 4104, 0, 0), (torch.bool, 4111, 0, 0), (torch.bool, 4096, 1, 0),
    (torch.uint8, 16, 0, 1), (torch.uint8, 15, 0, 0), (torch.uint8, 1024, 16, 1),
    (torch.uint8, 1024, 8, 0),
    # pack over int32 values and popcount over int32 words: n or w % 4 == 0
    (torch.int32, 1024, 0, 1), (torch.int32, 1028, 0, 1), (torch.int32, 1022, 0, 0),
    (torch.int32, 1023, 0, 0), (torch.int32, 1024, 1, 0), (torch.int32, 1024, 4, 1),
    (torch.int32, 0, 0, 1), (torch.int32, 7, 0, 0),
])
def test_vec_rows_picks_the_route(dtype, n, offset, vec):
    """The route helper of the pack and popcount_planes wrappers (and the
    ELL slab): 16-byte vector loads only when every row starts 16-byte
    aligned, scalar loads otherwise."""
    t = _offset_copy(torch.zeros((3, n), dtype=dtype), offset)
    assert t.data_ptr() % 16 == (offset * t.element_size()) % 16  # CPU storage is aligned
    assert kernels.vec_rows(t) == vec


@pytest.mark.parametrize("w", [1024, 2048, 1500, 7])
def test_popcount_planes_matches_jax(w):
    rng = np.random.default_rng(w)
    words = rng.integers(0, 2**32, size=(5, w), dtype=np.uint64).astype(np.uint32)
    expect = np.asarray(jpc_ops.popcount_planes(jnp.asarray(words)))
    got = pc_ops.popcount_planes(_i32(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    if w % jpopcount.WORDS_PER_BLOCK == 0:
        pallas = jpopcount.popcount_planes_pallas(jnp.asarray(words), interpret=True)
        np.testing.assert_array_equal(np.asarray(pallas).sum(axis=1), expect)
    np.testing.assert_array_equal(
        pc_ops.popcount_words(_i32(words)).numpy(),
        np.asarray(jpc_ref.popcount_words(jnp.asarray(words))),
    )


def _spmv_inputs(rng, n_rows, k, n_real, planes, density=0.2, unreached=0.5):
    nbr = rng.integers(0, n_real, size=(n_rows, k)).astype(np.int32)
    nbr[rng.random((n_rows, k)) < 0.3] = n_real  # pad slots hold the sentinel
    f_bits = np.zeros((planes, n_real + (-n_real) % 1024), np.uint32)
    f_bits[:, :n_real] = rng.random((planes, n_real)) < density
    u_bits = np.zeros((planes, n_rows + (-n_rows) % 1024), np.uint32)
    u_bits[:, :n_rows] = rng.random((planes, n_rows)) < unreached
    f = np.asarray(jbp_ops.pack_planes(jnp.asarray(f_bits), 1))
    u = np.asarray(jbp_ops.pack_planes(jnp.asarray(u_bits), 1))
    return nbr, f, u, f_bits.shape[1]


@pytest.mark.parametrize("n_rows,k,planes", [(1024, 8, 3), (2048, 16, 2)])
def test_spmv_aligned_matches_pallas(n_rows, k, planes):
    rng = np.random.default_rng(n_rows + k)
    nbr, f, u, n_cols = _spmv_inputs(rng, n_rows, k, 4096, planes)
    push = np.asarray(jspmv.spmv_min_planes_pallas(
        jnp.asarray(nbr), jnp.asarray(f), n_cols, interpret=True))
    pull = np.asarray(jpull.spmv_pull_min_planes_pallas(
        jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(u), n_cols, interpret=True))
    t_nbr, t_f, t_u = torch.from_numpy(nbr), _i32(f), _i32(u)
    np.testing.assert_array_equal(sp_ops.spmv_min_planes(t_nbr, t_f, n_cols).numpy(), push)
    np.testing.assert_array_equal(
        sp_ops.spmv_pull_min_planes(t_nbr, t_f, t_u, n_cols).numpy(), pull)


@pytest.mark.parametrize("n_rows,k,n_real,planes", [(1500, 13, 4500, 3), (77, 1, 100, 9),
                                                    (3001, 5, 2048, 1)])
def test_spmv_ragged_matches_jax_ops(n_rows, k, n_real, planes):
    rng = np.random.default_rng(n_rows * k)
    nbr, f, u, n_cols = _spmv_inputs(rng, n_rows, k, n_real, planes)
    push = np.asarray(jsp_ops.spmv_min_planes(jnp.asarray(nbr), jnp.asarray(f), n_cols))
    pull = np.asarray(jsp_ops.spmv_pull_min_planes(
        jnp.asarray(nbr), jnp.asarray(f), jnp.asarray(u), n_cols))
    t_nbr, t_f, t_u = torch.from_numpy(nbr), _i32(f), _i32(u)
    np.testing.assert_array_equal(sp_ops.spmv_min_planes(t_nbr, t_f, n_cols).numpy(), push)
    np.testing.assert_array_equal(
        sp_ops.spmv_pull_min_planes(t_nbr, t_f, t_u, n_cols).numpy(), pull)


def test_frontier_bit_matches_jax():
    from repro.kernels.spmv import ref as jsp_ref

    rng = np.random.default_rng(3)
    bits = np.zeros(3072, np.uint32)
    bits[rng.choice(3072, 700, replace=False)] = 1
    words = np.asarray(jbp_ref.pack(jnp.asarray(bits), 1))
    idx = rng.integers(0, 3500, size=(40, 7)).astype(np.int32)
    expect = np.asarray(jsp_ref.frontier_bit(jnp.asarray(words), jnp.asarray(idx), 3072))
    got = sp_ref.frontier_bit(_i32(words), torch.from_numpy(idx), 3072)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("planes", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("n_real", [1000, 5000])
def test_frontier_mask_matches_jax_bitmap(planes, n_real):
    """The plain frontier mask (what the ELL kernels probe on the card) holds
    plane 8g + q's bit c at bit q of byte [g, c], as the JAX package reads
    its packed frontier (``frontier_bit``), across mask-byte boundaries and
    ragged column counts (bits past n_real clear)."""
    from repro.kernels.spmv import ref as jsp_ref

    rng = np.random.default_rng(planes * 7919 + n_real)
    n_cols = n_real + (-n_real) % 1024
    bits = np.zeros((planes, n_cols), np.uint32)
    bits[:, :n_real] = rng.random((planes, n_real)) < 0.3
    words = np.asarray(jbp_ops.pack_planes(jnp.asarray(bits), 1))
    mask = sp_ops.frontier_mask(_i32(words)).numpy()
    assert mask.shape == (-(-planes // 8), n_cols) and mask.dtype == np.uint8
    cols = jnp.arange(n_cols, dtype=jnp.int32)
    for p in range(planes):
        want = np.asarray(jsp_ref.frontier_bit(jnp.asarray(words[p]), cols, n_real))
        np.testing.assert_array_equal((mask[p // 8] >> (p % 8)) & 1, want.astype(np.uint8))
    if planes % 8:  # the last byte's unused bits stay clear
        assert not (mask[-1] >> (planes % 8)).any()


@pytest.mark.parametrize("planes", [1, 7, 8, 9, 16])
@pytest.mark.parametrize("n_x,n_cols", [(4096, 4096), (1001, 1024), (5000, 4096)])
def test_interleave_values_all_set_is_the_transpose(planes, n_x, n_cols):
    """At an all-set mask the plain interleave is the plane transpose
    ``x.view(g, 8, n_x).transpose(1, 2)`` of x padded to 8g planes with INF
    (the PyTorch call chip_smoke.py times beside the kernel), over every
    column the mask covers; columns past n_cols have no byte and read INF."""
    rng = np.random.default_rng(planes * 31 + n_x)
    x = torch.from_numpy(rng.integers(0, sp_ref.INF, size=(planes, n_x)).astype(np.int32))
    groups = -(-planes // 8)
    full = torch.full((groups, n_cols), 0xFF, dtype=torch.uint8)
    padded = torch.nn.functional.pad(x, (0, 0, 0, 8 * groups - planes), value=sp_ref.INF)
    want = padded.view(groups, 8, n_x).transpose(1, 2)
    got = sp_ops.interleave_values(x, full)
    assert got.shape == (groups, n_x, 8) and got.dtype == torch.int32
    cover = min(n_x, n_cols)
    assert torch.equal(got[:, :cover], want[:, :cover])
    assert bool((got[:, cover:] == sp_ref.INF).all())


@pytest.mark.parametrize("i", range(len(chip_smoke.SPMV_CASES)),
                         ids=[c[0] for c in chip_smoke.SPMV_CASES])
def test_spmv_cases_match_jax(i):
    """The SpMV wrappers' plain versions against JAX's ops on the inputs the
    smoke script holds the CUDA kernels to (``chip_smoke.SPMV_CASES``: 1 to
    17 planes, K from 1 to 64, unsorted and all-sentinel rows, empty and
    full frontiers, every row reached, slabs as offset views): push, pull,
    and the value gather for both ops with nonzero bases, push and pull."""
    from repro.core import algebra as jalgebra
    from repro_torch.core import algebra

    case = chip_smoke.spmv_case(i)
    nbr, f, u, x, n_cols = chip_smoke.spmv_case_tensors(case, "cpu")
    j_nbr, j_f, j_u, j_x = (jnp.asarray(a) for a in (case["nbr"], _u32(f), _u32(u), case["x"]))
    np.testing.assert_array_equal(sp_ops.spmv_min_planes(nbr, f, n_cols).numpy(),
                                  np.asarray(jsp_ops.spmv_min_planes(j_nbr, j_f, n_cols)))
    np.testing.assert_array_equal(
        sp_ops.spmv_pull_min_planes(nbr, f, u, n_cols).numpy(),
        np.asarray(jsp_ops.spmv_pull_min_planes(j_nbr, j_f, j_u, n_cols)))
    # x has n_x < n_cols columns: the kernel's semantics read INF past n_x,
    # as the reference's kernel path pads (its plain path would clamp)
    j_x = jnp.pad(j_x, ((0, 0), (0, n_cols - x.shape[1])), constant_values=chip_smoke.INF)
    base = chip_smoke.SPMV_BASES[1]
    mw = chip_smoke.SPMV_MAX_WEIGHT
    for alg, jalg in ((algebra.SsspAlgebra(max_weight=mw), jalgebra.SsspAlgebra(max_weight=mw)),
                      (algebra.CcAlgebra(), jalgebra.CcAlgebra())):
        for uw, j_uw in ((None, None), (u, j_u)):
            want = jsp_ops.gspmm_planes(j_nbr, j_f, j_x, n_cols, jalg, row_base=base[0],
                                        col_base=base[1], u_words=j_uw)
            got = sp_ops.gspmm_planes(nbr, f, x, n_cols, alg, row_base=base[0],
                                      col_base=base[1], u_words=uw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for tensors all on the CPU or
    all on meta; anything else that is not one CUDA device raises instead
    of running it."""
    meta = torch.zeros((1, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        sp_ops.spmv_min_planes(torch.zeros((4, 2), dtype=torch.int32), meta, 1024)
    with pytest.raises(ValueError):
        sp_ops.spmv_pull_min_planes(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                                    torch.zeros((1, 32), dtype=torch.int32), meta, 1024)
    with pytest.raises(ValueError):
        bp_ops.pack_planes(torch.zeros((1, 8), dtype=torch.int32), 3)
    assert kernels.on_cuda(torch.zeros(1)) is False


@pytest.mark.parametrize("other", ["mps", "xpu", "hpu"])
def test_meta_route_takes_the_plain_version(other):
    """``quantize`` (and the other wrappers) on meta tensors return the
    plain version's outputs on meta; a mix of meta and CPU tensors raises,
    and so does a tensor on any other device."""
    from repro_torch.kernels.quant import ops as q_ops
    from repro_torch.kernels.quant import ref as q_ref

    x = torch.empty(3 * 128, dtype=torch.float32, device="meta")
    q, scales = q_ops.quantize(x)
    want_q, want_s = q_ref.quantize(torch.zeros(3 * 128))
    for got, want in ((q, want_q), (scales, want_s)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    words = bp_ops.pack_planes(torch.empty((2, 1024), dtype=torch.bool, device="meta"), 1)
    assert words.device.type == "meta" and words.shape == (2, 32)
    counts = pc_ops.popcount_planes(words)
    assert counts.device.type == "meta" and counts.shape == (2,)
    assert kernels.on_cuda(x, words) is False
    with pytest.raises(ValueError):
        kernels.on_cuda(x, torch.zeros(1))
    with pytest.raises(ValueError):
        kernels.on_cuda(types.SimpleNamespace(device=torch.device(other)))
    with pytest.raises(ValueError):
        kernels.on_cuda(types.SimpleNamespace(device=torch.device(other)), torch.zeros(1))


@pytest.mark.parametrize("b", bp_ref.B_CLASSES)
@pytest.mark.parametrize("n", [1024, 4096, 12288])
def test_unpack_matches_jax_bit_for_bit(b, n):
    """unpack / unpack_planes equal the JAX oracle and the Pallas kernel
    in interpret mode, and invert pack; b=1 gives bool planes."""
    rng = np.random.default_rng(7 * b + n)
    words = np.asarray(jbp_ref.pack(jnp.asarray(_values(rng, n, b)), b))
    expect = np.asarray(jbp_ref.unpack(jnp.asarray(words), b))
    got = bp_ops.unpack(_i32(words), b)
    assert got.dtype == (torch.bool if b == 1 else torch.int32)
    np.testing.assert_array_equal(got.numpy().astype(np.int64) & 0xFFFFFFFF,
                                  expect.astype(np.int64))
    if n % jbitpack.VALS_PER_BLOCK == 0:
        pallas = jbitpack.unpack_pallas(jnp.asarray(words), b, interpret=True)
        np.testing.assert_array_equal(np.asarray(pallas), expect)
    planes = np.stack([words, words[::-1]])
    expect_p = np.asarray(jbp_ops.unpack_planes(jnp.asarray(planes), b))
    got_p = bp_ops.unpack_planes(_i32(planes), b).numpy().astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(got_p, expect_p.astype(np.int64))
    np.testing.assert_array_equal(_u32(bp_ops.pack_planes(bp_ops.unpack_planes(
        _i32(planes), b).to(torch.int32), b)), planes)


@pytest.mark.parametrize("n,capacity,density", [(5000, 64, 0.05), (5000, 8192, 0.3),
                                                (2048, 2048, 1.0), (3000, 128, 0.0)])
def test_compact_ids_and_gap_coding_match_jax(n, capacity, density):
    """Fixed-capacity compaction: ids past ``capacity`` are dropped and
    padding takes ``fill``, while ``count`` stays the full popcount (the
    first case has count > capacity); the gap coding round-trips."""
    from repro.kernels.bitpack import ops as jops

    rng = np.random.default_rng(n + capacity)
    bits = rng.random((3, n)) < density
    fill = n + 5
    for k in range(3):
        j_ids, j_count = jops.compact_ids(jnp.asarray(bits[k]), capacity, fill=fill)
        ids, count = bp_ops.compact_ids(torch.from_numpy(bits[k]), capacity, fill=fill)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        assert int(count) == int(j_count) == int(bits[k].sum())
        j_gaps = jbp_ref.gaps_from_sorted(j_ids, j_count)
        gaps = bp_ops.gaps_from_sorted(ids, count)
        np.testing.assert_array_equal(gaps.numpy(), np.asarray(j_gaps).astype(np.int64))
        back = bp_ops.sorted_from_gaps(gaps, count, fill)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jbp_ref.sorted_from_gaps(j_gaps, j_count, fill)))
    ids, counts = bp_ops.compact_ids(torch.from_numpy(bits), capacity, fill=fill)
    for k in range(3):  # the batched form is the per-row form
        one, cnt = bp_ops.compact_ids(torch.from_numpy(bits[k]), capacity, fill=fill)
        assert torch.equal(ids[k], one) and int(counts[k]) == int(cnt)


@pytest.mark.parametrize("w", [1024, 3072, 1500, 7])
def test_popcount_blocks_matches_jax(w):
    rng = np.random.default_rng(w + 1)
    words = rng.integers(0, 2**32, size=w, dtype=np.uint64).astype(np.uint32)
    expect = np.asarray(jpc_ops.popcount_blocks(jnp.asarray(words)))
    got = pc_ops.popcount_blocks(_i32(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    if w % jpopcount.WORDS_PER_BLOCK == 0:
        pallas = jpopcount.popcount_blocks_pallas(jnp.asarray(words), interpret=True)
        np.testing.assert_array_equal(np.asarray(pallas), expect)


@pytest.mark.parametrize("n_rows,k,n_real", [(1024, 8, 4096), (1500, 13, 4500)])
def test_single_plane_spmv_matches_jax(n_rows, k, n_real):
    """spmv_min / spmv_pull_min: the single-plane entries equal JAX's ops
    (and the Pallas kernels in interpret mode where the rows are aligned)."""
    rng = np.random.default_rng(n_rows + 3 * k)
    nbr, f, u, n_cols = _spmv_inputs(rng, n_rows, k, n_real, 1)
    f1, u1 = f[0], u[0]
    push = np.asarray(jsp_ops.spmv_min(jnp.asarray(nbr), jnp.asarray(f1), n_cols))
    pull = np.asarray(jsp_ops.spmv_pull_min(jnp.asarray(nbr), jnp.asarray(f1),
                                            jnp.asarray(u1), n_cols))
    if n_rows % 1024 == 0:
        np.testing.assert_array_equal(np.asarray(jspmv.spmv_min_pallas(
            jnp.asarray(nbr), jnp.asarray(f1), n_cols, interpret=True)), push)
        np.testing.assert_array_equal(np.asarray(jpull.spmv_pull_min_pallas(
            jnp.asarray(nbr), jnp.asarray(f1), jnp.asarray(u1), n_cols, interpret=True)),
            pull)
    t_nbr = torch.from_numpy(nbr)
    np.testing.assert_array_equal(sp_ops.spmv_min(t_nbr, _i32(f1), n_cols).numpy(), push)
    np.testing.assert_array_equal(
        sp_ops.spmv_pull_min(t_nbr, _i32(f1), _i32(u1), n_cols).numpy(), pull)
