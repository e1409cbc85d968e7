"""The port's registry API and id-stream helpers against the JAX package.

The registration API (``register_*``, ``available_*`` and the lookups
``wire_plan``, ``traversal``, ``algebra``, ``expansion``) over the port's
name tables: the same names, the same errors with the same messages, and a
policy, backend and algebra registered under new names usable by name in
``bfs``, with the same values as JAX's ``bfs`` given the same registrations.
The bit-pack id-stream helpers (``pack_sorted_ids``, ``unpack_sorted_ids``,
``compressed_words``, ``compact_ids``, ``required_width_class``),
``popcount_total`` and ``ell_from_coo`` bit for bit against JAX on the same
numpy inputs, at the shapes of the reference's own tests
(``tests/test_kernels.py``, ``tests/test_spmv_kernel.py``) and wider.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import registry as jregistry
from repro.core import algebra as jalgebra
from repro.core import bfs as jbfs
from repro.core import expand as jexpand
from repro.core import traversal as jtraversal
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro.kernels.bitpack import ops as jbp_ops
from repro.kernels.bitpack import ref as jbp_ref
from repro.kernels.popcount import ops as jpc_ops
from repro.kernels.popcount import ref as jpc_ref
from repro.kernels.spmv import ref as jsp_ref
from repro_torch.comm import registry
from repro_torch.core import algebra, bfs, expand, traversal
from repro_torch.graphgen import builder
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.bitpack import ref as bp_ref
from repro_torch.kernels.popcount import ops as pc_ops
from repro_torch.kernels.popcount import ref as pc_ref
from repro_torch.kernels.spmv import ref as sp_ref

AXES = ("wire_plans", "traversals", "algebras", "expansions")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", AXES)
def test_available_names_equal_reference(axis):
    assert getattr(registry, f"available_{axis}")() == getattr(jregistry, f"available_{axis}")()


@pytest.mark.parametrize("lookup", ["wire_plan", "traversal", "algebra", "expansion"])
def test_unknown_name_raises_as_reference(lookup):
    with pytest.raises(KeyError) as ours:
        getattr(registry, lookup)("nope")
    with pytest.raises(KeyError) as ref:
        getattr(jregistry, lookup)("nope")
    assert str(ours.value) == str(ref.value)
    # the port's resolvers refuse a bad argument with ValueError too
    assert isinstance(ours.value, ValueError)


def test_resolvers_raise_the_registry_error():
    for resolve, name in ((traversal.resolve, "sideways"), (expand.resolve, "csr"),
                          (algebra.resolve, "betweenness")):
        with pytest.raises(KeyError, match=f"unknown .* '{name}'; known: "):
            resolve(name)


@pytest.mark.parametrize("axis", ["wire_plan", "traversal", "algebra", "expansion"])
def test_duplicate_registration_raises_as_reference(axis):
    ours_obj, ref_obj = {
        "wire_plan": (registry.wire_plan("auto"), jregistry.wire_plan("auto")),
        "traversal": (traversal.resolve("top_down"), jtraversal.resolve("top_down")),
        "algebra": (algebra.resolve("sssp"), jalgebra.resolve("sssp")),
        "expansion": (expand.resolve("coo"), jexpand.resolve("coo")),
    }[axis]
    with pytest.raises(ValueError) as ours:
        getattr(registry, f"register_{axis}")(ours_obj)
    with pytest.raises(ValueError) as ref:
        getattr(jregistry, f"register_{axis}")(ref_obj)
    assert str(ours.value) == str(ref.value)


def _registered(mod_traversal, mod_expand, mod_algebra):
    """A top-down policy, a COO backend and an SSSP algebra (delta 7) under
    new names."""

    class Td(mod_traversal.TopDownPolicy):
        name = "top_down_again"

    class Coo(mod_expand.CooExpansion):
        name = "coo_again"

    # the reference's algebras carry their name as a dataclass field
    sssp = mod_algebra.SsspAlgebra(delta=7)
    if "name" in {f.name for f in dataclasses.fields(sssp)}:
        sssp = dataclasses.replace(sssp, name="sssp_delta7")
    else:
        sssp = type("Sssp", (mod_algebra.SsspAlgebra,), {"name": "sssp_delta7"})(delta=7)
    return Td(), Coo(), sssp


def test_registered_axes_usable_by_name_in_bfs():
    g = builder.build_csr(jkronecker.kronecker_edges(10, seed=1), n=1 << 10)
    jg = jbuilder.build_csr(jkronecker.kronecker_edges(10, seed=1), n=1 << 10)
    roots = np.asarray([3, 17, 100], np.int32)
    ours = _registered(traversal, expand, algebra)
    refs = _registered(jtraversal, jexpand, jalgebra)
    tables = (traversal.POLICIES, expand.BACKENDS, algebra.ALGEBRAS)
    jtables = (jregistry._TRAVERSALS, jregistry._EXPANSIONS, jregistry._ALGEBRAS)
    try:
        for reg, obj in zip(("traversal", "expansion", "algebra"), ours):
            getattr(registry, f"register_{reg}")(obj)
        for reg, obj in zip(("traversal", "expansion", "algebra"), refs):
            getattr(jregistry, f"register_{reg}")(obj)
        assert registry.traversal("top_down_again") is ours[0]
        assert registry.expansion("coo_again") is ours[1]
        assert "sssp_delta7" in registry.available_algebras()
        got = bfs.bfs(g.src, g.dst, roots, g.n, policy="top_down_again", expand="coo_again",
                      algebra="sssp_delta7", device="cpu", max_levels=256)
        want = bfs.bfs(g.src, g.dst, roots, g.n, policy="top_down", expand="coo",
                       algebra=algebra.SsspAlgebra(delta=7), device="cpu", max_levels=256)
        ref = jbfs.bfs(jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.asarray(roots), jg.n,
                       policy="top_down_again", expand="coo_again", algebra="sssp_delta7",
                       max_levels=256)
    finally:
        for table, obj in zip(tables + jtables, ours + refs):
            table.pop(obj.name, None)
    for res in (got, want):
        np.testing.assert_array_equal(res.parent.numpy(), np.asarray(ref.parent))
        np.testing.assert_array_equal(res.level.numpy(), np.asarray(ref.level))
        assert res.n_levels == int(ref.n_levels)
    assert "top_down_again" not in registry.available_traversals()


# ---------------------------------------------------------------------------
# the id-stream helpers
# ---------------------------------------------------------------------------


def _sorted_stream(b: int, count: int, cap: int, seed: int) -> np.ndarray:
    """A (cap,) id stream whose first ``count`` gaps fit ``b`` bits (as the
    reference's round-trip test draws them), zeros after."""
    rng = np.random.default_rng(seed)
    max_gap = (1 << b) - 1 if b < 32 else (1 << 20)
    gaps = rng.integers(0, max(max_gap, 1) + 1, size=count)
    padded = np.zeros(cap, np.int32)
    padded[:count] = np.cumsum(gaps).astype(np.int32)
    return padded


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32) if np.asarray(x).dtype == np.int32 else np.asarray(x)


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("count,cap", [(0, 4096), (1, 4096), (1024, 4096), (2500, 4096),
                                       (4096, 4096), (65536, 65536)])
def test_sorted_id_streams_equal_reference(b, count, cap):
    padded = _sorted_stream(b, count, cap, seed=b * 7 + count)
    t_ids = torch.from_numpy(padded)
    j_ids = jnp.asarray(padded)
    j_words = np.asarray(jbp_ops.pack_sorted_ids(j_ids, jnp.int32(count), b))
    for mod in (bp_ops, bp_ref):
        words = mod.pack_sorted_ids(t_ids, count, b)
        assert words.dtype == torch.int32 and words.shape == (cap * b // 32,)
        np.testing.assert_array_equal(_u32(words.numpy()), j_words)
    np.testing.assert_array_equal(
        _u32(bp_ref.pack_sorted_ids(t_ids, torch.tensor(count), b).numpy()),
        np.asarray(jbp_ref.pack_sorted_ids(j_ids, jnp.int32(count), b)))
    words = torch.from_numpy(j_words.view(np.int32).copy())
    j_back = np.asarray(jbp_ops.unpack_sorted_ids(jnp.asarray(j_words), jnp.int32(count), b,
                                                  fill=-1))
    for mod in (bp_ops, bp_ref):
        back = mod.unpack_sorted_ids(words, count, b, fill=-1)
        assert back.dtype == torch.int32
        np.testing.assert_array_equal(back.numpy(), j_back)
    np.testing.assert_array_equal(j_back[:count], padded[:count])
    assert (j_back[count:] == -1).all()


def test_compressed_words_equal_reference():
    for cap in (1024, 4096, 65536):
        for b in bp_ref.B_CLASSES:
            assert bp_ops.compressed_words(cap, b) == jbp_ops.compressed_words(cap, b)
    for mod in (bp_ops, jbp_ops):
        with pytest.raises(AssertionError):
            mod.compressed_words(1000, 16)


def test_required_width_class_equals_reference():
    # the reference test's cases, then each class's extremes and random gaps
    cases = [np.array([0, 1, 3], np.uint32), np.array([0, 300], np.uint32)]
    rng = np.random.default_rng(0)
    for b in bp_ref.B_CLASSES:
        top = (1 << b) - 1
        cases += [np.array([top], np.uint32), np.array([0, top // 2 + 1], np.uint32),
                  rng.integers(0, top + 1, 100, dtype=np.uint64).astype(np.uint32)]
    cases.append(np.zeros(5, np.uint32))
    for gaps in cases:
        want = int(jbp_ref.required_width_class(jnp.asarray(gaps)))
        for t in (torch.from_numpy(gaps.astype(np.int64)), torch.from_numpy(gaps.view(np.int32))):
            got = bp_ref.required_width_class(t)
            assert got.dtype == torch.int32 and got.dim() == 0 and int(got) == want, gaps


@pytest.mark.parametrize("n,capacity,density", [(8, 8, None), (4096, 4096, 0.1),
                                                (4096, 512, 0.5), (5000, 1024, 0.01),
                                                (1024, 1024, 1.0), (1024, 64, 0.0)])
def test_compact_ids_equal_reference(n, capacity, density):
    if density is None:  # the reference test's mask
        mask = np.array([0, 1, 1, 0, 1, 0, 0, 1], bool)
    else:
        mask = np.random.default_rng(n + capacity).random(n) < density
    ids, count = bp_ops.compact_ids(torch.from_numpy(mask), capacity, fill=capacity)
    j_ids, j_count = jbp_ops.compact_ids(jnp.asarray(mask), capacity, fill=capacity)
    assert ids.dtype == torch.int32 and count.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert int(count) == int(j_count)


@pytest.mark.parametrize("shape", [(1,), (1000,), (3, 4096), (7, 33)])
def test_popcount_total_equals_reference(shape):
    words = np.random.default_rng(len(shape)).integers(0, 1 << 32, shape, dtype=np.uint64)
    words = words.astype(np.uint32)
    want = jpc_ref.popcount_total(jnp.asarray(words))
    assert int(jpc_ops.popcount_total(jnp.asarray(words))) == int(want)
    for fn in (pc_ref.popcount_total, pc_ops.popcount_total):
        got = fn(torch.from_numpy(words.view(np.int32)))
        assert got.dtype == torch.int32 and got.dim() == 0 and int(got) == int(want)


@pytest.mark.parametrize("seed", range(6))
def test_ell_from_coo_equals_reference(seed):
    """At ``test_spmv_matches_segment_min_formulation``'s shapes (1,024 rows,
    2,048 columns, up to 4,000 edges, max_deg a multiple of 8 covering the
    densest row), then with rows cut below the densest and out-of-range
    destinations."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 1024, 2048
    m = int(rng.integers(1, 4000))
    src = rng.integers(0, n_cols, m).astype(np.int32)
    dst = rng.integers(0, n_rows, m).astype(np.int32)
    deg = np.bincount(dst, minlength=n_rows).max()
    full = max(int(-(-deg // 8) * 8), 8)
    wide = rng.integers(0, n_rows + 3, m).astype(np.int32)
    for d, max_deg in ((dst, full), (dst, 2), (wide, 4)):
        want = np.asarray(jsp_ref.ell_from_coo(jnp.asarray(src), jnp.asarray(d), n_rows, n_cols,
                                               max_deg))
        got = sp_ref.ell_from_coo(torch.from_numpy(src), torch.from_numpy(d), n_rows, n_cols,
                                  max_deg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
