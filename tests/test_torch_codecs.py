"""The port's codec study against the reference: the host codecs and their
factory (``repro_torch.comm.{codecs,registry}``), the Zipf streams
(``repro_torch.graphgen.zipf``), the density oracle's ``local_count`` and
the two study harnesses (``repro_torch.bench.{frontier_stats,codecs}``)
against ``repro.comm``, ``repro.graphgen.zipf``,
``repro.core.traversal.DensityOracle`` and ``benchmarks.{frontier_stats,
codecs}``.  Inputs come from fixed numpy seeds and cross as numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import codecs as jbench_codecs
from benchmarks import frontier_stats as jbench_frontier
from repro.comm import codecs as jcodecs
from repro.comm import registry as jregistry
from repro.core import traversal as jtraversal
from repro.graphgen import zipf as jzipf
from repro_torch.bench import codecs as bench_codecs
from repro_torch.bench import frontier_stats as bench_frontier
from repro_torch.comm import codecs, registry
from repro_torch.core import traversal
from repro_torch.graphgen import zipf

SCALE = 10  # the harnesses' scale here, on the CPU
N_ZIPF = 20_000  # the Zipf draws of the harness comparison
STREAM_NAMES = ("sorted_ids", "unsorted", "zipf_index", "frontier_l3")
CODECS = ("bitmap", "bp128", "bp128d", "copy", "pfor", "pfor-delta", "vbyte", "vbyte-delta")
CASES = [(c, s) for c in CODECS for s in STREAM_NAMES
         if not (c == "bitmap" and s == "unsorted")]  # a bitmap codes sorted sets


@pytest.fixture(scope="module")
def streams() -> dict:
    """The four streams: sorted unique ids, an unsorted stream, the sorted
    Zipf index stream and the level-3 frontier of the scale-10 BFS."""
    rng = np.random.default_rng(7)
    return {
        "sorted_ids": jzipf.sorted_id_stream(5000, 1 << 20, seed=3),
        "unsorted": rng.integers(0, 1 << 31, size=3001, dtype=np.int64).astype(np.uint32),
        "zipf_index": np.sort(np.unique(jzipf.zipf_stream(50_000, alpha=1.2, seed=0)))
        .astype(np.uint32),
        "frontier_l3": jbench_codecs.extract_frontier_stream(scale=SCALE, level=3),
    }


@pytest.mark.parametrize("codec,stream", CASES)
def test_codec_bytes_match_and_round_trip(streams, codec, stream):
    values = streams[stream]
    assert values.size > 100, stream
    blob = registry.make_codec(codec).encode(values)
    assert blob == jregistry.make_codec(codec).encode(values)
    back = registry.make_codec(codec).decode(blob, values.size)
    assert back.dtype == np.uint32 and np.array_equal(back, values)


def test_codec_factory_matches():
    assert registry.available_codecs() == jregistry.available_codecs() == list(CODECS)
    for name in registry.available_codecs():
        mine, ref = registry.make_codec(name), jregistry.make_codec(name)
        assert (mine.name, mine.is_sorted_input) == (ref.name, ref.is_sorted_input)
    for reg in (registry, jregistry):
        with pytest.raises(KeyError, match="unknown codec 'lz4'"):
            reg.make_codec("lz4")
        with pytest.raises(ValueError, match="already registered"):
            reg.register_codec("copy", reg.make_codec)


def test_codec_helpers_match():
    rng = np.random.default_rng(11)
    ids = np.sort(rng.choice(1 << 24, size=4000, replace=False)).astype(np.uint32)
    signed = rng.integers(-(1 << 30), 1 << 30, size=4000)
    for mine, ref, arg in ((codecs.delta_encode, jcodecs.delta_encode, ids),
                           (codecs.zigzag_encode, jcodecs.zigzag_encode, signed)):
        assert mine(arg).tobytes() == ref(arg).tobytes()
    gaps = codecs.delta_encode(ids)
    assert codecs.delta_decode(gaps).tobytes() == jcodecs.delta_decode(gaps).tobytes()
    zz = codecs.zigzag_encode(signed)
    assert np.array_equal(codecs.zigzag_decode(zz), signed)
    for b in (0, 1, 5, 13, 31, 32):
        vals = (rng.integers(0, 1 << 32, size=777, dtype=np.uint64)
                & np.uint64((1 << b) - 1)).astype(np.uint32)
        words = codecs.pack_bits(vals, b)
        assert words.tobytes() == jcodecs.pack_bits(vals, b).tobytes()
        assert np.array_equal(codecs.unpack_bits(words, b, vals.size), vals)


@pytest.mark.parametrize("kw", [dict(n=100_000, alpha=1.2, seed=0),
                                dict(n=5000, alpha=0.8, vocab=1 << 12, seed=4)])
def test_zipf_stream_byte_identical(kw):
    assert zipf.zipf_stream(**kw).tobytes() == jzipf.zipf_stream(**kw).tobytes()


@pytest.mark.parametrize("kw", [dict(n=5000, universe=1 << 20, seed=3),
                                dict(n=3000, universe=1 << 14, seed=1, skew=1.5),
                                dict(n=100, universe=64, seed=2)])
def test_sorted_id_stream_byte_identical(kw):
    assert zipf.sorted_id_stream(**kw).tobytes() == jzipf.sorted_id_stream(**kw).tobytes()


def test_empirical_entropy_bits_identical(streams):
    rng = np.random.default_rng(5)
    for values in (rng.integers(0, 300, size=10_000), np.zeros(10, np.uint32),
                   streams["zipf_index"], codecs.delta_encode(streams["frontier_l3"])):
        assert zipf.empirical_entropy_bits(values) == jzipf.empirical_entropy_bits(values)


@pytest.mark.parametrize("n", [3000, 33 * 1024])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_local_count_matches_jax(n, density):
    """The cases of the reference's own test (``tests/test_traversal.py``):
    n not a multiple of the 1024-bit chunk, and packed words not a multiple
    of the popcount kernel's 1024-word block."""
    bits = np.random.default_rng(int(density * 100) + n).random(n) < density
    got = traversal.DensityOracle(n).local_count(torch.from_numpy(bits))
    want = jtraversal.DensityOracle(n).local_count(jnp.asarray(bits))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want) == int(bits.sum())


def test_frontier_stats_run_matches_jax():
    got = bench_frontier.run(scale=SCALE, device="cpu")
    want = jbench_frontier.run(scale=SCALE)
    assert (got["scale"], got["n"], got["m"]) == (want["scale"], want["n"], want["m"])
    assert len(got["levels"]) == len(want["levels"]) > 2
    for a, b in zip(got["levels"], want["levels"]):
        assert a == b  # sizes and directions exactly, entropies and skewness bit for bit
    assert len(bench_frontier.rows(got)) == len(got["levels"]) + 1


def test_frontier_stats_profile_policies_agree():
    """Every policy and backend gives the profile of the reference's
    ``top_down`` + ``coo``, directions included (they come from the counts)."""
    from repro_torch.graphgen import builder, kronecker

    g = builder.build_csr(kronecker.kronecker_edges(SCALE, seed=1), n=1 << SCALE)
    base = bench_frontier.profile(g.src, g.dst, g.n, g.m, 17, device="cpu")
    for policy, expand in (("direction_opt", "hybrid"), ("bottom_up", "ell")):
        other = bench_frontier.profile(g.src, g.dst, g.n, g.m, 17, device="cpu",
                                       policy=policy, expand=expand)
        assert other == base


def test_codecs_run_matches_jax():
    got = bench_codecs.run(scale=SCALE, n_zipf=N_ZIPF, device="cpu")
    want = jbench_codecs.run(scale=SCALE, n_zipf=N_ZIPF)
    assert [(r["codec"], r["dataset"]) for r in got] == [(r["codec"], r["dataset"])
                                                           for r in want]
    for a, b in zip(got, want):
        if "ratio_pct" in b:  # the speeds are host times and are not compared
            assert (a["ratio_pct"], a["bits_per_int"]) == (b["ratio_pct"], b["bits_per_int"])
    assert bench_codecs.host_cpu()
    assert bench_codecs.csv_lines(got)[0].startswith("codec,dataset,ratio_pct")
