"""The port's equivariant layer, EGNN and NequIP, and the graph data
pipeline against the JAX package.

Irreps: every function of ``models/irreps.py`` against
``repro.models.irreps`` on the same inputs (fixed numpy seeds), within
``1e-6``; the product paths and ``rotate`` commute with a rotation.
Models: ``egnn_forward`` (features and coordinates) and ``nequip_forward``
at the smoke widths and at the published widths over the refinement-2
multimesh with padding edges (src = dst = n) appended, against JAX within
``1e-5`` of the output's peak (float32 sums in another order); both
models' rotation invariance (EGNN: and shift) and EGNN's coordinate
equivariance in the port, at the reference's bar (``tests/test_models.py``:
``atol = 1e-4``), also on the 2D grid.  Data: ``rmat_edges`` and every
function of ``data/graphs.py`` byte-identical to the reference's for fixed
seeds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as jgraphs
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro.models import gnn as jgnn
from repro.models import irreps as jir
from repro_torch.data import graphs
from repro_torch.graphgen import builder, kronecker
from repro_torch.models import gnn, gnn_dist, icosahedron
from repro_torch.models import irreps as ir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IRREPS_TOL = 1e-6
FP32_TOL = 1e-5
EQUIV_TOL = 1e-4  # tests/test_models.py's bar


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _rot(theta, axis):
    c, s = np.cos(theta), np.sin(theta)
    m = {2: [[c, -s, 0], [s, c, 0], [0, 0, 1]], 0: [[1, 0, 0], [0, c, -s], [0, s, c]]}[axis]
    return np.asarray(m, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _close(got, want, tol=IRREPS_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# irreps against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    return {"s": rng.normal(size=(7, 3)).astype(np.float32),
            "v": rng.normal(size=(7, 3, 3)).astype(np.float32),
            "v2": rng.normal(size=(7, 3, 3)).astype(np.float32),
            "t": rng.normal(size=(7, 3, 3, 3)).astype(np.float32),
            "t2": rng.normal(size=(7, 3, 3, 3)).astype(np.float32),
            "w": rng.normal(size=(3, 3, 3)).astype(np.float32),
            "g": rng.normal(size=(2, 7, 3)).astype(np.float32),
            "rhat": rng.normal(size=(11, 3)).astype(np.float32),
            "r": np.abs(rng.normal(size=13) * 3).astype(np.float32)}


def test_harmonics_and_traceless_sym_match_jax(feats):
    rhat = feats["rhat"] / np.linalg.norm(feats["rhat"], axis=1, keepdims=True)
    _close(ir.sph_l1(_t(rhat)), jir.sph_l1(jnp.asarray(rhat)))
    y2 = ir.sph_l2(_t(rhat))
    _close(y2, jir.sph_l2(jnp.asarray(rhat)))
    assert torch.allclose(y2.diagonal(dim1=-2, dim2=-1).sum(-1), torch.zeros(11), atol=1e-6)
    _close(ir.traceless_sym(_t(feats["t"])), jir.traceless_sym(jnp.asarray(feats["t"])))


@pytest.mark.parametrize("name,args", [
    ("p_vv_s", ("v", "v2")), ("p_vv_v", ("v", "v2")), ("p_vv_t", ("v", "v2")),
    ("p_tv_v", ("t", "v")), ("p_tt_s", ("t", "t2")), ("p_tt_t", ("t", "t2"))])
def test_product_paths_match_jax(feats, name, args):
    got = getattr(ir, name)(*(_t(feats[a]) for a in args))
    want = getattr(jir, name)(*(jnp.asarray(feats[a]) for a in args))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_linear_gate_rotate_and_map_match_jax(feats):
    x = ir.Irreps(_t(feats["s"]), _t(feats["v"]), _t(feats["t"]))
    jx = jir.Irreps(*(jnp.asarray(feats[k]) for k in ("s", "v", "t")))
    w = [_t(m) for m in feats["w"]]
    jw = [jnp.asarray(m) for m in feats["w"]]
    rot = _rot(0.9, 2) @ _rot(-0.4, 0)
    pairs = [(ir.linear(x, *w), jir.linear(jx, *jw)),
             (ir.gate(x, _t(feats["g"][0]), _t(feats["g"][1])),
              jir.gate(jx, jnp.asarray(feats["g"][0]), jnp.asarray(feats["g"][1]))),
             (ir.rotate(x, _t(rot)), jir.rotate(jx, jnp.asarray(rot))),
             (x.map(lambda a: 2 * a), jx.map(lambda a: 2 * a))]
    for got, want in pairs:
        for a, b in zip(got, want):
            _close(a, b)
    # a None member stays None
    half = ir.Irreps(x.s, None, None)
    assert ir.linear(half, *w).v is None and ir.gate(half, w[1], w[2]).t is None
    assert ir.rotate(half, _t(rot)).v is None and half.map(lambda a: a).t is None


def test_bessel_rbf_matches_jax(feats):
    r = np.concatenate([feats["r"], [0.0, 1e-6, 5.0, 7.5]]).astype(np.float32)
    got = ir.bessel_rbf(_t(r), 8, 5.0)
    want = jir.bessel_rbf(jnp.asarray(r), 8, 5.0)
    assert torch.isfinite(got).all() and not got[-1].any()  # past the cutoff
    _close(got, want)


def test_product_paths_and_rotate_are_equivariant(feats):
    """Rotating the inputs rotates each output by its own l: scalars stay,
    vectors turn by R, tensors by R . R^T; the cross product is a
    pseudovector, which a proper rotation turns as a vector."""
    rot = _t(_rot(0.9, 2) @ _rot(-0.4, 0))
    v, v2, t, t2 = (_t(feats[k]) for k in ("v", "v2", "t", "t2"))

    def rv(a):
        return ir.rotate(ir.Irreps(None, a, None), rot).v

    def rt(a):
        return ir.rotate(ir.Irreps(None, None, a), rot).t

    torch.testing.assert_close(ir.p_vv_s(rv(v), rv(v2)), ir.p_vv_s(v, v2), atol=1e-5, rtol=0)
    torch.testing.assert_close(ir.p_vv_v(rv(v), rv(v2)), rv(ir.p_vv_v(v, v2)), atol=1e-5, rtol=0)
    torch.testing.assert_close(ir.p_vv_t(rv(v), rv(v2)), rt(ir.p_vv_t(v, v2)), atol=1e-5, rtol=0)
    torch.testing.assert_close(ir.p_tv_v(rt(t), rv(v)), rv(ir.p_tv_v(t, v)), atol=1e-5, rtol=0)
    torch.testing.assert_close(ir.p_tt_s(rt(t), rt(t2)), ir.p_tt_s(t, t2), atol=1e-5, rtol=0)
    torch.testing.assert_close(ir.p_tt_t(rt(t), rt(t2)), rt(ir.p_tt_t(t, t2)), atol=1e-5, rtol=0)
    x = ir.Irreps(_t(feats["s"]), v, t)
    back = ir.rotate(ir.rotate(x, rot), rot.T)  # R^T undoes R
    for a, b in zip(back, x):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    # the linear map and the gate commute with the rotation
    w = [_t(m) for m in feats["w"]]
    g = [_t(m) for m in feats["g"]]
    for fn in (lambda z: ir.linear(z, *w), lambda z: ir.gate(z, *g)):
        for a, b in zip(fn(ir.rotate(x, rot)), ir.rotate(fn(x), rot)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_identity_follows_the_input():
    """The traceless projection's identity is made on the input's dtype
    (and device): float64 in, float64 out, no float32 constant mixed in."""
    m = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 3, 3)))
    out = ir.traceless_sym(m)
    assert out.dtype == torch.float64
    assert float(out.diagonal(dim1=-2, dim2=-1).sum(-1).abs().max()) < 1e-14
    assert ir.sph_l2(m[:, 0]).dtype == torch.float64


# ---------------------------------------------------------------------------
# EGNN and NequIP single device against the reference
# ---------------------------------------------------------------------------


def _configs(name, smoke):
    # through the registry, which loads every config module: importing one
    # module alone would leave the registry partial for later tests
    from repro.configs import common as jconfigs
    from repro_torch.configs import common as configs

    js, ts = jconfigs.get(name), configs.get(name)
    jcfg, cfg = ((js.smoke_config(), ts.smoke_config()) if smoke
                 else (js.model_config(), ts.model_config()))
    assert cfg.__dict__ == jcfg.__dict__ and js.notes == ts.notes
    return jcfg, cfg


def _multimesh_graph(d_in, pad=5, seed=6):
    verts, edges = icosahedron.multimesh(2)
    n = verts.shape[0]
    edges = np.concatenate([edges, np.full((pad, 2), n)]).astype(np.int32)
    rng = np.random.default_rng(seed)
    nf = rng.normal(size=(n, d_in)).astype(np.float32)
    return nf, edges, verts.astype(np.float32)


def _graphs(nf, edges, pos):
    jg = jgnn.Graph(nf=jnp.asarray(nf), src=jnp.asarray(edges[:, 0]),
                    dst=jnp.asarray(edges[:, 1]), pos=jnp.asarray(pos))
    tg = gnn.Graph(nf=_t(nf), src=torch.from_numpy(edges[:, 0]),
                   dst=torch.from_numpy(edges[:, 1]), pos=_t(pos))
    return jg, tg


def _peak_close(got, want, tol=FP32_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("name", ["egnn", "nequip"])
def test_single_device_forward_matches_jax(name, smoke):
    """The refinement-2 multimesh at its vertices, 5 padding edges
    appended: EGNN's outputs and updated coordinates, NequIP's outputs."""
    jcfg, cfg = _configs(name, smoke)
    nf, edges, pos = _multimesh_graph(cfg.d_in)
    jg, tg = _graphs(nf, edges, pos)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jgnn.init(jcfg, k))(
        jax.random.PRNGKey(2)))
    mine = gnn.params_from_numpy(params, "cpu")
    if name == "egnn":
        (h, x) = gnn.egnn_forward(cfg, mine, tg)
        jh, jx = jax.jit(lambda p, g: jgnn.egnn_forward(jcfg, p, g))(params, jg)
        _peak_close(h, jh)
        _peak_close(x, jx)
        assert torch.equal(gnn.forward(cfg, mine, tg), h)
    else:
        out = gnn.forward(cfg, mine, tg)
        assert out.shape == (tg.n, cfg.d_out) and torch.isfinite(out).all()
        _peak_close(out, jax.jit(lambda p, g: jgnn.forward(jcfg, p, g))(params, jg))


@pytest.mark.parametrize("name", ["egnn", "nequip"])
def test_params_from_numpy_round_trip(name):
    """The reference's tree, NequIP's bare (c, c) mixes among the MLP lists,
    crosses over leaf for leaf; ``init`` makes the same keys and shapes."""
    jcfg, cfg = _configs(name, False)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jgnn.init(jcfg, k))(
        jax.random.PRNGKey(1)))
    mine = gnn.params_from_numpy(params, "cpu")
    flat, tdef = jax.tree.flatten(params)
    mine_flat, mine_def = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), mine))
    assert tdef == mine_def
    for a, b in zip(flat, mine_flat):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    fresh = gnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, jax.tree.map(lambda t: t.numpy(), fresh)) == \
        jax.tree.map(np.shape, params)
    if name == "nequip":
        assert fresh["layers"][0]["w_v"].shape == (cfg.d_hidden, cfg.d_hidden)


def test_missing_pos_raises():
    for name in ("egnn", "nequip"):
        _, cfg = _configs(name, True)
        nf, edges, _ = _multimesh_graph(cfg.d_in)
        params = gnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
        g = gnn.Graph(nf=_t(nf), src=torch.from_numpy(edges[:, 0]),
                      dst=torch.from_numpy(edges[:, 1]))
        with pytest.raises(ValueError, match=name):
            gnn.forward(cfg, params, g)


# ---------------------------------------------------------------------------
# equivariance of the port's models
# ---------------------------------------------------------------------------


def _random_graph(d_in, seed=0, n=40, m=160):
    """tests/test_models.py's graph: 40 nodes, 160 random edges."""
    rng = np.random.default_rng(seed)
    return gnn.Graph(nf=_t(rng.normal(size=(n, d_in))),
                     src=torch.from_numpy(rng.integers(0, n, m).astype(np.int32)),
                     dst=torch.from_numpy(rng.integers(0, n, m).astype(np.int32)),
                     pos=_t(rng.normal(size=(n, 3))))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_nequip_rotation_invariance(smoke):
    _, cfg = _configs("nequip", smoke)
    g1 = _random_graph(cfg.d_in)
    rot = _t(_rot(0.7, 2))
    params = gnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    o1 = gnn.nequip_forward(cfg, params, g1)
    o2 = gnn.nequip_forward(cfg, params, g1._replace(pos=g1.pos @ rot.T))
    peak = max(1.0, float(o1.abs().max()))
    torch.testing.assert_close(o2, o1, atol=EQUIV_TOL * peak, rtol=0)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_egnn_equivariance(smoke):
    _, cfg = _configs("egnn", smoke)
    g1 = _random_graph(cfg.d_in)
    rot = _t(_rot(-1.2, 0))
    shift = torch.tensor([1.0, -2.0, 0.5])
    params = gnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    h1, x1 = gnn.egnn_forward(cfg, params, g1)
    h2, x2 = gnn.egnn_forward(cfg, params, g1._replace(pos=g1.pos @ rot.T + shift))
    peak = max(1.0, float(h1.abs().max()))
    torch.testing.assert_close(h2, h1, atol=EQUIV_TOL * peak, rtol=0)  # E(n) invariant h
    torch.testing.assert_close(x2, x1 @ rot.T + shift, atol=EQUIV_TOL, rtol=0)


@pytest.mark.parametrize("name", ["egnn", "nequip"])
def test_2d_forward_is_invariant(name):
    """On the 2x2 grid (the refinement-3 multimesh, smoke widths, fp32),
    rotating (and for EGNN shifting) every owned position leaves the 2D
    outputs as they were, and they equal the single-device forward."""
    from repro_torch.bench import gnn as gnn_bench

    st = gnn_bench.setup(name, refine=3, smoke=True, device="cpu")
    rot = _rot(0.5, 2) @ _rot(1.1, 0)
    shift = np.float32([0.3, -0.2, 0.1]) if name == "egnn" else np.zeros(3, np.float32)
    out = gnn_bench.forward_2d(st, False)[: st.n]
    pos = np.zeros((st.bg.part.n, 3), np.float32)
    pos[: st.n] = st.verts @ rot.T + shift
    st.pos = gnn_dist.shard_nodes(st.grid, pos, st.bg.part)
    turned = gnn_bench.forward_2d(st, False)[: st.n]
    peak = float(out.abs().max())
    torch.testing.assert_close(turned, out, atol=EQUIV_TOL * peak, rtol=0)
    single = gnn_bench.forward_single(gnn_bench.setup(name, refine=3, smoke=True, device="cpu"))
    torch.testing.assert_close(out, single, atol=FP32_TOL * peak, rtol=FP32_TOL)


# ---------------------------------------------------------------------------
# the data pipeline: byte-identical copies
# ---------------------------------------------------------------------------


def test_graphs_module_is_the_reference_with_the_port_imports():
    here = open(os.path.join(ROOT, "src", "repro_torch", "data", "graphs.py")).read()
    there = open(os.path.join(ROOT, "src", "repro", "data", "graphs.py")).read()
    assert here == there.replace("from repro.graphgen import", "from repro_torch.graphgen import")


@pytest.mark.parametrize("kw", [dict(scale=8), dict(scale=10, edgefactor=4, seed=3),
                                dict(scale=9, a=0.45, b=0.15, c=0.15, permute=False)])
def test_rmat_edges_byte_identical(kw):
    got, want = kronecker.rmat_edges(**kw), jkronecker.rmat_edges(**kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _same_batch(a, b):
    for f in ("nf", "src", "dst", "pos", "targets", "mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f


def test_graph_batches_byte_identical():
    _same_batch(graphs.synthetic_graph(200, 800, 16, seed=1, n_classes=7),
                jgraphs.synthetic_graph(200, 800, 16, seed=1, n_classes=7))
    _same_batch(graphs.synthetic_graph(300, 50_000, 8, seed=2),  # topped up with uniform edges
                jgraphs.synthetic_graph(300, 50_000, 8, seed=2))
    _same_batch(graphs.molecule_batch(128, 30, 64, 16, seed=0),
                jgraphs.molecule_batch(128, 30, 64, 16, seed=0))
    assert graphs.sampled_shape(1024, (15, 10)) == jgraphs.sampled_shape(1024, (15, 10))
    edges = kronecker.kronecker_edges(10, seed=4)
    g, jg = builder.build_csr(edges, n=1 << 10), jbuilder.build_csr(edges, n=1 << 10)
    mine, ref = graphs.NeighborSampler(g, (15, 10), seed=5), jgraphs.NeighborSampler(jg, (15, 10),
                                                                                     seed=5)
    seeds = np.arange(0, 1 << 10, 37)
    for a, b in zip(mine.sample(seeds), ref.sample(seeds)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    _same_batch(mine.batch(seeds, 12, feat_seed=3), ref.batch(seeds, 12, feat_seed=3))
