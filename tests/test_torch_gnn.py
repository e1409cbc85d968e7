"""The port's int8 block quantization and GNN forwards against the JAX package.

Kernel level: the plain ``quantize`` against JAX ``quant.ref.quantize`` and
the Pallas ``quantize_pallas`` in interpret mode (codes equal, scales within
``rtol=1e-6``, the bar the reference holds its own kernel to), at fixed
seeds.  ``Int8Format``'s geometry equals JAX's.  Single device:
``graphcast_forward`` and ``gat_forward`` at the smoke widths over the
refinement-2 multimesh against JAX (EGNN's and NequIP's are in
``tests/test_torch_equivariant.py``).  Distributed: ``forward_2d`` on
``SimGrid(2, 2, "cpu")`` for ``graphcast``, ``gat-cora``, ``egnn`` and
``nequip`` (positions from seed 1), payload quantization off and on,
against JAX ``graphcast_2d`` / ``gat_2d`` / ``egnn_2d`` / ``nequip_2d``
under ``shard_map`` in a 4-device subprocess started when the module
starts (it overlaps the other tests), on the scale-9 Kronecker graph of
``tests/test_dist.py``; NequIP asked for int8 quantizes nothing and equals
its fp32 forward bit for bit.  The same subprocess runs EGNN at its
published widths on the refinement-4 multimesh (the harness's fields,
positions and padding), int8 and fp32: the reference's int8/fp32 gap,
which quantizes the coordinates with the features, beside the port's.

Tolerances: the single-device float32 forwards in another summation
order, ``atol = rtol = 1e-5``.  The 2D float32 forwards at ``rtol = 1e-5``
and ``atol = 1e-5 * max|ref|``: a hub's aggregate sums hundreds of messages
whose magnitudes exceed the result, so an element's rounding error scales
with the output's peak, not with the element (JAX and the port are each
~5e-4 from a float64 run at peak 271; they differ by ~1e-4).  The int8
forwards at ``1e-3 * max|ref|``: a float-order flip upstream of a quantizer
can move one code by one step (scale/127 of its group), which the
following layers carry.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import formats as jformats
from repro.core import csr as jcsr
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro.kernels.quant import quant as jquant
from repro.kernels.quant import ref as jqref
from repro.models import gnn as jgnn
from repro.models import icosahedron as jico
from repro_torch import kernels, tree
from repro_torch.comm import Int8Format, SimGrid
from repro_torch.core import csr
from repro_torch.kernels.quant import ops as qops
from repro_torch.kernels.quant import ref as qref
from repro_torch.models import gnn, gnn_dist, icosahedron

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = 1e-5
INT8_REL = 1e-3
D_IN = 12
#: the 2D configurations of tests/test_dist.py
CONFIGS = {
    "graphcast": dict(n_layers=2, d_hidden=16, d_in=D_IN, d_out=16, edge_state=False),
    "gat-cora": dict(n_layers=2, d_hidden=8, n_heads=2, d_in=D_IN, d_out=16),
    "egnn": dict(n_layers=2, d_hidden=16, d_in=D_IN, d_out=16),
    "nequip": dict(n_layers=2, d_hidden=4, n_rbf=4, d_in=D_IN, d_out=16),
}
CLASSES = {"graphcast": gnn.GraphCastConfig, "gat-cora": gnn.GATConfig,
           "egnn": gnn.EGNNConfig, "nequip": gnn.NequIPConfig}
#: EGNN at its published widths: the multimesh refinement of the int8 gap
EGNN_GAP_REFINE = 4
#: the int8 payload against fp32, relative L2 (chip_smoke.GNN_INT8_L2)
INT8_L2 = 0.05

_JAX_RUN = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import csr as csrmod
from repro.graphgen import builder, kronecker
from repro.models import gnn, gnn_dist
from repro.configs import common as jconfigs
from repro.models import icosahedron
configs, d_in, gap_refine, out = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"))
CLASSES = {"graphcast": gnn.GraphCastConfig, "gat-cora": gnn.GATConfig,
           "egnn": gnn.EGNNConfig, "nequip": gnn.NequIPConfig}
FWD = {"graphcast": gnn_dist.graphcast_2d, "gat-cora": gnn_dist.gat_2d,
       "egnn": gnn_dist.egnn_2d, "nequip": gnn_dist.nequip_2d}


def forward_2d(name, cfg, params, bg, nf, pos, q):
    part = bg.part
    r, c, s = part.rows, part.cols, part.chunk
    fwd, dcfg = FWD[name], gnn_dist.Dist2DConfig(quantize_payload=q)

    def local(params, nf, pos, src_l, dst_l):
        args = (nf.reshape(s, -1), src_l.reshape(-1), dst_l.reshape(-1), part, dcfg)
        if name in ("egnn", "nequip"):
            args = args[:1] + (pos.reshape(s, 3),) + args[1:]
        return fwd(cfg, params, *args).reshape(1, 1, s, -1)

    own = P("data", "model", None)
    fn = jax.jit(compat.shard_map(local, mesh=mesh, in_specs=(P(), own, own, own, own),
                                  out_specs=P("data", "model", None, None), check_vma=False))
    return np.asarray(fn(params, jnp.asarray(nf.reshape(r, c, s, -1)),
                         jnp.asarray(pos.reshape(r, c, s, 3)), jnp.asarray(bg.src_local),
                         jnp.asarray(bg.dst_local)))


g = builder.build_csr(kronecker.kronecker_edges(9, seed=5), n=1 << 9)
bg = csrmod.partition_2d(g, rows=2, cols=2, chunk_multiple=256)
nf = np.random.default_rng(0).normal(size=(bg.part.n, d_in)).astype(np.float32)
pos = np.random.default_rng(1).normal(size=(bg.part.n, 3)).astype(np.float32)
res = {}
for name, kw in configs.items():
    cfg = CLASSES[name](**kw)
    params = gnn.init(cfg, jax.random.PRNGKey(0))
    for q in (False, True):
        res[f"{name}/{int(q)}"] = forward_2d(name, cfg, params, bg, nf, pos, q)
# EGNN at its published widths on the multimesh, fields and positions in
# the layout of the port's bench.gnn (passed in as numpy by the test)
data = np.load(out + ".in.npz")
verts, edges = icosahedron.multimesh(gap_refine)
n = verts.shape[0]
mg = builder.CSRGraph(n=n, row_ptr=np.concatenate(
    [[0], np.cumsum(np.bincount(edges[:, 0], minlength=n))]).astype(np.int64),
    col_idx=edges[:, 1].astype(np.int32), src=edges[:, 0].astype(np.int32),
    dst=edges[:, 1].astype(np.int32), m_input=len(edges))
mbg = csrmod.partition_2d(mg, rows=2, cols=2, chunk_multiple=1024)
cfg = jconfigs.get("egnn").model_config()
params = jax.jit(lambda k: gnn.init(cfg, k))(jax.random.PRNGKey(0))
for k, x in enumerate(jax.tree.leaves(params)):
    res[f"gap/param{k}"] = np.asarray(x)
for q in (False, True):
    res[f"gap/{int(q)}"] = forward_2d("egnn", cfg, params, mbg, data["nf"], data["pos"], q)
np.savez(out, **res)
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads only contend
    with the JAX side and the other test processes.  Restored when the
    module ends."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _gap_setup():
    """EGNN at its published widths on the refinement-:data:`EGNN_GAP_REFINE`
    multimesh over a 2x2 grid, as the harness sets it up (fields from seed
    0, the vertices as positions, zero on the padded vertices)."""
    from repro_torch.bench import gnn as gnn_bench

    return gnn_bench.setup("egnn", EGNN_GAP_REFINE, (2, 2), 0, False, "cpu")


@pytest.fixture(scope="module")
def jax_2d(tmp_path_factory):
    """The JAX 2D forwards, computed in a 4-device subprocess started here
    and read on first use."""
    out = tmp_path_factory.mktemp("jax_gnn") / "runs.npz"
    st = _gap_setup()
    pos = np.zeros((st.bg.part.n, 3), np.float32)
    pos[: st.n] = st.verts
    np.savez(str(out) + ".in.npz", nf=st.nf, pos=pos)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RUN,
                             json.dumps([CONFIGS, D_IN, EGNN_GAP_REFINE, str(out)])],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cache = {}

    def get():
        if not cache:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout + stderr[-3000:]
            cache.update(np.load(out))
        return cache

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _jcfg(name):
    return getattr(jgnn, CLASSES[name].__name__)(**CONFIGS[name])


def _tcfg(name):
    return CLASSES[name](**CONFIGS[name])


def _np_params(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# quantize: plain version against the reference and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("n", [1024, 4096, 8192])
def test_quantize_matches_jax_ref_and_pallas(n, scale):
    rng = np.random.default_rng(n + int(scale * 1000))
    x = (rng.normal(size=n) * scale).astype(np.float32)
    x[: qref.GROUP] = 0.0  # an all-zero group: scale 0, codes 0
    q, s = qref.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    for jq, js in (jqref.quantize(jnp.asarray(x)),
                   jquant.quantize_pallas(jnp.asarray(x), interpret=True)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    assert (q[: qref.GROUP] == 0).all() and s[0] == 0
    np.testing.assert_array_equal(qref.dequantize(q, s).numpy(),
                                  np.asarray(jqref.dequantize(jnp.asarray(q.numpy()),
                                                              jnp.asarray(s.numpy()))))


def test_quantize_rounds_half_to_even():
    """A group with max 127 has scale 1.0; 0.5, 1.5, 2.5 and their negatives
    give 0, 2, 2 (half to even, as ``jnp.round``), not 1, 2, 3."""
    x = np.zeros(qref.GROUP, np.float32)
    x[:7] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    q, s = qops.quantize(torch.from_numpy(x))
    assert float(s[0]) == 1.0
    assert q[:7].tolist() == [127, 0, 2, 2, 0, -2, -2]
    jq, _ = jqref.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("seed", [0, 1, 2, 13156])
def test_quantize_error_bound(seed):
    """|x - dequantize(quantize(x))| <= scale/2 per group, plus a float slack
    of 2 ulp of |x| and 1 ulp of the scale (x / scale and q * scale each
    round once); the seeds include the draw that broke the reference's
    property test with a 1e-12 slack."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=qref.GROUP * 4) * 3.0).astype(np.float32)
    q, s = qref.quantize(torch.from_numpy(x))
    back = qref.dequantize(q, s).numpy()
    sg = np.repeat(s.numpy(), qref.GROUP)
    bound = sg / 2 + 2 * np.spacing(np.abs(x)) + np.spacing(sg)
    assert np.all(np.abs(back - x) <= bound)


def test_quantize_wrapper_takes_any_multiple_of_128_on_cpu():
    kernels.reset_launches()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=128 * 13).astype(np.float32))
    q, s = qops.quantize(x)
    want_q, want_s = qref.quantize(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert not kernels.LAUNCHES  # the CPU runs the plain version, no kernel
    with pytest.raises(AssertionError):
        qops.quantize(x[:100])


def test_int8_format_equals_jax():
    for n in (128, 4096, 11264 * 512, 2 * 11264 * 512):
        mine, ref = Int8Format(n), jformats.Int8Format(n)
        assert (mine.name, mine.data_words, mine.meta_words, mine.wire_bytes) == (
            ref.name, ref.data_words, ref.meta_words, ref.wire_bytes)
    x = np.random.default_rng(4).normal(size=1024).astype(np.float32)
    fmt = Int8Format(1024)
    q, s = fmt.pack(torch.from_numpy(x))
    jq, js = jformats.Int8Format(1024).pack(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(fmt.unpack(q, s).numpy(),
                                  np.asarray(jformats.Int8Format(1024).unpack(jq, js)))


def test_ste_quant_gradient_is_identity():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(37, 9)).astype(np.float32))
    x.requires_grad_(True)
    y = gnn_dist._ste_quant(x)
    flat = torch.nn.functional.pad(x.detach().reshape(-1), (0, (-x.numel()) % 128))
    want = qref.dequantize(*qref.quantize(flat))[: x.numel()].reshape(x.shape)
    assert torch.equal(y.detach(), want) and not torch.equal(y.detach(), x.detach())
    (y * 3).sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


# ---------------------------------------------------------------------------
# models: the multimesh, parameters, single-device forwards
# ---------------------------------------------------------------------------


def test_icosahedron_byte_identical():
    here = os.path.join(ROOT, "src", "repro_torch", "models", "icosahedron.py")
    there = os.path.join(ROOT, "src", "repro", "models", "icosahedron.py")
    assert open(here, "rb").read() == open(there, "rb").read()
    for a, b in zip(icosahedron.multimesh(2), jico.multimesh(2)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["graphcast", "gat-cora"])
def test_params_from_numpy_round_trip(name):
    params = _np_params(jgnn.init(_jcfg(name), jax.random.PRNGKey(1)))
    mine = gnn.params_from_numpy(params, "cpu")
    flat, tree = jax.tree.flatten(params)
    mine_flat, mine_tree = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), mine))
    assert tree == mine_tree
    for a, b in zip(flat, mine_flat):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    # new parameters from a generator take the reference's shapes
    fresh = gnn.init(_tcfg(name), torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, jax.tree.map(lambda t: t.numpy(), fresh)) == \
        jax.tree.map(np.shape, params)


def test_unported_archs_raise():
    """An unknown config raises ``TypeError`` in ``init``, ``forward`` and
    ``forward_2d``; EGNN and NequIP without positions raise ``TypeError``
    naming the arch in ``forward_2d``."""
    class UnknownConfig:
        name = "schnet"

    with pytest.raises(TypeError):
        gnn.init(UnknownConfig(), torch.Generator(), "cpu")
    with pytest.raises(TypeError):
        gnn.forward(UnknownConfig(), {}, None)
    grid = SimGrid(2, 2, "cpu")
    with pytest.raises(TypeError, match="schnet"):
        gnn_dist.forward_2d(grid, UnknownConfig(), {}, None, None, None, None)
    for name in ("egnn", "nequip"):
        params = gnn.init(_tcfg(name), torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(TypeError, match=name):
            gnn_dist.forward_2d(grid, _tcfg(name), params, None, None, None, None)


@pytest.mark.parametrize("name,edge_state", [("graphcast", True), ("graphcast", False),
                                             ("gat-cora", None)])
def test_single_device_forward_matches_jax(name, edge_state):
    """The smoke widths over the refinement-2 multimesh, with padding edges
    (src = dst = n) appended, against the JAX forward."""
    # through the registry, which loads every config module: importing one
    # module alone would leave the registry partial for later tests
    from repro.configs import common as jconfigs
    from repro_torch.configs import gat_cora, graphcast

    if name == "graphcast":
        jcfg, cfg = jconfigs.get("graphcast").smoke_config(), graphcast.smoke_config()
        jcfg = jcfg.__class__(**{**jcfg.__dict__, "edge_state": edge_state})
        cfg = cfg.__class__(**{**cfg.__dict__, "edge_state": edge_state})
    else:
        jcfg, cfg = jconfigs.get("gat-cora").smoke_config(), gat_cora.smoke_config()
    assert cfg.__dict__ == jcfg.__dict__
    verts, edges = icosahedron.multimesh(2)
    n = verts.shape[0]
    edges = np.concatenate([edges, np.full((5, 2), n)]).astype(np.int32)
    nf = np.random.default_rng(6).normal(size=(n, cfg.d_in)).astype(np.float32)
    params = _np_params(jgnn.init(jcfg, jax.random.PRNGKey(2)))
    want = np.asarray(jgnn.forward(jcfg, params, jgnn.Graph(
        nf=jnp.asarray(nf), src=jnp.asarray(edges[:, 0]), dst=jnp.asarray(edges[:, 1]))))
    got = gnn.forward(cfg, gnn.params_from_numpy(params, "cpu"), gnn.Graph(
        nf=torch.from_numpy(nf), src=torch.from_numpy(edges[:, 0]),
        dst=torch.from_numpy(edges[:, 1])))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL, rtol=FP32_TOL)


# ---------------------------------------------------------------------------
# the 2D forward on the simulated grid against JAX under shard_map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blocked():
    g = jbuilder.build_csr(jkronecker.kronecker_edges(9, seed=5), n=1 << 9)
    bg = jcsr.partition_2d(g, rows=2, cols=2, chunk_multiple=256)
    mine = csr.partition_2d(g, 2, 2, chunk_multiple=256)
    assert np.array_equal(mine.src_local, bg.src_local)
    assert np.array_equal(mine.dst_local, bg.dst_local)
    return mine


def _forward_2d(blocked, name, quantize):
    part = blocked.part
    r, c, s = part.rows, part.cols, part.chunk
    nf = np.random.default_rng(0).normal(size=(part.n, D_IN)).astype(np.float32)
    pos = np.random.default_rng(1).normal(size=(part.n, 3)).astype(np.float32)
    params = gnn.params_from_numpy(_np_params(jgnn.init(_jcfg(name), jax.random.PRNGKey(0))),
                                   "cpu")
    grid = SimGrid(2, 2, "cpu")
    out = gnn_dist.forward_2d(grid, _tcfg(name), params,
                              gnn_dist.shard_nodes(grid, nf.reshape(r, c, s, D_IN), part),
                              gnn_dist.shard_edges(grid, blocked.src_local),
                              gnn_dist.shard_edges(grid, blocked.dst_local), part,
                              gnn_dist.Dist2DConfig(quantize_payload=quantize),
                              pos=gnn_dist.shard_nodes(grid, pos, part))
    return torch.stack(out).reshape(r, c, s, -1).numpy()


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", ["graphcast", "gat-cora", "egnn"])
def test_forward_2d_matches_jax(jax_2d, blocked, name, quantize):
    got = _forward_2d(blocked, name, quantize)
    want = jax_2d()[f"{name}/{int(quantize)}"]
    assert got.shape == want.shape
    # the reference's own int8 GAT output holds non-finite values (its max
    # pass quantizes the -1e30 identity of empty rows with real maxima):
    # the port's must sit at the same places, and every other value agree
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert finite.all() or (name == "gat-cora" and quantize)
    peak = np.abs(want[finite]).max()
    if quantize:
        np.testing.assert_allclose(got[finite], want[finite], atol=INT8_REL * peak, rtol=0)
        fp32 = jax_2d()[f"{name}/0"][finite]
        assert np.abs(got[finite] - fp32).max() > 10 * FP32_TOL * peak  # it was quantized
    else:
        np.testing.assert_allclose(got, want, atol=FP32_TOL * peak, rtol=FP32_TOL)


def test_nequip_forward_2d_matches_jax_and_never_quantizes(jax_2d, blocked):
    """NequIP's 2D forward against JAX ``nequip_2d`` (fp32 bar); asked for
    int8 it launches no quantize (on the CPU: calls no quantizer) and
    equals its fp32 forward bit for bit, as the reference's does."""
    want = jax_2d()["nequip/0"]
    np.testing.assert_array_equal(jax_2d()["nequip/1"], want)
    real, calls = qops.quantize, []
    qops.quantize = lambda x: calls.append(x.numel()) or real(x)
    try:
        got8 = _forward_2d(blocked, "nequip", True)
    finally:
        qops.quantize = real
    assert not calls
    got = _forward_2d(blocked, "nequip", False)
    assert np.array_equal(got8, got) and np.isfinite(got).all()
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=FP32_TOL * peak, rtol=FP32_TOL)


def test_egnn_int8_gap_at_published_width(jax_2d):
    """EGNN at its published widths on the refinement-4 multimesh, the
    reference's parameters: the port's fp32 2D forward equals the
    reference's (fp32 bar), and the int8/fp32 relative L2 gap — the int8
    payload quantizes the coordinates with the features, in both — is
    under :data:`INT8_L2` in both and the port's within 10% of the
    reference's (``-s`` prints both)."""
    from repro_torch.bench import gnn as gnn_bench

    ref = jax_2d()
    st = _gap_setup()
    _, unflatten = tree.flatten(st.params)  # jax.tree's leaf order
    st.params = unflatten([torch.from_numpy(ref[f"gap/param{k}"])
                           for k in range(len(tree.leaves(st.params)))])
    got = {q: gnn_bench.forward_2d(st, q)[: st.n].double() for q in (False, True)}
    want = {q: torch.from_numpy(ref[f"gap/{int(q)}"]).reshape(-1, got[q].shape[1])[: st.n]
            .double() for q in (False, True)}
    peak = float(want[False].abs().max())
    torch.testing.assert_close(got[False], want[False], atol=FP32_TOL * peak, rtol=FP32_TOL)
    gaps = {k: float((d[True] - d[False]).norm() / d[False].norm())
            for k, d in (("port", got), ("reference", want))}
    print(f"EGNN published widths, refinement {EGNN_GAP_REFINE}, 2x2: int8 vs fp32 relative "
          f"L2, reference {gaps['reference']:.6e}, port {gaps['port']:.6e}")
    assert 0 < gaps["reference"] < INT8_L2 and 0 < gaps["port"] < INT8_L2
    assert abs(gaps["port"] - gaps["reference"]) < 0.1 * gaps["reference"]


class _CountingGrid(SimGrid):
    """A SimGrid that keeps, for every collective call, each rank's
    contribution in values."""

    def __init__(self, *args):
        super().__init__(*args)
        self.sent = []

    def all_gather(self, xs, *args, **kw):
        self.sent.append([x.numel() for x in xs])
        return super().all_gather(xs, *args, **kw)

    def all_to_all(self, xs, *args, **kw):
        self.sent.append([x.numel() for x in xs])
        return super().all_to_all(xs, *args, **kw)

    def ppermute(self, xs, *args, **kw):
        self.sent.append([x.numel() for x in xs])
        return super().ppermute(xs, *args, **kw)


@pytest.mark.parametrize("name", ["graphcast", "gat-cora", "egnn", "nequip"])
def test_payload_bytes_count_every_exchange(blocked, name):
    """The harness's payload bytes, worked out from the shapes, equal those
    of every collective the 2D forward calls (int8 ``Int8Format(n)``, fp32
    ``4 n``, summed over ranks), and int8 cuts them ~3.9x; NequIP's
    payload stays fp32 when int8 is asked for."""
    from repro_torch.bench import gnn as gnn_bench

    part = blocked.part
    cfg = _tcfg(name)
    params = gnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    nf = np.random.default_rng(0).normal(size=(part.n, D_IN)).astype(np.float32)
    pos = np.random.default_rng(1).normal(size=(part.n, 3)).astype(np.float32)
    grid = _CountingGrid(2, 2, "cpu")
    gnn_dist.forward_2d(grid, cfg, params, gnn_dist.shard_nodes(grid, nf, part),
                        gnn_dist.shard_edges(grid, blocked.src_local),
                        gnn_dist.shard_edges(grid, blocked.dst_local), part,
                        gnn_dist.Dist2DConfig(quantize_payload=True),
                        pos=gnn_dist.shard_nodes(grid, pos, part))
    sent = [n for call in grid.sent for n in call]
    fp32 = sum(4 * n for n in sent)
    want = {"int8": fp32 if name == "nequip" else sum(Int8Format(n).wire_bytes for n in sent),
            "fp32": fp32, "calls": len(grid.sent)}
    # per aggregation pass: 3 gather payloads of (s, d) and one (c, s, dm) all-to-all
    assert want["calls"] == 4 * 2 * (2 if name == "gat-cora" else 1)
    assert gnn_bench.payload_bytes(cfg, params, part) == want
    if name == "nequip":
        assert want["int8"] == want["fp32"]
    else:
        assert want["fp32"] > 3.8 * want["int8"]
