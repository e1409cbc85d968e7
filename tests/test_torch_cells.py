"""The port's ``launch/{mesh,cells,roofline}`` and placement specs against the
JAX package.

* the mesh geometry (``make_production_mesh``, ``fsdp_axes``,
  ``grid_rows_cols``) against the reference's on an ``AbstractMesh``;
* ``param_specs`` and ``cache_spec`` entry for entry against JAX's
  ``PartitionSpec``s, for the five LM configs under both FSDP tuples and
  both expert layouts, and AutoInt with and without the int8 table;
* ``shard_shape`` against ``NamedSharding(mesh, spec).shard_shape`` in a
  4-device JAX subprocess, on every argument of every cell at a (2, 2) mesh;
* the FLOP models, and every cell's ``kind``, ``skip_reason`` and ``meta``
  at the (2, 2) and both production meshes, exactly against the JAX FLOP
  functions applied to the JAX configs at the same shapes (the reference's
  recipe of ``build_cell``, reckoned here from its parts);
* every built cell's ``fn`` run on its meta arguments at a (2, 2) mesh, the
  counterpart of ``test_all_cells_lower_on_small_mesh``; the cells of
  :data:`HOST_CELLS` run at a test-size graph on the CPU instead;
* the four variants of ``test_perf_variants_lower``, and the roofline
  arithmetic of ``test_roofline_terms_arithmetic``.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import common as jcfgs
from repro.core import bfs as jbfs
from repro.data import graphs as jgraphs
from repro.graphgen import builder as jbuilder
from repro.graphgen import kronecker as jkronecker
from repro.launch import cells as jcells
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.models import gnn as jgnn
from repro.models import recsys as jrecsys
from repro.models import transformer as jtfm
from repro_torch import tree
from repro_torch.comm import SimGrid
from repro_torch.configs import common as cfgs
from repro_torch.core import csr
from repro_torch.graphgen import builder
from repro_torch.launch import cells, mesh, roofline
from repro_torch.models import gnn, gnn_dist, recsys
from repro_torch.models import transformer as tfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ("dbrx-132b", "deepseek-coder-33b", "deepseek-v2-236b", "gemma-2b", "minicpm-2b")
GNN_ARCHS = ("egnn", "gat-cora", "graphcast", "nequip")
MESHES = {"2x2": ((2, 2), ("data", "model")), "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
#: the cells whose ``fn`` cannot run on meta arguments, run at a test-size
#: graph on the CPU instead: graph500's distributed BFS reads the root and
#: each level's counts to the host.  The 2D GraphCast and GAT steps run on
#: meta: their int8 payloads go through the ``quantize`` kernel's wrapper,
#: which takes its plain version for meta tensors as for CPU ones
HOST_CELLS = ("graph500/scale22", "graph500/scale27", "graph500/scale30")
ALL = cells.all_cells()
BUILT = [f"{a}/{s}" for a, s in ALL if cfgs.get(a).shape(s).kind != "skip"]
META_RUN = [c for c in BUILT if c not in HOST_CELLS]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def _cells(mesh_name: str) -> dict:
    m = mesh.make_mesh(*MESHES[mesh_name])
    return {f"{a}/{s}": cells.build_cell(a, s, m) for a, s in ALL}


def _spec_tree(specs):
    """A JAX ``PartitionSpec`` tree as the port's tuples."""
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# mesh geometry and placement specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_geometry_equals_reference(name):
    sizes, names = MESHES[name]
    m = mesh.make_mesh(sizes, names)
    am = AbstractMesh(sizes, names)
    assert m.shape == dict(am.shape) and m.size == am.size
    assert mesh.fsdp_axes(m) == jmesh.fsdp_axes(am)
    assert mesh.grid_rows_cols(m) == jmesh.grid_rows_cols(am)
    if name != "2x2":  # the reference's make_production_mesh geometry
        prod = mesh.make_production_mesh(multi_pod=name == "multipod")
        assert (prod.axis_sizes, prod.axis_names) == (sizes, names)


@pytest.mark.parametrize("expert_shard", ["d", "ff"])
@pytest.mark.parametrize("fsdp", [("data",), ("pod", "data")])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_equal_reference(arch, fsdp, expert_shard):
    cfg = dataclasses.replace(cfgs.get(arch).model_config(), expert_shard=expert_shard)
    jcfg = dataclasses.replace(jcfgs.get(arch).model_config(), expert_shard=expert_shard)
    ours = tfm.param_specs(cfg, fsdp=fsdp, tp="model")
    assert ours == _spec_tree(jtfm.param_specs(jcfg, fsdp=fsdp, tp="model"))
    # one entry per dimension of init_params' leaf, in its tree
    params = tfm.init_params(cfg, torch.Generator(), "meta")
    assert tree.structure(params) == tree.structure(
        mesh.map_specs(lambda sp: 0, ours)).replace("0", "*")
    for x, sp in zip(tree.leaves(params), mesh.spec_leaves(ours)):
        assert len(sp) == x.dim()
    assert tfm.cache_spec(fsdp=fsdp, tp="model") == tuple(jtfm.cache_spec(fsdp=fsdp, tp="model"))


@pytest.mark.parametrize("table_quant", [False, True])
@pytest.mark.parametrize("fsdp", [("data",), ("pod", "data")])
def test_autoint_param_specs_equal_reference(fsdp, table_quant):
    cfg = dataclasses.replace(cfgs.get("autoint").model_config(), table_quant=table_quant)
    jcfg = dataclasses.replace(jcfgs.get("autoint").model_config(), table_quant=table_quant)
    assert (recsys.param_specs(cfg, fsdp=fsdp, tp="model")
            == _spec_tree(jrecsys.param_specs(jcfg, fsdp=fsdp, tp="model")))


_SHARD_RUN = """
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = []
for shape, spec in json.loads(sys.stdin.read()):
    try:
        sp = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        out.append(list(NamedSharding(mesh, sp).shard_shape(tuple(shape))))
    except Exception as e:
        out.append(type(e).__name__)
print(json.dumps(out))
"""


def test_shard_shape_equals_named_sharding():
    """Every (argument shape, spec) of the cells at (2, 2), and specs at the
    edges: a dimension its axes do not divide, an axis twice, an axis not on
    the mesh, entries past the shape's rank (``None``, or split)."""
    m = mesh.make_mesh(*MESHES["2x2"])
    cases = {((7, 4), ("data", None)), ((4,), (None, None)), ((4, 4), ("data", "data")),
             ((4,), ("data", "model")),
             ((8, 6), (("data", "model"), None)), ((6, 8), (("data", "model"),)),
             ((4, 4), ("pod", None)), ((), ())}
    for cell in _cells("2x2").values():
        for arg, specs in zip(cell.args, cell.in_shardings or ()):
            for x, sp in zip(tree.leaves(arg), mesh.spec_leaves(specs)):
                cases.add((tuple(x.shape), sp))
    cases = sorted(cases, key=repr)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _SHARD_RUN], input=json.dumps(cases),
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    n_err = 0
    for (shape, sp), w in zip(cases, want):
        if isinstance(w, str):
            n_err += 1
            with pytest.raises(ValueError):
                mesh.shard_shape(shape, sp, m)
        else:
            assert mesh.shard_shape(shape, sp, m) == tuple(w), (shape, sp)
    assert n_err == 5 and len(cases) > 50


# ---------------------------------------------------------------------------
# FLOP models and the catalogue's meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_flop_models_equal_reference(arch):
    cfg, jcfg = cfgs.get(arch).model_config(), jcfgs.get(arch).model_config()
    for b, s in ((256, 4096), (32, 32768), (128, 32768), (1, 7), (3, 1000)):
        for name in ("lm_train_flops", "lm_prefill_flops", "lm_decode_flops"):
            assert getattr(cells, name)(cfg, b, s) == getattr(jcells, name)(jcfg, b, s)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_flop_models_equal_reference(arch):
    for d_in, d_out in ((1433, 7), (16, 16), (100, 47)):
        cfg = cfgs.get(arch).model_config(d_in=d_in, d_out=d_out)
        jcfg = jcfgs.get(arch).model_config(d_in=d_in, d_out=d_out)
        for n, m in ((2708, 10556), (3840, 8192), (2449029, 61859140), (1, 0)):
            assert cells.gnn_flops(cfg, n, m, d_in) == jcells.gnn_flops(jcfg, n, m, d_in)
    with pytest.raises(TypeError):
        cells.gnn_flops(object(), 1, 1, 1)


def test_recsys_and_mlp_flops_equal_reference():
    cfg, jcfg = cfgs.get("autoint").model_config(), jcfgs.get("autoint").model_config()
    for b in (1, 512, 65536, 262144):
        assert cells.recsys_flops(cfg, b) == jcells.recsys_flops(jcfg, b)
    smoke, jsmoke = cfgs.get("autoint").smoke_config(), jcfgs.get("autoint").smoke_config()
    assert cells.recsys_flops(smoke, 7) == jcells.recsys_flops(jsmoke, 7)
    for dims in ((3, 4), (1536, 512, 512), (8, 32, 96), (5,)):
        assert cells._mlp_flops(dims) == jcells._mlp_flops(dims)


def _want(arch: str, shape_name: str, am: AbstractMesh) -> tuple[str, str, dict]:
    """The reference's kind, skip reason and meta of a cell, from the JAX
    configs and FLOP functions."""
    spec = jcfgs.get(arch)
    sh = spec.shape(shape_name)
    if sh.kind == "skip":
        return "skip", sh.skip_reason, {}
    p = sh.params
    rows, cols = jmesh.grid_rows_cols(am)
    if spec.family == "lm":
        cfg = spec.model_config()
        b, s = p["global_batch"], p["seq_len"]
        base = dict(n_params=cfg.n_params(), loop_mult=float(cfg.n_layers))
        if sh.kind == "train":
            return "train", "", dict(base, model_flops=jcells.lm_train_flops(cfg, b, s),
                                     n_active=cfg.n_active_params())
        if sh.kind == "prefill":
            return "prefill", "", dict(base, model_flops=jcells.lm_prefill_flops(cfg, b, s))
        return "decode", "", dict(
            base, model_flops=jcells.lm_decode_flops(cfg, b, s),
            cache_bytes=cfg.n_layers * b * s * cfg.cache_width
            * np.dtype(cfg.compute_dtype).itemsize)
    if spec.family == "gnn":
        dist, d_in = p["dist"], p["d_feat"]
        cfg = spec.model_config(d_in=d_in, d_out=p["n_classes"])
        if isinstance(cfg, jgnn.GraphCastConfig):
            cfg = dataclasses.replace(cfg, edge_state=dist != "2d")
        shapes = jax.eval_shape(lambda: jgnn.init(cfg, jax.random.PRNGKey(0)))
        n_params = sum(x.size for x in jax.tree.leaves(shapes))
        if dist == "2d":
            n, m = p["n_nodes"], p["n_edges"]
            return "graph_train_2d", "", dict(
                model_flops=3.0 * jcells.gnn_flops(cfg, n, m, d_in), n_params=n_params,
                loop_mult=1.0, n_nodes=n, n_edges=m,
                e_cap=jcells._round_up(2 * m // (rows * cols), 1024))
        if dist == "batched":
            n, m = p["n_nodes"] * p["batch"], p["n_edges"] * p["batch"]
        elif dist == "sampled":
            n, m = jgraphs.sampled_shape(p["batch_nodes"], p["fanout"])
        else:
            n, m = p["n_nodes"], p["n_edges"]
        return "graph_train", "", dict(model_flops=3.0 * jcells.gnn_flops(cfg, n, m, d_in),
                                       n_params=n_params, loop_mult=1.0, n_nodes=n, n_edges=m)
    if spec.family == "recsys":
        cfg = spec.model_config()
        f, d = cfg.n_sparse, cfg.embed_dim
        base = dict(n_params=cfg.n_params(), loop_mult=1.0)
        if sh.kind == "train":
            b = p["batch"]
            return "train", "", dict(base, model_flops=3.0 * jcells.recsys_flops(cfg, b),
                                     lookup_bytes=b * f * d * 4)
        if sh.kind == "serve":
            b = p["batch"]
            return "serve", "", dict(base, model_flops=jcells.recsys_flops(cfg, b),
                                     lookup_bytes=b * f * d * 4)
        nc = p["n_candidates"]
        return "retrieval", "", dict(base, model_flops=jcells.recsys_flops(cfg, 1) + 2.0 * nc * d,
                                     lookup_bytes=nc * d * 4)
    m_sym = 2 * p["edgefactor"] * (1 << p["scale"])
    return "bfs", "", dict(model_flops=2.0 * m_sym, n_edges=m_sym, loop_mult=8.0,
                           e_cap=jcells._round_up(int(4.0 * m_sym) // (rows * cols), 1024))


def test_catalogue_equals_reference():
    assert ALL == jcells.all_cells()
    assert len(ALL) == 43 and len(BUILT) == 38
    skips = [c for c, x in _cells("pod").items() if x.kind == "skip"]
    assert skips == [f"{a}/long_500k" for a in LM_ARCHS]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_cell_meta_equals_reference(name):
    am = AbstractMesh(*MESHES[name])
    for cid, cell in _cells(name).items():
        kind, reason, meta = _want(*cid.split("/"), am)
        assert (cell.kind, cell.skip_reason) == (kind, reason), cid
        assert cell.meta == meta, (cid, cell.meta, meta)
        assert all(type(cell.meta[k]) is type(v) for k, v in meta.items()), cid
        assert cell.cell_id == cid


@pytest.mark.parametrize("name", sorted(MESHES))
def test_cell_specs_place_every_argument(name):
    """One spec per argument leaf, every dimension divisible on the mesh,
    and every argument a meta tensor."""
    m = mesh.make_mesh(*MESHES[name])
    for cid, cell in _cells(name).items():
        if cell.kind == "skip":
            assert cell.fn is None and cell.args == ()
            continue
        assert len(cell.args) == len(cell.in_shardings), cid
        for arg, specs in zip(cell.args, cell.in_shardings):
            xs, sps = tree.leaves(arg), mesh.spec_leaves(specs)
            assert len(xs) == len(sps) and xs, cid
            for x, sp in zip(xs, sps):
                assert x.device.type == "meta", cid
                mesh.shard_shape(x.shape, sp, m)


# ---------------------------------------------------------------------------
# the cells' functions
# ---------------------------------------------------------------------------


def _same_shapes(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and x.dtype == y.dtype
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("cid", META_RUN)
def test_cell_runs_on_meta_arguments(cid):
    cell = _cells("2x2")[cid]
    out = cell.fn(*cell.args)
    assert all(x.device.type == "meta" for x in tree.leaves(out))
    if cell.kind in ("train", "graph_train"):
        state, metrics = out
        assert _same_shapes(state, cell.args[0])
        assert metrics["loss"].shape == () and metrics["loss"].dtype == torch.float32
    elif cell.kind == "graph_train_2d":
        loss, grads = out
        assert loss.shape == () and _same_shapes(grads, cell.args[0])
    elif cell.kind == "prefill":
        assert out.shape == (cell.args[1].shape[0], cell.args[0]["embed"].shape[0])
    elif cell.kind == "decode":
        logits, cache = out
        assert logits.shape == (cell.args[2].shape[0], cell.args[0]["embed"].shape[0])
        assert cache is cell.args[1]
    else:  # serve, retrieval: one score a row or candidate
        assert out.shape == cell.args[-1].shape[:1] and out.dtype == torch.float32


def _padded_blocks(bg, e_cap: int):
    pad = e_cap - bg.src_local.shape[-1]
    assert pad >= 0
    src = np.pad(bg.src_local, ((0, 0), (0, 0), (0, pad)), constant_values=bg.part.n_c)
    dst = np.pad(bg.dst_local, ((0, 0), (0, 0), (0, pad)), constant_values=bg.part.n_r)
    return torch.from_numpy(src), torch.from_numpy(dst)


@pytest.mark.parametrize("variant", ["baseline", "ecap15-bitmaponly"])
def test_graph500_cell_runs_at_test_size(variant):
    """graph500's cell at scale 12 (the least at which the 1.5x capacity of
    ``ecap15`` holds the largest block) on the (2, 2) mesh: parents and
    levels equal to JAX's single-device BFS on the same graph."""
    shape = cfgs.ShapeSpec("scale12", "bfs", {"scale": 12, "edgefactor": 16})
    cell = cells._graph500_cell(cfgs.get("graph500"), shape, mesh.make_mesh(*MESHES["2x2"]),
                                variant)
    edges = jkronecker.kronecker_edges(12, seed=1)
    bg = csr.partition_2d(builder.build_csr(edges, n=1 << 12), 2, 2)
    src, dst = _padded_blocks(bg, cell.meta["e_cap"])
    assert src.shape == cell.args[0].shape and src.dtype == cell.args[0].dtype
    parent, level, depth = cell.fn(src, dst, np.int32(17))
    jg = jbuilder.build_csr(edges, n=1 << 12)
    ref = jbfs.bfs(jnp.asarray(jg.src), jnp.asarray(jg.dst), jnp.int32(17), jg.n)
    np.testing.assert_array_equal(parent.numpy()[:jg.n], np.asarray(ref.parent))
    np.testing.assert_array_equal(level.numpy()[:jg.n], np.asarray(ref.level))
    assert (parent.numpy()[jg.n:] == -1).all() and depth == int(ref.n_levels)


@pytest.mark.parametrize("arch", ["gat-cora", "graphcast"])
def test_2d_cell_runs_at_test_size(arch):
    """The ``ogb_products`` cell's step (published widths, int8 payloads) on
    a 4,000-node graph at the (2, 2) mesh: its gradients have the
    parameters' shapes, GraphCast's loss is finite (the int8 GAT's is not,
    as in the reference: ROADMAP Queue 3), and GAT's loss and gradients
    equal, bit for bit, the 2D train step's on the grid's own sharding
    helpers (the cheaper arch checks the rank-major split both share)."""
    shape = cfgs.ShapeSpec("ogb_products_test", "graph_train",
                           {"n_nodes": 4000, "n_edges": 1200, "d_feat": 100,
                            "n_classes": 47, "dist": "2d"})
    m = mesh.make_mesh(*MESHES["2x2"])
    cell = cells._gnn_2d_cell(cfgs.get(arch), shape, m)
    rng = np.random.default_rng(0)
    g = builder.build_csr(rng.integers(0, 4000, (1200, 2)), n=4000)
    bg = csr.partition_2d(g, 2, 2)
    src, dst = _padded_blocks(bg, cell.meta["e_cap"])
    n_pad, s = bg.part.n, bg.part.chunk
    nf = rng.standard_normal((n_pad, 100)).astype(np.float32)
    pos = rng.standard_normal((n_pad, 3)).astype(np.float32)
    targets = rng.integers(0, 47, n_pad).astype(np.int32)
    cfg = cfgs.get(arch).model_config(d_in=100, d_out=47)
    if arch == "graphcast":
        cfg = dataclasses.replace(cfg, edge_state=False)
    params = gnn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    args = (params, torch.from_numpy(nf).reshape(2, 2, s, 100),
            torch.from_numpy(pos).reshape(2, 2, s, 3), src, dst,
            torch.from_numpy(targets).reshape(2, 2, s))
    assert all(_same_shapes(a, b) for a, b in zip(args, cell.args))
    loss, grads = cell.fn(*args)
    assert loss.shape == () and _same_shapes(grads, params)
    if arch == "graphcast":
        assert bool(torch.isfinite(loss))
        return
    grid = SimGrid(2, 2, "cpu")
    step = gnn_dist.build_2d_train_step(cfg, bg.part, gnn_dist.Dist2DConfig(True))
    want_loss, want_grads = step(grid, params, gnn_dist.shard_nodes(grid, nf, bg.part),
                                 gnn_dist.shard_edges(grid, src.numpy()),
                                 gnn_dist.shard_edges(grid, dst.numpy()),
                                 gnn_dist.shard_targets(grid, targets, bg.part))
    assert torch.equal(loss.nan_to_num(), want_loss.nan_to_num())
    for x, y in zip(tree.leaves(grads), tree.leaves(want_grads)):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


VARIANTS = [("deepseek-v2-236b", "train_4k", "bf16-fullremat-moepin-experttp"),
            ("gemma-2b", "decode_32k", "tpserve"),
            ("autoint", "serve_bulk", "modeltable-int8table"),
            ("graph500", "scale30", "ecap15-bitmaponly")]


@pytest.mark.parametrize("arch,shape,variant", VARIANTS)
def test_perf_variants_build(arch, shape, variant):
    """The variants of ``test_perf_variants_lower``: the placement each one
    changes, held against JAX's specs under the same change, and each run
    on its meta arguments (graph500's at a test size, above).  JAX 0.9
    cannot lower the deepseek-v2-236b one (ROADMAP Queue 3): its specs are
    held against ``param_specs`` directly."""
    m = mesh.make_mesh(*MESHES["2x2"])
    cell = cells.build_cell(arch, shape, m, variant=variant)
    base = cells.build_cell(arch, shape, m)
    if arch == "deepseek-v2-236b":
        jcfg = dataclasses.replace(jcfgs.get(arch).model_config(), param_dtype=jnp.bfloat16,
                                   moe_dp_axes=("data",), moe_tp_axis="model",
                                   expert_shard="ff")
        want = _spec_tree(jtfm.param_specs(jcfg, fsdp=("data",), tp="model"))
        assert cell.in_shardings[0].params == want != base.in_shardings[0].params
        state = cell.args[0]
        assert {x.dtype for x in tree.leaves(state.params)} == {torch.bfloat16}
        assert {x.dtype for x in tree.leaves(state.opt.m)} == {torch.float32}
    elif arch == "gemma-2b":
        jspecs = jtfm.param_specs(jcfgs.get(arch).model_config(), fsdp=("data",), tp="model")
        want = _spec_tree(jax.tree.map(lambda sp: P(*["model" if e == "model" else None
                                                      for e in sp]),
                                       jspecs, is_leaf=lambda x: isinstance(x, P)))
        assert cell.in_shardings[0] == want != base.in_shardings[0]
    elif arch == "autoint":
        jcfg = dataclasses.replace(jcfgs.get(arch).model_config(), table_quant=True)
        want = dict(_spec_tree(jrecsys.param_specs(jcfg, fsdp=("data",), tp="model")),
                    table=("model", None), table_scale=("model",))
        assert cell.in_shardings[0] == want
        assert cell.args[0]["table"].dtype == torch.int8
    else:
        m_sym = 2 * 16 * (1 << 30)
        assert cell.meta["e_cap"] == jcells._round_up(int(1.5 * m_sym) // 4, 1024)
        assert base.meta["e_cap"] == jcells._round_up(int(4.0 * m_sym) // 4, 1024)
        return
    out = cell.fn(*cell.args)
    assert all(x.device.type == "meta" for x in tree.leaves(out))


def test_roofline_terms_arithmetic():
    """``test_roofline_terms_arithmetic``'s case on the H100's constants,
    and the ratios equal the reference's on the same terms."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    kw = dict(compute_s=1.0, memory_s=2.0, collective_s=0.5, hlo_flops=1e12, hlo_bytes=1e12,
              collective_bytes=1e10, chips=256)
    t = roofline.RooflineTerms(model_flops=roofline.PEAK_FLOPS * 256, **kw)
    assert t.dominant == "memory" and t.bound_s == 2.0
    assert abs(t.roofline_fraction - 0.5) < 1e-9  # 1 s ideal / 2 s bound
    j = jroofline.RooflineTerms(model_flops=roofline.PEAK_FLOPS * 256, **kw)
    assert t.useful_flop_ratio == j.useful_flop_ratio
    for terms in ((3.0, 2.0, 1.0), (0.0, 0.0, 4.0), (0.0, 0.0, 0.0)):
        kw.update(zip(("compute_s", "memory_s", "collective_s"), terms))
        ours = roofline.RooflineTerms(model_flops=1e15, **kw)
        ref = jroofline.RooflineTerms(model_flops=1e15, **kw)
        assert (ours.dominant, ours.bound_s) == (ref.dominant, ref.bound_s)
        ideal = 1e15 / (256 * roofline.PEAK_FLOPS)
        assert ours.roofline_fraction == (ideal / ours.bound_s if ours.bound_s else 0.0)
    assert roofline.RooflineTerms(0, 0, 0, 0, 0, 0, 1.0, 1).useful_flop_ratio == 0.0
