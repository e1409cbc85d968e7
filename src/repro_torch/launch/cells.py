"""Cell catalogue: (arch x shape x mesh) -> the port's step, its arguments
as shapes, their placement specs and the analytic meta.

The port's counterpart of ``repro/launch/cells.py``: the same 43
``(arch, shape)`` pairs in the same order (38 built, and ``long_500k`` a
skip for each of the 5 LM archs), the same FLOP models and ``meta``.
:func:`build_cell` returns

* ``fn``           -- the port's step for the cell's kind: for the
                      AutoInt and the single-device GNN cells the
                      single-device step at the global shapes; for the LM
                      train cells the sharded train step
                      (:func:`repro_torch.train.step.make_sharded_train_step`)
                      and for the LM prefill and decode cells the sharded
                      serving program
                      (:mod:`repro_torch.models.transformer_sharded`), each
                      under the cell's param specs; for
                      ``ogb_products`` (``dist="2d"``) the 2D train step
                      (:func:`repro_torch.models.gnn_dist.build_2d_train_step`)
                      and for graph500 the distributed BFS
                      (:func:`repro_torch.core.distributed_bfs.build_bfs`),
                      all on a :class:`~repro_torch.comm.SimGrid` of
                      :func:`~repro_torch.launch.mesh.grid_rows_cols` on the
                      arguments' device, or on the grid of their ``grid=``
                      keyword;
* ``args``         -- tensors on ``torch.device("meta")``: shape and dtype,
                      never storage (the counterpart of
                      ``jax.ShapeDtypeStruct``);
* ``in_shardings`` -- one placement spec tree per argument
                      (:mod:`repro_torch.launch.mesh`; the counterpart of
                      the ``NamedSharding`` trees): the models' param specs,
                      and for the 2D and BFS cells the grid's rank-major
                      layout, their data arguments carrying leading
                      ``(*fsdp axes, model)`` dims of which ``fn`` hands
                      grid rank ``p = i*C + j`` the ``[i, j]`` slice;
* ``meta``         -- analytic MODEL_FLOPS, parameter counts, the loop
                      multiplier and the sizes, as the reference reckons them.

The variants are the reference's substrings (``bf16``, ``moegroup256``,
``noremat``, ``dotsave``, ``moepin``, ``experttp``, ``tpserve``,
``int8table``, ``modeltable``, ``ecap15``, ``bitmaponly``), each changing
what it changes there.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.comm import SimGrid
from repro_torch.configs import common as cfgs
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.core.csr import Partition2D
from repro_torch.data.graphs import sampled_shape
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import gnn, gnn_dist, recsys
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable | None = None
    args: tuple = ()
    in_shardings: Any = None
    meta: dict = dataclasses.field(default_factory=dict)
    skip_reason: str = ""

    @property
    def cell_id(self) -> str:
        return f"{self.arch_id}/{self.shape_name}"


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _replicated(params):
    return tree.tree_map(lambda _: (), params)


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# analytic FLOPs (MODEL_FLOPS for the roofline: useful work, global)
# ---------------------------------------------------------------------------


def lm_train_flops(cfg: tfm.TransformerConfig, batch: int, seq: int) -> float:
    tokens = batch * seq
    dense = 6.0 * cfg.n_active_params() * tokens
    attn_fwd = batch * cfg.n_layers * cfg.n_heads * seq * seq * (
        cfg.qk_head_dim + (cfg.v_head_dim if cfg.use_mla else cfg.head_dim)
    )
    return dense + 3.0 * attn_fwd


def lm_prefill_flops(cfg: tfm.TransformerConfig, batch: int, seq: int) -> float:
    tokens = batch * seq
    dense = 2.0 * cfg.n_active_params() * tokens
    attn = batch * cfg.n_layers * cfg.n_heads * seq * seq * (
        cfg.qk_head_dim + (cfg.v_head_dim if cfg.use_mla else cfg.head_dim)
    )
    return dense + attn


def lm_decode_flops(cfg: tfm.TransformerConfig, batch: int, seq: int) -> float:
    dense = 2.0 * cfg.n_active_params() * batch
    if cfg.use_mla:  # absorbed decode reads the latent cache
        attn = 2.0 * batch * cfg.n_layers * cfg.n_heads * seq * (
            cfg.kv_lora_rank + cfg.qk_rope_dim
        ) * 2
    else:
        attn = 2.0 * batch * cfg.n_layers * cfg.n_heads * seq * 2 * cfg.head_dim
    return dense + attn


def _mlp_flops(dims: tuple[int, ...]) -> float:
    return 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def gnn_flops(cfg, n: int, m: int, d_in: int) -> float:
    if isinstance(cfg, gnn.GraphCastConfig):
        d = cfg.d_hidden
        per_layer = m * _mlp_flops((3 * d, d, d)) + n * _mlp_flops((2 * d, d, d))
        return cfg.n_layers * per_layer + n * (
            _mlp_flops((d_in, d, d)) + _mlp_flops((d, d, cfg.d_out))
        )
    if isinstance(cfg, gnn.GATConfig):
        f = 0.0
        d_prev = d_in
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            heads = 1 if last else cfg.n_heads
            d_o = cfg.d_out if last else cfg.d_hidden
            f += 2.0 * n * heads * d_prev * d_o + 6.0 * m * heads * d_o
            d_prev = heads * d_o
        return f
    if isinstance(cfg, gnn.EGNNConfig):
        d = cfg.d_hidden
        per_layer = m * (_mlp_flops((2 * d + 1, d, d)) + _mlp_flops((d, d, 1))) + n * _mlp_flops(
            (2 * d, d, d)
        )
        return cfg.n_layers * per_layer + n * (
            _mlp_flops((cfg.d_in, d)) + _mlp_flops((d, cfg.d_out))
        )
    if isinstance(cfg, gnn.NequIPConfig):
        c = cfg.d_hidden
        # radial MLP + tensor-product paths (13c floats/node state)
        per_edge = _mlp_flops((cfg.n_rbf, c, 3 * c)) + 2.0 * 13 * c * 9
        per_node = 2.0 * 3 * c * c + _mlp_flops((c, 2 * c))
        return cfg.n_layers * (m * per_edge + n * per_node)
    raise TypeError(type(cfg))


def recsys_flops(cfg: recsys.AutoIntConfig, batch: int) -> float:
    f, d, da, h = cfg.n_sparse, cfg.embed_dim, cfg.d_attn, cfg.n_heads
    flops = 0.0
    d_prev = d
    for _ in range(cfg.n_attn_layers):
        flops += batch * (
            3 * 2 * f * h * d_prev * da + 2 * 2 * h * f * f * da + 2 * f * d_prev * h * da
        )
        d_prev = h * da
    dims = (f * d_prev,) + cfg.mlp_dims + (1,)
    flops += batch * _mlp_flops(dims)
    return flops


# ---------------------------------------------------------------------------
# the grid of the 2D and BFS cells
# ---------------------------------------------------------------------------


def make_grid(mesh: Mesh, device) -> SimGrid:
    """The mesh's 2D grid on ``device``: grid row ``i`` folds the FSDP axes
    row-major, column ``j`` is ``model``.  The 2D, BFS and LM serving cells'
    ``fn`` runs on this grid, or on the one its ``grid=`` keyword names (the
    dry-run passes one whose collectives it counts)."""
    rows, cols = meshlib.grid_rows_cols(mesh)
    fsdp = meshlib.fsdp_axes(mesh)
    fold = None if fsdp == ("data",) else {a: mesh.shape[a] for a in fsdp}
    return SimGrid(rows, cols, device, row_fold=fold)


def _per_rank(grid: SimGrid, x: torch.Tensor, lead: int) -> list:
    """(*grid dims, ...) -> the per-rank list, rank ``p`` the ``p``-th
    slice of the grid dims taken row-major."""
    flat = x.reshape(grid.size, *x.shape[lead:])
    return [flat[p] for p in range(grid.size)]


def _train_2d(mesh: Mesh, step, params, nf, pos, src, dst, targets, *, grid=None):
    """The 2D train step over per-rank slices of the rank-major arguments
    -> (loss, grads)."""
    grid = grid or make_grid(mesh, nf.device)
    lead = len(mesh.axis_names)
    ranks = functools.partial(_per_rank, grid, lead=lead)
    return step(grid, params, ranks(nf), [x.long() for x in ranks(src)],
                [x.long() for x in ranks(dst)], [x.long() for x in ranks(targets)],
                pos=ranks(pos))


def _bfs(mesh: Mesh, part: Partition2D, bcfg: dbfs.DistBFSConfig, src, dst, root, *,
         grid=None):
    """The distributed BFS over per-rank slices of the rank-major edge
    blocks -> (parent, level, n_levels); ``root`` is read on the host (on
    ``meta`` one level runs: :mod:`repro_torch.core.distributed_bfs`)."""
    grid = grid or make_grid(mesh, src.device)
    lead = len(mesh.axis_names)
    fn = dbfs.build_bfs(grid, part, bcfg)
    return fn(_per_rank(grid, src, lead), _per_rank(grid, dst, lead), root)


def _lm_train(mesh: Mesh, cfg, specs, opt_cfg, state, batch, *, grid=None, layers=None):
    """The sharded train step (:func:`repro_torch.train.step.make_sharded_train_step`)
    on each rank's slices of the global state (params, ``m`` and ``v``
    placed alike) and its rows of the batch -> (the global new state, the
    metrics).  ``layers``: run only the first that many (the dry-run)."""
    grid = grid or make_grid(mesh, batch["tokens"].device)
    step = tstep.make_sharded_train_step(cfg, grid, specs, opt_cfg, layers=layers)
    states, metrics = step(tstep.shard_state(cfg, grid, state, specs),
                           tsh.shard_rows(grid, batch["tokens"]))
    return tstep.gather_state(grid, states, specs), metrics


def _lm_prefill(mesh: Mesh, cfg, specs, params, tokens, *, grid=None, layers=None):
    """The sharded prefill (:func:`repro_torch.models.transformer_sharded.prefill`)
    over each rank's slices of the global arguments -> the global
    last-position logits (B, V_pad).  ``layers``: run only the first that
    many (the dry-run counts one layer and scales)."""
    grid = grid or make_grid(mesh, tokens.device)
    out = tsh.prefill(cfg, grid, tsh.shard_params(cfg, params, grid, specs),
                      tsh.shard_rows(grid, tokens), specs, layers=layers)
    return tsh.assemble(grid, out)


def _lm_decode(mesh: Mesh, cfg, specs, params, cache, tokens, pos, *, grid=None, layers=None):
    """One sharded decode step (:func:`repro_torch.models.transformer_sharded.decode_step`)
    -> (the global logits (B, V_pad), ``cache``, its ranks' blocks written
    in place)."""
    grid = grid or make_grid(mesh, tokens.device)
    logits = tsh.decode_step(cfg, grid, tsh.shard_params(cfg, params, grid, specs),
                             tsh.shard_cache(grid, cache), tsh.shard_rows(grid, tokens),
                             tsh.shard_rows(grid, pos), specs, layers=layers)
    return tsh.assemble(grid, logits), cache


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_cell(spec: cfgs.ArchSpec, shape: cfgs.ShapeSpec, mesh: Mesh,
             variant: str = "baseline") -> Cell:
    cfg: tfm.TransformerConfig = spec.model_config()
    fsdp = meshlib.fsdp_axes(mesh)
    # --- the reference's perf variants ---------------------------------------
    if "bf16" in variant:  # bf16 param storage (fp32 Adam moments kept)
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    if "moegroup256" in variant and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_group=256)
    if "noremat" in variant:
        cfg = dataclasses.replace(cfg, remat=False)
    if "dotsave" in variant:
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    if "moepin" in variant and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_dp_axes=fsdp, moe_tp_axis="model")
    if "experttp" in variant and cfg.is_moe:
        cfg = dataclasses.replace(cfg, expert_shard="ff")
    serve_fsdp = () if "tpserve" in variant else fsdp  # TP-only serving params
    # ---------------------------------------------------------------------------
    p_specs = tfm.param_specs(cfg, fsdp=fsdp, tp="model")
    batch = shape.params["global_batch"]
    seq = shape.params["seq_len"]
    dp = fsdp if len(fsdp) > 1 else fsdp[0]
    params = tfm.init_params(cfg, _gen(), META)

    if shape.kind == "train":
        state_specs = tstep.TrainState(
            params=p_specs, opt=adamw.OptState(step=(), m=p_specs, v=p_specs), ef=None)
        return Cell(
            spec.arch_id, shape.name, "train",
            fn=functools.partial(_lm_train, mesh, cfg, p_specs, adamw.AdamWConfig()),
            args=(tstep.init_state(params), {"tokens": _sds((batch, seq), torch.int32)}),
            in_shardings=(state_specs, {"tokens": (dp, None)}),
            meta=dict(
                model_flops=lm_train_flops(cfg, batch, seq),
                n_params=cfg.n_params(),
                n_active=cfg.n_active_params(),
                loop_mult=float(cfg.n_layers),
            ),
        )

    if shape.kind in ("prefill", "decode") and not serve_fsdp:
        # serving layout: weights TP-sharded and replicated over the data
        # axes, no per-step FSDP all-gather on the latency path
        p_specs = tsh.tp_only(p_specs)
    if shape.kind == "prefill":
        return Cell(
            spec.arch_id, shape.name, "prefill",
            fn=functools.partial(_lm_prefill, mesh, cfg, p_specs),
            args=(params, _sds((batch, seq), torch.int32)),
            in_shardings=(p_specs, (dp, None)),
            meta=dict(
                model_flops=lm_prefill_flops(cfg, batch, seq),
                n_params=cfg.n_params(),
                loop_mult=float(cfg.n_layers),
            ),
        )

    if shape.kind == "decode":
        cache = _sds((cfg.n_layers, batch, seq, cfg.cache_width), cfg.compute_dtype)
        return Cell(
            spec.arch_id, shape.name, "decode",
            fn=functools.partial(_lm_decode, mesh, cfg, p_specs),
            args=(params, cache, _sds((batch,), torch.int32), _sds((batch,), torch.int32)),
            in_shardings=(p_specs, tfm.cache_spec(fsdp=fsdp, tp="model"), (dp,), (dp,)),
            meta=dict(
                model_flops=lm_decode_flops(cfg, batch, seq),
                n_params=cfg.n_params(),
                cache_bytes=cfg.n_layers * batch * seq * cfg.cache_width
                * cfg.compute_dtype.itemsize,
                loop_mult=float(cfg.n_layers),
            ),
        )
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_cell(spec: cfgs.ArchSpec, shape: cfgs.ShapeSpec, mesh: Mesh) -> Cell:
    p = shape.params
    dist = p["dist"]
    fsdp = meshlib.fsdp_axes(mesh)
    dp = fsdp if len(fsdp) > 1 else fsdp[0]

    if dist == "2d":
        return _gnn_2d_cell(spec, shape, mesh)

    if dist == "batched":
        n = p["n_nodes"] * p["batch"]
        m = p["n_edges"] * p["batch"]
    elif dist == "sampled":
        n, m = sampled_shape(p["batch_nodes"], p["fanout"])
    else:
        n, m = p["n_nodes"], p["n_edges"]
    d_in, n_classes = p["d_feat"], p["n_classes"]
    cfg = spec.model_config(d_in=d_in, d_out=n_classes)
    if isinstance(cfg, gnn.GraphCastConfig):
        cfg = dataclasses.replace(cfg, edge_state=dist not in ("2d",))

    params = gnn.init(cfg, _gen(), META)
    step_fn = tstep.make_train_step(functools.partial(gnn.loss_fn, cfg), adamw.AdamWConfig())
    rep = _replicated(params)
    state_specs = tstep.TrainState(params=rep, opt=adamw.OptState(step=(), m=rep, v=rep),
                                   ef=None)
    # nodes/edges sharded over the data axes when divisible, else replicated
    dp_prod = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        dp_prod *= mesh.shape[a]
    node_ax = dp if n % dp_prod == 0 else None
    edge_ax = dp if m % dp_prod == 0 else None

    graph = gnn.Graph(nf=_sds((n, d_in), torch.float32), src=_sds((m,), torch.int32),
                      dst=_sds((m,), torch.int32), pos=_sds((n, 3), torch.float32))
    graph_specs = gnn.Graph(nf=(node_ax, None), src=(edge_ax,), dst=(edge_ax,),
                            pos=(node_ax, None))
    batch = {"graph": graph, "targets": _sds((n,), torch.int32)}
    batch_specs = {"graph": graph_specs, "targets": (node_ax,)}
    return Cell(
        spec.arch_id, shape.name, "graph_train",
        fn=step_fn,
        args=(tstep.init_state(params), batch),
        in_shardings=(state_specs, batch_specs),
        meta=dict(
            model_flops=3.0 * gnn_flops(cfg, n, m, d_in),
            n_params=sum(x.numel() for x in tree.leaves(params)),
            loop_mult=1.0,
            n_nodes=n,
            n_edges=m,
        ),
    )


def _gnn_2d_cell(spec: cfgs.ArchSpec, shape: cfgs.ShapeSpec, mesh: Mesh) -> Cell:
    p = shape.params
    rows, cols = meshlib.grid_rows_cols(mesh)
    n_pad = _round_up(p["n_nodes"], rows * cols * 1024)
    part = Partition2D(n=n_pad, n_orig=p["n_nodes"], rows=rows, cols=cols)
    e_cap = _round_up(2 * p["n_edges"] // (rows * cols), 1024)
    d_in, n_classes = p["d_feat"], p["n_classes"]
    cfg = spec.model_config(d_in=d_in, d_out=n_classes)
    if isinstance(cfg, gnn.GraphCastConfig):
        cfg = dataclasses.replace(cfg, edge_state=False)
    dcfg = gnn_dist.Dist2DConfig(quantize_payload=spec.arch_id in ("graphcast", "gat-cora"))
    step = gnn_dist.build_2d_train_step(cfg, part, dcfg)
    params = gnn.init(cfg, _gen(), META)
    s = part.chunk
    axes = meshlib.fsdp_axes(mesh) + ("model",)
    ax_sizes = tuple(mesh.shape[a] for a in axes)
    own, own_flat = (*axes, None), axes
    return Cell(
        spec.arch_id, shape.name, "graph_train_2d",
        fn=functools.partial(_train_2d, mesh, step),
        args=(
            params,
            _sds(ax_sizes + (s, d_in), torch.float32),
            _sds(ax_sizes + (s, 3), torch.float32),
            _sds(ax_sizes + (e_cap,), torch.int32),
            _sds(ax_sizes + (e_cap,), torch.int32),
            _sds(ax_sizes + (s,), torch.int32),
        ),
        # params replicated; data arrays owner-chunk / block per rank
        in_shardings=(_replicated(params), own, own, own, own, own_flat),
        meta=dict(
            model_flops=3.0 * gnn_flops(cfg, p["n_nodes"], p["n_edges"], d_in),
            n_params=sum(x.numel() for x in tree.leaves(params)),
            loop_mult=1.0,
            n_nodes=p["n_nodes"],
            n_edges=p["n_edges"],
            e_cap=e_cap,
        ),
    )


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------


def _recsys_cell(spec: cfgs.ArchSpec, shape: cfgs.ShapeSpec, mesh: Mesh,
                 variant: str = "baseline") -> Cell:
    cfg: recsys.AutoIntConfig = spec.model_config()
    fsdp = meshlib.fsdp_axes(mesh)
    all_axes = fsdp + ("model",)
    p_specs = recsys.param_specs(cfg, fsdp=fsdp, tp="model")
    if "int8table" in variant:
        cfg = dataclasses.replace(cfg, table_quant=True)
        p_specs = dict(recsys.param_specs(cfg, fsdp=fsdp, tp="model"),
                       table_scale=(fsdp + ("model",),))
    if "modeltable" in variant:
        # table rows over 'model' only (replicated across the data axes)
        p_specs = dict(p_specs, table=("model", None))
        if "int8table" in variant:
            p_specs = dict(p_specs, table_scale=("model",))
    params = recsys.init_params(cfg, _gen(), device=META)
    f = cfg.n_sparse

    if shape.kind == "train":
        b = shape.params["batch"]
        step_fn = tstep.make_train_step(functools.partial(recsys.loss_fn, cfg),
                                        adamw.AdamWConfig())
        state_specs = tstep.TrainState(
            params=p_specs, opt=adamw.OptState(step=(), m=p_specs, v=p_specs), ef=None)
        batch = {"ids": _sds((b, f), torch.int32), "labels": _sds((b,), torch.float32)}
        return Cell(
            spec.arch_id, shape.name, "train",
            fn=step_fn,
            args=(tstep.init_state(params), batch),
            in_shardings=(state_specs, {"ids": (all_axes, None), "labels": (all_axes,)}),
            meta=dict(
                model_flops=3.0 * recsys_flops(cfg, b),
                n_params=cfg.n_params(),
                lookup_bytes=b * f * cfg.embed_dim * 4,
                loop_mult=1.0,
            ),
        )

    if shape.kind == "serve":
        b = shape.params["batch"]
        return Cell(
            spec.arch_id, shape.name, "serve",
            fn=functools.partial(recsys.forward, cfg),
            args=(params, _sds((b, f), torch.int32)),
            in_shardings=(p_specs, (all_axes, None)),
            meta=dict(
                model_flops=recsys_flops(cfg, b),
                n_params=cfg.n_params(),
                lookup_bytes=b * f * cfg.embed_dim * 4,
                loop_mult=1.0,
            ),
        )

    if shape.kind == "retrieval":
        nc = shape.params["n_candidates"]
        nc_pad = _round_up(nc, mesh.size)
        return Cell(
            spec.arch_id, shape.name, "retrieval",
            fn=functools.partial(recsys.retrieval_scores, cfg),
            args=(params, _sds((1, f), torch.int32), _sds((nc_pad,), torch.int32)),
            in_shardings=(p_specs, (None, None), (all_axes,)),
            meta=dict(
                model_flops=recsys_flops(cfg, 1) + 2.0 * nc * cfg.embed_dim,
                n_params=cfg.n_params(),
                lookup_bytes=nc * cfg.embed_dim * 4,
                loop_mult=1.0,
            ),
        )
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# graph500 (the paper's workload)
# ---------------------------------------------------------------------------


def _graph500_cell(spec: cfgs.ArchSpec, shape: cfgs.ShapeSpec, mesh: Mesh,
                   variant: str = "baseline") -> Cell:
    cfg = spec.model_config()
    scale, ef = shape.params["scale"], shape.params["edgefactor"]
    rows, cols = meshlib.grid_rows_cols(mesh)
    n = _round_up(1 << scale, rows * cols * 1024)
    part = Partition2D(n=n, n_orig=1 << scale, rows=rows, cols=cols)
    m_sym = 2 * ef * (1 << scale)
    # baseline: 4x the mean block capacity (RMAT-skew headroom); the
    # variant 'ecap15': 1.5x, the measured block imbalance of label-permuted
    # RMAT graphs
    skew = 1.5 if "ecap15" in variant else 4.0
    e_cap = _round_up(int(skew * m_sym) // (rows * cols), 1024)
    row_axes = meshlib.fsdp_axes(mesh)
    mode = "bitmap" if "bitmaponly" in variant else cfg.mode
    bcfg = dbfs.DistBFSConfig(row_axes=row_axes, mode=mode)
    ax_sizes = tuple(mesh.shape[a] for a in row_axes + ("model",))
    blk = _sds(ax_sizes + (e_cap,), torch.int32)
    blk_spec = (*row_axes, "model", None)
    return Cell(
        spec.arch_id, shape.name, "bfs",
        fn=functools.partial(_bfs, mesh, part, bcfg),
        args=(blk, blk, _sds((), torch.int32)),
        in_shardings=(blk_spec, blk_spec, ()),
        meta=dict(
            model_flops=2.0 * m_sym,  # one compare+select per directed edge
            n_edges=m_sym,
            e_cap=e_cap,
            loop_mult=8.0,  # typical RMAT BFS depth
        ),
    )


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, mesh: Mesh, variant: str = "baseline") -> Cell:
    spec = cfgs.get(arch_id)
    shape = spec.shape(shape_name)
    if shape.kind == "skip":
        return Cell(arch_id, shape_name, "skip", skip_reason=shape.skip_reason)
    if spec.family == "lm":
        return _lm_cell(spec, shape, mesh, variant)
    if spec.family == "gnn":
        return _gnn_cell(spec, shape, mesh)
    if spec.family == "recsys":
        return _recsys_cell(spec, shape, mesh, variant)
    if spec.family == "graph":
        return _graph500_cell(spec, shape, mesh, variant)
    raise ValueError(spec.family)


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch in cfgs.list_archs():
        for shape in cfgs.get(arch).shapes:
            out.append((arch, shape.name))
    return out
