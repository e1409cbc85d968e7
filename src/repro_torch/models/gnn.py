"""Graph neural networks via segment-sum message passing, in PyTorch.

The port's counterpart of ``repro/models/gnn.py`` for GraphCast and GAT:
every aggregator is a gather over an edge index followed by a segment
reduction over destinations (``index_add_`` / ``scatter_reduce_``).
Padding edges use the sentinel (src = dst = n) and fall into segment n,
which is dropped.

* ``graphcast`` — encode-process-decode stack of interaction networks
                  (edge MLP + node MLP + residual), sum aggregation.
* ``gat-cora``  — multi-head attention aggregation (SDDMM -> edge softmax
                  -> SpMM, all as segment ops).

Parameters are the reference's pytree as plain nested dicts and lists of
tensors, with the same keys and shapes: :func:`params_from_numpy` carries
the JAX package's parameters across, and :func:`init` makes new ones from
a ``torch.Generator`` (other numbers than ``jax.random`` from the same
seed).  :func:`loss_fn` is the node-level loss of the training step.  EGNN
and NequIP are not ported: :func:`init` and :func:`forward` (and so
:func:`loss_fn`) raise ``TypeError`` for them, as for any unknown config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device

Params = dict[str, Any]


class Graph(NamedTuple):
    """Static-shape graph batch. Padding edges: src = dst = n."""

    nf: torch.Tensor  # (n, d_in) node features
    src: torch.Tensor  # (m,) int32 or int64
    dst: torch.Tensor  # (m,)
    pos: torch.Tensor | None = None  # (n, 3) coordinates (EGNN / NequIP)

    @property
    def n(self) -> int:
        return self.nf.shape[0]

    @property
    def m(self) -> int:
        return self.src.shape[0]


def seg_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = vals.new_zeros((n + 1, *vals.shape[1:]))
    return out.index_add_(0, seg.long(), vals)[:n]


def seg_max(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Segment max; an empty segment gives -inf, as ``jax.ops.segment_max``."""
    out = vals.new_full((n + 1, *vals.shape[1:]), float("-inf"))
    idx = seg.long().reshape(-1, *([1] * (vals.dim() - 1))).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, "amax", include_self=True)[:n]


def segment_softmax(logits: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Numerically stable softmax over edges grouped by destination."""
    mx = seg_max(logits, seg, n)
    mx_full = torch.cat([mx, torch.zeros_like(mx[:1])])
    idx = torch.clamp(seg.long(), max=n)
    e = torch.exp(logits - mx_full[idx])
    denom = seg_sum(e, seg, n)
    denom_full = torch.cat([denom, torch.ones_like(denom[:1])])
    return e / torch.clamp(denom_full[idx], min=1e-16)


def _mlp_params(gen: torch.Generator, dims, device) -> list[dict]:
    return [
        {"w": (torch.randn((a, b), generator=gen) / a**0.5).to(device),
         "b": torch.zeros((b,), device=device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def _mlp(params, x: torch.Tensor) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            x = F.silu(x)
    return x


class _Gather(torch.autograd.Function):
    """``concat([h, 0])[idx]``, whose backward is one ``index_add_`` into
    the n + 1 rows, the sentinel row dropped.  Autograd's own backward of
    the indexing (``index_put_`` with accumulation) sums every padding
    edge's row into the sentinel row in one serial run: 82% of a
    full-width train step's device time on an H100 (PERF.md, the training
    cell)."""

    @staticmethod
    def forward(ctx, h, idx):
        ctx.save_for_backward(idx)
        ctx.n = h.shape[0]
        return torch.cat([h, torch.zeros_like(h[:1])], dim=0)[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.new_zeros((ctx.n + 1, *g.shape[1:])).index_add_(0, idx, g)[: ctx.n], None


def _gather(h: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sentinel-safe node gather (idx == n -> zeros)."""
    return _Gather.apply(h, torch.clamp(idx.long(), max=n))


# ---------------------------------------------------------------------------
# GraphCast-style interaction networks (encode-process-decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    d_in: int = 227  # n_vars
    d_out: int = 227
    mesh_refinement: int = 6
    edge_state: bool = True  # persistent edge features (off in the 2D path)


def init_graphcast(cfg: GraphCastConfig, gen: torch.Generator, device=None) -> Params:
    d = cfg.d_hidden
    return {
        "encoder": _mlp_params(gen, (cfg.d_in, d, d), device),
        "layers": [
            {"edge": _mlp_params(gen, (3 * d, d, d), device),
             "node": _mlp_params(gen, (2 * d, d, d), device)}
            for _ in range(cfg.n_layers)
        ],
        "decoder": _mlp_params(gen, (d, d, cfg.d_out), device),
    }


def graphcast_forward(cfg: GraphCastConfig, params: Params, g: Graph) -> torch.Tensor:
    n = g.n
    h = _mlp(params["encoder"], g.nf)
    ef = h.new_zeros((g.m, cfg.d_hidden))
    valid = (g.src < n)[:, None]
    for lyr in params["layers"]:
        hs, hd = _gather(h, g.src, n), _gather(h, g.dst, n)
        msg = _mlp(lyr["edge"], torch.cat([ef, hs, hd], -1)) * valid
        if cfg.edge_state:
            ef = ef + msg
            msg = ef
        agg = seg_sum(msg, g.dst, n)
        h = h + _mlp(lyr["node"], torch.cat([h, agg], -1))
    return _mlp(params["decoder"], h)


# ---------------------------------------------------------------------------
# GAT (attention aggregation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8  # per head
    n_heads: int = 8
    d_in: int = 1433
    d_out: int = 7
    negative_slope: float = 0.2


def init_gat(cfg: GATConfig, gen: torch.Generator, device=None) -> Params:
    layers = []
    d_prev = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.d_out if last else cfg.d_hidden
        layers.append({
            "w": (torch.randn((heads, d_prev, d_out), generator=gen) / d_prev**0.5).to(device),
            "a_src": (torch.randn((heads, d_out), generator=gen) * 0.1).to(device),
            "a_dst": (torch.randn((heads, d_out), generator=gen) * 0.1).to(device),
        })
        d_prev = heads * d_out
    return {"layers": layers}


def gat_forward(cfg: GATConfig, params: Params, g: Graph) -> torch.Tensor:
    n, h = g.n, g.nf
    for i, lyr in enumerate(params["layers"]):
        heads = lyr["w"].shape[0]
        z = torch.einsum("nd,hdo->nho", h, lyr["w"])  # (n, heads, d_out)
        # SDDMM: per-edge attention logits
        zs, zd = _gather(z, g.src, n), _gather(z, g.dst, n)
        logits = (torch.einsum("mho,ho->mh", zs, lyr["a_src"])
                  + torch.einsum("mho,ho->mh", zd, lyr["a_dst"]))
        logits = F.leaky_relu(logits, cfg.negative_slope)
        logits = torch.where((g.src < n)[:, None], logits, logits.new_tensor(-1e30))
        alpha = segment_softmax(logits, g.dst, n)  # per head: the reference vmaps
        msg = alpha[..., None] * zs  # (m, heads, d_out)
        agg = seg_sum(msg.reshape(g.m, -1), g.dst, n).reshape(n, heads, -1)
        h = agg.reshape(n, -1)
        if i < len(params["layers"]) - 1:
            h = F.elu(h)
    return h


# ---------------------------------------------------------------------------
# unified facade
# ---------------------------------------------------------------------------


def init(cfg, gen: torch.Generator, device=None) -> Params:
    """New parameters from ``gen`` (a CPU generator), on ``device``
    (``None`` means ``cuda``)."""
    device = resolve_device(device)
    if isinstance(cfg, GraphCastConfig):
        return init_graphcast(cfg, gen, device)
    if isinstance(cfg, GATConfig):
        return init_gat(cfg, gen, device)
    raise TypeError(type(cfg))


def forward(cfg, params: Params, g: Graph) -> torch.Tensor:
    if isinstance(cfg, GraphCastConfig):
        return graphcast_forward(cfg, params, g)
    if isinstance(cfg, GATConfig):
        return gat_forward(cfg, params, g)
    raise TypeError(type(cfg))


def loss_fn(cfg, params: Params, batch) -> torch.Tensor:
    """Node-level loss: cross-entropy (over ``log_softmax`` in float32) when
    the targets are integers, else MSE; ``batch["mask"]``, where given,
    weights the nodes as in the reference.  ``batch["graph"]`` is a
    :class:`Graph`.  EGNN and NequIP raise ``TypeError`` in :func:`forward`."""
    g: Graph = batch["graph"]
    out = forward(cfg, params, g)
    tgt = batch["targets"]
    mask = batch.get("mask")
    if not tgt.is_floating_point():
        logp = F.log_softmax(out.to(torch.float32), -1)
        nll = -logp.gather(1, tgt.long()[:, None])[:, 0]
        if mask is not None:
            return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)
        return nll.mean()
    err = (out.to(torch.float32) - tgt) ** 2
    if mask is not None:
        return (torch.sum(err * mask[:, None])
                / torch.clamp(mask.sum() * err.shape[-1], min=1))
    return err.mean()


def params_from_numpy(tree, device=None):
    """The reference's parameter pytree (nested dicts and lists of arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the same tree of float32
    tensors on ``device`` (``None`` means ``cuda``)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
