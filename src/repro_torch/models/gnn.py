"""Graph neural networks via segment-sum message passing, in PyTorch.

The port's counterpart of ``repro/models/gnn.py``: every aggregator is a
gather over an edge index followed by a segment reduction over
destinations (``index_add_`` / ``scatter_reduce_``).  Padding edges use the
sentinel (src = dst = n) and fall into segment n, which is dropped.

* ``graphcast`` — encode-process-decode stack of interaction networks
                  (edge MLP + node MLP + residual), sum aggregation.
* ``gat-cora``  — multi-head attention aggregation (SDDMM -> edge softmax
                  -> SpMM, all as segment ops).
* ``egnn``      — E(n)-equivariant: messages from invariants (h_i, h_j,
                  |x_i - x_j|^2), coordinate updates along displacements.
* ``nequip``    — E(3)-equivariant l<=2 tensor-product convolutions
                  (see :mod:`repro_torch.models.irreps`).

EGNN and NequIP read the graph's ``pos`` (n, 3).  Parameters are the
reference's pytree as plain nested dicts and lists of tensors, with the
same keys and shapes: :func:`params_from_numpy` carries the JAX package's
parameters across, and :func:`init` makes new ones from a
``torch.Generator`` (other numbers than ``jax.random`` from the same
seed).  :func:`loss_fn` is the node-level loss of the training step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import irreps as ir

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
# EGNN (E(n)-equivariant)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    d_out: int = 16


def init_egnn(cfg: EGNNConfig, gen: torch.Generator, device=None) -> Params:
    d = cfg.d_hidden
    return {
        "embed": _mlp_params(gen, (cfg.d_in, d), device),
        "layers": [
            {"edge": _mlp_params(gen, (2 * d + 1, d, d), device),
             "coord": _mlp_params(gen, (d, d, 1), device),
             "node": _mlp_params(gen, (2 * d, d, d), device)}
            for _ in range(cfg.n_layers)
        ],
        "out": _mlp_params(gen, (d, cfg.d_out), device),
    }


def egnn_forward(cfg: EGNNConfig, params: Params, g: Graph):
    """Returns (node outputs (n, d_out), updated coordinates (n, 3))."""
    if g.pos is None:
        raise ValueError("egnn_forward: the graph has no pos")
    n = g.n
    h = _mlp(params["embed"], g.nf)
    x = g.pos
    valid = (g.src < n)[:, None]
    deg = torch.clamp(seg_sum(valid.to(x.dtype), g.dst, n), min=1.0)
    for lyr in params["layers"]:
        hs, hd = _gather(h, g.src, n), _gather(h, g.dst, n)
        xs, xd = _gather(x, g.src, n), _gather(x, g.dst, n)
        diff = xd - xs
        d2 = torch.sum(diff * diff, -1, keepdim=True)
        m_ij = _mlp(lyr["edge"], torch.cat([hs, hd, d2], -1)) * valid
        # E(n) coordinate update: x_i += mean_j (x_i - x_j) * phi_x(m_ij)
        w = torch.tanh(_mlp(lyr["coord"], m_ij))  # bounded for stability
        x = x + seg_sum(-diff * w * valid, g.dst, n) / deg
        agg = seg_sum(m_ij, g.dst, n)
        h = h + _mlp(lyr["node"], torch.cat([h, agg], -1))
    return _mlp(params["out"], h), x


# ---------------------------------------------------------------------------
# NequIP (E(3)-equivariant tensor-product convolutions, l <= 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32  # channels per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16  # species embedding width
    d_out: int = 1  # per-atom energy


def init_nequip(cfg: NequIPConfig, gen: torch.Generator, device=None) -> Params:
    c = cfg.d_hidden

    def square():
        return (torch.randn((c, c), generator=gen) / c**0.5).to(device)

    layers = [
        {
            # radial MLP -> per-path weights (3 paths x channels)
            "radial": _mlp_params(gen, (cfg.n_rbf, c, 3 * c), device),
            "w_s": square(), "w_v": square(), "w_t": square(),
            "gate": _mlp_params(gen, (c, 2 * c), device),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "embed": _mlp_params(gen, (cfg.d_in, c), device),
        "layers": layers,
        "readout": _mlp_params(gen, (c, c, cfg.d_out), device),
    }


def nequip_messages(w: torch.Tensor, s: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                    y1: torch.Tensor, y2: torch.Tensor, c: int):
    """The tensor-product messages of one NequIP layer: the source
    features (s (m, c), v (m, c, 3), t (m, c, 3, 3)) (x) the edge's
    harmonics (y1 (m, 3), y2 (m, 3, 3)), weighted per path by the radial
    MLP's ``w`` (m, 3c).  Returns (m_s, m_v, m_t)."""
    w0, w1, w2 = w[:, :c], w[:, c: 2 * c], w[:, 2 * c:]
    m_s = w0 * (s + ir.p_vv_s(v, y1[:, None, :]))  # 0x0->0, 1x1->0
    m_v = w1[..., None] * (
        s[..., None] * y1[:, None, :]  # 0x1->1
        + v  # 0(r)x1 identity path
        + ir.p_tv_v(t, y1[:, None, :])  # 2x1->1
    )
    m_t = w2[..., None, None] * (
        s[..., None, None] * y2[:, None]  # 0x2->2
        + ir.p_vv_t(v, y1[:, None, :])  # 1x1->2
        + t  # identity path
    )
    return m_s, m_v, m_t


def nequip_update(lyr, feats: ir.Irreps, agg: ir.Irreps, c: int) -> ir.Irreps:
    """One NequIP layer's self-interaction, gate and residual on the
    aggregated messages."""
    mixed = ir.linear(agg, lyr["w_s"], lyr["w_v"], lyr["w_t"])
    gates = _mlp(lyr["gate"], mixed.s)
    out = ir.gate(mixed, gates[:, :c], gates[:, c:])
    return ir.Irreps(s=feats.s + out.s, v=feats.v + out.v, t=feats.t + out.t)


def edge_geometry(xs: torch.Tensor, xd: torch.Tensor):
    """(r (m,), y1 (m, 3), y2 (m, 3, 3)) of the displacements xd - xs."""
    disp = xd - xs
    r = torch.sqrt(torch.sum(disp * disp, -1) + 1e-12)
    rhat = disp / r[:, None]
    return r, ir.sph_l1(rhat), ir.sph_l2(rhat)


def nequip_forward(cfg: NequIPConfig, params: Params, g: Graph) -> torch.Tensor:
    """Per-node scalar outputs (invariant); internal features are l<=2."""
    if g.pos is None:
        raise ValueError("nequip_forward: the graph has no pos")
    n, c = g.n, cfg.d_hidden
    s = _mlp(params["embed"], g.nf)
    feats = ir.Irreps(s=s, v=s.new_zeros((n, c, 3)), t=s.new_zeros((n, c, 3, 3)))
    valid_e = g.src < n
    r, y1, y2 = edge_geometry(_gather(g.pos, g.src, n), _gather(g.pos, g.dst, n))
    rbf = ir.bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * valid_e[:, None]

    for lyr in params["layers"]:
        w = _mlp(lyr["radial"], rbf)  # (m, 3c)
        hs = ir.Irreps(
            s=_gather(feats.s, g.src, n),
            v=_gather(feats.v.reshape(n, -1), g.src, n).reshape(-1, c, 3),
            t=_gather(feats.t.reshape(n, -1), g.src, n).reshape(-1, c, 3, 3),
        )
        # tensor-product messages: neighbor features (x) SH(rhat), radial-weighted
        m_s, m_v, m_t = nequip_messages(w, hs.s, hs.v, hs.t, y1, y2, c)
        agg = ir.Irreps(
            s=seg_sum(m_s, g.dst, n),
            v=seg_sum(m_v.reshape(g.m, -1), g.dst, n).reshape(n, c, 3),
            t=seg_sum(m_t.reshape(g.m, -1), g.dst, n).reshape(n, c, 3, 3),
        )
        feats = nequip_update(lyr, feats, agg, c)
    return _mlp(params["readout"], feats.s)


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
    if isinstance(cfg, EGNNConfig):
        return init_egnn(cfg, gen, device)
    if isinstance(cfg, NequIPConfig):
        return init_nequip(cfg, gen, device)
    raise TypeError(type(cfg))


def forward(cfg, params: Params, g: Graph) -> torch.Tensor:
    if isinstance(cfg, GraphCastConfig):
        return graphcast_forward(cfg, params, g)
    if isinstance(cfg, GATConfig):
        return gat_forward(cfg, params, g)
    if isinstance(cfg, EGNNConfig):
        return egnn_forward(cfg, params, g)[0]
    if isinstance(cfg, NequIPConfig):
        return nequip_forward(cfg, params, g)
    raise TypeError(type(cfg))


def loss_fn(cfg, params: Params, batch) -> torch.Tensor:
    """Node-level loss: cross-entropy (over ``log_softmax`` in float32) when
    the targets are integers, else MSE; ``batch["mask"]``, where given,
    weights the nodes as in the reference.  ``batch["graph"]`` is a
    :class:`Graph` (with ``pos`` for EGNN and NequIP).  An unknown config
    raises ``TypeError`` in :func:`forward`."""
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
    e.g. ``jax.tree.map(np.asarray, params)``) as the same tree of tensors
    on ``device`` (``None`` means ``cuda``): every float leaf as float32, an
    integer leaf in its own dtype (AutoInt's int8 table)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    a = np.array(a, dtype=a.dtype if np.issubdtype(a.dtype, np.integer) else np.float32)
    return torch.from_numpy(a).to(device)
