"""2D-partitioned GNN message passing over a grid of ranks (the paper's SpMV
pattern): the forward, and the training step's loss and gradients.

The port's counterpart of ``repro/models/gnn_dist.py``, written once
against per-rank lists over a :class:`~repro_torch.comm.grid.Grid`, so that
the same body runs on :class:`~repro_torch.comm.SimGrid` (every rank in one
process) and on :class:`~repro_torch.comm.procgrid.ProcessGrid` (one
process per rank, whose lists hold its own rank only):

* node state lives in owned chunks (rank (i, j) owns chunk q = i*C + j,
  width s), as in the distributed BFS;
* per layer, rank (i, j) assembles the **column slice** of source features
  (TransposeVector + all-gather over rows) and the **row slice** of
  destination features (all-gather over columns), computes messages for its
  edge block, segment-reduces them into row-slice partials, and an
  all-to-all over columns lands the reduced aggregates at their owners;
* optional **int8 payload compression** of every feature exchange
  (:class:`Dist2DConfig` ``quantize_payload``): quantize-dequantize through
  the ``quantize`` CUDA kernel, with a straight-through gradient.

The owned chunk is quantized once per exchange and the same codes feed the
transpose and the row all-gather; the reference quantizes the identical
input twice (``gnn_dist.py:81`` and ``:83``), so the port launches the
kernel twice per aggregation and rank, not three times, and the
straight-through cotangent of the one quantization is the sum of both uses,
as the reference's two identities give.

The exchanges go through the grid's differentiable collectives
(``comm.grid.ad_*``), whose backwards are their transposes, so that
:func:`build_2d_train_step` differentiates through them on either grid.
Aggregations support sum and max, so attention (GAT) runs as two passes: a
max pass (softmax stability), then a fused exp-sum pass.  EGNN and NequIP
take each rank's owned positions (``pos``): EGNN sends ``[h, x]`` and
quantizes the whole payload, coordinates included, under
``quantize_payload``, as the reference does; NequIP sends its flattened
l<=2 irreps and positions and never quantizes them (the config is forced
to fp32, as in the reference).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.comm.grid import (COL_AXIS, Grid, ad_all_gather, ad_all_to_all,
                                   ad_ppermute, ad_psum, pmean_trees)
from repro_torch.core.csr import Partition2D
from repro_torch.kernels.quant import ops as quant
from repro_torch.models import gnn
from repro_torch.models import irreps as ir

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class Dist2DConfig:
    quantize_payload: bool = False  # int8 wire format for feature exchanges


class _SteQuant(torch.autograd.Function):
    """Quantize-dequantize with a straight-through gradient."""

    @staticmethod
    def forward(ctx, x):
        flat = x.reshape(-1)
        pad = (-flat.shape[0]) % quant.ref.GROUP
        if pad:
            flat = F.pad(flat, (0, pad))
        q, s = quant.quantize(flat.to(torch.float32))
        out = quant.dequantize(q, s)
        return out[: x.numel()].reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


_ste_quant = _SteQuant.apply


def _wire(x: torch.Tensor, cfg: Dist2DConfig) -> torch.Tensor:
    return _ste_quant(x) if cfg.quantize_payload else x


def gather_col_row(grid: Grid, h_own: list, part: Partition2D,
                   cfg: Dist2DConfig) -> tuple[list, list]:
    """Owned chunks (s, d) per rank -> (column slice (n_c, d), row slice
    (n_r, d)) per rank."""
    wire = grid.local(lambda p: _wire(h_own[p], cfg))
    h_t = ad_ppermute(grid, wire, grid.all_axes, part.transpose_perm())
    return ad_all_gather(grid, h_t, grid.row_axes), ad_all_gather(grid, wire, COL_AXIS)


def reduce_to_owned(grid: Grid, partial: list, part: Partition2D, cfg: Dist2DConfig,
                    op: str = "sum") -> list:
    """Row-slice partials (n_r, d) per rank -> owned aggregates (s, d) via
    an all-to-all over the columns."""
    c, s = part.cols, part.chunk
    recv = ad_all_to_all(grid, grid.local(lambda p: _wire(partial[p].reshape(c, s, -1), cfg)),
                         COL_AXIS)
    reduce = (lambda r: r.amax(dim=0)) if op == "max" else (lambda r: r.sum(dim=0))
    return grid.local(lambda p: reduce(recv[p].reshape(c, s, -1)))


def aggregate_2d(
    grid: Grid,
    h_own: list,
    edge_fn: Callable[[int, torch.Tensor, torch.Tensor], torch.Tensor],
    src_l: list,
    dst_l: list,
    part: Partition2D,
    cfg: Dist2DConfig,
    op: str = "sum",
    h_aux_own: list | None = None,
) -> list:
    """One 2D aggregation pass.

    ``edge_fn(p, h_src (m, d), h_dst (m, d)) -> messages (m, dm)`` on rank
    ``p``'s edge block; padding edges (src_l == n_c) produce identity
    elements.  ``src_l`` / ``dst_l`` are each rank's int64 edge block.
    Returns owned (s, dm) per rank.
    """
    n_r, n_c = part.n_r, part.n_c
    payload = (h_own if h_aux_own is None
               else grid.local(lambda p: torch.cat([h_own[p], h_aux_own[p]], -1)))
    p_col, p_row = gather_col_row(grid, payload, part, cfg)

    def partial(p):
        hs = gnn._gather(p_col[p], src_l[p], n_c)
        hd = gnn._gather(p_row[p], dst_l[p], n_r)
        msg = edge_fn(p, hs, hd)
        valid = (src_l[p] < n_c)[:, None]
        ident = msg.new_tensor(0.0 if op == "sum" else NEG)
        msg = torch.where(valid, msg, ident)
        if op == "sum":
            return gnn.seg_sum(msg, dst_l[p], n_r)
        # the segment_max identity fix: empty rows give NEG (out of place:
        # the scatter's backward reads its result)
        return torch.clamp(gnn.seg_max(msg, dst_l[p], n_r), min=NEG)

    return reduce_to_owned(grid, grid.local(partial), part, cfg, op)


# ---------------------------------------------------------------------------
# per-arch 2D layers; ``params`` holds each local rank's parameter tree (the
# single-device ones: the same tree on every rank for a forward, a leaf copy
# per rank for the gradients)
# ---------------------------------------------------------------------------


def _n_layers(grid: Grid, params: list) -> int:
    return len(params[grid.local_ranks[0]]["layers"])


def graphcast_2d(grid, cfg_m, params, h_own, src_l, dst_l, part, dcfg):
    """Interaction-network stack, sum aggregation (edge state omitted in the
    distributed variant: messages recomputed per layer)."""
    h = grid.local(lambda p: gnn._mlp(params[p]["encoder"], h_own[p]))
    for li in range(_n_layers(grid, params)):
        def edge_fn(p, hs, hd, li=li):
            return gnn._mlp(params[p]["layers"][li]["edge"],
                            torch.cat([torch.zeros_like(hs), hs, hd], -1))

        agg = aggregate_2d(grid, h, edge_fn, src_l, dst_l, part, dcfg, op="sum")
        h = grid.local(lambda p: h[p] + gnn._mlp(params[p]["layers"][li]["node"],
                                                 torch.cat([h[p], agg[p]], -1)))
    return grid.local(lambda p: gnn._mlp(params[p]["decoder"], h[p]))


def gat_2d(grid, cfg_m, params, h_own, src_l, dst_l, part, dcfg):
    """GAT: max pass (stability) then fused exp-sum pass per layer."""
    h = h_own
    n_layers = _n_layers(grid, params)
    for li in range(n_layers):
        heads, _, d_out = params[grid.local_ranks[0]]["layers"][li]["w"].shape

        def logits_fn(p, zs, zd, li=li, heads=heads, d_out=d_out):
            lyr = params[p]["layers"][li]
            lg = (torch.einsum("mho,ho->mh", zs.reshape(-1, heads, d_out), lyr["a_src"])
                  + torch.einsum("mho,ho->mh", zd.reshape(-1, heads, d_out), lyr["a_dst"]))
            return F.leaky_relu(lg, 0.2)

        z = grid.local(lambda p: torch.einsum("nd,hdo->nho", h[p], params[p]["layers"][li]["w"])
                       .reshape(h[p].shape[0], -1))
        mx = aggregate_2d(grid, z, logits_fn, src_l, dst_l, part, dcfg, op="max")

        def expsum_fn(p, payload_s, payload_d, logits_fn=logits_fn, heads=heads, d_out=d_out):
            zs = payload_s[:, : heads * d_out]
            zd = payload_d[:, : heads * d_out]
            mxd = payload_d[:, heads * d_out: heads * d_out + heads]
            e = torch.exp(logits_fn(p, zs, zd) - mxd)  # (m, h)
            num = (e[..., None] * zs.reshape(-1, heads, d_out)).reshape(e.shape[0], -1)
            return torch.cat([num, e], -1)

        agg = aggregate_2d(grid, z, expsum_fn, src_l, dst_l, part, dcfg, op="sum",
                           h_aux_own=mx)

        def combine(p, heads=heads, d_out=d_out):
            a = agg[p]
            num = a[:, : heads * d_out].reshape(-1, heads, d_out)
            den = a[:, heads * d_out:][:, :, None]
            out = (num / torch.clamp(den, min=1e-16)).reshape(a.shape[0], -1)
            return F.elu(out) if li < n_layers - 1 else out

        h = grid.local(combine)
    return h


def egnn_2d(grid, cfg_m, params, h_own, pos_own, src_l, dst_l, part, dcfg):
    """EGNN: payload = [h, x]; messages, coordinate deltas and the degree
    in one pass of width d + 4."""
    h = grid.local(lambda p: gnn._mlp(params[p]["embed"], h_own[p]))
    x = pos_own
    d = cfg_m.d_hidden
    for li in range(_n_layers(grid, params)):
        def edge_fn(p, ps, pd, li=li):
            lyr = params[p]["layers"][li]
            hs, xs = ps[:, :d], ps[:, d: d + 3]
            hd, xd = pd[:, :d], pd[:, d: d + 3]
            diff = xd - xs
            d2 = torch.sum(diff * diff, -1, keepdim=True)
            m = gnn._mlp(lyr["edge"], torch.cat([hs, hd, d2], -1))
            w = torch.tanh(gnn._mlp(lyr["coord"], m))
            return torch.cat([m, -diff * w, torch.ones_like(d2)], -1)

        agg = aggregate_2d(grid, h, edge_fn, src_l, dst_l, part, dcfg, op="sum", h_aux_own=x)
        x = grid.local(lambda p: x[p] + agg[p][:, d: d + 3]
                       / torch.clamp(agg[p][:, d + 3:], min=1.0))
        h = grid.local(lambda p: h[p] + gnn._mlp(params[p]["layers"][li]["node"],
                                                 torch.cat([h[p], agg[p][:, :d]], -1)))
    return grid.local(lambda p: gnn._mlp(params[p]["out"], h[p]))


def nequip_2d(grid, cfg_m, params, h_own, pos_own, src_l, dst_l, part, dcfg):
    """NequIP: the l<=2 irreps flattened into the payload with the
    positions, [s, v, t, pos] (13c + 3 floats a node); a message is 13c.

    Payload quantization is forced off: lossy wire formats break exact
    equivariance."""
    dcfg = dataclasses.replace(dcfg, quantize_payload=False)
    c = cfg_m.d_hidden

    def embed(p):
        s = gnn._mlp(params[p]["embed"], h_own[p])
        n = s.shape[0]
        return ir.Irreps(s=s, v=s.new_zeros((n, c, 3)), t=s.new_zeros((n, c, 3, 3)))

    feats = grid.local(embed)
    for li in range(_n_layers(grid, params)):
        def edge_fn(p, ps, pd, li=li):
            m = ps.shape[0]
            r, y1, y2 = gnn.edge_geometry(ps[:, 13 * c:], pd[:, 13 * c:])
            w = gnn._mlp(params[p]["layers"][li]["radial"],
                         ir.bessel_rbf(r, cfg_m.n_rbf, cfg_m.cutoff))
            m_s, m_v, m_t = gnn.nequip_messages(
                w, ps[:, :c], ps[:, c: 4 * c].reshape(m, c, 3),
                ps[:, 4 * c: 13 * c].reshape(m, c, 3, 3), y1, y2, c)
            return torch.cat([m_s, m_v.reshape(m, -1), m_t.reshape(m, -1)], -1)

        payload = grid.local(lambda p: torch.cat(
            [feats[p].s, feats[p].v.flatten(1), feats[p].t.flatten(1), pos_own[p]], -1))
        agg = aggregate_2d(grid, payload, edge_fn, src_l, dst_l, part, dcfg, op="sum")

        def update(p, li=li):
            a, n = agg[p], agg[p].shape[0]
            a = ir.Irreps(s=a[:, :c], v=a[:, c: 4 * c].reshape(n, c, 3),
                          t=a[:, 4 * c:].reshape(n, c, 3, 3))
            return gnn.nequip_update(params[p]["layers"][li], feats[p], a, c)

        feats = grid.local(update)
    return grid.local(lambda p: gnn._mlp(params[p]["readout"], feats[p].s))


_FWD_2D = {"graphcast": graphcast_2d, "gat-cora": gat_2d, "egnn": egnn_2d,
           "nequip": nequip_2d}
#: the archs whose 2D forward reads each rank's owned positions
NEEDS_POS = ("egnn", "nequip")
#: the archs whose payload stays fp32 whatever ``quantize_payload`` asks
FP32_PAYLOAD = ("nequip",)


def _arch(model_cfg, who: str) -> str:
    """The arch's name; an unknown config raises ``TypeError``."""
    name = getattr(model_cfg, "name", None)
    if name not in _FWD_2D:
        raise TypeError(f"{who}: unknown GNN arch {name!r}")
    return name


def _forward(grid, model_cfg, params, nf, pos, src_l, dst_l, part, dcfg, who: str) -> list:
    """The arch's 2D forward; ``pos`` goes to the archs that read it (which
    raise ``TypeError`` without it) and is ignored by the others, as in the
    reference."""
    name = _arch(model_cfg, who)
    fwd = _FWD_2D[name]
    if name in NEEDS_POS:
        if pos is None:
            raise TypeError(f"{who}: arch {name!r} needs each rank's owned positions (pos)")
        return fwd(grid, model_cfg, params, nf, pos, src_l, dst_l, part, dcfg)
    return fwd(grid, model_cfg, params, nf, src_l, dst_l, part, dcfg)


def shard_nodes(grid: Grid, x: np.ndarray, part: Partition2D) -> list:
    """Owner-chunk rows of ``x`` ((R, C, s, d) or (n, d)) -> per-rank (s, d)
    float32 tensors on the grid's device, for the local ranks."""
    x = np.ascontiguousarray(x, np.float32).reshape(grid.size, part.chunk, -1)
    return grid.local(lambda p: torch.from_numpy(x[p]).to(grid.device))


def shard_targets(grid: Grid, t: np.ndarray, part: Partition2D) -> list:
    """Owner-chunk integer targets ((R, C, s) or (n,)) -> per-rank (s,)
    int64 tensors on the grid's device, for the local ranks."""
    t = np.ascontiguousarray(t).reshape(grid.size, part.chunk)
    return grid.local(lambda p: torch.from_numpy(t[p]).to(grid.device, torch.int64))


def shard_edges(grid: Grid, e_local: np.ndarray) -> list:
    """(R, C, e_cap) local edge ids (``core.csr.partition_2d``'s blocks) ->
    per-rank int64 tensors on the grid's device, for the local ranks."""
    e = np.ascontiguousarray(e_local).reshape(grid.size, -1)
    return grid.local(lambda p: torch.from_numpy(e[p]).to(grid.device, torch.int64))


def forward_2d(grid: Grid, model_cfg, params, nf: list, src_l: list, dst_l: list,
               part: Partition2D, dcfg: Dist2DConfig | None = None,
               pos: list | None = None) -> list:
    """The 2D forward of ``model_cfg`` (``graphcast``, ``gat-cora``,
    ``egnn`` or ``nequip``): the forward inside the reference's
    ``build_2d_train_step`` (``local``), without the loss and gradients.

    Per-rank lists (:func:`shard_nodes`, :func:`shard_edges`): ``nf`` the
    (s, d_in) owned features, ``src_l`` / ``dst_l`` the local edge blocks,
    ``pos`` the (s, 3) owned positions, which EGNN and NequIP need (a
    ``TypeError`` without them) and the others ignore; ``params`` one tree
    on the grid's device, shared by the ranks.  Returns per-rank (s, d_out)
    outputs.
    """
    return _forward(grid, model_cfg, grid.local(lambda p: params), nf, pos, src_l, dst_l,
                    part, dcfg or Dist2DConfig(), "forward_2d")


# ---------------------------------------------------------------------------
# the training step's loss and gradients
# ---------------------------------------------------------------------------


def value_and_grad_2d(grid: Grid, model_cfg, params, nf: list, src_l: list, dst_l: list,
                      targets: list, part: Partition2D, dcfg: Dist2DConfig | None = None,
                      pos: list | None = None):
    """The loss and each local rank's gradients, before their mean: the
    body of the reference's ``local`` up to ``jax.value_and_grad``.

    Every rank's mean NLL over its owned chunk (the padded vertices count,
    as in the reference) is ``pmean``ed over the whole grid; that is the
    loss, and each rank differentiates it (seed 1) with respect to its own
    leaf copy of ``params``, through the grid's transposed collectives.
    ``pos`` as in :func:`forward_2d`.  Returns the loss (0-d), the per-rank
    gradient trees and the per-rank forward outputs (s, d_out), both
    detached.
    """
    flat, unflatten = tree.flatten(params)
    ranks = grid.local_ranks
    mine = {p: [x.detach().requires_grad_() for x in flat] for p in ranks}
    with torch.enable_grad():
        out = _forward(grid, model_cfg, grid.local(lambda p: unflatten(mine[p])), nf, pos,
                       src_l, dst_l, part, dcfg or Dist2DConfig(), "build_2d_train_step")

        def nll_mean(p):
            logp = F.log_softmax(out[p].to(torch.float32), -1)
            return -logp.gather(1, targets[p][:, None])[:, 0].mean()

        total = ad_psum(grid, grid.local(nll_mean), grid.all_axes)
        loss = [total[p] / grid.size for p in ranks]
        # zeros for a leaf the loss does not read (NequIP's last gate and
        # l>0 mixes), as under jax.grad
        grads = torch.autograd.grad(loss, [x for p in ranks for x in mine[p]],
                                    materialize_grads=True)
    k, at = len(flat), {p: i * len(flat) for i, p in enumerate(ranks)}
    per_rank = grid.local(lambda p: unflatten(list(grads[at[p]: at[p] + k])))
    return loss[0].detach(), per_rank, grid.local(lambda p: out[p].detach())


def build_2d_train_step(model_cfg, part: Partition2D, dcfg: Dist2DConfig | None = None):
    """The counterpart of the reference's ``build_2d_train_step`` (without
    the mesh, which the grid replaces, and the unused ``e_cap`` and
    ``n_classes``): returns ``step(grid, params, nf, src_l, dst_l,
    targets, pos=None) -> (loss, grads)``, the loss ``pmean``ed over the
    grid (:func:`value_and_grad_2d`) and the gradients ``pmean``ed over
    every axis (``comm.grid.pmean_trees``), one tree the same on every
    rank.  The per-rank lists are :func:`shard_nodes` (features and
    positions), :func:`shard_edges` and :func:`shard_targets`; EGNN and
    NequIP need ``pos`` (a ``TypeError`` without it), the others ignore it.
    An unknown arch raises ``TypeError`` here."""
    _arch(model_cfg, "build_2d_train_step")

    def step(grid, params, nf, src_l, dst_l, targets, pos=None):
        loss, grads, _ = value_and_grad_2d(grid, model_cfg, params, nf, src_l, dst_l,
                                           targets, part, dcfg, pos)
        return loss, pmean_trees(grid, grads)[grid.local_ranks[0]]

    return step
