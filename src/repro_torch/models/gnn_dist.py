"""2D-partitioned GNN message passing on a simulated grid (the paper's SpMV
pattern), forward pass.

The port's counterpart of the forward half of ``repro/models/gnn_dist.py``,
written against :class:`~repro_torch.comm.SimGrid`'s per-rank lists:

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
kernel twice per aggregation and rank, not three times.

Aggregations support sum and max, so attention (GAT) runs as two passes: a
max pass (softmax stability), then a fused exp-sum pass.  The training step
(``build_2d_train_step``'s gradients), EGNN and NequIP are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.comm.grid import ALL_AXES, COL_AXIS, ROW_AXIS, SimGrid
from repro_torch.core.csr import Partition2D
from repro_torch.kernels.quant import ops as quant
from repro_torch.models import gnn

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


def gather_col_row(grid: SimGrid, h_own: list, part: Partition2D,
                   cfg: Dist2DConfig) -> tuple[list, list]:
    """Owned chunks (s, d) per rank -> (column slice (n_c, d), row slice
    (n_r, d)) per rank."""
    wire = [_wire(h, cfg) for h in h_own]
    h_t = grid.ppermute(wire, ALL_AXES, part.transpose_perm())
    return grid.all_gather(h_t, ROW_AXIS), grid.all_gather(wire, COL_AXIS)


def reduce_to_owned(grid: SimGrid, partial: list, part: Partition2D, cfg: Dist2DConfig,
                    op: str = "sum") -> list:
    """Row-slice partials (n_r, d) per rank -> owned aggregates (s, d) via
    an all-to-all over the columns."""
    c, s = part.cols, part.chunk
    recv = grid.all_to_all([_wire(p.reshape(c, s, -1), cfg) for p in partial], COL_AXIS)
    reduce = (lambda r: r.amax(dim=0)) if op == "max" else (lambda r: r.sum(dim=0))
    return [reduce(r.reshape(c, s, -1)) for r in recv]


def aggregate_2d(
    grid: SimGrid,
    h_own: list,
    edge_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    src_l: list,
    dst_l: list,
    part: Partition2D,
    cfg: Dist2DConfig,
    op: str = "sum",
    h_aux_own: list | None = None,
) -> list:
    """One 2D aggregation pass.

    ``edge_fn(h_src (m, d), h_dst (m, d)) -> messages (m, dm)``; padding
    edges (src_l == n_c) produce identity elements.  ``src_l`` / ``dst_l``
    are each rank's int64 edge block.  Returns owned (s, dm) per rank.
    """
    n_r, n_c = part.n_r, part.n_c
    payload = (h_own if h_aux_own is None
               else [torch.cat([h, a], -1) for h, a in zip(h_own, h_aux_own)])
    p_col, p_row = gather_col_row(grid, payload, part, cfg)
    partial = []
    for p in range(grid.size):
        hs = gnn._gather(p_col[p], src_l[p], n_c)
        hd = gnn._gather(p_row[p], dst_l[p], n_r)
        msg = edge_fn(hs, hd)
        valid = (src_l[p] < n_c)[:, None]
        ident = msg.new_tensor(0.0 if op == "sum" else NEG)
        msg = torch.where(valid, msg, ident)
        if op == "sum":
            red = gnn.seg_sum(msg, dst_l[p], n_r)
        else:  # the segment_max identity fix: empty rows give NEG
            red = gnn.seg_max(msg, dst_l[p], n_r).clamp_(min=NEG)
        partial.append(red)
    return reduce_to_owned(grid, partial, part, cfg, op)


# ---------------------------------------------------------------------------
# per-arch 2D layers (forward); params are the single-device ones
# ---------------------------------------------------------------------------


def graphcast_2d(grid, params, h_own, src_l, dst_l, part, dcfg):
    """Interaction-network stack, sum aggregation (edge state omitted in the
    distributed variant: messages recomputed per layer)."""
    h = [gnn._mlp(params["encoder"], x) for x in h_own]
    for lyr in params["layers"]:
        def edge_fn(hs, hd, lyr=lyr):
            return gnn._mlp(lyr["edge"], torch.cat([torch.zeros_like(hs), hs, hd], -1))

        agg = aggregate_2d(grid, h, edge_fn, src_l, dst_l, part, dcfg, op="sum")
        h = [x + gnn._mlp(lyr["node"], torch.cat([x, a], -1)) for x, a in zip(h, agg)]
    return [gnn._mlp(params["decoder"], x) for x in h]


def gat_2d(grid, params, h_own, src_l, dst_l, part, dcfg):
    """GAT: max pass (stability) then fused exp-sum pass per layer."""
    h = h_own
    for li, lyr in enumerate(params["layers"]):
        heads, d_out = lyr["w"].shape[0], lyr["w"].shape[2]
        z = [torch.einsum("nd,hdo->nho", x, lyr["w"]).reshape(x.shape[0], -1) for x in h]

        def logits_fn(zs, zd, lyr=lyr, heads=heads, d_out=d_out):
            zs = zs.reshape(-1, heads, d_out)
            zd = zd.reshape(-1, heads, d_out)
            lg = (torch.einsum("mho,ho->mh", zs, lyr["a_src"])
                  + torch.einsum("mho,ho->mh", zd, lyr["a_dst"]))
            return F.leaky_relu(lg, 0.2)

        mx = aggregate_2d(grid, z, logits_fn, src_l, dst_l, part, dcfg, op="max")

        def expsum_fn(payload_s, payload_d, lyr=lyr, heads=heads, d_out=d_out):
            zs = payload_s[:, : heads * d_out].reshape(-1, heads, d_out)
            zd = payload_d[:, : heads * d_out].reshape(-1, heads, d_out)
            mxd = payload_d[:, heads * d_out: heads * d_out + heads]
            lg = (torch.einsum("mho,ho->mh", zs, lyr["a_src"])
                  + torch.einsum("mho,ho->mh", zd, lyr["a_dst"]))
            e = torch.exp(F.leaky_relu(lg, 0.2) - mxd)  # (m, h)
            num = (e[..., None] * zs).reshape(e.shape[0], -1)
            return torch.cat([num, e], -1)

        agg = aggregate_2d(grid, z, expsum_fn, src_l, dst_l, part, dcfg, op="sum",
                           h_aux_own=mx)
        nxt = []
        for a in agg:
            num = a[:, : heads * d_out].reshape(-1, heads, d_out)
            den = a[:, heads * d_out:][:, :, None]
            nxt.append((num / torch.clamp(den, min=1e-16)).reshape(a.shape[0], -1))
        h = nxt
        if li < len(params["layers"]) - 1:
            h = [F.elu(x) for x in h]
    return h


_FWD_2D = {"graphcast": graphcast_2d, "gat-cora": gat_2d}


def shard_nodes(grid: SimGrid, x: np.ndarray, part: Partition2D) -> list:
    """Owner-chunk rows of ``x`` ((R, C, s, d) or (n, d)) -> per-rank (s, d)
    float32 tensors on the grid's device."""
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(grid.device)
    x = x.reshape(grid.size, part.chunk, -1)
    return [x[p].contiguous() for p in range(grid.size)]


def shard_edges(grid: SimGrid, e_local: np.ndarray) -> list:
    """(R, C, e_cap) local edge ids (``core.csr.partition_2d``'s blocks) ->
    per-rank int64 tensors on the grid's device."""
    e = torch.from_numpy(np.ascontiguousarray(e_local)).to(grid.device, torch.int64)
    e = e.reshape(grid.size, -1)
    return [e[p].contiguous() for p in range(grid.size)]


def forward_2d(grid: SimGrid, model_cfg, params, nf: list, src_l: list, dst_l: list,
               part: Partition2D, dcfg: Dist2DConfig | None = None) -> list:
    """The 2D forward of ``model_cfg`` (``graphcast`` or ``gat-cora``): the
    forward inside the reference's ``build_2d_train_step`` (``local``),
    without the loss and gradients.

    Per-rank lists (:func:`shard_nodes`, :func:`shard_edges`): ``nf`` the
    (s, d_in) owned features, ``src_l`` / ``dst_l`` the local edge blocks;
    ``params`` on the grid's device.  The reference's ``pos`` (EGNN and
    NequIP) is not taken: neither ported arch reads it.  Returns per-rank
    (s, d_out) outputs.
    """
    if model_cfg.name not in _FWD_2D:
        raise TypeError(f"forward_2d: arch {model_cfg.name!r} is not ported")
    return _FWD_2D[model_cfg.name](grid, params, nf, src_l, dst_l, part,
                                   dcfg or Dist2DConfig())
