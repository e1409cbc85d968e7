"""AutoInt recommender (arXiv:1810.11921) with a hand-built EmbeddingBag.

Port of :mod:`repro.models.recsys`, function for function.  The lookup is
a gather on one fused table (every field's rows one after another, each
field's ids shifted by its offset) and a masked sum over the bag axis,
with ``-1`` as padding, as the reference builds it; not ``nn.EmbeddingBag``,
whose offsets and padding mean other things.  The embedding table is the
hot path: 39 sparse fields with multi-million-row tables (Criteo-like
cardinalities), 173,588,480 rows at the published widths.

Paths:
* :func:`forward` -- CTR scoring: embeddings -> 3 self-attention
  interaction layers (2 heads, d=32) -> MLP -> logit.
* :func:`retrieval_scores` -- one query against N candidate items: the
  user tower runs once; the candidates are scored by one (N, d) @ (d,)
  product, not a loop.

``table_quant`` keeps the table in int8 with a float32 scale per row
(quantized in :func:`init_params`, no kernel) and dequantizes after the
gather.  :func:`param_specs` gives the reference's placement (the table
row-sharded over every mesh axis) as tuples.  No hand-written kernel is on
this path: the reference reaches no Pallas kernel here either.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

Params = dict[str, Any]

# Criteo-like table sizes cycled over the 39 sparse fields (public Criteo-1TB
# cardinalities span 10..~200M; this mix keeps the fused table ~120M rows).
_TABLE_SIZES = (
    40_000_000, 10_000_000, 4_000_000, 2_000_000, 1_000_000, 500_000,
    200_000, 100_000, 50_000, 10_000, 2_000, 500, 128,
)


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    mlp_dims: tuple[int, ...] = (256, 128)
    table_sizes: tuple[int, ...] = ()
    # int8 row-quantized embedding table (per-row scale): 4x less table
    # memory and 4x fewer gathered bytes
    table_quant: bool = False

    def resolved_tables(self) -> tuple[int, ...]:
        if self.table_sizes:
            sizes = list(self.table_sizes)
        else:
            sizes = [_TABLE_SIZES[i % len(_TABLE_SIZES)] for i in range(self.n_sparse)]
        # the last table padded so that the fused row count is a multiple
        # of 4,096 (the reference row-shards it over up to 4,096 chips)
        total = sum(sizes)
        sizes[-1] += -total % 4096
        return tuple(sizes)

    @property
    def total_rows(self) -> int:
        return sum(self.resolved_tables())

    @property
    def d_interact(self) -> int:
        return self.n_heads * self.d_attn

    def n_params(self) -> int:
        d, da, h = self.embed_dim, self.d_attn, self.n_heads
        n = self.total_rows * d
        d_prev = d
        for _ in range(self.n_attn_layers):
            n += 3 * h * d_prev * da + d_prev * h * da
            d_prev = h * da
        dims = (self.n_sparse * d_prev,) + self.mlp_dims + (1,)
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        n += d_prev * d  # retrieval projection
        return n


def field_offsets(cfg: AutoIntConfig, device=None) -> torch.Tensor:
    """(F,) base row of each field in the fused table: int32 while the
    table has fewer than 2**31 rows, else int64, as in the reference."""
    return _field_offsets(cfg, resolve_device(device))


@functools.lru_cache(maxsize=64)
def _field_offsets(cfg: AutoIntConfig, device: torch.device) -> torch.Tensor:
    sizes = np.asarray(cfg.resolved_tables(), np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    dtype = torch.int32 if cfg.total_rows < 2**31 else torch.int64
    return torch.from_numpy(offs).to(device=device, dtype=dtype)


def quantize_rows(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's int8 rule for the table (``init_params``): per row,
    ``scale = max(max|x|, 1e-8) / 127`` and ``clip(round(x / scale), -127,
    127)``.  Overwrites ``raw`` (the full table's fp32 draw is 11 GB, so no
    second copy is made) and returns (int8 rows, float32 scales)."""
    lo, hi = torch.aminmax(raw, dim=1)  # max|x| without an |x| copy
    scale = torch.clamp(torch.maximum(hi, -lo), min=1e-8) / 127.0
    q = raw.div_(scale[:, None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def init_params(cfg: AutoIntConfig, gen: torch.Generator, table_dtype=torch.float32,
                device=None) -> Params:
    """Random parameters in the reference's tree, drawn from ``gen`` (a
    generator on ``device``; ``None`` means ``cuda``) leaf after leaf in the
    reference's order: each layer's wq, wk, wv, wres, the MLP's weights, the
    table (N(0, 1) * 0.01, drawn on the device), then w_user.  Dense
    weights are N(0, 1) over the square root of their fan-in; the MLP's
    biases are zeros."""
    device = resolve_device(device)
    d, da, h = cfg.embed_dim, cfg.d_attn, cfg.n_heads

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(scale)

    layers = []
    d_prev = d
    for _ in range(cfg.n_attn_layers):
        s = 1.0 / d_prev**0.5
        layers.append({"wq": normal((h, d_prev, da), s), "wk": normal((h, d_prev, da), s),
                       "wv": normal((h, d_prev, da), s), "wres": normal((d_prev, h * da), s)})
        d_prev = h * da
    dims = (cfg.n_sparse * d_prev,) + cfg.mlp_dims + (1,)
    mlp = [{"w": normal((a, b), 1.0 / a**0.5),
            "b": torch.zeros((b,), dtype=torch.float32, device=device)}
           for a, b in zip(dims[:-1], dims[1:])]
    raw = normal((cfg.total_rows, d), 0.01)
    if cfg.table_quant:
        table, scale = quantize_rows(raw)
        del raw
        extra = {"table": table, "table_scale": scale}
    else:
        extra = {"table": raw.to(table_dtype)}
    return {**extra, "attn": layers, "mlp": mlp,
            "w_user": normal((d_prev, d), 1.0 / d_prev**0.5)}


def param_specs(cfg: AutoIntConfig, fsdp=("data",), tp: str = "model"):
    """Placement specs in :func:`init_params`' tree: the embedding table
    row-sharded over *all* mesh axes (the DLRM layout); the dense
    interaction and MLP parameters are tiny and replicated."""
    all_axes = tuple(fsdp) + (tp,)
    return {
        "table": (all_axes, None),
        "attn": [{"wq": (None,), "wk": (None,), "wv": (None,), "wres": (None,)}
                 for _ in range(cfg.n_attn_layers)],
        "mlp": [{"w": (None,), "b": (None,)} for _ in range(len(cfg.mlp_dims) + 1)],
        "w_user": (None,),
    }


# ---------------------------------------------------------------------------
# EmbeddingBag: gather + masked pooling
# ---------------------------------------------------------------------------


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` for in-range ``idx`` of any shape."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


def embedding_bag(table, ids, offsets=None, mode: str = "sum"):
    """``torch.nn.EmbeddingBag``'s job on a fused table, in the reference's
    semantics.

    Args:
      table: (rows, d).
      ids: (B, F) single-valued, or (B, F, K) multi-valued with -1 padding.
      offsets: optional (F,) per-field base offsets into the fused table
        (added to the ids that are not padding).
    Returns (B, F, d) pooled embeddings (``mode`` "sum" or "mean" over the
    valid slots; a bag of padding only pools to zeros).
    """
    if offsets is not None:
        off = offsets.reshape((1, -1) + (1,) * (ids.dim() - 2)).to(ids.dtype)
        ids = torch.where(ids >= 0, ids + off, ids)
    if ids.dim() == 2:
        return _take(table, torch.clamp(ids, min=0))
    valid = (ids >= 0)[..., None]
    emb = _take(table, torch.clamp(ids, min=0))
    pooled = (emb * valid).sum(dim=2)
    if mode == "mean":
        pooled = pooled / torch.clamp(valid.sum(dim=2), min=1)
    return pooled


# ---------------------------------------------------------------------------
# AutoInt forward paths
# ---------------------------------------------------------------------------


def _interact(cfg: AutoIntConfig, params: Params, emb):
    """emb (B, F, d) -> (B, F, h*da) via stacked self-attention layers."""
    x = emb
    for lyr in params["attn"]:
        q = torch.einsum("bfd,hde->bhfe", x, lyr["wq"])
        k = torch.einsum("bfd,hde->bhfe", x, lyr["wk"])
        v = torch.einsum("bfd,hde->bhfe", x, lyr["wv"])
        scores = torch.einsum("bhfe,bhge->bhfg", q, k) / cfg.d_attn**0.5
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhfg,bhge->bhfe", w, v)
        o = o.permute(0, 2, 1, 3).reshape(x.shape[0], x.shape[1], -1)
        x = torch.relu(o + x @ lyr["wres"])
    return x


def _lookup(cfg: AutoIntConfig, params: Params, ids):
    """Embedding lookup; dequantizes after the (int8) gather when quantized."""
    offs = field_offsets(cfg, ids.device)
    emb = embedding_bag(params["table"], ids, offsets=offs)
    if cfg.table_quant:
        flat = torch.where(ids >= 0, ids + offs[None, :].to(ids.dtype), 0)
        scale = _take(params["table_scale"], flat)  # (B, F)
        emb = emb.to(torch.float32) * scale[..., None]
    return emb


def head(cfg: AutoIntConfig, params: Params, emb):
    """The dense part of :func:`forward`: embeddings (B, F, d) -> the
    interaction layers -> the MLP -> CTR logits (B,)."""
    x = _interact(cfg, params, emb)
    flat = x.reshape(x.shape[0], -1)
    for i, lyr in enumerate(params["mlp"]):
        flat = flat @ lyr["w"] + lyr["b"]
        if i < len(params["mlp"]) - 1:
            flat = torch.relu(flat)
    return flat[:, 0]


def forward(cfg: AutoIntConfig, params: Params, ids) -> torch.Tensor:
    """ids (B, F) int per-field local indices -> CTR logits (B,)."""
    return head(cfg, params, _lookup(cfg, params, ids))


def loss_fn(cfg: AutoIntConfig, params: Params, batch) -> torch.Tensor:
    """Binary cross-entropy on click labels (numerically stable form)."""
    logits = forward(cfg, params, batch["ids"])
    y = batch["labels"].to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def user_vector(cfg: AutoIntConfig, params: Params, ids) -> torch.Tensor:
    """(B, F) query features -> (B, embed_dim) user vectors (two-tower head)."""
    x = _interact(cfg, params, _lookup(cfg, params, ids))  # (B, F, d_interact)
    return x.mean(dim=1) @ params["w_user"]


def candidate_rows(cfg: AutoIntConfig, cand_ids) -> torch.Tensor:
    """Fused-table rows of candidate ids of the last sparse field."""
    return cand_ids + field_offsets(cfg, cand_ids.device)[-1].to(cand_ids.dtype)


def retrieval_scores(cfg: AutoIntConfig, params: Params, ids, cand_ids) -> torch.Tensor:
    """Score one query (1, F) against N candidates of the last sparse field.

    The user tower runs once; candidate scoring is a single (N, d) @ (d,)
    product against the candidate field's embedding rows."""
    uv = user_vector(cfg, params, ids)[0]  # (d,)
    rows = candidate_rows(cfg, cand_ids)
    item_emb = _take(params["table"], rows)
    if cfg.table_quant:
        item_emb = item_emb.to(torch.float32) * _take(params["table_scale"], rows)[:, None]
    return item_emb @ uv
