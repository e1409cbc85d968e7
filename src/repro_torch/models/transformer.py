"""Decoder-only transformer family (dense, GQA/MQA, MLA, fine-grained MoE).

Port of :mod:`repro.models.transformer`, function for function:

* **layers**: parameters carry a leading ``(L,)`` dim under the
  reference's keys (:func:`init_params`), so the reference's
  ``jax.tree.map(np.asarray, params)`` carries across unchanged
  (``models.gnn.params_from_numpy``); the layer stack is a Python loop over
  ``L`` views.  ``remat`` is honoured: under autograd each layer runs in
  ``torch.utils.checkpoint`` (non-reentrant), keeps only its input and is
  recomputed in the backward, the reference's ``nothing_saveable``
  checkpoint; values do not change.  ``remat_policy="dots"`` recomputes
  the same way (nothing saved), and ``scan_layers`` and ``attn_remat``
  are kept and change nothing.
* **blockwise attention**: online softmax over KV chunks; a group of q
  chunks runs at once, bounded by the logits it holds, and a KV chunk that
  lies wholly after the group's last query is skipped (it would add nothing).
* **MLA** (DeepSeek-V2): low-rank KV latent cache; decode uses the absorbed
  form (q projected into latent space) so the cache stays (B, S, r + rope).
* **MoE**: GShard-style capacity dispatch with fine-grained routing groups
  (one-hot einsums) and optional shared experts.  The router's top-k puts
  the lower expert first among equal gates, as ``jax.lax.top_k`` does.
* **decode**: the new KV row is written into the cache in place (the
  reference blends it in through a one-hot; the values are the same).
* ``moe_dp_axes``, ``moe_tp_axis`` and ``expert_shard`` pin shardings on a
  TPU mesh in the reference; on one device they change nothing.
* **placement**: :func:`param_specs` and :func:`cache_spec` give the
  reference's ``PartitionSpec`` trees as plain tuples, one entry per
  dimension (``None``, a mesh axis name or a tuple of names): FSDP over the
  data axes, tensor parallelism over ``model``.
  :func:`repro_torch.launch.mesh.shard_shape` maps one to a rank's shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device

Params = dict[str, Any]

#: the norms' weights, which ``rmsnorm`` reads in their own dtype; every
#: other leaf is cast to the compute dtype where it is used
NORMS = ("ln1", "ln2", "final_norm")
#: the fp32 logits a group of q chunks may hold in :func:`blockwise_attention`
LOGIT_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # MoE (0 experts = dense)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_group: int = 512  # routing-group length (tokens)
    capacity_factor: float = 1.25
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # misc
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    q_chunk: int = 512
    kv_chunk: int = 1024
    # the reference's layer scan and recomputation switches (no value
    # change; ``remat`` recomputes each layer in the backward)
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "nothing"
    attn_remat: bool = True
    # the reference's sharding pins for a TPU mesh (no value change)
    moe_dp_axes: tuple = ()
    moe_tp_axis: str = ""
    expert_shard: str = "d"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (MiniCPM's 122753 ->
        122880); pad logits are masked."""
        return -(-self.vocab // 256) * 256

    @property
    def qk_head_dim(self) -> int:
        return (self.qk_nope_dim + self.qk_rope_dim) if self.use_mla else self.head_dim

    @property
    def cache_width(self) -> int:
        """Per-token KV cache width (the MLA memory win shows up here)."""
        if self.use_mla:
            return self.kv_lora_rank + self.qk_rope_dim
        return 2 * self.n_kv_heads * self.head_dim

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND roofline accounting)."""
        d, l = self.d_model, self.n_layers
        if self.use_mla:
            q_in = (
                self.q_lora_rank * (d + self.n_heads * self.qk_head_dim)
                if self.q_lora_rank
                else d * self.n_heads * self.qk_head_dim
            )
            attn = (
                q_in
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2
        if self.is_moe:
            ffn = d * self.n_experts + 3 * d * self.d_ff_expert * (
                self.n_experts + self.n_shared_experts
            )
        else:
            ffn = 3 * d * self.d_ff
        return l * (attn + ffn + 2 * d) + 2 * self.vocab * d + d

    def n_active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.n_params()
        d, l = self.d_model, self.n_layers
        full = self.n_params()
        ffn_all = 3 * d * self.d_ff_expert * (self.n_experts + self.n_shared_experts)
        ffn_act = 3 * d * self.d_ff_expert * (self.top_k + self.n_shared_experts)
        return full - l * (ffn_all - ffn_act)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dense(gen, shape, dtype, scale_axis, device):
    scale = 1.0 / max(shape[scale_axis], 1) ** 0.5
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(scale)
    return w.to(dtype)


def _init_leaves(cfg: TransformerConfig, gen: torch.Generator, device):
    """Every leaf of :func:`init_params` as ``(key path, tensor)``, drawn
    from ``gen`` one at a time in the reference's order (the layer stack,
    then ``embed`` and ``lm_head``): a leaf is made when the iteration
    reaches it."""
    d, l, dt = cfg.d_model, cfg.n_layers, cfg.param_dtype

    def dense(key, shape, scale_axis):
        return ("layers", key), _dense(gen, (l,) + shape, dt, scale_axis + 1, device)

    yield ("layers", "ln1"), torch.ones((l, d), dtype=dt, device=device)
    yield ("layers", "ln2"), torch.ones((l, d), dtype=dt, device=device)
    if cfg.use_mla:
        if cfg.q_lora_rank:
            yield dense("wq_a", (d, cfg.q_lora_rank), 0)
            yield dense("wq_b", (cfg.q_lora_rank, cfg.n_heads * cfg.qk_head_dim), 0)
        else:
            yield dense("wq", (d, cfg.n_heads * cfg.qk_head_dim), 0)
        yield dense("wkv_a", (d, cfg.kv_lora_rank + cfg.qk_rope_dim), 0)
        yield dense("wkv_b", (cfg.kv_lora_rank, cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)),
                    0)
        yield dense("wo", (cfg.n_heads * cfg.v_head_dim, d), 0)
    else:
        yield dense("wq", (d, cfg.n_heads * cfg.head_dim), 0)
        yield dense("wk", (d, cfg.n_kv_heads * cfg.head_dim), 0)
        yield dense("wv", (d, cfg.n_kv_heads * cfg.head_dim), 0)
        yield dense("wo", (cfg.n_heads * cfg.head_dim, d), 0)
    if cfg.is_moe:
        e, fe = cfg.n_experts, cfg.d_ff_expert
        yield dense("router", (d, e), 0)
        yield dense("we_gate", (e, d, fe), 1)
        yield dense("we_up", (e, d, fe), 1)
        yield dense("we_down", (e, fe, d), 1)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * fe
            yield dense("ws_gate", (d, fs), 0)
            yield dense("ws_up", (d, fs), 0)
            yield dense("ws_down", (fs, d), 0)
    else:
        yield dense("w_gate", (d, cfg.d_ff), 0)
        yield dense("w_up", (d, cfg.d_ff), 0)
        yield dense("w_down", (cfg.d_ff, d), 0)
    yield ("embed",), _dense(gen, (cfg.padded_vocab, d), dt, 1, device)
    yield ("final_norm",), torch.ones((d,), dtype=dt, device=device)
    yield ("lm_head",), _dense(gen, (d, cfg.padded_vocab), dt, 0, device)


def init_params(cfg: TransformerConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters in the reference's tree, drawn from ``gen`` (a
    generator on ``device``; ``None`` means ``cuda``) leaf after leaf in the
    reference's key order, each N(0, 1) over the square root of its fan-in."""
    params: Params = {"embed": None, "layers": {}, "final_norm": None, "lm_head": None}
    for path, x in _init_leaves(cfg, gen, resolve_device(device)):
        if path[0] == "layers":
            params["layers"][path[1]] = x
        else:
            params[path[0]] = x
    return params


def cast_params(cfg: TransformerConfig, params: Params) -> Params:
    """The tree with every leaf the reference casts at use (all but the
    norms) in the compute dtype: the functions below then cast nothing, and
    give the same values as on ``params``.  At fp32 compute the leaves are
    ``params``' own tensors."""
    cdt = cfg.compute_dtype
    return {
        "embed": params["embed"].to(cdt),
        "layers": {k: v if k in NORMS else v.to(cdt) for k, v in params["layers"].items()},
        "final_norm": params["final_norm"],
        "lm_head": params["lm_head"].to(cdt),
    }


def param_specs(cfg: TransformerConfig, fsdp: tuple[str, ...] = ("data",), tp: str = "model"):
    """Placement specs in :func:`init_params`' tree (FSDP x TP): the
    reference's ``PartitionSpec``s as tuples."""
    f = fsdp if len(fsdp) > 1 else fsdp[0]
    layer: dict[str, tuple] = {"ln1": (None, None), "ln2": (None, None)}
    two_d = (None, f, tp)  # (L, d_in, d_out): FSDP on in, TP on out
    out_proj = (None, tp, f)  # (L, h, d): TP on in, FSDP on out
    if cfg.use_mla:
        if cfg.q_lora_rank:
            layer["wq_a"] = (None, f, None)
            layer["wq_b"] = (None, None, tp)
        else:
            layer["wq"] = two_d
        layer["wkv_a"] = (None, f, None)
        layer["wkv_b"] = (None, None, tp)
        layer["wo"] = out_proj
    else:
        layer.update(wq=two_d, wk=two_d, wv=two_d, wo=out_proj)
    if cfg.is_moe:
        layer["router"] = (None, f, None)
        if cfg.expert_shard == "ff":
            # experts over TP, d_ff over FSDP: weights stay resident
            layer["we_gate"] = (None, tp, None, f)
            layer["we_up"] = (None, tp, None, f)
            layer["we_down"] = (None, tp, f, None)
        else:
            layer["we_gate"] = (None, tp, f, None)
            layer["we_up"] = (None, tp, f, None)
            layer["we_down"] = (None, tp, None, f)
        if cfg.n_shared_experts:
            layer.update(ws_gate=two_d, ws_up=two_d, ws_down=out_proj)
    else:
        layer.update(w_gate=two_d, w_up=two_d, w_down=out_proj)
    return {
        "embed": (tp, f),  # vocab over TP
        "layers": layer,
        "final_norm": (None,),
        "lm_head": (f, tp),  # logits vocab-sharded over TP
    }


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps=1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope(x, pos, theta):
    """x: (..., S, H, hd) with even hd; pos: (..., S)."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos[..., :, None, None].float() * freqs  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], -1).reshape(x.shape).to(x.dtype)


def _act(cfg, g):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(g, approximate="tanh") if cfg.act == "gelu" else F.silu(g)


def blockwise_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int):
    """Online-softmax attention; q (B,S,H,hd), k/v (B,T,KV,hd_v). GQA-aware.

    S and T are padded to whole chunks; padded keys take the position
    ``s_pad + t_pad``, so they never attend, and masked logits take
    ``-1e30``.  Each query row sees the KV chunks in the reference's order
    with its (max, sum, acc) carried in fp32; rows of several q chunks run
    together (``LOGIT_BYTES`` bounds their logits).  Under ``causal`` a KV
    chunk wholly after a group's last query is skipped: every logit of it
    is masked for every row of the group, so it would multiply the carry by
    ``exp(0)`` and add zeros.  (The reference's ``remat_chunks`` switch
    only chooses what its backward recomputes.)
    """
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = h // kvh  # query heads per kv head
    scale = hd**-0.5
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    s_pad = -(-s // q_chunk) * q_chunk
    t_pad = -(-t // kv_chunk) * kv_chunk
    dev = q.device
    qg = F.pad(q.float(), (0, 0, 0, 0, 0, s_pad - s)).reshape(b, s_pad, kvh, g, hd)
    qg = qg.permute(0, 2, 3, 1, 4)  # (b, kvh, g, s_pad, hd)
    kt = F.pad(k.float(), (0, 0, 0, 0, 0, t_pad - t)).permute(0, 2, 3, 1)  # (b, kvh, hd, t)
    vt = F.pad(v.float(), (0, 0, 0, 0, 0, t_pad - t)).permute(0, 2, 1, 3)  # (b, kvh, t, hd_v)
    ar = torch.arange(t_pad, device=dev)
    k_pos = torch.where(ar < t, ar, s_pad + t_pad)
    nk = t_pad // kv_chunk
    per_chunk = b * h * q_chunk * kv_chunk * 4
    # a meta tensor (the cell catalogue's shape-only run) holds no logits:
    # all q chunks in one group, so the op count does not grow with S * T
    chunks = (s_pad // q_chunk if dev.type == "meta"
              else max(1, min(LOGIT_BYTES // per_chunk, s_pad // q_chunk)))
    rows = q_chunk * chunks

    outs = []
    for r0 in range(0, s_pad, rows):
        r1 = min(r0 + rows, s_pad)
        n = r1 - r0
        qi = qg[:, :, :, r0:r1].reshape(b, kvh, g * n, hd)
        qpos = torch.arange(r0, r1, device=dev).repeat(g)  # rows in (g, n) order
        m = torch.full((b, kvh, g * n), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, g * n), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g * n, hd_v), dtype=torch.float32, device=dev)
        last = min(nk, (r1 - 1) // kv_chunk + 1) if causal else nk
        for j in range(last):
            c0, c1 = j * kv_chunk, (j + 1) * kv_chunk
            logits = (qi @ kt[..., c0:c1]) * scale
            kpos_j = k_pos[c0:c1]
            mask = kpos_j[None, :] < (s_pad + t_pad)  # drop padded KV
            if causal:
                mask = mask & (qpos[:, None] >= kpos_j[None, :])
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vt[:, :, c0:c1]
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.reshape(b, kvh, g, n, hd_v))
    out = torch.cat(outs, 3).permute(0, 3, 1, 2, 4).reshape(b, s_pad, h, hd_v)
    return out[:, :s]


# ---------------------------------------------------------------------------
# attention variants (train/prefill path)
# ---------------------------------------------------------------------------


def _attention(cfg: TransformerConfig, lp: Params, x, pos):
    b, s, d = x.shape
    cdt = cfg.compute_dtype
    if cfg.use_mla:
        if cfg.q_lora_rank:
            q = (x @ lp["wq_a"].to(cdt)) @ lp["wq_b"].to(cdt)
        else:
            q = x @ lp["wq"].to(cdt)
        q = q.reshape(b, s, cfg.n_heads, cfg.qk_head_dim)
        q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
        q_rope = rope(q_rope, pos, cfg.rope_theta)
        kv = x @ lp["wkv_a"].to(cdt)  # (b, s, r + rope)
        latent, k_rope = kv[..., : cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
        k_rope = rope(k_rope[:, :, None, :], pos, cfg.rope_theta)  # shared head
        kvu = latent @ lp["wkv_b"].to(cdt)  # (b, s, H*(nope+v))
        kvu = kvu.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
        k_nope, v = kvu[..., : cfg.qk_nope_dim], kvu[..., cfg.qk_nope_dim:]
        k = torch.cat([k_nope, k_rope.expand(b, s, cfg.n_heads, cfg.qk_rope_dim)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        o = blockwise_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
        o = o.reshape(b, s, cfg.n_heads * cfg.v_head_dim).to(cdt)
        return o @ lp["wo"].to(cdt)
    # GQA / MQA / MHA
    q = (x @ lp["wq"].to(cdt)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ lp["wk"].to(cdt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ lp["wv"].to(cdt)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    o = o.reshape(b, s, cfg.n_heads * cfg.head_dim).to(cdt)
    return o @ lp["wo"].to(cdt)


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------


def _dense_ffn(cfg, lp, x):
    cdt = cfg.compute_dtype
    g = _act(cfg, x @ lp["w_gate"].to(cdt))
    u = x @ lp["w_up"].to(cdt)
    return (g * u) @ lp["w_down"].to(cdt)


def top_k(x, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` orders ties otherwise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(cfg: TransformerConfig, router, x):
    """GShard capacity routing of ``x`` (..., d) in groups of ``moe_group``
    tokens -> (xt (ng, gsz, d), dispatch and combine (ng, gsz, e, cap),
    the one-hot choices (ng, gsz, k, e), the gates (ng, gsz, e), the token
    count)."""
    cdt = cfg.compute_dtype
    d = x.shape[-1]
    e, k = cfg.n_experts, cfg.top_k
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gsz = min(cfg.moe_group, t)
    t_pad = -(-t // gsz) * gsz
    tokens = F.pad(tokens, (0, 0, 0, t_pad - t))
    ng = t_pad // gsz
    cap = min(max(int(gsz * k * cfg.capacity_factor / e), 1), gsz)  # a host int
    xt = tokens.reshape(ng, gsz, d)

    logits = (xt @ router.to(cdt)).float()  # (ng, gsz, e)
    gates = torch.softmax(logits, -1)
    top_g, top_e = top_k(gates, k)  # (ng, gsz, k)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9)

    onehot = F.one_hot(top_e, e).float()  # (ng, gsz, k, e)
    # position of each (token, choice) in its expert buffer, token-major
    pos = torch.cumsum(onehot.reshape(ng, gsz * k, e), 1).reshape(ng, gsz, k, e) - 1.0
    keep = (pos < cap) * onehot
    # per-choice buffer position (gathered along e) -> no 5D (k,e,cap) tensor
    pos_k = torch.gather(pos, -1, top_e[..., None])[..., 0]
    cap_oh = (pos_k[..., None] == torch.arange(cap, device=x.device)).float()  # (ng,gsz,k,cap)
    dispatch = torch.einsum("gske,gskc->gsec", keep, cap_oh)  # (ng, gsz, e, cap)
    combine = torch.einsum("gske,gskc->gsec", keep * top_g[..., None], cap_oh)
    return xt, dispatch, combine, onehot, gates, t


def expert_ffn(cfg: TransformerConfig, we_gate, we_up, we_down, xt, dispatch, combine):
    """The experts of ``we_*`` (e', ...) over their columns of ``dispatch``
    and ``combine`` (ng, gsz, e', cap) -> their share of the output (ng,
    gsz, d)."""
    cdt = cfg.compute_dtype
    xin = torch.einsum("gsec,gsd->gecd", dispatch.to(cdt), xt)  # (ng, e', cap, d)
    hg = _act(cfg, torch.einsum("gecd,edf->gecf", xin, we_gate.to(cdt)))
    hu = torch.einsum("gecd,edf->gecf", xin, we_up.to(cdt))
    hout = torch.einsum("gecf,efd->gecd", hg * hu, we_down.to(cdt))
    return torch.einsum("gsec,gecd->gsd", combine.to(cdt), hout)


def _moe_ffn(cfg: TransformerConfig, lp: Params, x):
    """GShard capacity dispatch with fine-grained routing groups -> (y, aux)."""
    cdt = cfg.compute_dtype
    b, s, d = x.shape
    xt, dispatch, combine, onehot, gates, t = moe_route(cfg, lp["router"], x)
    y = expert_ffn(cfg, lp["we_gate"], lp["we_up"], lp["we_down"], xt, dispatch, combine)
    if cfg.n_shared_experts:
        gsh = _act(cfg, xt @ lp["ws_gate"].to(cdt))
        ush = xt @ lp["ws_up"].to(cdt)
        y = y + (gsh * ush) @ lp["ws_down"].to(cdt)
    # aux load-balance loss (GShard): mean fraction^2 per expert
    me = onehot.sum(2).mean(1)  # (ng, e) token fraction
    ce = gates.mean(1)
    aux = (me * ce).sum(-1).mean() * cfg.n_experts
    return y.reshape(-1, d)[:t].reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def _layer(cfg: TransformerConfig, lp: Params, x, pos):
    h = x + _attention(cfg, lp, rmsnorm(x, lp["ln1"]), pos)
    ff_in = rmsnorm(h, lp["ln2"])
    if cfg.is_moe:
        ff, aux = _moe_ffn(cfg, lp, ff_in)
    else:
        ff, aux = _dense_ffn(cfg, lp, ff_in), torch.zeros((), device=x.device)
    return h + ff, aux


def _layer_params(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params["layers"].items()}


def _embed(cfg, params, tokens):
    # gather, then cast: the same values as casting the table first
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def _mask_pad(cfg, logits):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return logits + pad.to(logits.dtype) * -1e9  # pad logits out of the softmax


def _hidden(cfg: TransformerConfig, params: Params, tokens):
    """tokens (B, S) -> (the last layer's output (B, S, d), aux_loss); under
    ``cfg.remat`` and autograd each layer is recomputed in the backward."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    pos = torch.arange(s, device=x.device).expand(b, s)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        args = (cfg, _layer_params(params, i), x, pos)
        x, a = (checkpoint(_layer, *args, use_reentrant=False, preserve_rng_state=False)
                if remat else _layer(*args))
        aux = aux + a
    return x, aux


def _head(cfg: TransformerConfig, params: Params, x):
    """(..., d) -> the final norm and the LM head: logits (..., V_pad)."""
    x = rmsnorm(x, params["final_norm"])
    return _mask_pad(cfg, x @ params["lm_head"].to(cfg.compute_dtype))


def forward(cfg: TransformerConfig, params: Params, tokens):
    """tokens (B, S) -> (logits (B, S, V_pad), aux_loss)."""
    x, aux = _hidden(cfg, params, tokens)
    return _head(cfg, params, x), aux


def loss_fn(cfg: TransformerConfig, params: Params, batch):
    """Next-token cross entropy (+0.01 * MoE aux)."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens[:, :-1])
    targets = tokens[:, 1:].long()
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - gold).mean() + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=None, device=None):
    """(L, B, S, cache_width) zeros — MLA stores the compressed latent +
    rope key.  ``device=None`` means ``cuda``."""
    return torch.zeros((cfg.n_layers, batch, max_seq, cfg.cache_width),
                       dtype=dtype or cfg.compute_dtype, device=resolve_device(device))


def cache_spec(fsdp=("data",), tp: str = "model") -> tuple:
    """Placement of the (L, B, S, W) cache: batch over the FSDP axes,
    sequence over TP."""
    f = fsdp if len(fsdp) > 1 else fsdp[0]
    return (None, f, tp, None)


def _write_cache(cache_l, new_entry, pos):
    """cache_l (B,S,W)[b, pos[b]] <- new_entry (B,W), in place."""
    rows = torch.arange(cache_l.shape[0], device=cache_l.device)
    cache_l[rows, pos] = new_entry.to(cache_l.dtype)


def _decode_attention(cfg: TransformerConfig, lp: Params, x, cache_l, pos):
    """One-token attention against a (B, S, cache_width) cache layer,
    attending over the whole window under the ``live`` mask.

    Writes the new row into ``cache_l`` and returns the output (B, 1, d).
    ``pos``: (B,) int64 current positions.
    """
    b = x.shape[0]
    cdt = cfg.compute_dtype
    s_max = cache_l.shape[1]
    live = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]  # (B, S)

    if cfg.use_mla:
        r = cfg.kv_lora_rank
        if cfg.q_lora_rank:
            q = (x @ lp["wq_a"].to(cdt)) @ lp["wq_b"].to(cdt)
        else:
            q = x @ lp["wq"].to(cdt)
        q = q.reshape(b, cfg.n_heads, cfg.qk_head_dim)
        q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
        q_rope = rope(q_rope[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        kv = (x @ lp["wkv_a"].to(cdt))[:, None, :]  # (B,1,r+rope)
        k_rope_new = rope(kv[..., r:][:, :, None, :], pos[:, None], cfg.rope_theta)[:, :, 0, :]
        _write_cache(cache_l, torch.cat([kv[..., :r], k_rope_new], -1)[:, 0], pos)
        c32 = cache_l.float()
        latent, k_rope = c32[..., :r], c32[..., r:]  # (B, S, r), (B, S, rope)
        # absorbed scores: q_nope -> latent space via wkv_b's k-part
        wkv_b = lp["wkv_b"].to(cdt).reshape(r, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
        w_uk = wkv_b[..., : cfg.qk_nope_dim].float()  # (r, H, nope)
        w_uv = wkv_b[..., cfg.qk_nope_dim:].float()  # (r, H, v)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope.float(), w_uk)
        scores = torch.einsum("bhr,bsr->bhs", q_lat, latent)
        scores = scores + torch.einsum("bhp,bsp->bhs", q_rope.float(), k_rope)
        scores = scores * cfg.qk_head_dim**-0.5
        scores = torch.where(live[:, None], scores, -1e30)
        w = torch.softmax(scores, -1)
        ctx_lat = torch.einsum("bhs,bsr->bhr", w, latent)
        o = torch.einsum("bhr,rhv->bhv", ctx_lat, w_uv)
        o = o.reshape(b, 1, cfg.n_heads * cfg.v_head_dim).to(cdt)
        return o @ lp["wo"].to(cdt)

    kvw = cfg.n_kv_heads * cfg.head_dim
    q = (x @ lp["wq"].to(cdt)).reshape(b, cfg.n_heads, cfg.head_dim)
    k_new = (x @ lp["wk"].to(cdt)).reshape(b, cfg.n_kv_heads, cfg.head_dim)
    v_new = (x @ lp["wv"].to(cdt)).reshape(b, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k_new = rope(k_new[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    _write_cache(cache_l, torch.cat([k_new.reshape(b, -1), v_new.reshape(b, -1)], -1), pos)
    c32 = cache_l.float()
    kc = c32[..., :kvw].reshape(b, s_max, cfg.n_kv_heads, cfg.head_dim)
    vc = c32[..., kvw:].reshape(b, s_max, cfg.n_kv_heads, cfg.head_dim)
    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, g, cfg.head_dim)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), kc) * cfg.head_dim**-0.5
    scores = torch.where(live[:, None, None], scores, -1e30)
    w = torch.softmax(scores, -1)
    o = torch.einsum("bkgs,bskd->bkgd", w, vc)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(cdt)
    return o @ lp["wo"].to(cdt)


def _decode_ffn(cfg, lp, x):
    if cfg.is_moe:
        # one token a slot: the routing group is the B slots (gsz = B)
        y, _ = _moe_ffn(cfg, lp, x)
        return y
    return _dense_ffn(cfg, lp, x)


def decode_step(cfg: TransformerConfig, params: Params, cache, tokens, pos):
    """One decode step. tokens (B,) ints, pos (B,) ints -> (logits (B,
    V_pad), cache); the new rows are written into ``cache`` in place."""
    pos = pos.long()
    x = _embed(cfg, params, tokens)[:, None, :]  # (B,1,d)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = x + _decode_attention(cfg, lp, rmsnorm(x, lp["ln1"])[:, 0], cache[i], pos)
        x = h + _decode_ffn(cfg, lp, rmsnorm(h, lp["ln2"]))
    x = rmsnorm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(cfg.compute_dtype))[:, 0]
    return _mask_pad(cfg, logits), cache


def prefill(cfg: TransformerConfig, params: Params, tokens):
    """Prefill pass: full forward returning last-position logits (cache fill
    is exercised by the decode path; prefill cells measure the forward).
    The head runs on the last position only, so the (B, V_pad) result is
    all that stays alive of the logits."""
    x, _ = _hidden(cfg, params, tokens)
    return _head(cfg, params, x[:, -1])
