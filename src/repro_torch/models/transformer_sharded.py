"""The transformer's prefill, decode and training loss over an R x C grid,
placed as the cell catalogue places them: FSDP over the grid rows, tensor
parallelism over the columns.

The program is written once, as a per-rank body against a
:class:`repro_torch.comm.grid.Grid` (per-rank lists of tensors), and runs
on a :class:`~repro_torch.comm.grid.SimGrid` (every rank in one process: the
CPU, one card, or ``meta`` for the dry-run) and on a
:class:`~repro_torch.comm.procgrid.ProcessGrid` (one process per rank, gloo
or NCCL).  Grid rows are the FSDP axes (``"data"``, or ``("pod", "data")``
folded), columns ``"model"``, rank ``p = i*C + j``.

**Placement** (:func:`serving_specs`): :func:`repro_torch.models.transformer.param_specs`
-- two-dimensional weights FSDP on their input dimension and TP on their
output, ``wo`` / ``w_down`` TP on their input, the vocabulary over TP,
experts over TP -- or its TP-only serving map (``tpserve``: the FSDP
entries dropped, the weights replicated over the rows).  The batch (the
tokens, the cache's slots) lies over the rows and the cache's sequence over
the columns (:func:`repro_torch.models.transformer.cache_spec`): rank
``(i, j)`` holds positions ``[j*S/C, (j+1)*S/C)`` of its slots.  The
placement is kept as the specs give it even where a head does not divide
over TP (gemma-2b's single kv head, deepseek-coder-33b's 8 kv heads over
16 columns): a rank gathers the columns it lacks before use.

**The program** (per layer, each weight's FSDP split all-gathered first --
the baseline layout's per-layer weight gather; none under ``tpserve``):

* embedding: a masked lookup of the rank's vocabulary range, ``psum`` over
  TP; where the table's model dimension lies over the rows, the lookup
  covers every token of the grid column (their ids all-gathered over the
  rows) and an all-to-all over the rows hands each rank its own tokens'
  full rows;
* prefill attention: column-parallel ``wq``/``wk``/``wv`` (MLA: ``wq_b``,
  ``wkv_b``), row-parallel ``wo`` and a ``psum`` over TP.  Rank ``j``
  computes the heads its rows of ``wo`` cover, taking their q, k and v
  columns from its own product, or from an all-gather over TP where they
  are not all its own;
* decode attention against the sequence-sharded cache: q, k and v (MLA:
  the absorbed query) all-gathered over TP, the new row written by the rank
  that owns ``pos``, each rank's scores and partial softmax over its own
  positions, combined by a ``pmax`` of the maxima and a ``psum`` of the
  rescaled sums and outputs;
* dense FFN: column-parallel gate and up, row-parallel down, ``psum``;
* MoE: the router and the capacity dispatch on the whole routing group (its
  tokens all-gathered over the rows where a group spans rows), each rank's
  experts, the shared experts column-parallel, the combine a ``psum`` over
  TP.  Under ``expert_shard="ff"`` (the ``experttp`` variant) the experts'
  ``d_ff`` stays split over the rows: every row computes its share for the
  column's tokens and the shares ``psum`` over the rows first;
* head: the final norm and ``lm_head``'s columns: logits vocabulary-sharded
  over TP, the padded ids masked on the rank that holds them.

The arithmetic is the single-device program's: the fp32 upcasts, the
``live`` mask, the router and the capacity drops.  Only the order of some
float sums changes (the ``psum`` of partial products, the softmax combined
over ranks).

**Training** (:func:`loss_fn`; the step is
:func:`repro_torch.train.step.make_sharded_train_step`): the forward over
every position (:func:`hidden`, each layer recomputed in the backward
under ``cfg.remat``), each rank's MoE aux loss over the routing groups it
routed, and a vocabulary-parallel cross entropy (:func:`token_losses`: no
rank holds more than its block of the logits, a chunk of the sequence at
a time).  Every collective of the program is differentiable: a gather's
transpose is the reduce-scatter of the same dimension, a ``psum``'s a
``psum``, the all-to-all its own inverse (``comm.grid.ad_*``); with no
input requiring a gradient each runs the grid's own collective, so serving
is unchanged.  A leaf replicated over an axis has its gradient summed over
it afterwards (:func:`sum_replicas`), and :func:`grad_norm` counts it
once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.comm.grid import COL_AXIS, Grid, ad_all_gather, ad_all_to_all, ad_psum
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as tfm

TP = COL_AXIS
RankParams = list  # per-rank parameter trees (None for ranks of other processes)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def tp_only(specs):
    """The TP-only serving layout (``tpserve``) of a spec tree: every entry
    but ``"model"`` dropped, so the weights are replicated over the rows."""
    return meshlib.map_specs(lambda sp: tuple(TP if e == TP else None for e in sp), specs)


def serving_specs(cfg: tfm.TransformerConfig, grid: Grid, tpserve: bool = False):
    """:func:`~repro_torch.models.transformer.param_specs` over the grid's
    axes, or its TP-only map."""
    specs = tfm.param_specs(cfg, fsdp=grid.row_axes, tp=TP)
    return tp_only(specs) if tpserve else specs


def grid_mesh(grid: Grid) -> meshlib.Mesh:
    """The mesh of the grid's axes: the row axes (folded as the grid folds
    them), then ``"model"``."""
    rows = tuple(grid.row_fold.values()) if grid.row_fold else (grid.rows,)
    return meshlib.make_mesh(rows + (grid.cols,), grid.row_axes + (TP,))


def _kind(entry, grid: Grid) -> str | None:
    """A spec entry on the grid: ``None`` (not split), ``"row"`` (over the
    row axes) or ``"col"`` (over TP)."""
    axes = meshlib.spec_axes(entry)
    if not axes:
        return None
    if axes == (TP,):
        return "col"
    if axes == grid.row_axes:
        return "row"
    raise ValueError(f"spec entry {entry!r} is neither the grid's row axes {grid.row_axes} "
                     f"nor {TP!r}")


def shard_leaf(x: torch.Tensor, spec: tuple, grid: Grid, p: int) -> torch.Tensor:
    """Rank ``p``'s shard of ``x`` under ``spec``: a view (``narrow``), its
    shape :func:`repro_torch.launch.mesh.shard_shape`'s."""
    shape = meshlib.shard_shape(x.shape, spec, grid_mesh(grid))
    i, j = divmod(p, grid.cols)
    for dim, entry in enumerate(spec[:x.dim()]):
        kind = _kind(entry, grid)
        if kind is not None:
            x = x.narrow(dim, (i if kind == "row" else j) * shape[dim], shape[dim])
    return x


def _map(fn, params, specs):
    return {k: _map(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
            for k, v in params.items()}


def shard_params(cfg: tfm.TransformerConfig, params, grid: Grid, specs=None) -> RankParams:
    """Each local rank's slice of every leaf of ``params`` (the reference's
    tree, e.g. from :func:`repro_torch.models.gnn.params_from_numpy`) under
    ``specs`` (default :func:`serving_specs`): views of ``params``' own
    tensors."""
    specs = serving_specs(cfg, grid) if specs is None else specs
    return grid.local(lambda p: _map(lambda x, sp: shard_leaf(x, sp, grid, p), params, specs))


def init_sharded(cfg: tfm.TransformerConfig, gen: torch.Generator, grid: Grid, specs=None,
                 device=None) -> RankParams:
    """The slices :func:`shard_params` gives of ``init_params(cfg, gen,
    device)``, each a tensor of its own, without ever holding the whole
    model: one leaf is drawn at a time, the local ranks' slices are copied
    out of it, and it is freed before the next is drawn (the largest leaf
    is the only transient)."""
    specs = serving_specs(cfg, grid) if specs is None else specs
    out = grid.local(lambda p: {"embed": None, "layers": {}, "final_norm": None,
                                "lm_head": None})
    for path, x in tfm._init_leaves(cfg, gen, device if device is not None else grid.device):
        spec = specs["layers"][path[1]] if path[0] == "layers" else specs[path[0]]
        for p in grid.local_ranks:
            own = shard_leaf(x, spec, grid, p).clone(memory_format=torch.contiguous_format)
            if path[0] == "layers":
                out[p]["layers"][path[1]] = own
            else:
                out[p][path[0]] = own
        del x
    return out


def cast_params(cfg: tfm.TransformerConfig, params: RankParams) -> RankParams:
    """:func:`repro_torch.models.transformer.cast_params` on each rank's
    slices."""
    return [None if x is None else tfm.cast_params(cfg, x) for x in params]


def shard_rows(grid: Grid, x: torch.Tensor) -> list:
    """Each local rank's rows of ``x`` (batch over the grid rows): grid row
    ``i`` takes the ``i``-th of R equal blocks of dim 0."""
    b = x.shape[0] // grid.rows
    if b * grid.rows != x.shape[0]:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {grid.rows} grid rows")
    return grid.local(lambda p: x.narrow(0, (p // grid.cols) * b, b))


def init_caches(cfg: tfm.TransformerConfig, grid: Grid, batch: int, max_seq: int,
                dtype=None) -> list:
    """Each local rank's block of the (L, B, S, cache_width) cache under
    :func:`~repro_torch.models.transformer.cache_spec`: (L, B/R, S/C, W)
    zeros on the grid's device."""
    spec = tfm.cache_spec(fsdp=grid.row_axes, tp=TP)
    shape = meshlib.shard_shape((cfg.n_layers, batch, max_seq, cfg.cache_width), spec,
                                grid_mesh(grid))
    return grid.local(lambda p: torch.zeros(shape, dtype=dtype or cfg.compute_dtype,
                                            device=grid.device))


def shard_cache(grid: Grid, cache: torch.Tensor) -> list:
    """Each local rank's block of a global cache: views, so the program's
    writes land in ``cache``."""
    spec = tfm.cache_spec(fsdp=grid.row_axes, tp=TP)
    return grid.local(lambda p: shard_leaf(cache, spec, grid, p))


def assemble(grid: Grid, xs: list, row_dim: int = 0, col_dim: int | None = -1) -> torch.Tensor:
    """The global tensor of per-rank blocks (rows over ``row_dim``, columns
    over ``col_dim``; ``None``: replicated over the columns), on a grid that
    holds every rank."""
    if set(grid.local_ranks) != set(range(grid.size)):
        raise ValueError("assemble needs every rank's block (a SimGrid)")
    c = grid.cols
    rows = [xs[i * c] if col_dim is None else torch.cat(xs[i * c:(i + 1) * c], col_dim)
            for i in range(grid.rows)]
    return torch.cat(rows, row_dim)


def unshard_leaf(grid: Grid, xs: list, spec: tuple) -> torch.Tensor:
    """The global tensor of every rank's slice of a leaf placed by ``spec``
    (the inverse of :func:`shard_leaf`), on a grid that holds every rank."""
    if set(grid.local_ranks) != set(range(grid.size)):
        raise ValueError("unshard_leaf needs every rank's slice (a SimGrid)")
    dims = {_kind(e, grid): dim for dim, e in enumerate(spec)}
    c = grid.cols

    def row(i):
        if "col" not in dims:
            return xs[i * c]
        return torch.cat([xs[i * c + j] for j in range(c)], dims["col"])

    if "row" not in dims:
        return row(0)
    return torch.cat([row(i) for i in range(grid.rows)], dims["row"])


def replicated_over(grid: Grid, spec: tuple):
    """The grid axes over which a leaf placed by ``spec`` is replicated
    (the row axes, ``"model"``, or both), or ``None``."""
    kinds = {_kind(e, grid) for e in spec}
    rows = "row" not in kinds and grid.rows > 1
    cols = "col" not in kinds and grid.cols > 1
    if rows and cols:
        return grid.all_axes
    if rows:
        return grid.row_axes
    return (TP,) if cols else None


# ---------------------------------------------------------------------------
# collectives (none over a group of one), differentiable: each runs the
# grid's own collective when no input requires a gradient
# ---------------------------------------------------------------------------


def _gather(grid: Grid, xs: list, axis, dim: int) -> list:
    """Tiled all-gather along ``dim``; its transpose is the reduce-scatter
    of the same ``dim``."""
    if grid.group_size(axis) == 1:
        return xs
    if dim == 0:
        return ad_all_gather(grid, xs, axis, scatter=True)
    moved = ad_all_gather(grid, grid.local(lambda p: xs[p].movedim(dim, 0).contiguous()), axis,
                          scatter=True)
    return grid.local(lambda p: moved[p].movedim(0, dim))


def _psum(grid: Grid, xs: list, axis) -> list:
    return xs if grid.group_size(axis) == 1 else ad_psum(grid, xs, axis)


def _use(grid: Grid, xs: list, spec: tuple, keep=()) -> list:
    """A weight as the program uses it: its FSDP split all-gathered on every
    dimension but those of ``keep``; only the TP split remains."""
    for dim, entry in enumerate(spec):
        if dim not in keep and _kind(entry, grid) == "row":
            xs = _gather(grid, xs, grid.row_axes, dim)
    return xs


def _cols(grid: Grid, xs: list, total: int, want) -> list:
    """Columns ``want(p) = (lo, hi)`` of a last dimension of ``total``
    split over TP (rank ``j`` holds ``[j*w, (j+1)*w)``): local slices when
    every rank's range is its own, else slices of an all-gather over TP.
    The choice depends on the geometry only, so every process makes it
    alike."""
    w = total // grid.cols

    def own(p):
        return (p % grid.cols) * w

    if all(own(p) <= want(p)[0] and want(p)[1] <= own(p) + w for p in range(grid.size)):
        return grid.local(lambda p: xs[p][..., want(p)[0] - own(p):want(p)[1] - own(p)])
    full = _gather(grid, xs, TP, xs[grid.local_ranks[0]].dim() - 1)
    return grid.local(lambda p: full[p][..., want(p)[0]:want(p)[1]])


def _batched(grid: Grid, fn, *lists) -> list:
    """``fn`` over the local ranks' tensors, the ranks whose tensors have the
    same shapes run as one call on their tensors concatenated along dim 0
    (rows are independent in ``fn``; a ``SimGrid`` then makes one call
    where it would make R*C, on ``meta`` as on a card)."""
    classes: dict = {}
    for p in grid.local_ranks:
        classes.setdefault(tuple(tuple(xs[p].shape) for xs in lists), []).append(p)
    out = grid._new()
    for ranks in classes.values():
        if len(ranks) == 1:
            out[ranks[0]] = fn(*(xs[ranks[0]] for xs in lists))
            continue
        y = fn(*(torch.cat([xs[p] for p in ranks]) for xs in lists))
        for p, part in zip(ranks, torch.chunk(y, len(ranks))):
            out[p] = part
    return out


def _head_range(grid: Grid, p: int, total: int, width: int) -> tuple[int, int, int, int]:
    """Rank ``p``'s rows ``[lo, hi)`` of a TP row split of ``total`` =
    heads x ``width`` (``wo``'s input), and the heads ``[h0, h1)`` they
    cover."""
    w = total // grid.cols
    lo = (p % grid.cols) * w
    hi = lo + w
    return lo, hi, lo // width, -(-hi // width)


def _kv_index(h0: int, h1: int, g: int) -> tuple[int, int, list[int] | None]:
    """The kv heads ``[k0, k1)`` of q heads ``[h0, h1)`` (``g`` q heads a kv
    head), and the index that repeats them per q head where the local
    grouping is not ``blockwise_attention``'s (else ``None``)."""
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    nh, nk = h1 - h0, k1 - k0
    idx = [(h0 + a) // g - k0 for a in range(nh)]
    if nh % nk == 0 and idx == [a // (nh // nk) for a in range(nh)]:
        return k0, k1, None
    return k0, k1, idx


# ---------------------------------------------------------------------------
# embedding and head
# ---------------------------------------------------------------------------


def _embed(cfg: tfm.TransformerConfig, grid: Grid, table: list, spec: tuple, toks: list) -> list:
    """Token ids (b, ...) per rank -> their rows (b, ..., d) in the compute
    dtype."""
    vkind, dkind = _kind(spec[0], grid), _kind(spec[1], grid)
    if dkind == "row":  # the column's tokens: this rank holds a d-slice of them all
        toks = _gather(grid, toks, grid.row_axes, 0)

    def look(p):
        t, w = toks[p].long(), table[p]
        if vkind == "col":
            t = t - (p % grid.cols) * w.shape[0]
            hit = (t >= 0) & (t < w.shape[0])
            return torch.where(hit[..., None], w[t.clamp(0, w.shape[0] - 1)], 0).to(
                cfg.compute_dtype)
        return w[t].to(cfg.compute_dtype)

    xs = grid.local(look)
    if vkind == "col":
        xs = _psum(grid, xs, TP)
    if dkind == "row" and grid.group_size(grid.row_axes) > 1:
        # rank (i', j) holds d-slice i' of every token of the column: the
        # all-to-all hands rank (i, j) every d-slice of its own tokens
        r = grid.rows
        xs = ad_all_to_all(grid, xs, grid.row_axes)
        xs = grid.local(lambda p: xs[p].reshape(r, -1, *xs[p].shape[1:]).movedim(0, -2)
                        .flatten(-2))
    return xs


def _head_weight(cfg: tfm.TransformerConfig, grid: Grid, prm: RankParams, specs) -> list:
    """``lm_head`` as each rank uses it: its vocabulary columns (d,
    V_pad/C), the FSDP split gathered, in the compute dtype."""
    return _use(grid, grid.local(lambda p: prm[p]["lm_head"].to(cfg.compute_dtype)),
                specs["lm_head"])


def _vocab_lo(grid: Grid, specs, p: int, vc: int) -> int:
    """The first vocabulary id of rank ``p``'s ``vc`` logit columns."""
    return (p % grid.cols) * vc if _kind(specs["lm_head"][1], grid) == "col" else 0


def _logits(cfg: tfm.TransformerConfig, x, norm, head, lo: int):
    """The final norm of ``x`` (..., d) times a block of ``lm_head``'s
    columns from id ``lo`` on, the padded ids masked."""
    y = tfm.rmsnorm(x, norm) @ head
    if cfg.padded_vocab == cfg.vocab:
        return y
    pad = torch.arange(lo, lo + y.shape[-1], device=y.device) >= cfg.vocab
    return y + pad.to(y.dtype) * -1e9


def _head(cfg: tfm.TransformerConfig, grid: Grid, prm: RankParams, specs, xs: list) -> list:
    """(b, d) per rank -> its vocabulary columns of the logits (b, V_pad/C),
    the padded ids masked."""
    head = _head_weight(cfg, grid, prm, specs)
    return grid.local(lambda p: _logits(cfg, xs[p], prm[p]["final_norm"], head[p],
                                        _vocab_lo(grid, specs, p, head[p].shape[-1])))


# ---------------------------------------------------------------------------
# one layer's weights
# ---------------------------------------------------------------------------


def _resident(cfg: tfm.TransformerConfig, key: str) -> tuple[int, ...]:
    """The dimensions of a layer leaf (layer dim dropped) that keep their
    FSDP split: the experts' ``d_ff`` under ``expert_shard="ff"``."""
    if cfg.expert_shard != "ff":
        return ()
    return {"we_gate": (2,), "we_up": (2,), "we_down": (1,)}.get(key, ())


def _layer(cfg: tfm.TransformerConfig, grid: Grid, prm: RankParams, specs, l: int) -> list:
    """Layer ``l``'s weights on each local rank, their FSDP split gathered
    (but the resident experts'), in the compute dtype."""
    out = grid.local(lambda p: {})
    for key, spec in specs["layers"].items():
        xs = grid.local(lambda p: prm[p]["layers"][key][l])
        if key not in tfm.NORMS:  # cast before the gather: half the bytes in bf16
            xs = grid.local(lambda p: xs[p].to(cfg.compute_dtype))
        xs = _use(grid, xs, spec[1:], keep=_resident(cfg, key))
        for p in grid.local_ranks:
            out[p][key] = xs[p]
    return out


# ---------------------------------------------------------------------------
# prefill attention (heads over TP)
# ---------------------------------------------------------------------------


def _attention(cfg: tfm.TransformerConfig, grid: Grid, w: list, xs: list, pos) -> list:
    """Causal attention of the normed (b, s, d) per rank -> the layer's
    attention output (b, s, d), replicated over TP."""
    h = cfg.n_heads
    hd_v = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
    ranges = {p: _head_range(grid, p, h * hd_v, hd_v) for p in range(grid.size)}
    qk = cfg.qk_head_dim

    def attention(q, k, v):
        return tfm.blockwise_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                       kv_chunk=cfg.kv_chunk)

    def heads(width):
        return lambda p: (ranges[p][2] * width, ranges[p][3] * width)

    if cfg.use_mla:
        r, nope = cfg.kv_lora_rank, cfg.qk_nope_dim
        if cfg.q_lora_rank:
            qc = grid.local(lambda p: (xs[p] @ w[p]["wq_a"]) @ w[p]["wq_b"])
        else:
            qc = grid.local(lambda p: xs[p] @ w[p]["wq"])
        kv = grid.local(lambda p: xs[p] @ w[p]["wkv_a"])  # (b, s, r + rope), replicated
        kvu = grid.local(lambda p: kv[p][..., :r] @ w[p]["wkv_b"])
        qh = _cols(grid, qc, h * qk, heads(qk))
        kvh = _cols(grid, kvu, h * (nope + hd_v), heads(nope + hd_v))

        def qkv(p):
            b, s = xs[p].shape[:2]
            nh = ranges[p][3] - ranges[p][2]
            u = kvh[p].reshape(b, s, nh, nope + hd_v)
            return (qh[p].reshape(b, s, nh, qk), kv[p][..., r:][:, :, None, :], u[..., :nope],
                    u[..., nope:])

        def roped(q, k_rope, k_nope, v):  # rope per element: the same values batched
            at = pos[0]
            q = torch.cat([q[..., :nope], tfm.rope(q[..., nope:], at, cfg.rope_theta)], -1)
            k_rope = tfm.rope(k_rope, at, cfg.rope_theta)
            k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], cfg.qk_rope_dim)], -1)
            return attention(q, k, v)

        parts = grid.local(qkv)
        o = _batched(grid, roped, *(grid.local(lambda p, a=a: parts[p][a]) for a in range(4)))

        def attend(p):
            b, s = xs[p].shape[:2]
            lo, hi, h0, h1 = ranges[p]
            y = o[p].reshape(b, s, (h1 - h0) * hd_v)[..., lo - h0 * hd_v:hi - h0 * hd_v]
            return y.to(cfg.compute_dtype) @ w[p]["wo"]

        return _psum(grid, grid.local(attend), TP)

    hd, kvh_n = cfg.head_dim, cfg.n_kv_heads
    g = h // kvh_n
    kvr = {p: _kv_index(ranges[p][2], ranges[p][3], g) for p in range(grid.size)}
    qh = _cols(grid, grid.local(lambda p: xs[p] @ w[p]["wq"]), h * hd, heads(hd))

    def kv_cols(p):
        return kvr[p][0] * hd, kvr[p][1] * hd

    kh = _cols(grid, grid.local(lambda p: xs[p] @ w[p]["wk"]), kvh_n * hd, kv_cols)
    vh = _cols(grid, grid.local(lambda p: xs[p] @ w[p]["wv"]), kvh_n * hd, kv_cols)

    def qkv(p):
        b, s = xs[p].shape[:2]
        _, _, h0, h1 = ranges[p]
        k0, k1, idx = kvr[p]
        q = qh[p].reshape(b, s, h1 - h0, hd)
        k = kh[p].reshape(b, s, k1 - k0, hd)
        v = vh[p].reshape(b, s, k1 - k0, hd)
        if idx is not None:  # the rank's q heads straddle kv groups: one kv head each
            k, v = k[:, :, idx], v[:, :, idx]
        return q, k, v

    def roped(q, k, v):  # rope per element: the same values batched over ranks
        at = pos[0]
        return attention(tfm.rope(q, at, cfg.rope_theta), tfm.rope(k, at, cfg.rope_theta), v)

    parts = grid.local(qkv)
    o = _batched(grid, roped, *(grid.local(lambda p, a=a: parts[p][a]) for a in range(3)))

    def attend(p):
        b, s = xs[p].shape[:2]
        lo, hi, h0, h1 = ranges[p]
        y = o[p].reshape(b, s, (h1 - h0) * hd)[..., lo - h0 * hd:hi - h0 * hd]
        return y.to(cfg.compute_dtype) @ w[p]["wo"]

    return _psum(grid, grid.local(attend), TP)


# ---------------------------------------------------------------------------
# decode attention (sequence over TP)
# ---------------------------------------------------------------------------


def _write_rows(cache_l, new, pos, lo: int) -> None:
    """Write ``new`` (B, W) at ``pos`` into the rank's positions ``[lo, lo
    + S/C)`` of ``cache_l`` (B, S/C, W), in place: a slot whose ``pos`` is
    another rank's writes its own old value back (no host sync)."""
    sc = cache_l.shape[1]
    local = pos - lo
    mine = (local >= 0) & (local < sc)
    rows = torch.arange(cache_l.shape[0], device=cache_l.device)
    at = local.clamp(0, sc - 1)
    cache_l[rows, at] = torch.where(mine[:, None], new.to(cache_l.dtype), cache_l[rows, at])


def _combine(grid: Grid, scores: list, values, einsum: str) -> list:
    """Softmax over every rank's positions of the (…, S/C) ``scores`` per
    rank, times ``values(p)``: each rank's max, sum and weighted values,
    combined by ``pmax`` and ``psum`` over TP."""
    m = grid.local(lambda p: scores[p].amax(-1))
    big = _reduce_max(grid, m)

    def part(p):
        e = torch.exp(scores[p] - m[p][..., None])
        f = torch.exp(m[p] - big[p])
        acc = torch.einsum(einsum, e, values(p)) * f[..., None]
        return torch.cat([acc, (e.sum(-1) * f)[..., None]], -1)

    tot = _psum(grid, grid.local(part), TP)
    return grid.local(lambda p: tot[p][..., :-1] / tot[p][..., -1:])


def _reduce_max(grid: Grid, xs: list) -> list:
    """The ``pmax`` over TP of a softmax's shift, which takes no gradient."""
    xs = grid.local(lambda p: xs[p].detach())
    return xs if grid.group_size(TP) == 1 else grid.pmax(xs, TP)


def _decode_attention(cfg: tfm.TransformerConfig, grid: Grid, w: list, xs: list, caches: list,
                      pos: list) -> list:
    """One token a slot: the normed (b, d) per rank against its block of a
    cache layer (b, S/C, W), the new rows written -> the attention output
    (b, 1, d), replicated over TP."""
    h, cdt = cfg.n_heads, cfg.compute_dtype
    sc = caches[grid.local_ranks[0]].shape[1]

    def lo(p):
        return (p % grid.cols) * sc

    def live(p):
        t = lo(p) + torch.arange(sc, device=xs[p].device)
        return t[None, :] <= pos[p][:, None]  # (b, S/C)

    def out(o):  # o (b, H*hd_v) on every rank -> its rows of wo, psum
        hd_v = cfg.v_head_dim if cfg.use_mla else cfg.head_dim

        def proj(p):
            a, z, _, _ = _head_range(grid, p, h * hd_v, hd_v)
            return (o[p][:, a:z].to(cdt) @ w[p]["wo"])[:, None]

        return _psum(grid, grid.local(proj), TP)

    if cfg.use_mla:
        r, nope, hd_v, qk = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.v_head_dim, cfg.qk_head_dim
        ranges = {p: _head_range(grid, p, h * hd_v, hd_v) for p in range(grid.size)}
        if cfg.q_lora_rank:
            qc = grid.local(lambda p: (xs[p] @ w[p]["wq_a"]) @ w[p]["wq_b"])
        else:
            qc = grid.local(lambda p: xs[p] @ w[p]["wq"])
        qh = _cols(grid, qc, h * qk, lambda p: (ranges[p][2] * qk, ranges[p][3] * qk))
        wb = _cols(grid, grid.local(lambda p: w[p]["wkv_b"]), h * (nope + hd_v),
                   lambda p: (ranges[p][2] * (nope + hd_v), ranges[p][3] * (nope + hd_v)))

        def own_query(p):  # the rank's heads' absorbed query and rope query
            b, (_, _, h0, h1) = xs[p].shape[0], ranges[p]
            q = qh[p].reshape(b, h1 - h0, qk)
            q_rope = tfm.rope(q[..., nope:][:, None], pos[p][:, None], cfg.rope_theta)[:, 0]
            w_uk = wb[p].reshape(r, h1 - h0, nope + hd_v)[..., :nope].float()
            q_lat = torch.einsum("bhn,rhn->bhr", q[..., :nope].float(), w_uk)
            kv = xs[p] @ w[p]["wkv_a"]
            k_rope = tfm.rope(kv[:, None, r:][:, :, None, :], pos[p][:, None],
                              cfg.rope_theta)[:, 0, 0, :]
            _write_rows(caches[p], torch.cat([kv[:, :r], k_rope], -1), pos[p], lo(p))
            q = torch.cat([q_lat, q_rope.float()], -1)  # (b, nh, r + rope)
            return F.pad(q, (0, 0, 0, widest - (h1 - h0)))

        widest = max(z - a for _, _, a, z in ranges.values())
        qs = _gather(grid, grid.local(own_query), TP, 1)
        heads = _unique_heads(grid, ranges, widest)

        def scores(p):
            q = qs[p] if heads is None else qs[p][:, heads]
            c = caches[p].float()
            s = (torch.einsum("bhr,bsr->bhs", q[..., :r], c[..., :r])
                 + torch.einsum("bhp,bsp->bhs", q[..., r:], c[..., r:])) * qk**-0.5
            return torch.where(live(p)[:, None], s, -1e30)

        sc_ = grid.local(scores)
        ctx = _combine(grid, sc_, lambda p: caches[p][..., :r].float(), "bhs,bsr->bhr")

        def value(p):  # the rank's heads' outputs, as wo's rows of them
            b, (a, z, h0, h1) = xs[p].shape[0], ranges[p]
            w_uv = wb[p].reshape(r, h1 - h0, nope + hd_v)[..., nope:].float()
            o = torch.einsum("bhr,rhv->bhv", ctx[p][:, h0:h1], w_uv).reshape(b, -1)
            return (o[:, a - h0 * hd_v:z - h0 * hd_v].to(cdt) @ w[p]["wo"])[:, None]

        return _psum(grid, grid.local(value), TP)

    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    g = h // kvh
    kvw = kvh * hd
    cat = grid.local(lambda p: torch.cat([xs[p] @ w[p]["wq"], xs[p] @ w[p]["wk"],
                                          xs[p] @ w[p]["wv"]], -1))
    full = _gather(grid, grid.local(lambda p: cat[p][:, None]), TP, 1)  # (b, C, seg)
    widths = [h * hd // grid.cols, kvw // grid.cols, kvw // grid.cols]

    def attend_scores(p):
        b = xs[p].shape[0]
        q, k, v = (t.reshape(b, -1) for t in torch.split(full[p], widths, -1))
        q = tfm.rope(q.reshape(b, 1, h, hd), pos[p][:, None], cfg.rope_theta)[:, 0]
        k = tfm.rope(k.reshape(b, 1, kvh, hd), pos[p][:, None], cfg.rope_theta)[:, 0]
        _write_rows(caches[p], torch.cat([k.reshape(b, -1), v], -1), pos[p], lo(p))
        kc = caches[p][..., :kvw].float().reshape(b, sc, kvh, hd)
        s = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, kvh, g, hd).float(), kc) * hd**-0.5
        return torch.where(live(p)[:, None, None], s, -1e30)

    sc_ = grid.local(attend_scores)
    o = _combine(grid, sc_, lambda p: caches[p][..., kvw:].float().reshape(
        xs[p].shape[0], sc, kvh, hd), "bkgs,bskd->bkgd")
    return out(grid.local(lambda p: o[p].reshape(o[p].shape[0], h * hd)))


def _unique_heads(grid: Grid, ranges: dict, widest: int) -> list[int] | None:
    """The TP ranks' head ranges, each padded to ``widest`` heads and
    concatenated: the index of each head's first copy, or ``None`` where
    the concatenation is every head once, in order."""
    cat = [hh if a < z - h0 else -1 for j in range(grid.cols)
           for (_, _, h0, z) in [ranges[j]] for a in range(widest) for hh in [h0 + a]]
    n = max(cat) + 1
    if cat == list(range(n)):
        return None
    return [cat.index(hh) for hh in range(n)]


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def _ffn(cfg: tfm.TransformerConfig, grid: Grid, specs, w: list, xs: list,
         aux: bool = False) -> tuple[list, list | None]:
    """The normed (b, s, d) per rank -> (the FFN output, replicated over TP;
    with ``aux``, each rank's MoE load-balance loss, else ``None``).

    The aux is the reference's mean over the routing groups the rank
    routed: its own rows' groups, or where they are routed gathered (a
    group spanning rows, or the experts' ``d_ff`` over the rows) every
    group of the column, each once -- the whole batch's.  Either way the
    mean of the ranks' aux over the grid is the reference's over the
    global batch (every row routes as many groups).  The experts' row
    ``psum`` under ``expert_shard="ff"`` sums outputs only."""
    if not cfg.is_moe:
        y = _psum(grid, grid.local(lambda p: tfm._dense_ffn(cfg, w[p], xs[p])), TP)
        return y, (grid.local(lambda p: torch.zeros((), device=xs[p].device)) if aux else None)
    r0 = grid.local_ranks[0]
    b, s, d = xs[r0].shape
    e_loc = w[r0]["we_gate"].shape[0]
    rows = grid.group_size(grid.row_axes)
    # the experts' d_ff kept over the rows (expert_shard="ff"): every row
    # computes its share for the column's tokens, the shares psum over the rows
    ff_rows = rows > 1 and any(_kind(specs["layers"][k][1 + dim], grid) == "row"
                               for k in ("we_gate", "we_up", "we_down")
                               for dim in _resident(cfg, k))
    # a routing group that spans rows: the column's tokens are routed
    spans = (b * s) % min(cfg.moe_group, b * s * grid.rows) != 0
    gathered = rows > 1 and (ff_rows or spans)
    xa = _gather(grid, xs, grid.row_axes, 0) if gathered else xs
    routed = grid.local(lambda p: tfm.moe_route(cfg, w[p]["router"], xa[p])[:5])

    def experts(p):
        xt, dispatch, combine = routed[p][:3]
        e0 = (p % grid.cols) * e_loc
        return tfm.expert_ffn(cfg, w[p]["we_gate"], w[p]["we_up"], w[p]["we_down"], xt,
                              dispatch[:, :, e0:e0 + e_loc], combine[:, :, e0:e0 + e_loc])

    ys = grid.local(experts)
    if ff_rows:
        ys = _psum(grid, ys, grid.row_axes)

    def with_shared(p):
        if not cfg.n_shared_experts:
            return ys[p]
        xt = routed[p][0]
        gsh = tfm._act(cfg, xt @ w[p]["ws_gate"])
        return ys[p] + (gsh * (xt @ w[p]["ws_up"])) @ w[p]["ws_down"]

    ys = _psum(grid, grid.local(with_shared), TP)

    def own(p):
        n = xa[p].shape[0]
        y = ys[p].reshape(-1, d)[:n * s].reshape(n, s, d)
        return y.narrow(0, (p // grid.cols) * b, b) if gathered else y

    def balance(p):
        onehot, gates = routed[p][3:5]
        return (onehot.sum(2).mean(1) * gates.mean(1)).sum(-1).mean() * cfg.n_experts

    return grid.local(own), (grid.local(balance) if aux else None)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def _n_layers(cfg, layers) -> int:
    return cfg.n_layers if layers is None else layers


def _block(cfg: tfm.TransformerConfig, grid: Grid, params: RankParams, specs, l: int, xs: list,
           pos, aux: bool = False) -> tuple[list, list | None]:
    """Layer ``l`` over each rank's (b, s, d) -> (its output, each rank's
    MoE aux with ``aux``)."""
    w = _layer(cfg, grid, params, specs, l)
    a = _attention(cfg, grid, w, grid.local(lambda p: tfm.rmsnorm(xs[p], w[p]["ln1"])), pos)
    hs = grid.local(lambda p: xs[p] + a[p])
    f, ax = _ffn(cfg, grid, specs, w, grid.local(lambda p: tfm.rmsnorm(hs[p], w[p]["ln2"])), aux)
    return grid.local(lambda p: hs[p] + f[p]), ax


def prefill(cfg: tfm.TransformerConfig, grid: Grid, params: RankParams, tokens: list,
            specs=None, *, layers: int | None = None) -> list:
    """Prefill over the grid: each rank's tokens (b, S) (its rows of the
    batch) -> its block of the last position's logits (b, V_pad/C).
    ``params``: each rank's slices (:func:`shard_params`,
    :func:`init_sharded`), in the parameter or the compute dtype.
    ``layers`` runs the first that many layers only (the dry-run counts one
    and scales)."""
    specs = serving_specs(cfg, grid) if specs is None else specs
    xs = _embed(cfg, grid, grid.local(lambda p: params[p]["embed"]), specs["embed"], tokens)
    r0 = grid.local_ranks[0]
    b, s = tokens[r0].shape
    pos = torch.arange(s, device=xs[r0].device).expand(b, s)
    for l in range(_n_layers(cfg, layers)):
        xs, _ = _block(cfg, grid, params, specs, l, xs, pos)
    return _head(cfg, grid, params, specs, grid.local(lambda p: xs[p][:, -1]))


def decode_step(cfg: tfm.TransformerConfig, grid: Grid, params: RankParams, caches: list,
                tokens: list, pos: list, specs=None, *, layers: int | None = None) -> list:
    """One decode step over the grid: each rank's tokens and positions (b,)
    (its slots) -> its block of the logits (b, V_pad/C); the new rows are
    written into each rank's cache block (L, b, S/C, W) in place."""
    specs = serving_specs(cfg, grid) if specs is None else specs
    pos = grid.local(lambda p: pos[p].long())
    xs = _embed(cfg, grid, grid.local(lambda p: params[p]["embed"]), specs["embed"], tokens)
    xs = grid.local(lambda p: xs[p][:, None, :])  # (b, 1, d)
    for l in range(_n_layers(cfg, layers)):
        w = _layer(cfg, grid, params, specs, l)
        a = _decode_attention(cfg, grid, w,
                              grid.local(lambda p: tfm.rmsnorm(xs[p], w[p]["ln1"])[:, 0]),
                              grid.local(lambda p: caches[p][l]), pos)
        hs = grid.local(lambda p: xs[p] + a[p])
        f, _ = _ffn(cfg, grid, specs, w, grid.local(lambda p: tfm.rmsnorm(hs[p], w[p]["ln2"])))
        xs = grid.local(lambda p: hs[p] + f[p])
        del w, a, hs, f
    return _head(cfg, grid, params, specs, grid.local(lambda p: xs[p][:, 0]))


def gather_logits(grid: Grid, logits: list) -> list:
    """Each rank's vocabulary block (b, V_pad/C) -> its rows' whole logits
    (b, V_pad), all-gathered over TP."""
    return _gather(grid, logits, TP, 1)



# ---------------------------------------------------------------------------
# training: the forward over every position, the vocabulary-parallel loss
# ---------------------------------------------------------------------------

#: the fp32 logits (b, c, V_pad/C) one chunk of the loss holds at once
LOSS_BYTES = 1 << 30


def _unstacked(prm: dict, n: int) -> dict:
    """A rank's tree with each layer leaf split into its first ``n`` layers
    (one autograd node whose backward stacks their gradients once)."""
    def split(v):
        return (v if n == v.shape[0] else v[:n]).unbind(0)

    return dict(prm, layers={k: split(v) for k, v in prm["layers"].items()})


def hidden(cfg: tfm.TransformerConfig, grid: Grid, params: RankParams, tokens: list, specs=None,
           *, layers: int | None = None) -> tuple[list, list]:
    """The forward over every position: each rank's tokens (b, S) -> (the
    last layer's output (b, S, d), replicated over TP; each rank's MoE aux
    summed over the layers, 0-d fp32).  Under ``cfg.remat`` and autograd
    each layer is recomputed in the backward (its FSDP gathers and TP sums
    with it) and keeps only its input, as the reference's
    ``nothing_saveable`` checkpoint does."""
    specs = serving_specs(cfg, grid) if specs is None else specs
    n = _n_layers(cfg, layers)
    params = grid.local(lambda p: _unstacked(params[p], n))
    xs = _embed(cfg, grid, grid.local(lambda p: params[p]["embed"]), specs["embed"], tokens)
    r0 = grid.local_ranks[0]
    b, s = tokens[r0].shape
    pos = torch.arange(s, device=xs[r0].device).expand(b, s)
    aux = grid.local(lambda p: torch.zeros((), device=xs[p].device))
    remat = cfg.remat and torch.is_grad_enabled()
    for l in range(n):
        args = (cfg, grid, params, specs, l, xs, pos, True)
        xs, a = (checkpoint(_block, *args, use_reentrant=False, preserve_rng_state=False)
                 if remat else _block(*args))
        aux = grid.local(lambda p: aux[p] + a[p])
    return xs, aux


def _ce_parts(cfg: tfm.TransformerConfig, x, norm, head, lo: int, targets):
    """One rank's (b, c, d) rows and targets (b, c) against its logit block
    -> the block's row max (no gradient), the sum of ``exp(logit - max)``
    over the block, and the target's logit where the block holds it (else
    0), each (b, c) fp32."""
    y = _logits(cfg, x, norm, head, lo).float()
    m = y.amax(-1).detach()
    se = torch.exp(y - m[..., None]).sum(-1)
    rel = targets.long() - lo
    hit = (rel >= 0) & (rel < y.shape[-1])
    gold = torch.gather(y, -1, rel.clamp(0, y.shape[-1] - 1)[..., None])[..., 0]
    return m, se, torch.where(hit, gold, 0.0)


def token_losses(cfg: tfm.TransformerConfig, grid: Grid, params: RankParams, specs, xs: list,
                 targets: list) -> list:
    """The next-token cross entropy of each rank's rows (b, S) in fp32,
    replicated over TP, from the vocabulary-sharded logits: each rank's
    block max, sum of exponentials and target logit, then one ``pmax`` over
    TP of the maxima (no gradient) and one ``psum`` of the rescaled sums
    and the target logits.  No rank holds the (b, S, V_pad) logits: its
    block is computed in chunks of the sequence (:data:`LOSS_BYTES`), each
    recomputed in the backward and holding no logits in between (on
    ``meta``, one chunk and no recomputation)."""
    head = _head_weight(cfg, grid, params, specs)
    r0 = grid.local_ranks[0]
    b, s, _ = xs[r0].shape
    vc = head[r0].shape[-1]
    meta = xs[r0].device.type == "meta"
    chunk = s if meta else max(1, min(s, LOSS_BYTES // (b * vc * 4)))
    fit = not meta and torch.is_grad_enabled()

    def parts(p):
        lo, pieces = _vocab_lo(grid, specs, p, vc), []
        for c0 in range(0, s, chunk):
            a = (cfg, xs[p][:, c0:c0 + chunk], params[p]["final_norm"], head[p], lo,
                 targets[p][:, c0:c0 + chunk])
            pieces.append(checkpoint(_ce_parts, *a, use_reentrant=False, preserve_rng_state=False)
                          if fit else _ce_parts(*a))
        return [torch.cat(z, 1) for z in zip(*pieces)]

    loc = grid.local(parts)
    big = _reduce_max(grid, grid.local(lambda p: loc[p][0]))
    tot = _psum(grid, grid.local(lambda p: torch.stack(
        [loc[p][1] * torch.exp(loc[p][0] - big[p]), loc[p][2]])), TP)
    return grid.local(lambda p: big[p] + torch.log(tot[p][0]) - tot[p][1])


def loss_fn(cfg: tfm.TransformerConfig, grid: Grid, params: RankParams, tokens: list, specs=None,
            *, layers: int | None = None) -> list:
    """Each rank's token rows (b, S+1) -> its share of the loss (0-d fp32):
    its rows' mean next-token cross entropy (the same on the ranks of a
    grid row) plus 0.01 x its MoE aux.  Their mean over the grid is the
    reference's ``loss_fn`` on the whole batch (every row holds as many
    tokens); :func:`repro_torch.train.step.make_sharded_train_step`
    differentiates that mean."""
    specs = serving_specs(cfg, grid) if specs is None else specs
    xs, aux = hidden(cfg, grid, params, grid.local(lambda p: tokens[p][:, :-1]), specs,
                     layers=layers)
    ce = token_losses(cfg, grid, params, specs, xs, grid.local(lambda p: tokens[p][:, 1:]))
    return grid.local(lambda p: ce[p].mean() + 0.01 * aux[p])


def sum_replicas(grid: Grid, grads: list, specs) -> list:
    """Each rank's gradient tree with every leaf that is replicated over an
    axis summed over it (``grid.psum``: one call an axis and dtype, the
    leaves flattened into one vector): a replica's gradient holds only its
    own uses of the leaf, the leaf's is their sum.  Leaves split over every
    axis are returned as they are."""
    ranks = grid.local_ranks
    flat = {p: tree.flatten(grads[p]) for p in ranks}
    out = {p: list(flat[p][0]) for p in ranks}
    first = flat[ranks[0]][0]
    axes = [replicated_over(grid, sp) for sp in meshlib.spec_leaves(specs)]
    keys = sorted({(a, str(g.dtype)) for a, g in zip(axes, first) if a is not None})
    for axis, dtype in keys:
        idx = [k for k, (a, g) in enumerate(zip(axes, first))
               if a == axis and str(g.dtype) == dtype]
        total = grid.psum(grid.local(lambda p: torch.cat([out[p][k].reshape(-1) for k in idx])),
                          axis)
        for p in ranks:
            for k, part in zip(idx, torch.split(total[p], [out[p][k].numel() for k in idx])):
                out[p][k] = part.view(out[p][k].shape)
    return grid.local(lambda p: flat[p][1](out[p]))


def grad_norm(grid: Grid, grads: list, specs) -> list:
    """The global norm of the gradient (after :func:`sum_replicas`), on
    every rank: each rank's sum of squares over its slices, a replicated
    leaf counted on its first replica only, ``psum``ed over the grid."""
    spec_list = meshlib.spec_leaves(specs)
    ri, ci = grid.axis_index(grid.row_axes), grid.axis_index(TP)

    def partial(p):
        leaves = tree.leaves(grads[p])
        acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for g, sp in zip(leaves, spec_list):
            kinds = {_kind(e, grid) for e in sp}
            if ("row" in kinds or not ri[p]) and ("col" in kinds or not ci[p]):
                acc = acc + torch.sum(g.to(torch.float32) ** 2)
        return acc

    total = grid.psum(grid.local(partial), grid.all_axes)
    return grid.local(lambda p: torch.sqrt(total[p]))
