"""The adaptive collectives of the BFS, on the AdaptiveExchange engine.

The port's counterpart of ``repro/comm/collectives.py:43-479`` (paper
Alg. 4): the column phase (ALLGATHERV + compress) and the row phase
(ALLTOALLV + compress) dispatch through
:class:`repro_torch.comm.engine.AdaptiveExchange`, with the wire format
chosen per communicator group by the bucket ladder.  The bottom-up (pull)
direction swaps the row id streams for :func:`alltoall_bitmap_min_planes`
— found-bitmap + bit-packed parents, density-independent.

The frontier algebras add a value column phase
(:func:`gather_values_planes`) and a combine row phase for sum algebras
(:func:`alltoall_dense_combine_planes`); value payloads that are already
global ride the min-candidate and bitmap+payload wires with ``n_c=None``.

Every function takes and returns per-rank lists over the grid.  The
``*_planes`` forms carry ``(B, ...)`` source planes per rank with a packed
one-word-per-plane id-stream sideband; the single-source forms (one root)
keep the two-word ``(count, exc)`` sideband, so the two differ in bytes.
Where the two wires are the same, the single-source form is the planes
form on one plane.  The butterfly wire plan's stages
(:mod:`repro_torch.comm.butterfly`) go through :func:`ppermute_min_block`
and :func:`ppermute_membership_block`: one adaptive partner exchange per
stage, re-bucketed on the merged stream.  The int8 all-reduce comes with a
later slice.
"""

from __future__ import annotations

import torch

from repro_torch.comm.engine import AdaptiveExchange
from repro_torch.comm.grid import SimGrid
from repro_torch.comm.formats import (
    INF,
    BitmapFormat,
    BitmapParentFormat,
    DenseFormat,
    IdStreamFormat,
    RawIdFormat,
    pack_plane_meta,
    unpack_plane_meta,
)
from repro_torch.comm.ladder import BucketLadder, stream_stats
from repro_torch.comm.stats import CommStats


def _scatter_membership(u_ids: torch.Tensor, s: int) -> torch.Tensor:
    """(..., g, cap) received ids (``>= s`` = padding) -> (..., g*s)
    membership of the concatenated chunks (contiguous: it feeds the pack
    kernel)."""
    *lead, g, cap = u_ids.shape
    u = u_ids.reshape(-1, g, cap).to(torch.int64)
    offs = (torch.arange(g, device=u.device) * s)[None, :, None]
    flat = torch.where(u < s, u + offs, g * s).reshape(u.shape[0], -1)
    out = torch.zeros((u.shape[0], g * s + 1), dtype=torch.bool, device=u.device)
    out.scatter_(1, flat, True)
    return out[:, : g * s].contiguous().reshape(*lead, g * s)


def _segment_min(segs: torch.Tensor, vals: torch.Tensor, s: int) -> torch.Tensor:
    """Per-plane min of ``vals`` into ``s`` segments: (B, L) segment ids
    (``s`` = padding) and values -> (B, s) int32, INF where empty.  The
    INF-filled ``(s+1)`` row lets the padding segment soak up the invalid
    slots."""
    out = torch.full((segs.shape[0], s + 1), INF, dtype=torch.int32, device=segs.device)
    out.scatter_reduce_(1, segs.to(torch.int64), vals.to(torch.int32), "amin")
    return out[:, :s].contiguous()


def _unpack_meta(meta: torch.Tensor, packed: bool) -> torch.Tensor:
    """Received sideband -> (N, 2) (count, exc) pairs."""
    if packed:
        cnt, exc = unpack_plane_meta(meta.reshape(-1))
        return torch.stack([cnt, exc], dim=1)
    return meta.reshape(-1, 2)


def _pack_meta(meta: torch.Tensor, packed: bool) -> torch.Tensor:
    """(N, 2) (count, exc) pairs -> the sideband sent: one packed word per
    stream, or the pairs themselves."""
    return pack_plane_meta(meta[:, 0], meta[:, 1]) if packed else meta


# ---------------------------------------------------------------------------
# column phase: membership all-gather
# ---------------------------------------------------------------------------


def gather_bitmap_planes(ex: AdaptiveExchange, bits: list, groups=None) -> list:
    """Width-1 bitmap all-gather of per-rank ``(B, s)`` membership planes ->
    ``(B, g*s)``."""
    ranks = ex.ranks(groups)
    b, s = bits[ranks[0]].shape
    fmt = BitmapFormat(s)
    words = [None] * ex.grid.size
    for p in ranks:
        words[p] = fmt.pack(bits[p])  # (B, s/32)
    got = ex.all_gather(words, fmt=fmt.name, groups=groups)
    out = [None] * ex.grid.size
    for p in ranks:
        mem = fmt.unpack(got[p].reshape(ex.group_size, b, -1))  # (g, B, s)
        out[p] = mem.transpose(0, 1).reshape(b, -1)
    return out


def gather_bitmap(ex: AdaptiveExchange, bits: list, groups=None) -> list:
    """Single-source form: per-rank ``(s,)`` -> ``(g*s,)`` (the same wire)."""
    got = gather_bitmap_planes(ex, [None if x is None else x[None] for x in bits], groups)
    return [None if x is None else x[0] for x in got]


def gather_raw_ids_planes(ex: AdaptiveExchange, bits: list, groups=None) -> list:
    """Uncompressed 32-bit id-list all-gather of per-rank ``(B, s)`` planes
    (the paper's Baseline)."""
    ranks = ex.ranks(groups)
    b, s = bits[ranks[0]].shape
    fmt = RawIdFormat(s)
    ids, meta = [None] * ex.grid.size, [None] * ex.grid.size
    for p in ranks:
        ids[p], m = fmt.pack(bits[p])  # (B, s), (B, 1)
        meta[p] = m.reshape(b)
    g_ids = ex.all_gather(ids, fmt=fmt.name, groups=groups)
    g_meta = ex.all_gather(meta, fmt=fmt.name, part="meta", groups=groups)
    out = [None] * ex.grid.size
    for p in ranks:
        u_ids, _ = fmt.unpack(g_ids[p].reshape(ex.group_size, b, s),
                              g_meta[p].reshape(ex.group_size, b, 1), fill=s)
        out[p] = _scatter_membership(u_ids.transpose(0, 1), s)
    return out


def gather_raw_ids(ex: AdaptiveExchange, bits: list, groups=None) -> list:
    """Single-source form of :func:`gather_raw_ids_planes` (the same wire)."""
    got = gather_raw_ids_planes(ex, [None if x is None else x[None] for x in bits], groups)
    return [None if x is None else x[0] for x in got]


def _allgather_membership(ex: AdaptiveExchange, bits: list, ladder: BucketLadder,
                          packed: bool) -> list:
    """Adaptive all-gather of per-rank ``(B, s)`` membership planes."""
    if not ladder.specs:  # degenerate ladder: dense bitmap only
        return ex.dispatch(None, [lambda gs: gather_bitmap_planes(ex, bits, gs)])
    s = ladder.s
    ranks = ex.ranks()
    b = bits[ranks[0]].shape[0]
    streams, my_bucket = {}, [None] * ex.grid.size
    for p in ranks:
        ids, counts, excs = stream_stats(bits[p], s)
        streams[p] = (ids, counts)
        my_bucket[p] = ladder.bucket_for(counts, excs).max()

    def sparse_branch(fmt: IdStreamFormat):
        def run(gs):
            words, metas = [None] * ex.grid.size, [None] * ex.grid.size
            for p in ex.ranks(gs):
                words[p], meta = fmt.pack(*streams[p])  # (B, dw), (B, 2)
                metas[p] = _pack_meta(meta, packed).reshape(-1)
            g_words = ex.all_gather(words, fmt=fmt.name, groups=gs)
            g_meta = ex.all_gather(metas, fmt=fmt.name, part="meta", groups=gs)
            out = [None] * ex.grid.size
            for p in ex.ranks(gs):
                u_ids, _, _ = fmt.unpack(g_words[p], _unpack_meta(g_meta[p], packed),
                                         fill=s)  # (g*B, cap)
                u_ids = u_ids.reshape(ex.group_size, b, -1).transpose(0, 1)
                out[p] = _scatter_membership(u_ids, s)
            return out

        return run

    branches = [sparse_branch(f) for f in ladder.formats()] + [
        lambda gs: gather_bitmap_planes(ex, bits, gs)
    ]
    return ex.dispatch(my_bucket, branches)


def allgather_membership_planes(bits: list, grid: SimGrid, axis, ladder: BucketLadder,
                                *, stats: CommStats | None = None,
                                phase: str = "bfs/column") -> list:
    """Adaptive all-gather of per-rank ``(B, s)`` membership planes over
    ``axis`` (the batched column phase) -> ``(B, g*s)``.

    One bucket consensus (max over every plane on every rank of a group)
    and one pair of collectives serve all B planes; sparse branches pack
    each plane's id stream at the shared bucket, and the B (count, exc)
    pairs ride one packed word per plane.
    """
    b, s = next(x for x in bits if x is not None).shape
    assert s == ladder.s, (s, ladder.s)
    ex = AdaptiveExchange(phase, grid, axis, ladder, stats, planes=b)
    return _allgather_membership(ex, bits, ladder, packed=True)


def allgather_membership(bits: list, grid: SimGrid, axis, ladder: BucketLadder, *,
                         stats: CommStats | None = None, phase: str = "bfs/column") -> list:
    """Single-source column phase: per-rank ``(s,)`` -> ``(g*s,)``, with the
    two-word (count, exc) sideband."""
    ex = AdaptiveExchange(phase, grid, axis, ladder, stats)
    got = _allgather_membership(ex, [None if x is None else x[None] for x in bits],
                                ladder, packed=False)
    return [None if x is None else x[0] for x in got]


# ---------------------------------------------------------------------------
# column phase: value-plane all-gather (the frontier algebras but bfs)
# ---------------------------------------------------------------------------


def gather_values_planes(ex: AdaptiveExchange, x: list, groups=None) -> list:
    """Dense int32 all-gather of per-rank ``(B, s)`` encoded value planes ->
    ``(B, g*s)``: the source values of the column slice, next to its
    membership bits.  Values travel as raw int32 words (width-32 packing is
    the identity), recorded as ``values``."""
    ranks = ex.ranks(groups)
    b, s = x[ranks[0]].shape
    got = ex.all_gather(x, fmt="values", groups=groups)
    out = [None] * ex.grid.size
    for p in ranks:
        out[p] = got[p].reshape(ex.group_size, b, s).transpose(0, 1).reshape(b, -1)
    return out


# ---------------------------------------------------------------------------
# row phase: candidate all-to-all + min-reduce
# ---------------------------------------------------------------------------


def alltoall_dense_min_planes(ex: AdaptiveExchange, prop: list, groups=None) -> list:
    """Dense int32 all-to-all + min of per-rank ``(B, c, s)`` candidate
    planes -> ``(B, s)`` (raw/bitmap row phase and the fallback)."""
    ranks = ex.ranks(groups)
    b, c, s = prop[ranks[0]].shape
    fmt = DenseFormat(s)
    send = [None] * ex.grid.size
    for p in ranks:
        send[p] = prop[p].transpose(0, 1).contiguous()  # (c, B, s)
    recv = ex.all_to_all(send, fmt=fmt.name, groups=groups)
    out = [None] * ex.grid.size
    for p in ranks:
        out[p] = recv[p].reshape(c, b, s).amin(dim=0)
    return out


def alltoall_dense_combine_planes(ex: AdaptiveExchange, prop: list, alg,
                                  groups=None) -> list:
    """Dense int32 all-to-all of per-rank ``(B, c, s)`` candidate planes,
    merged with the algebra's combine -> ``(B, s)``: a min like
    :func:`alltoall_dense_min_planes`, or a sum of the decoded float32
    partial sums (the absent 0 decodes to 0.0, so nothing is masked)."""
    ranks = ex.ranks(groups)
    b, c, s = prop[ranks[0]].shape
    fmt = DenseFormat(s)
    send = [None] * ex.grid.size
    for p in ranks:
        send[p] = prop[p].transpose(0, 1).contiguous()  # (c, B, s)
    recv = ex.all_to_all(send, fmt=fmt.name, groups=groups)
    out = [None] * ex.grid.size
    for p in ranks:
        got = recv[p].reshape(c, b, s)
        if alg.reduce == "min":
            out[p] = got.amin(dim=0)
        else:
            out[p] = alg.enc(alg.dec(got).sum(dim=0))
    return out


def alltoall_dense_min(ex: AdaptiveExchange, prop: list, groups=None) -> list:
    """Single-source form: per-rank ``(c, s)`` -> ``(s,)`` (the same wire)."""
    got = alltoall_dense_min_planes(ex, [None if x is None else x[None] for x in prop],
                                    groups)
    return [None if x is None else x[0] for x in got]


def _alltoall_min_candidates(ex: AdaptiveExchange, prop: list, ladder: BucketLadder,
                             n_c: int | None, packed: bool) -> list:
    """Adaptive all-to-all + min-reduce of per-rank ``(B, c, s)`` planes."""
    if not ladder.specs:
        return ex.dispatch(None, [lambda gs: alltoall_dense_min_planes(ex, prop, gs)])
    assert ladder.payload_width > 0, (
        "row-phase ladder must carry the parent payload: build it with "
        "BucketLadder.default(s, floor_words=s, payload_width=...)"
    )
    s, c = ladder.s, ex.group_size
    ranks = ex.ranks()
    b = prop[ranks[0]].shape[0]
    col = ex.grid.axis_index(ex.axis)
    streams, my_bucket = {}, [None] * ex.grid.size
    for p in ranks:
        flat = prop[p].transpose(0, 1).reshape(c * b, s)  # all-to-all split layout
        ids, counts, excs = stream_stats(flat < INF, s)
        streams[p] = (flat, ids, counts)
        my_bucket[p] = ladder.bucket_for(counts, excs).max()

    def sparse_branch(fmt: IdStreamFormat):
        cap = fmt.spec.cap

        def run(gs):
            words, metas = [None] * ex.grid.size, [None] * ex.grid.size
            for p in ex.ranks(gs):
                flat, ids, counts = streams[p]
                base = 0 if n_c is None else col[p] * n_c
                # strip this sender's j * n_c: the payload packs column-local
                # offsets, which the receiver re-globalizes per sender
                par = torch.gather(flat, 1, torch.clamp(ids[:, :cap], 0, s - 1)
                                   .to(torch.int64)) - base
                w, meta = fmt.pack(ids, counts, payload=par)  # (c*B, dw), (c*B, 2)
                words[p] = w.reshape(c, b, fmt.data_words)
                metas[p] = _pack_meta(meta, packed).reshape(c, -1)
            r_words = ex.all_to_all(words, fmt=fmt.name, groups=gs)
            r_meta = ex.all_to_all(metas, fmt=fmt.name, part="meta", groups=gs)
            out = [None] * ex.grid.size
            slot = torch.arange(cap, device=ex.grid.device)
            for p in ex.ranks(gs):
                u_ids, u_count, par = fmt.unpack(
                    r_words[p].reshape(c * b, fmt.data_words),
                    _unpack_meta(r_meta[p], packed), fill=s)  # (c*B, cap) each
                valid = slot < u_count[:, None]
                seg = torch.where(valid, u_ids, s)
                if n_c is not None:
                    sender = torch.arange(c, device=par.device).repeat_interleave(b)
                    par = par + (sender * n_c)[:, None].to(torch.int32)
                val = torch.where(valid, par, INF)
                seg = seg.reshape(c, b, cap).transpose(0, 1).reshape(b, c * cap)
                val = val.reshape(c, b, cap).transpose(0, 1).reshape(b, c * cap)
                out[p] = _segment_min(seg, val, s)
            return out

        return run

    branches = [sparse_branch(f) for f in ladder.formats()] + [
        lambda gs: alltoall_dense_min_planes(ex, prop, gs)
    ]
    return ex.dispatch(my_bucket, branches)


def alltoall_min_candidates_planes(prop: list, grid: SimGrid, axis, ladder: BucketLadder,
                                   *, stats: CommStats | None = None,
                                   phase: str = "bfs/row", n_c: int | None = None) -> list:
    """Adaptive all-to-all + min-reduce over ``axis`` of per-rank
    ``(B, c, s)`` candidate planes (INF = none) -> ``(B, s)``.

    B planes share one bucket consensus (max over every (destination,
    plane) stream of the group) and one pair of collectives.  ``n_c`` (the
    column-slice width) localizes the parent payload: the sender strips its
    own ``j * n_c`` before packing at the ladder's payload width and the
    receiver adds ``sender * n_c`` back, lossless at any grid width.
    """
    b = next(x for x in prop if x is not None).shape[0]
    ex = AdaptiveExchange(phase, grid, axis, ladder, stats, planes=b)
    return _alltoall_min_candidates(ex, prop, ladder, n_c, packed=True)


def alltoall_min_candidates(prop: list, grid: SimGrid, axis, ladder: BucketLadder, *,
                            stats: CommStats | None = None, phase: str = "bfs/row",
                            n_c: int | None = None) -> list:
    """Single-source row phase: per-rank ``(c, s)`` -> ``(s,)``, with the
    two-word (count, exc) sideband per destination."""
    ex = AdaptiveExchange(phase, grid, axis, ladder, stats)
    got = _alltoall_min_candidates(ex, [None if x is None else x[None] for x in prop],
                                   ladder, n_c, packed=False)
    return [None if x is None else x[0] for x in got]


def alltoall_bitmap_min_planes(ex: AdaptiveExchange, prop: list, fmt: BitmapParentFormat,
                               n_c: int | None, groups=None) -> list:
    """Bottom-up row exchange of per-rank ``(B, c, s)`` column-local
    candidates: found-bitmap + packed parents per destination chunk, one
    all-to-all for all planes; the receiver rebuilds ``sender * n_c +
    local`` and min-reduces.  ``n_c=None`` means the payload is already
    global."""
    ranks = ex.ranks(groups)
    b, c, s = prop[ranks[0]].shape
    assert s == fmt.s, (s, fmt.s)
    send = [None] * ex.grid.size
    for p in ranks:
        send[p] = fmt.pack(prop[p].transpose(0, 1))  # (c, B, data_words)
    recv = ex.all_to_all(send, fmt=fmt.name, groups=groups)
    out = [None] * ex.grid.size
    for p in ranks:
        bits, local = fmt.unpack(recv[p].reshape(c, b, fmt.data_words))  # (c, B, s)
        glob = local
        if n_c is not None:
            sender = torch.arange(c, dtype=torch.int32, device=local.device)
            glob = sender[:, None, None] * n_c + local
        out[p] = torch.where(bits, glob, INF).amin(dim=0).to(torch.int32)
    return out


def alltoall_bitmap_min(ex: AdaptiveExchange, prop: list, fmt: BitmapParentFormat,
                        n_c: int | None, groups=None) -> list:
    """Single-source form: per-rank ``(c, s)`` -> ``(s,)`` (the same wire)."""
    got = alltoall_bitmap_min_planes(ex, [None if x is None else x[None] for x in prop],
                                     fmt, n_c, groups)
    return [None if x is None else x[0] for x in got]


# ---------------------------------------------------------------------------
# butterfly stages: adaptive merge-exchange of subchunk blocks (ppermute)
# ---------------------------------------------------------------------------


def _stage_streams(ex: AdaptiveExchange, bits, ladder: BucketLadder, gate) -> tuple:
    """Per rank, the id streams of its ``(N, s)`` membership rows
    (``bits[p]``) and its bucket, gated to 0 where the rank sends nothing
    at this stage (so stale state never escalates the group's consensus)."""
    streams, my_bucket = {}, [None] * ex.grid.size
    for p in ex.ranks():
        ids, counts, excs = stream_stats(bits[p], ladder.s)
        streams[p] = (ids, counts)
        bucket = ladder.bucket_for(counts, excs).max()
        my_bucket[p] = bucket if gate[p] else torch.zeros_like(bucket)
    return streams, my_bucket


def _ppermute_streams(ex: AdaptiveExchange, fmt: IdStreamFormat, perm, gs, packed,
                      nb: int, b: int) -> list:
    """Ship each rank's packed ``(nb*b, ...)`` words and (count, exc) pairs
    to its partner; the sideband is one word a plane when ``b > 1``, and
    the received one comes back as (count, exc) pairs."""
    words, metas = [None] * ex.grid.size, [None] * ex.grid.size
    for p in ex.ranks(gs):
        w, meta = packed[p]
        words[p] = w.reshape(nb, b, fmt.data_words)
        metas[p] = pack_plane_meta(meta[:, 0], meta[:, 1]).reshape(nb, b) if b > 1 else meta
    r_words = ex.ppermute(words, perm, fmt=fmt.name, groups=gs)
    r_meta = ex.ppermute(metas, perm, fmt=fmt.name, part="meta", groups=gs)
    out = [None] * ex.grid.size
    for p in ex.ranks(gs):
        out[p] = (r_words[p].reshape(nb * b, fmt.data_words), _unpack_meta(r_meta[p], b > 1))
    return out


def ppermute_min_block(ex: AdaptiveExchange, block: list, perm, ladder: BucketLadder,
                       floor_fmt, *, gate) -> list:
    """One butterfly stage: each rank sends its ``(nb, b, s)`` block of
    global candidate planes (INF = none) to its partner under ``perm`` and
    gets the partner's block back, rebuilt dense for the caller's merge.

    The ladder picks the wire per stage and group: delta + PFOR16 id streams
    carrying the candidates at the ladder's payload width (global ids:
    merged streams have no single sender), or ``floor_fmt`` (found-bitmap
    + packed parents, or dense int32).  One bucket consensus covers every
    subchunk and plane; ``gate[p]`` is whether rank ``p`` sends at this
    stage.  A rank no pair sends to gets an empty block (INF), or zeros
    under the dense floor, as ``ppermute`` gives it zero words."""
    ranks = ex.ranks()
    nb, b, s = block[ranks[0]].shape
    flat = {p: block[p].reshape(nb * b, s) for p in ranks}
    streams, my_bucket = {}, None
    if ladder.specs:
        streams, my_bucket = _stage_streams(ex, {p: flat[p] < INF for p in ranks}, ladder,
                                            gate)

    def sparse_branch(fmt: IdStreamFormat):
        cap = fmt.spec.cap

        def run(gs):
            packed = {}
            for p in ex.ranks(gs):
                ids, counts = streams[p]
                par = torch.gather(flat[p], 1,
                                   torch.clamp(ids[:, :cap], 0, s - 1).to(torch.int64))
                packed[p] = fmt.pack(ids, counts, payload=par)
            got = _ppermute_streams(ex, fmt, perm, gs, packed, nb, b)
            slot = torch.arange(cap, device=ex.grid.device)
            out = [None] * ex.grid.size
            for p in ex.ranks(gs):
                u_ids, u_count, par = fmt.unpack(*got[p], fill=s)  # (nb*b, cap) each
                valid = slot < u_count[:, None]
                out[p] = _segment_min(torch.where(valid, u_ids, s),
                                      torch.where(valid, par, INF), s).reshape(nb, b, s)
            return out

        return run

    def floor_branch(gs):
        if not isinstance(floor_fmt, BitmapParentFormat):
            return ex.ppermute(block, perm, fmt=floor_fmt.name, groups=gs)
        words = [None] * ex.grid.size
        for p in ex.ranks(gs):
            words[p] = floor_fmt.pack(block[p])  # (nb, b, data_words)
        recv = ex.ppermute(words, perm, fmt=floor_fmt.name, groups=gs)
        out = [None] * ex.grid.size
        for p in ex.ranks(gs):
            bits, par = floor_fmt.unpack(recv[p])
            out[p] = torch.where(bits, par, INF)
        return out

    branches = [sparse_branch(f) for f in ladder.formats()] + [floor_branch]
    return ex.dispatch(my_bucket, branches)


def ppermute_membership_block(ex: AdaptiveExchange, block: list, perm,
                              ladder: BucketLadder, *, gate) -> list:
    """One butterfly all-gather stage: each rank sends its ``(nb, b, s)``
    bool block of membership planes to its partner under ``perm`` and gets
    the partner's block back.  Sparse stages travel as delta + PFOR16 id
    streams per chunk-plane, dense ones as width-1 bitmaps; the doubling
    block keeps chunk identity, so the caller places it as it is.
    ``gate`` as for :func:`ppermute_min_block`."""
    ranks = ex.ranks()
    nb, b, s = block[ranks[0]].shape
    flat = {p: block[p].reshape(nb * b, s) for p in ranks}
    streams, my_bucket = {}, None
    if ladder.specs:
        streams, my_bucket = _stage_streams(ex, flat, ladder, gate)

    def sparse_branch(fmt: IdStreamFormat):
        cap = fmt.spec.cap

        def run(gs):
            packed = {p: fmt.pack(*streams[p]) for p in ex.ranks(gs)}
            got = _ppermute_streams(ex, fmt, perm, gs, packed, nb, b)
            slot = torch.arange(cap, device=ex.grid.device)
            out = [None] * ex.grid.size
            for p in ex.ranks(gs):
                u_ids, u_count, _ = fmt.unpack(*got[p], fill=s)
                seg = torch.where(slot < u_count[:, None], u_ids, s).to(torch.int64)
                mem = torch.zeros((nb * b, s + 1), dtype=torch.bool, device=seg.device)
                mem.scatter_(1, seg, True)
                out[p] = mem[:, :s].reshape(nb, b, s)
            return out

        return run

    def bitmap_branch(gs):
        fmt = BitmapFormat(s)
        words = [None] * ex.grid.size
        for p in ex.ranks(gs):
            words[p] = fmt.pack(flat[p]).reshape(nb, b, -1)
        recv = ex.ppermute(words, perm, fmt=fmt.name, groups=gs)
        out = [None] * ex.grid.size
        for p in ex.ranks(gs):
            out[p] = fmt.unpack(recv[p]).reshape(nb, b, s)
        return out

    branches = [sparse_branch(f) for f in ladder.formats()] + [bitmap_branch]
    return ex.dispatch(my_bucket, branches)
