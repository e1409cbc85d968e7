"""Plain PyTorch version of the ELL frontier-expansion kernels.

    out[p, r] = min over d of ( nbr[r, d]  if bit nbr[r, d] of frontier p
                                 else INF )

``nbr`` is an (n_rows, K) int32 destination-major neighbor slab padded
with a sentinel >= the real column count, whose bit is never set.  Frontier
planes are (B, n_cols/32) int32 words in the vertical width-1 layout of
:mod:`repro_torch.kernels.bitpack`; :func:`frontier_mask` is the plain
version of the kernel that interleaves them into one byte per column, and
:func:`interleave_values` of the one that interleaves the value gather's
planes.  The pull direction adds a (B, W)
unreached-row bitmap: rows whose bit is clear give INF.

:func:`gspmm` is the op x reduce form behind the frontier algebras' value
expansion (the reference's ``repro/kernels/spmv/ref.py:gspmm``): a hit slot
proposes a message computed from the source's value instead of its id, and
the candidates reduce per row under min or under a float32 sum.
:func:`gspmm_min_planes` is its min instantiation, the plain version of the
``gspmm_min_planes`` CUDA kernel: ``copy`` (CC labels) and ``minplus``
(SSSP distances plus the hashed edge weight of :func:`edge_weight`).
"""

from __future__ import annotations

import torch

INF = 2**31 - 1
_M32 = 0xFFFFFFFF


def ell_from_coo(src: torch.Tensor, dst: torch.Tensor, n_rows: int, n_cols: int,
                 max_deg: int) -> torch.Tensor:
    """COO edges -> (n_rows, max_deg) int32 ELL slab padded with ``n_cols``
    (for tests and small blocks).  A row keeps its first ``max_deg`` edges in
    edge order (a stable sort by destination); edges whose ``dst`` is
    ``n_rows`` or more are dropped."""
    order = torch.argsort(dst, stable=True)
    src_s, dst_s = src[order].to(torch.int64), dst[order].to(torch.int64)
    inside = dst_s < n_rows
    counts = torch.bincount(dst_s[inside], minlength=n_rows)
    row_start = torch.cumsum(counts, 0) - counts
    rank = (torch.arange(dst_s.shape[0], device=dst.device)
            - row_start[torch.clamp(dst_s, max=n_rows - 1)])
    valid = inside & (rank < max_deg)
    nbr = torch.full((n_rows + 1, max_deg), n_cols, dtype=torch.int32, device=dst.device)
    nbr[torch.where(valid, dst_s, n_rows), torch.where(valid, rank, 0)] = torch.where(
        valid, src_s, n_cols).to(torch.int32)
    return nbr[:n_rows]


def frontier_bit(words: torch.Tensor, idx: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Membership bits of (possibly out-of-range) indices.

    ``words`` is (W,) or (B, W); the result has shape
    ``words.shape[:-1] + idx.shape``.  Indices >= ``n_cols`` read as clear.
    """
    safe = torch.clamp(idx, max=n_cols - 1).to(torch.int64)
    within = safe % 1024
    word_idx = (safe // 1024) * 32 + within % 32
    w = words.index_select(-1, word_idx.reshape(-1))
    w = w.reshape(*words.shape[:-1], *idx.shape)
    bit = (w >> (within // 32)) & 1  # arithmetic >> is harmless under & 1
    return (bit == 1) & (idx < n_cols)


def frontier_mask(f_words: torch.Tensor) -> torch.Tensor:
    """Plane-interleaved mask of (B, W) frontier words (W a multiple of 32):
    (ceil(B/8), 32*W) uint8 whose byte [g, c] holds plane 8g + q's bit c at
    bit q (planes past B read as clear)."""
    planes, wf = f_words.shape
    n_cols = 32 * wf
    cols = torch.arange(n_cols, dtype=torch.int32, device=f_words.device)
    bits = frontier_bit(f_words, cols, n_cols).to(torch.int32)  # (B, n_cols)
    bits = torch.nn.functional.pad(bits, (0, 0, 0, (-planes) % 8))
    weights = (1 << torch.arange(8, dtype=torch.int32, device=f_words.device))[:, None]
    return (bits.view(-1, 8, n_cols) * weights).sum(dim=1).to(torch.uint8)


def interleave_values(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, n_x) values and their frontier mask (ceil(B/8), n_cols) ->
    (ceil(B/8), n_x, 8): ``[g, c, q]`` is plane 8g + q's value of column c
    where bit q of ``mask[g, c]`` is set, INF elsewhere."""
    planes, n_x = x.shape
    groups, n_cols = mask.shape
    m = mask[:, :n_x].to(torch.int32)
    m = torch.nn.functional.pad(m, (0, n_x - m.shape[1]))  # columns past n_cols: clear
    bits = (m[:, None, :] >> torch.arange(8, device=x.device)[None, :, None]) & 1
    padded = torch.nn.functional.pad(x, (0, 0, 0, 8 * groups - planes), value=INF)
    out = torch.where(bits.view(8 * groups, n_x) == 1, padded, INF)
    return out.view(groups, 8, n_x).transpose(1, 2).contiguous()


def spmv_min_planes(nbr: torch.Tensor, f_words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Push: (B, n_cols/32) frontier planes -> (B, n_rows) min frontier
    neighbor per row (INF if none)."""
    hit = frontier_bit(f_words, nbr, n_cols)  # (B, n_rows, K)
    cand = torch.where(hit, nbr, INF)
    return cand.amin(dim=2).to(torch.int32)


def spmv_pull_min_planes(
    nbr: torch.Tensor, f_words: torch.Tensor, u_words: torch.Tensor, n_cols: int
) -> torch.Tensor:
    """Pull: as push, but rows whose unreached bit is clear give INF."""
    n_rows = nbr.shape[0]
    rows = torch.arange(n_rows, dtype=torch.int32, device=nbr.device)
    unreached = frontier_bit(u_words, rows, n_rows)  # (B, n_rows)
    return torch.where(unreached, spmv_min_planes(nbr, f_words, n_cols), INF)


def spmv_min(nbr: torch.Tensor, f_words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Single-plane push: (n_cols/32,) frontier words -> (n_rows,)."""
    return spmv_min_planes(nbr, f_words.reshape(1, -1), n_cols)[0]


def spmv_pull_min(nbr: torch.Tensor, f_words: torch.Tensor, u_words: torch.Tensor,
                  n_cols: int) -> torch.Tensor:
    """Single-plane pull: as push, rows whose unreached bit is clear give INF."""
    return spmv_pull_min_planes(nbr, f_words.reshape(1, -1), u_words.reshape(1, -1),
                                n_cols)[0]


def edge_weight(u: torch.Tensor, v: torch.Tensor, max_weight: int = 31) -> torch.Tensor:
    """Symmetric hashed weight in [1, max_weight] of edges (u, v), int32.

    The uint32 avalanche mix of ``repro/core/algebra.py:edge_weight``, in
    int64 masked to 32 bits: with ids below 2**31 every product stays
    below 2**63, so the wrap mod 2**32 is exact."""
    a = torch.minimum(u, v).to(torch.int64) & _M32
    b = torch.maximum(u, v).to(torch.int64) & _M32
    h = ((a * 2654435761) & _M32) ^ ((b * 40503 + 2654435769) & _M32)
    h = h ^ (h >> 16)
    return (h % max_weight + 1).to(torch.int32)


def gspmm(nbr: torch.Tensor, f_words: torch.Tensor, n_cols: int, message,
          reduce: str = "min", empty: int = INF, u_words: torch.Tensor | None = None
          ) -> torch.Tensor:
    """One op x reduce expansion over B frontier planes.

        out[p, r] = reduce over d of message(r, nbr[r, d])[p]  where bit
                    nbr[r, d] of frontier p is set   (``empty`` if none)

    ``message(rows, cols)`` maps the (n_rows, 1) destination and (n_rows, K)
    source id grids (int64) to (B, n_rows, K) int32 candidates.  ``reduce``
    is ``"min"`` or ``"sum"``: the sum decodes
    the int32 words as float32 bit patterns, adds them and re-encodes (the
    sentinel 0 is the bit pattern of 0.0, so misses need no mask).
    ``u_words`` (B, >= n_rows/32), if given, masks rows whose unreached
    bit is clear to ``empty`` (pull).
    """
    n_rows = nbr.shape[0]
    hit = frontier_bit(f_words, nbr, n_cols)  # (B, n_rows, K)
    rows = torch.arange(n_rows, dtype=torch.int64, device=nbr.device)[:, None]
    cand = torch.where(hit, message(rows, nbr.to(torch.int64)), empty)
    if reduce == "min":
        out = cand.amin(dim=2)
    elif reduce == "sum":
        out = cand.view(torch.float32).sum(dim=2).view(torch.int32)
    else:
        raise ValueError(f"reduce must be 'min' or 'sum', got {reduce!r}")
    if u_words is not None:
        rows32 = torch.arange(n_rows, dtype=torch.int32, device=nbr.device)
        out = torch.where(frontier_bit(u_words, rows32, n_rows), out, empty)
    return out.to(torch.int32)


def gspmm_min_planes(nbr: torch.Tensor, f_words: torch.Tensor, x: torch.Tensor,
                     n_cols: int, op: str = "copy", max_weight: int = 31,
                     row_base: int = 0, col_base: int = 0,
                     u_words: torch.Tensor | None = None) -> torch.Tensor:
    """Min value gather: (B, n_cols/32) frontier planes and (B, n_x) int32
    source values -> (B, n_rows) min over hit slots of ``x[p, c]``
    (``copy``) or of ``x[p, c] + w`` saturating at INF (``minplus``, ``w``
    the :func:`edge_weight` of the global pair (row_base + r, col_base +
    c)).  Columns at or past ``n_x`` read as INF, as the reference pads
    ``x``; ``u_words`` as in :func:`gspmm`."""
    if op not in ("copy", "minplus"):
        raise ValueError(f"op must be 'copy' or 'minplus', got {op!r}")
    n_x = x.shape[1]

    def message(rows, cols):
        inside = cols < n_x
        xs = x[:, torch.clamp(cols, max=n_x - 1)]  # (B, n_rows, K)
        xs = torch.where(inside, xs, INF)
        if op == "copy":
            return xs
        w = edge_weight(rows + row_base, cols + col_base, max_weight)
        return torch.where(xs >= INF - w, INF, xs + w)

    return gspmm(nbr, f_words, n_cols, message, "min", INF, u_words)
