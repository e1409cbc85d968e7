"""Plain PyTorch version of the ELL frontier-expansion kernels.

    out[p, r] = min over d of ( nbr[r, d]  if bit nbr[r, d] of frontier p
                                 else INF )

``nbr`` is an (n_rows, K) int32 destination-major neighbor slab padded
with a sentinel >= the real column count, whose bit is never set.  Frontier
planes are (B, n_cols/32) int32 words in the vertical width-1 layout of
:mod:`repro_torch.kernels.bitpack`.  The pull direction adds a (B, W)
unreached-row bitmap: rows whose bit is clear give INF.
"""

from __future__ import annotations

import torch

INF = 2**31 - 1


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
