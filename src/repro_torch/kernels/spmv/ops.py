"""Wrappers of the ELL push/pull kernels (``csrc/spmv.cu``).

CPU tensors go to the plain version in :mod:`.ref`; CUDA tensors go to the
kernel or raise.  No ROW_TILE / DEG_CHUNK padding is needed: the kernel
masks its ragged edge, so any (n_rows, K) slab is taken as it is.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.spmv import ref

PUSH_KERNEL = "spmv_min_planes"
PULL_KERNEL = "spmv_pull_min_planes"
PUSH_ONE_KERNEL = "spmv_min"
PULL_ONE_KERNEL = "spmv_pull_min"


def _check(nbr: torch.Tensor, f_words: torch.Tensor, n_cols: int) -> None:
    kernels.require(nbr, "nbr", (torch.int32,), 2)
    kernels.require(f_words, "f_words", (torch.int32,), 2)
    if n_cols % 1024 or f_words.shape[1] != n_cols // 32:
        raise ValueError(
            f"frontier words {tuple(f_words.shape)} do not cover n_cols={n_cols} "
            "(chunk-aligned, n_cols/32 words per plane)"
        )
    if nbr.shape[0] >= 2**31 or n_cols >= 2**31:
        raise ValueError("n_rows and n_cols must fit int32")


def spmv_min_planes(nbr: torch.Tensor, f_words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Push: nbr (n_rows, K) int32, f_words (B, n_cols/32) -> (B, n_rows)."""
    if not kernels.on_cuda(nbr, f_words):
        return ref.spmv_min_planes(nbr, f_words, n_cols)
    return _push(nbr, f_words, n_cols, PUSH_KERNEL)


def _push(nbr, f_words, n_cols: int, kernel: str) -> torch.Tensor:
    _check(nbr, f_words, n_cols)
    n_rows, k = nbr.shape
    planes = f_words.shape[0]
    out = torch.empty((planes, n_rows), dtype=torch.int32, device=nbr.device)
    if out.numel() == 0:
        return out
    kernels.launch(
        kernel, "rt_spmv_min_planes",
        (kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.I32,
         kernels.I32, kernels.I64),
        nbr.data_ptr(), f_words.data_ptr(), out.data_ptr(), n_rows, k, n_cols,
        planes, f_words.shape[1],
    )
    return out


def spmv_pull_min_planes(
    nbr: torch.Tensor, f_words: torch.Tensor, u_words: torch.Tensor, n_cols: int
) -> torch.Tensor:
    """Pull: as push, plus (B, >= chunk_pad(n_rows)/32) unreached-row words;
    rows whose unreached bit is clear give INF."""
    if not kernels.on_cuda(nbr, f_words, u_words):
        return ref.spmv_pull_min_planes(nbr, f_words, u_words, n_cols)
    return _pull(nbr, f_words, u_words, n_cols, PULL_KERNEL)


def _pull(nbr, f_words, u_words, n_cols: int, kernel: str) -> torch.Tensor:
    _check(nbr, f_words, n_cols)
    kernels.require(u_words, "u_words", (torch.int32,), 2)
    n_rows, k = nbr.shape
    planes = f_words.shape[0]
    if u_words.shape[0] != planes or u_words.shape[1] * 32 < n_rows + (-n_rows) % 1024:
        raise ValueError(
            f"unreached words {tuple(u_words.shape)} do not cover {planes} planes "
            f"of {n_rows} rows"
        )
    out = torch.empty((planes, n_rows), dtype=torch.int32, device=nbr.device)
    if out.numel() == 0:
        return out
    kernels.launch(
        kernel, "rt_spmv_pull_min_planes",
        (kernels.P, kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32,
         kernels.I32, kernels.I32, kernels.I64, kernels.I64),
        nbr.data_ptr(), f_words.data_ptr(), u_words.data_ptr(), out.data_ptr(),
        n_rows, k, n_cols, planes, f_words.shape[1], u_words.shape[1],
    )
    return out


def spmv_min(nbr: torch.Tensor, f_words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Single-plane push (the reference's ``spmv_min``): f_words
    (n_cols/32,) -> (n_rows,).  Launches the ELL kernel with one plane,
    counted under its own name."""
    if not kernels.on_cuda(nbr, f_words):
        return ref.spmv_min(nbr, f_words, n_cols)
    return _push(nbr, f_words.reshape(1, -1), n_cols, PUSH_ONE_KERNEL)[0]


def spmv_pull_min(nbr: torch.Tensor, f_words: torch.Tensor, u_words: torch.Tensor,
                  n_cols: int) -> torch.Tensor:
    """Single-plane pull (the reference's ``spmv_pull_min``)."""
    if not kernels.on_cuda(nbr, f_words, u_words):
        return ref.spmv_pull_min(nbr, f_words, u_words, n_cols)
    return _pull(nbr, f_words.reshape(1, -1), u_words.reshape(1, -1), n_cols,
                 PULL_ONE_KERNEL)[0]
