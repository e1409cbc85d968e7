"""Wrappers of the ELL push/pull kernels, the value-gather kernel and the
frontier mask they probe (``csrc/spmv.cu``).

CPU tensors go to the plain version in :mod:`.ref`; CUDA tensors go to the
kernels or raise.  On CUDA tensors every entry with more than one plane
first launches the ``frontier_mask`` kernel (and the value gather's push
the ``interleave_values`` kernel, each counted under its own name) and
then the ELL kernel; with one plane the ELL kernel probes the bitmap
itself.  No ROW_TILE / DEG_CHUNK padding is needed: the kernel masks its
ragged edge, so any (n_rows, K) slab is taken as it is; it loads the slab
in 16-byte vectors when K % 4 == 0 and the slab is 16-byte aligned, as
scalars otherwise.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.spmv import ref

PUSH_KERNEL = "spmv_min_planes"
PULL_KERNEL = "spmv_pull_min_planes"
PUSH_ONE_KERNEL = "spmv_min"
PULL_ONE_KERNEL = "spmv_pull_min"
GSPMM_KERNEL = "gspmm_min_planes"
MASK_KERNEL = "frontier_mask"
INTERLEAVE_KERNEL = "interleave_values"


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


def frontier_mask(f_words: torch.Tensor) -> torch.Tensor:
    """(B, W) vertical frontier words, W a multiple of 32 -> (ceil(B/8), 32*W)
    uint8 mask: bit q of byte [g, c] is plane 8g + q's bit c."""
    kernels.require(f_words, "f_words", (torch.int32,), 2)
    if f_words.shape[1] % 32:
        raise ValueError(f"frontier words {tuple(f_words.shape)} are not whole 1024-value "
                         "chunks")
    if not kernels.on_cuda(f_words):
        return ref.frontier_mask(f_words)
    planes, wf = f_words.shape
    mask = torch.empty((-(-planes // 8), 32 * wf), dtype=torch.uint8, device=f_words.device)
    if mask.numel() == 0:
        return mask
    kernels.launch(MASK_KERNEL, "rt_frontier_mask",
                   (kernels.P, kernels.P, kernels.I64, kernels.I32, kernels.I64),
                   f_words.device, f_words.data_ptr(), mask.data_ptr(), 32 * wf, planes, wf)
    return mask


def interleave_values(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, n_x) int32 values and their frontier mask (ceil(B/8), n_cols) ->
    (ceil(B/8), n_x, 8) int32: ``[g, c, q]`` is plane 8g + q's value of
    column c where bit q of ``mask[g, c]`` is set, INF where it is clear.
    The kernel writes only the columns whose mask byte is nonzero (the
    gather reads no other); the plain version gives INF in the others."""
    kernels.require(x, "x", (torch.int32,), 2)
    kernels.require(mask, "mask", (torch.uint8,), 2)
    planes, n_x = x.shape
    if mask.shape[0] != -(-planes // 8):
        raise ValueError(f"mask {tuple(mask.shape)} does not cover {planes} planes")
    if not kernels.on_cuda(x, mask):
        return ref.interleave_values(x, mask)
    xi = torch.empty((mask.shape[0], n_x, 8), dtype=torch.int32, device=x.device)
    if xi.numel():
        _interleave_into(x, mask, xi)
    return xi


def interleave_vec(x: torch.Tensor, mask: torch.Tensor) -> int:
    """1 when the interleave kernel may load 4 columns of ``x`` as one
    16-byte vector and their 4 mask bytes as one word (every row of both
    aligned), 0 when it loads scalars."""
    return int(kernels.vec_rows(x) and mask.data_ptr() % 4 == 0 and mask.shape[1] % 4 == 0)


def _interleave_into(x: torch.Tensor, mask: torch.Tensor, xi: torch.Tensor) -> None:
    """Launch the interleave kernel on checked CUDA inputs into ``xi``, a
    contiguous (ceil(B/8), n_x, 8) int32 tensor: the columns whose mask
    byte is nonzero are written, the others keep what they held."""
    if (xi.shape != (mask.shape[0], x.shape[1], 8) or xi.dtype != torch.int32
            or not xi.is_contiguous()):
        raise ValueError(f"xi {tuple(xi.shape)} {xi.dtype} is not a contiguous (groups, n_x, "
                         "8) int32 output")
    if x.shape[1] >= 2**31 or mask.shape[1] >= 2**31:
        raise ValueError("n_x and n_cols must fit int32")
    kernels.launch(INTERLEAVE_KERNEL, "rt_interleave_values",
                   (kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32, kernels.I32,
                    kernels.I32),
                   x.device, x.data_ptr(), mask.data_ptr(), xi.data_ptr(), x.shape[0],
                   x.shape[1], mask.shape[1], interleave_vec(x, mask))


def _mask(f_words: torch.Tensor):
    """The frontier mask the ELL kernels probe (kept alive by the caller),
    or None with one plane, where they probe the bitmap itself."""
    return None if f_words.shape[0] == 1 else frontier_mask(f_words)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def spmv_min_planes(nbr: torch.Tensor, f_words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Push: nbr (n_rows, K) int32, f_words (B, n_cols/32) -> (B, n_rows)."""
    if not kernels.on_cuda(nbr, f_words):
        return ref.spmv_min_planes(nbr, f_words, n_cols)
    return _push(nbr, f_words, n_cols, PUSH_KERNEL)


def _push(nbr, f_words, n_cols: int, kernel: str) -> torch.Tensor:
    _check(nbr, f_words, n_cols)
    return _ell(nbr, f_words, None, n_cols, kernel)


def _ell(nbr, f_words, u_words, n_cols: int, kernel: str) -> torch.Tensor:
    n_rows, k = nbr.shape
    planes = f_words.shape[0]
    out = torch.empty((planes, n_rows), dtype=torch.int32, device=nbr.device)
    if out.numel() == 0:
        return out
    mask = _mask(f_words)
    kernels.launch(
        kernel, "rt_spmv_min_planes",
        (kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.I32, kernels.I32,
         kernels.I32, kernels.I32, kernels.I64, kernels.I32),
        nbr.device, nbr.data_ptr(), _ptr(mask), f_words.data_ptr(), _ptr(u_words),
        out.data_ptr(), n_rows, k, n_cols, planes, 0 if u_words is None else u_words.shape[1],
        kernels.vec_rows(nbr),
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
    return _ell(nbr, f_words, u_words, n_cols, kernel)


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


def gspmm_planes(nbr: torch.Tensor, f_words: torch.Tensor, x: torch.Tensor, n_cols: int,
                 alg, *, row_base: int = 0, col_base: int = 0,
                 u_words: torch.Tensor | None = None) -> torch.Tensor:
    """Value expansion of a frontier algebra over an ELL slab: (B, n_cols/32)
    frontier planes and (B, n_x) encoded source values -> (B, n_rows)
    combined candidates (``alg.empty`` where none).

    Each hit slot proposes ``alg``'s edge message of its source's value
    (global ids ``row_base + r`` / ``col_base + c`` derive the SSSP weight).
    A min-reduce algebra launches the ``gspmm_min_planes`` kernel on CUDA
    tensors (``op="minplus"`` when ``alg.uses_weights``, else ``"copy"``)
    and runs its plain version on CPU tensors.  A sum-reduce algebra
    (PageRank) runs the plain :func:`ref.gspmm` on both devices, as the
    reference does on every platform (``repro/kernels/spmv/ops.py:152``):
    its float32 accumulation has no kernel there to port.  ``u_words``
    masks rows whose unreached bit is clear (pull).
    """
    tensors = (nbr, f_words, x) if u_words is None else (nbr, f_words, x, u_words)
    cuda = kernels.on_cuda(*tensors)
    if alg.reduce == "sum":
        n_x = x.shape[1]

        def message(rows, cols):
            return x[:, torch.clamp(cols, max=n_x - 1)]

        return ref.gspmm(nbr, f_words, n_cols, message, "sum", alg.empty, u_words)
    if alg.reduce != "min":
        raise ValueError(f"gspmm_planes: unknown reduce {alg.reduce!r}")
    op = "minplus" if alg.uses_weights else "copy"
    max_weight = getattr(alg, "max_weight", 31)
    if not cuda:
        return ref.gspmm_min_planes(nbr, f_words, x, n_cols, op, max_weight,
                                    row_base, col_base, u_words)
    _check(nbr, f_words, n_cols)
    kernels.require(x, "x", (torch.int32,), 2)
    n_rows, planes = nbr.shape[0], f_words.shape[0]
    if x.shape[0] != planes:
        raise ValueError(f"x {tuple(x.shape)} does not match {planes} frontier planes")
    if u_words is not None:
        kernels.require(u_words, "u_words", (torch.int32,), 2)
        wu = u_words.shape[1]
        if u_words.shape[0] != planes or wu * 32 < n_rows + (-n_rows) % 1024:
            raise ValueError(f"unreached words {tuple(u_words.shape)} do not cover "
                             f"{planes} planes of {n_rows} rows")
    if not 0 <= row_base + n_rows < 2**31 or not 0 <= col_base + n_cols < 2**31:
        raise ValueError("global row and column ids must fit int32")
    # B > 1 push reads the values plane-interleaved, one sector a hit slot
    # (the copy writes only the frontier's columns); pull, whose hits are
    # fewer, and one plane read them as they are
    return _gather(nbr, f_words, x, u_words, n_cols, op, max_weight, row_base, col_base,
                   interleaved=planes > 1 and u_words is None)


def _gather(nbr, f_words, x, u_words, n_cols: int, op: str, max_weight: int, row_base: int,
            col_base: int, interleaved: bool) -> torch.Tensor:
    """Launch the value gather (and its helpers) on checked CUDA inputs,
    reading the values plane-interleaved (``interleaved``, B > 1 only) or as
    they are."""
    n_rows, k = nbr.shape
    planes = f_words.shape[0]
    out = torch.empty((planes, n_rows), dtype=torch.int32, device=nbr.device)
    if out.numel() == 0:
        return out
    mask = _mask(f_words)
    xi = interleave_values(x, mask) if interleaved else None
    kernels.launch(
        GSPMM_KERNEL, "rt_gspmm_min_planes",
        (kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P, kernels.P,
         kernels.I32, kernels.I32, kernels.I32, kernels.I32, kernels.I32, kernels.I64,
         kernels.I32, kernels.I32, kernels.I32, kernels.I32, kernels.I32),
        nbr.device, nbr.data_ptr(), _ptr(mask), f_words.data_ptr(), x.data_ptr(), _ptr(xi),
        _ptr(u_words), out.data_ptr(), n_rows, k, n_cols, x.shape[1], planes,
        0 if u_words is None else u_words.shape[1], int(row_base), int(col_base),
        int(op == "minplus"), int(max_weight), kernels.vec_rows(nbr),
    )
    return out
