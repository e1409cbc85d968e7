"""Local-expansion backends: the block storage one BFS level expands over.

The port's counterpart of ``repro/core/expand.py``.  Three backends,
resolved by name:

* ``coo``    — the flat min over the sentinel-padded edge arrays, a
  ``scatter_reduce_(..., "amin")`` into an INF-filled ``(n+1)`` row per
  plane with the sentinel row sliced off.  Plain PyTorch, as the reference
  leaves it to XLA's ``segment_min`` outside any Pallas kernel.
* ``ell``    — a dense ``(rows, k)`` neighbor slab driven through the
  :mod:`repro_torch.kernels.spmv` push/pull kernels (``k`` covers the
  heaviest row).
* ``hybrid`` — rows with degree <= ``k`` on an ELL slab, the hub residue
  COO (``k`` from :func:`repro_torch.graphgen.builder.select_split_k`);
  also reachable as ``auto``.

Every backend gives bit-identical ``(B, n_rows)`` min-candidate planes:
each row's edge set lives in exactly one structure, and min commutes with
the split.  The value expansions of the frontier algebras
(``push_value_planes`` / ``pull_value_planes``) propose the algebra's edge
message of each source's value and combine under its reduce; on the slab a
min-reduce runs the ``gspmm_min_planes`` kernel.  The hybrid halves merge
with the algebra's combine, exact for min; for PageRank's float32 sum the
split changes the order of the additions.  On the 2D grid ``block_arrays`` builds each backend's per-block
containers (:mod:`repro_torch.core.csr`), and a rank's block has
``n_rows = n_r`` destinations and ``n_cols = n_c`` sources.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import csr as csrmod
from repro_torch.core import lookup
from repro_torch.core.algebra import INF
from repro_torch.graphgen import builder
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.bitpack.ref import chunk_pad
from repro_torch.kernels.spmv import ops as spmv_ops
from repro_torch.kernels.spmv import ref as spmv_ref

ALIASES = {"auto": "hybrid"}


def _pack_planes(bits: torch.Tensor) -> torch.Tensor:
    """(B, m) bool membership planes -> (B, chunk_pad(m)/32) packed words
    (the vertical width-1 layout every bitmap probe uses).  The pack kernel
    reads the bool planes in place and masks the ragged last chunk."""
    return bp_ops.pack_planes(bits, 1)


def _put(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host array or tensor -> contiguous ``dtype`` tensor on ``device``."""
    return torch.as_tensor(a, device=device).to(dtype).contiguous()


class LocalBlock(NamedTuple):
    """Expansion-ready storage of one graph block.

    ``src``/``dst`` hold COO edges — the whole graph for ``coo``, the hub
    residue for ``hybrid``, none for ``ell``; ``dst`` is int64, the index
    type of ``scatter_reduce_``.  ``nbr`` is the ELL slab or ``None``.
    Sentinels: ``n_cols`` on the source side, ``n_rows`` on the
    destination side.
    """

    src: torch.Tensor  # (e,) int32 sources
    dst: torch.Tensor  # (e,) int64 destinations
    nbr: torch.Tensor | None  # (n_rows, k) int32 ELL slab, sentinel n_cols
    n_rows: int
    n_cols: int


def _coo_push(src, dst, n_rows: int, n_cols: int, f: torch.Tensor) -> torch.Tensor:
    """(B, n_cols) frontier planes -> (B, n_rows) min frontier source per
    destination.  One plane at a time, so the (e,) temporaries stay one
    plane wide."""
    out = torch.full((f.shape[0], n_rows + 1), INF, dtype=torch.int32, device=f.device)
    valid = src < n_cols
    s_cl = torch.clamp(src, 0, n_cols - 1)
    for p in range(f.shape[0]):
        cand = torch.where(f[p][s_cl] & valid, src, INF)
        out[p].scatter_reduce_(0, dst, cand, "amin")
    return out[:, :n_rows]


def _coo_pull(src, dst, n_rows: int, n_cols: int, words, unreached) -> torch.Tensor:
    """Pull over COO edges: the frontier is probed through its *packed*
    bitmap ``words`` (``_pack_planes`` of the planes), and only unreached
    destinations accumulate candidates."""
    n_cp = chunk_pad(n_cols)
    out = torch.full((words.shape[0], n_rows + 1), INF, dtype=torch.int32,
                     device=words.device)
    valid = (src < n_cols) & (dst < n_rows)
    d_cl = torch.clamp(dst, 0, n_rows - 1)
    for p in range(words.shape[0]):
        hit = spmv_ref.frontier_bit(words[p], src, n_cp) & unreached[p][d_cl] & valid
        cand = torch.where(hit, src, INF)
        out[p].scatter_reduce_(0, dst, cand, "amin")
    return out[:, :n_rows]


def _ell_push(nbr, n_cols: int, f) -> torch.Tensor:
    return spmv_ops.spmv_min_planes(nbr, _pack_planes(f), chunk_pad(n_cols))


def _ell_pull(nbr, n_cols: int, words, unreached) -> torch.Tensor:
    return spmv_ops.spmv_pull_min_planes(
        nbr, words, _pack_planes(unreached), chunk_pad(n_cols)
    )


def _coo_push_value(src, dst, n_rows, n_cols, f, x, alg, row_base, col_base):
    """Value push over COO edges: each active edge proposes the algebra's
    message of its source's value (column-LOCAL frontier, global ids from
    the bases), reduced per destination with the algebra's combine."""
    out = torch.empty((f.shape[0], n_rows), dtype=torch.int32, device=f.device)
    valid = src < n_cols
    s_cl = torch.clamp(src, 0, n_cols - 1).to(torch.int64)
    w = alg.edge_weights(src + col_base, dst + row_base)
    for p in range(f.shape[0]):
        msg = alg.edge_message(x[p][s_cl], w)
        cand = torch.where(f[p][s_cl] & valid, msg, alg.empty)
        out[p] = alg.segment_combine(cand, dst, n_rows + 1)[:n_rows]
    return out


def _coo_pull_value(src, dst, n_rows, n_cols, words, unreached, x, alg, row_base,
                    col_base):
    """Value pull over COO edges: the frontier probed through its packed
    bitmap ``words``, only ``unreached`` destinations (the algebra's pull
    mask) accumulating."""
    n_cp = chunk_pad(n_cols)
    out = torch.empty((words.shape[0], n_rows), dtype=torch.int32, device=words.device)
    valid = (src < n_cols) & (dst < n_rows)
    s_cl = torch.clamp(src, 0, n_cols - 1).to(torch.int64)
    d_cl = torch.clamp(dst, 0, n_rows - 1)
    w = alg.edge_weights(src + col_base, dst + row_base)
    for p in range(words.shape[0]):
        hit = spmv_ref.frontier_bit(words[p], src, n_cp) & unreached[p][d_cl] & valid
        msg = alg.edge_message(x[p][s_cl], w)
        cand = torch.where(hit, msg, alg.empty)
        out[p] = alg.segment_combine(cand, dst, n_rows + 1)[:n_rows]
    return out


def _ell_push_value(nbr, n_cols, f, x, alg, row_base, col_base):
    return spmv_ops.gspmm_planes(nbr, _pack_planes(f), x, chunk_pad(n_cols), alg,
                                 row_base=row_base, col_base=col_base)


def _ell_pull_value(nbr, n_cols, words, unreached, x, alg, row_base, col_base):
    return spmv_ops.gspmm_planes(nbr, words, x, chunk_pad(n_cols), alg,
                                 row_base=row_base, col_base=col_base,
                                 u_words=_pack_planes(unreached))


class ExpansionBackend:
    """One local-expansion data structure (or a degree split over two).

    ``graph_arrays`` builds the backend's extra host arrays (numpy; ``()``
    for COO) from the flat edge list, ``block_arrays`` the same per 2D
    block of a :class:`~repro_torch.core.csr.BlockedGraph` (each array leads
    with the (R, C) grid axes); ``local_block`` moves what the
    backend keeps of those onto ``device`` as a :class:`LocalBlock`;
    ``push_planes`` / ``pull_planes`` expand all B frontier planes at once
    into ``(B, n_rows)`` min-candidate ids (INF where none);
    ``push_value_planes`` / ``pull_value_planes`` do the same for a value
    algebra ``alg`` with ``(B, n_cols)`` encoded source values ``x``
    (``alg.empty`` where none), ``row_base`` / ``col_base`` being the
    block's global id offsets.
    """

    name: str = ""
    #: rank of each extra per-rank array (after the (R, C) grid axes)
    extra_ndims: tuple[int, ...] = ()

    def graph_arrays(self, src, dst, n: int) -> tuple[np.ndarray, ...]:
        return ()

    def block_arrays(self, bg: csrmod.BlockedGraph) -> tuple[np.ndarray, ...]:
        return ()

    def local_block(self, src, dst, extra, n_rows: int, n_cols: int,
                    device: torch.device) -> LocalBlock:
        raise NotImplementedError

    def push_planes(self, blk: LocalBlock, f: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pull_planes(self, blk: LocalBlock, f, unreached) -> torch.Tensor:
        raise NotImplementedError

    def push_value_planes(self, blk: LocalBlock, f, x, alg, *, row_base=0,
                          col_base=0) -> torch.Tensor:
        raise NotImplementedError

    def pull_value_planes(self, blk: LocalBlock, f, unreached, x, alg, *,
                          row_base=0, col_base=0) -> torch.Tensor:
        raise NotImplementedError

    def describe(self, bg: csrmod.BlockedGraph) -> list[dict]:
        """Per-block split and slab padding (``[]`` where there is no slab)."""
        return []


def _describe(blocks, bg: csrmod.BlockedGraph, residue: bool) -> list[dict]:
    waste = blocks.padding_ratio()
    out = []
    for i in range(bg.part.rows):
        for j in range(bg.part.cols):
            d = {"block": (i, j), "split_k": int(blocks.split_k[i, j]),
                 "padding_ratio": float(waste[i, j])}
            if residue:
                d["residue_edges"] = int((blocks.res_src[i, j] < bg.part.n_c).sum())
            out.append(d)
    return out


class CooExpansion(ExpansionBackend):
    name = "coo"

    def local_block(self, src, dst, extra, n_rows, n_cols, device):
        if len(extra):
            raise ValueError(f"coo takes no extra arrays, got {len(extra)}")
        return LocalBlock(src=_put(src, torch.int32, device),
                          dst=_put(dst, torch.int64, device),
                          nbr=None, n_rows=n_rows, n_cols=n_cols)

    def push_planes(self, blk, f):
        return _coo_push(blk.src, blk.dst, blk.n_rows, blk.n_cols, f)

    def pull_planes(self, blk, f, unreached):
        return _coo_pull(blk.src, blk.dst, blk.n_rows, blk.n_cols, _pack_planes(f),
                         unreached)

    def push_value_planes(self, blk, f, x, alg, *, row_base=0, col_base=0):
        return _coo_push_value(blk.src, blk.dst, blk.n_rows, blk.n_cols, f, x, alg,
                               row_base, col_base)

    def pull_value_planes(self, blk, f, unreached, x, alg, *, row_base=0, col_base=0):
        return _coo_pull_value(blk.src, blk.dst, blk.n_rows, blk.n_cols, _pack_planes(f),
                               unreached, x, alg, row_base, col_base)


class EllExpansion(ExpansionBackend):
    name = "ell"
    extra_ndims = (2,)  # (n_r, k) slab

    def graph_arrays(self, src, dst, n):
        nbr, _ = builder.ell_graph_arrays(np.asarray(src), np.asarray(dst), n)
        return (nbr,)

    def block_arrays(self, bg):
        return (csrmod.ell_blocked(bg).nbr,)

    def local_block(self, src, dst, extra, n_rows, n_cols, device):
        (nbr,) = extra
        none = np.zeros(0, np.int32)
        return LocalBlock(src=_put(none, torch.int32, device),
                          dst=_put(none, torch.int64, device),
                          nbr=_put(nbr, torch.int32, device),
                          n_rows=n_rows, n_cols=n_cols)

    def push_planes(self, blk, f):
        return _ell_push(blk.nbr, blk.n_cols, f)

    def pull_planes(self, blk, f, unreached):
        return _ell_pull(blk.nbr, blk.n_cols, _pack_planes(f), unreached)

    def push_value_planes(self, blk, f, x, alg, *, row_base=0, col_base=0):
        return _ell_push_value(blk.nbr, blk.n_cols, f, x, alg, row_base, col_base)

    def pull_value_planes(self, blk, f, unreached, x, alg, *, row_base=0, col_base=0):
        return _ell_pull_value(blk.nbr, blk.n_cols, _pack_planes(f), unreached, x, alg,
                               row_base, col_base)

    def describe(self, bg):
        return _describe(csrmod.ell_blocked(bg), bg, residue=False)


class HybridExpansion(ExpansionBackend):
    """Degree-split COO/ELL: low-degree rows on the slab, hubs in COO."""

    name = "hybrid"
    extra_ndims = (2, 1, 1)  # (n_r, k) slab + (r_cap,) residue src/dst

    def graph_arrays(self, src, dst, n):
        nbr, res_s, res_d, _ = builder.hybrid_graph_arrays(
            np.asarray(src), np.asarray(dst), n)
        return (nbr, res_s, res_d)

    def block_arrays(self, bg):
        h = csrmod.hybrid_blocked(bg)
        return (h.nbr, h.res_src, h.res_dst)

    def local_block(self, src, dst, extra, n_rows, n_cols, device):
        nbr, res_src, res_dst = extra
        return LocalBlock(src=_put(res_src, torch.int32, device),
                          dst=_put(res_dst, torch.int64, device),
                          nbr=_put(nbr, torch.int32, device),
                          n_rows=n_rows, n_cols=n_cols)

    def push_planes(self, blk, f):
        return torch.minimum(
            _ell_push(blk.nbr, blk.n_cols, f),
            _coo_push(blk.src, blk.dst, blk.n_rows, blk.n_cols, f),
        )

    def pull_planes(self, blk, f, unreached):
        words = _pack_planes(f)  # one pack for both halves
        return torch.minimum(
            _ell_pull(blk.nbr, blk.n_cols, words, unreached),
            _coo_pull(blk.src, blk.dst, blk.n_rows, blk.n_cols, words, unreached),
        )

    def push_value_planes(self, blk, f, x, alg, *, row_base=0, col_base=0):
        return alg.combine(
            _ell_push_value(blk.nbr, blk.n_cols, f, x, alg, row_base, col_base),
            _coo_push_value(blk.src, blk.dst, blk.n_rows, blk.n_cols, f, x, alg,
                            row_base, col_base),
        )

    def pull_value_planes(self, blk, f, unreached, x, alg, *, row_base=0, col_base=0):
        words = _pack_planes(f)  # one pack for both halves
        return alg.combine(
            _ell_pull_value(blk.nbr, blk.n_cols, words, unreached, x, alg, row_base,
                            col_base),
            _coo_pull_value(blk.src, blk.dst, blk.n_rows, blk.n_cols, words, unreached,
                            x, alg, row_base, col_base),
        )

    def describe(self, bg):
        return _describe(csrmod.hybrid_blocked(bg), bg, residue=True)


BACKENDS = {b.name: b for b in (CooExpansion(), EllExpansion(), HybridExpansion())}


def resolve(name: str) -> ExpansionBackend:
    """Expansion backend by name (``coo`` | ``ell`` | ``hybrid`` | ``auto``,
    or one added by :func:`repro_torch.comm.registry.register_expansion`)."""
    return lookup(BACKENDS, "expansion backend", ALIASES.get(name, name))


def block_from_arrays(expand: str, src, dst, extra, n: int, device=None) -> LocalBlock:
    """The port's :class:`LocalBlock` from host arrays.

    ``src``/``dst`` are the flat (m,) edge arrays and ``extra`` the numpy
    containers that ``ExpansionBackend.graph_arrays`` (or
    ``builder.hybrid_graph_arrays``) returns — in the port or in the JAX
    package, which build the same arrays.  This is what carries a graph's
    state onto the device.
    """
    return resolve(expand).local_block(src, dst, tuple(extra), n, n,
                                       resolve_device(device))
