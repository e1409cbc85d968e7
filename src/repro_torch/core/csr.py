"""The 2D block partitioner and its per-block containers (paper §2.6.2).

The port's copy of ``repro/core/csr.py:32-289`` (numpy, host side): every
array it returns is byte-identical to the reference's for the same graph.

The 2D partition: an R x C grid of ranks; rank (i, j) holds adjacency block
``A_ij`` = edges (u -> v) with ``u`` in column slice j (width n/C) and ``v``
in row slice i (width n/R).  The vertex space is split into R*C owned
chunks of ``s = n/(R*C)``; rank (i, j) owns chunk ``q = i*C + j``.  Every
block is padded to one capacity with sentinel edges (src = n_c, dst = n_r)
that fall out of every gather and segment reduction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphgen.builder import (
    CSRGraph,
    _round_up,
    edge_degrees,
    ell_from_edges,
    select_split_k,
)


@dataclasses.dataclass(frozen=True)
class Partition2D:
    """Geometry of the R x C grid over n (padded) vertices."""

    n: int  # padded global vertex count
    n_orig: int  # pre-padding vertex count
    rows: int  # R
    cols: int  # C

    @property
    def n_r(self) -> int:  # row-slice width (vertices per grid row)
        return self.n // self.rows

    @property
    def n_c(self) -> int:  # column-slice width
        return self.n // self.cols

    @property
    def chunk(self) -> int:  # owned-chunk width s
        return self.n // (self.rows * self.cols)

    def transpose_perm(self) -> list[tuple[int, int]]:
        """(src_rank, dst_rank) pairs of the paper's TransposeVector
        (Alg. 2 l.4) over the row-major linearized grid: rank p owns chunk
        q = p, and the column phase needs chunk q on rank (q % R, q // R)
        so that the column-j all-gather assembles the contiguous column
        slice."""
        r, c = self.rows, self.cols
        pairs = []
        for src in range(r * c):
            jp, ip = src // r, src % r
            pairs.append((src, ip * c + jp))
        return pairs


@dataclasses.dataclass(frozen=True)
class BlockedGraph:
    """2D-blocked edge arrays, shaped (R, C, e_cap) with local indices.

    ``src_local`` indexes into the column slice [0, n_c); ``dst_local`` into
    the row slice [0, n_r).  Padding edges use (n_c, n_r) sentinels.
    """

    part: Partition2D
    src_local: np.ndarray  # (R, C, e_cap) int32
    dst_local: np.ndarray  # (R, C, e_cap) int32
    e_counts: np.ndarray  # (R, C) int64 true edge counts per block
    m_input: int

    @property
    def e_cap(self) -> int:
        return int(self.src_local.shape[-1])


@dataclasses.dataclass(frozen=True)
class ELLBlocks:
    """Dense destination-major neighbor slabs, one per 2D block: ``nbr[i,
    j]`` is the ``(n_r, k)`` slab of ``A_ij``, sentinel-padded with ``n_c``;
    ``k`` is the max over blocks so every block has one shape."""

    part: Partition2D
    nbr: np.ndarray  # (R, C, n_r, k) int32, sentinel n_c
    split_k: np.ndarray  # (R, C) int32 per-block degree split

    @property
    def k(self) -> int:
        return int(self.nbr.shape[-1])


@dataclasses.dataclass(frozen=True)
class HybridBlocks:
    """Per-block degree-split COO/ELL storage: rows with degree <= the
    block's ``split_k`` live in the shared-width ELL slab, the hub residue
    in sentinel-padded COO arrays of one capacity."""

    part: Partition2D
    nbr: np.ndarray  # (R, C, n_r, k) int32, sentinel n_c
    res_src: np.ndarray  # (R, C, r_cap) int32, sentinel n_c
    res_dst: np.ndarray  # (R, C, r_cap) int32, sentinel n_r
    split_k: np.ndarray  # (R, C) int32 per-block degree split

    @property
    def k(self) -> int:
        return int(self.nbr.shape[-1])

    @property
    def r_cap(self) -> int:
        return int(self.res_src.shape[-1])


def _block_degrees(src: np.ndarray, dst: np.ndarray, part: Partition2D) -> np.ndarray:
    return edge_degrees(src, dst, part.n_r, part.n_c)


def ell_slab_width(bg: BlockedGraph, deg_multiple: int = 8) -> int:
    """The slab width :func:`ell_blocked` uses: the max row degree over all
    blocks, rounded to the degree multiple."""
    part = bg.part
    max_deg = max(
        int(_block_degrees(bg.src_local[i, j], bg.dst_local[i, j], part).max(initial=0))
        for i in range(part.rows)
        for j in range(part.cols)
    )
    return _round_up(max(max_deg, 1), deg_multiple)


def ell_blocked(bg: BlockedGraph, deg_multiple: int = 8) -> ELLBlocks:
    """Pure-ELL containers: one slab width covering every block's heaviest
    row."""
    part = bg.part
    r, c = part.rows, part.cols
    k = ell_slab_width(bg, deg_multiple)
    nbr = np.empty((r, c, part.n_r, k), np.int32)
    for i in range(r):
        for j in range(c):
            slab, res_s, _ = ell_from_edges(
                bg.src_local[i, j], bg.dst_local[i, j], part.n_r, part.n_c, k
            )
            if res_s.size:
                raise AssertionError("pure ELL must cover every row")
            nbr[i, j] = slab
    return ELLBlocks(part=part, nbr=nbr, split_k=np.full((r, c), k, np.int32))


def hybrid_blocked(
    bg: BlockedGraph,
    waste_budget: float = 0.5,
    split_k: int | None = None,
    deg_multiple: int = 8,
    res_multiple: int = 1024,
) -> HybridBlocks:
    """Per-block degree-split containers: each block's split from its own
    degree histogram (:func:`select_split_k`) unless ``split_k`` is forced;
    the slab width and residue capacity are the max over blocks."""
    part = bg.part
    r, c = part.rows, part.cols
    ks = np.empty((r, c), np.int32)
    for i in range(r):
        for j in range(c):
            deg = _block_degrees(bg.src_local[i, j], bg.dst_local[i, j], part)
            ks[i, j] = split_k or select_split_k(deg, waste_budget, deg_multiple)
    width = _round_up(int(ks.max(initial=1)), deg_multiple)
    slabs = np.empty((r, c, part.n_r, width), np.int32)
    residues = []
    for i in range(r):
        for j in range(c):
            slab, res_s, res_d = ell_from_edges(
                bg.src_local[i, j], bg.dst_local[i, j], part.n_r, part.n_c,
                int(ks[i, j]), width=width,
            )
            slabs[i, j] = slab
            residues.append((res_s, res_d))
    r_cap = _round_up(max(max(s.size for s, _ in residues), 1), res_multiple)
    res_src = np.full((r, c, r_cap), part.n_c, np.int32)
    res_dst = np.full((r, c, r_cap), part.n_r, np.int32)
    for b, (res_s, res_d) in enumerate(residues):
        i, j = divmod(b, c)
        res_src[i, j, : res_s.size] = res_s
        res_dst[i, j, : res_d.size] = res_d
    return HybridBlocks(part=part, nbr=slabs, res_src=res_src, res_dst=res_dst,
                        split_k=ks)


def padded_geometry(n: int, rows: int, cols: int,
                    chunk_multiple: int = 1024) -> tuple[int, int]:
    """(padded n, chunk width s) that :func:`partition_2d` produces for an
    ``n``-vertex graph."""
    n_pad = _round_up(max(n, rows * cols), rows * cols * chunk_multiple)
    return n_pad, n_pad // (rows * cols)


def partition_2d(
    g: CSRGraph,
    rows: int,
    cols: int,
    chunk_multiple: int = 1024,
    e_cap_multiple: int = 1024,
) -> BlockedGraph:
    """Partition a CSR graph onto an R x C grid with static-capacity blocks.

    ``chunk_multiple`` keeps the owned-chunk width s a multiple of the
    bit-packing chunk (1024) so compressed exchanges stay chunk-aligned.
    """
    n, _ = padded_geometry(g.n, rows, cols, chunk_multiple)
    part = Partition2D(n=n, n_orig=g.n, rows=rows, cols=cols)
    src, dst = g.src.astype(np.int64), g.dst.astype(np.int64)

    block = (dst // part.n_r) * cols + src // part.n_c
    order = np.argsort(block, kind="stable")
    src, dst, block = src[order], dst[order], block[order]
    del order
    counts = np.bincount(block, minlength=rows * cols)
    del block
    e_cap = _round_up(max(int(counts.max()), 1), e_cap_multiple)

    src_l = np.full((rows * cols, e_cap), part.n_c, dtype=np.int32)
    dst_l = np.full((rows * cols, e_cap), part.n_r, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for b in range(rows * cols):
        s0, cnt = starts[b], counts[b]
        if cnt == 0:
            continue
        i, j = divmod(b, cols)
        src_l[b, :cnt] = (src[s0 : s0 + cnt] - j * part.n_c).astype(np.int32)
        dst_l[b, :cnt] = (dst[s0 : s0 + cnt] - i * part.n_r).astype(np.int32)

    return BlockedGraph(
        part=part,
        src_local=src_l.reshape(rows, cols, e_cap),
        dst_local=dst_l.reshape(rows, cols, e_cap),
        e_counts=counts.reshape(rows, cols),
        m_input=g.m_input,
    )
