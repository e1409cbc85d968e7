"""Graph batch pipelines: shape-spec synthetic graphs + neighbor sampler.

The four GNN shape cells need different generators:

* ``full_graph_sm`` / ``ogb_products`` — one static graph with the spec's
  (n, m, d_feat); RMAT connectivity (power-law, like the real datasets).
* ``minibatch_lg`` — layered neighbor sampling (GraphSAGE fanout 15-10) out
  of a large graph: a REAL sampler over CSR, not a stub.
* ``molecule`` — batched small graphs (block-diagonal union with offsets).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphgen import builder, kronecker


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Host-side static-shape graph batch (padding edges: src=dst=n)."""

    nf: np.ndarray  # (n, d) float32
    src: np.ndarray  # (m,) int32
    dst: np.ndarray  # (m,) int32
    pos: np.ndarray | None  # (n, 3)
    targets: np.ndarray  # (n,) int or (n, d_out) float
    mask: np.ndarray | None = None  # (n,) valid-node mask


def synthetic_graph(
    n_nodes: int, n_edges: int, d_feat: int, seed: int = 0, n_classes: int = 16
) -> GraphBatch:
    """RMAT-connectivity graph with the exact (n, m) of a shape spec."""
    rng = np.random.default_rng(seed)
    scale = max(int(np.ceil(np.log2(n_nodes))), 1)
    ef = max(n_edges // (1 << scale), 1)
    e = kronecker.rmat_edges(scale, edgefactor=ef, seed=seed)
    e = e[e.max(axis=1) < n_nodes]
    if e.shape[0] >= n_edges:
        e = e[:n_edges]
    else:  # top up with uniform edges to hit the spec's m exactly
        extra = rng.integers(0, n_nodes, size=(n_edges - e.shape[0], 2))
        e = np.concatenate([e, extra])
    return GraphBatch(
        nf=rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        src=e[:, 0].astype(np.int32),
        dst=e[:, 1].astype(np.int32),
        pos=rng.normal(size=(n_nodes, 3)).astype(np.float32),
        targets=rng.integers(0, n_classes, n_nodes).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# layered neighbor sampler (minibatch_lg: batch_nodes=1024, fanout 15-10)
# ---------------------------------------------------------------------------


class NeighborSampler:
    """Uniform fanout sampling over a CSR graph (GraphSAGE-style).

    Produces static-shape blocks: seeds (B,), hop-1 (B*f1,), hop-2
    (B*f1*f2,) with edges between consecutive layers.  Sampling with
    replacement keeps shapes static (standard for TPU pipelines).
    """

    def __init__(self, g: builder.CSRGraph, fanouts: tuple[int, ...], seed: int = 0):
        self.g = g
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (nodes (N,), src (M,), dst (M,)) with *local* indices.

        nodes concatenates [seeds, hop1, hop2, ...]; every sampled edge
        points from a hop-k+1 node to its hop-k parent (message direction).
        """
        g = self.g
        layers = [seeds.astype(np.int64)]
        src_l, dst_l = [], []
        base = 0
        for f in self.fanouts:
            frontier = layers[-1]
            deg = (g.row_ptr[frontier + 1] - g.row_ptr[frontier]).astype(np.int64)
            # sample f neighbors with replacement (isolated nodes self-loop)
            offs = self.rng.integers(0, np.maximum(deg, 1)[:, None], size=(frontier.size, f))
            nbr_idx = g.row_ptr[frontier][:, None] + offs
            nbrs = np.where(
                deg[:, None] > 0, g.col_idx[np.minimum(nbr_idx, g.m - 1)], frontier[:, None]
            )
            next_base = base + frontier.size
            src_l.append(next_base + np.arange(frontier.size * f))
            dst_l.append(np.repeat(base + np.arange(frontier.size), f))
            layers.append(nbrs.reshape(-1))
            base = next_base
        nodes = np.concatenate(layers)
        return (
            nodes,
            np.concatenate(src_l).astype(np.int32),
            np.concatenate(dst_l).astype(np.int32),
        )

    def batch(self, seeds: np.ndarray, d_feat: int, feat_seed: int = 0) -> GraphBatch:
        nodes, src, dst = self.sample(seeds)
        rng = np.random.default_rng(feat_seed)
        nf = rng.normal(size=(nodes.size, d_feat)).astype(np.float32)
        mask = np.zeros(nodes.size, np.float32)
        mask[: seeds.size] = 1.0  # loss only on seed nodes
        return GraphBatch(
            nf=nf,
            src=src,
            dst=dst,
            pos=rng.normal(size=(nodes.size, 3)).astype(np.float32),
            targets=rng.integers(0, 16, nodes.size).astype(np.int32),
            mask=mask,
        )


def sampled_shape(batch_nodes: int, fanouts: tuple[int, ...]) -> tuple[int, int]:
    """(n_nodes, n_edges) of a sampled block — static, from the fanout spec."""
    n, m, layer = batch_nodes, 0, batch_nodes
    for f in fanouts:
        m += layer * f
        layer *= f
        n += layer
    return n, m


def molecule_batch(
    n_mols: int, nodes_per: int, edges_per: int, d_feat: int, seed: int = 0
) -> GraphBatch:
    """Block-diagonal union of small molecular graphs (batched-small-graphs)."""
    rng = np.random.default_rng(seed)
    n = n_mols * nodes_per
    src = np.concatenate(
        [k * nodes_per + rng.integers(0, nodes_per, edges_per) for k in range(n_mols)]
    )
    dst = np.concatenate(
        [k * nodes_per + rng.integers(0, nodes_per, edges_per) for k in range(n_mols)]
    )
    return GraphBatch(
        nf=rng.normal(size=(n, d_feat)).astype(np.float32),
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        pos=rng.normal(size=(n, 3)).astype(np.float32) * 2.0,
        targets=rng.normal(size=(n, 1)).astype(np.float32),
    )
