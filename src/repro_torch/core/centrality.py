"""Batched-BFS centrality accumulation (Brandes-style tree dependencies).

The port's counterpart of ``repro/core/centrality.py``.  Each of the B
parent/level planes of a batched BFS is a tree, and summing the
per-source tree dependencies approximates betweenness centrality the way
sampled-source Brandes does.  The reference sweeps the vertices one by one
in numpy; here one bottom-up sweep runs on the planes' device, one float64
``index_add_`` per level over all B planes at once.  The dependencies are
integer counts held in float64, so the sums are exact and equal the
reference's whatever order they are added in.
"""

from __future__ import annotations

import torch


def tree_betweenness(parents, levels, n: int) -> torch.Tensor:
    """Brandes-style dependency accumulation over each source's BFS tree.

    ``parents`` / ``levels``: (B, n') batched BFS output, tensors or numpy
    arrays (a single (n',) pair is promoted to B=1; columns past ``n``, the
    grid's padding, are dropped).  A vertex's dependency in one tree is the
    number of its tree descendants; a level-``L`` vertex hands ``1 + its
    dependency`` to its parent, deepest level first.  The roots' own
    dependencies (the endpoints) are left out.  Returns the (n,) float64
    sum over the planes, on the planes' device."""
    parents = torch.atleast_2d(torch.as_tensor(parents))[:, :n].to(torch.int64)
    levels = torch.atleast_2d(torch.as_tensor(levels, device=parents.device))[:, :n]
    b = parents.shape[0]
    delta = torch.zeros(b * n, dtype=torch.float64, device=parents.device)
    offset = (torch.arange(b, device=parents.device) * n)[:, None]
    flat_parent = (parents + offset).reshape(-1)
    flat_level = levels.reshape(-1)
    depth = int(flat_level.max()) if flat_level.numel() else 0
    for lv in range(depth, 0, -1):
        at = torch.nonzero(flat_level == lv).squeeze(1)
        delta.index_add_(0, flat_parent[at], 1.0 + delta[at])
    delta = delta.reshape(b, n)
    return torch.where(levels == 0, 0.0, delta).sum(dim=0)
