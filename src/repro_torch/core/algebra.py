"""Frontier algebras: the (message, combine, update) triple of a level.

The port's counterpart of ``repro/core/algebra.py:199-223``.  This slice
carries the ``bfs`` algebra only (min-parent: the candidate a frontier
source proposes is its own id, a vertex is activated on first touch);
``sssp``, ``cc`` and ``pagerank`` come with a later slice.
"""

from __future__ import annotations

import torch

INF = 2**31 - 1  # int32 max: "no candidate" on every candidate plane


class BfsAlgebra:
    """Min-parent BFS."""

    name = "bfs"

    def init(self, hit: torch.Tensor, roots: torch.Tensor):
        """Initial (value, frontier) planes: value = parent ids, -1 unreached."""
        value = torch.where(hit, roots[:, None], -1).to(torch.int32)
        return value, hit

    def update(self, value: torch.Tensor, cand: torch.Tensor):
        """Fold min candidates into the parent plane -> (value', new)."""
        new = (cand < INF) & (value < 0)
        return torch.where(new, cand, value), new

    def pull_mask(self, value: torch.Tensor) -> torch.Tensor:
        """Destinations that accumulate candidates in pull expansion."""
        return value < 0


ALGEBRAS = {"bfs": BfsAlgebra()}


def resolve(name: str) -> BfsAlgebra:
    try:
        return ALGEBRAS[name]
    except KeyError:
        raise ValueError(
            f"unknown algebra {name!r}; this port has {sorted(ALGEBRAS)}"
        ) from None
