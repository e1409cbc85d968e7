"""Frontier algebras: the (message, combine, update) triple of a level.

The port's counterpart of ``repro/core/algebra.py:160-223``.  This slice
carries the ``bfs`` algebra only (min-parent: the candidate a frontier
source proposes is its own id, a vertex is activated on first touch);
``sssp``, ``cc`` and ``pagerank`` come with a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bitpack.ref import B_CLASSES

INF = 2**31 - 1  # int32 max: "no candidate" on every candidate plane


def width_class(n: int) -> int:
    """Smallest bit-packing class covering ids in [0, n) (the reference's
    ``repro/comm/butterfly.py:width_class``)."""
    need = max((n - 1).bit_length(), 1)
    for b in B_CLASSES:
        if b >= need:
            return b
    return 32


class BfsAlgebra:
    """Min-parent BFS."""

    name = "bfs"
    payload_is_id = True  # wires may localize the payload and re-globalize it

    def row_payload_width(self, n_c: int, n: int) -> int:
        """Bits of the row wire's candidate payload: column-local parents."""
        return width_class(n_c)

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

    def post_update(self, ex, news: list, plane_counts) -> tuple[list, list]:
        """Distributed termination consensus -> (frontier, counts) per rank.

        The frontier is what was reached this level; ``counts`` is each
        plane's global frontier size: the popcount kernel over every rank's
        new planes, then one recorded all-reduce (``ex.psum``) over the
        grid.  The driver reads the counts to the host to decide whether
        any plane goes on.
        """
        counts = ex.psum([None if nw is None else plane_counts(nw) for nw in news],
                         fmt="termination")
        return news, counts

    def finalize(self, value: torch.Tensor) -> torch.Tensor:
        """The owned value plane in the output domain (parents as they are)."""
        return value


ALGEBRAS = {"bfs": BfsAlgebra()}


def resolve(name: str) -> BfsAlgebra:
    try:
        return ALGEBRAS[name]
    except KeyError:
        raise ValueError(
            f"unknown algebra {name!r}; this port has {sorted(ALGEBRAS)}"
        ) from None
