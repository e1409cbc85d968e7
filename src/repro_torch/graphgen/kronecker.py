"""Graph500 Kronecker (RMAT) edge-list generator (paper §2.7.1).

The port's copy of ``repro/graphgen/kronecker.py``: the same numpy random
stream, so a seed gives byte-identical edges in both packages.  Quadrant
probabilities (A, B, C, D) = (0.57, 0.19, 0.19, 0.05); ``vertices =
2**scale`` and ``edges = vertices * edgefactor`` (16 per the benchmark).
One vectorized pass per scale bit, then vertex labels are permuted and edge
order shuffled, as the spec requires.
"""

from __future__ import annotations

import numpy as np

# Graph500 quadrant probabilities.
A, B, C, D = 0.57, 0.19, 0.19, 0.05


def kronecker_edges(
    scale: int,
    edgefactor: int = 16,
    seed: int = 1,
    permute: bool = True,
) -> np.ndarray:
    """Return an int64 array of shape (m, 2) of directed edge endpoints.

    Follows the Graph 500 octave reference: per bit, choose the row/column
    half independently with the RMAT skew, then permute vertex labels and
    shuffle edge order.
    """
    n = 1 << scale
    m = n * edgefactor
    rng = np.random.default_rng(seed)

    ij = np.zeros((2, m), dtype=np.int64)
    ab = A + B
    c_norm = C / (1.0 - ab)
    a_norm = A / ab
    for ib in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > np.where(ii_bit, c_norm, a_norm)
        ij[0] += (1 << ib) * ii_bit
        ij[1] += (1 << ib) * jj_bit

    if permute:
        perm = rng.permutation(n)
        ij = perm[ij]
        ij = ij[:, rng.permutation(m)]
    return ij.T.copy()


def rmat_edges(
    scale: int,
    edgefactor: int = 16,
    seed: int = 1,
    a: float = A,
    b: float = B,
    c: float = C,
    permute: bool = True,
) -> np.ndarray:
    """General RMAT with tunable skew (used by benchmarks to vary gap entropy)."""
    n = 1 << scale
    m = n * edgefactor
    rng = np.random.default_rng(seed)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = np.zeros((2, m), dtype=np.int64)
    for ib in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > np.where(ii_bit, c_norm, a_norm)
        ij[0] += (1 << ib) * ii_bit
        ij[1] += (1 << ib) * jj_bit
    if permute:
        perm = rng.permutation(n)
        ij = perm[ij]
    return ij.T.copy()
