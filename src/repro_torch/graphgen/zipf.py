"""Synthetic integer streams for codec benchmarking (paper §5.3.2, Table 5.3).

The port's copy of ``repro/graphgen/zipf.py``: numpy only, the same random
streams, so a seed gives byte-identical output in both packages.  The
paper's codec comparison uses (a) a Zipf synthetic generator with tunable
skewness (TurboPFOR's test harness) and (b) real frontier-queue buffers
extracted from BFS runs (slightly-skewed uniform, 15-bit empirical entropy).
Both stream shapes are reproduced here.
"""

from __future__ import annotations

import numpy as np


def zipf_stream(
    n: int, alpha: float = 1.2, vocab: int = 1 << 20, seed: int = 0
) -> np.ndarray:
    """Zipf-distributed uint32 stream (inverted-index-like data)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    return rng.choice(vocab, size=n, p=probs).astype(np.uint32)


def sorted_id_stream(
    n: int, universe: int, seed: int = 0, skew: float = 0.0
) -> np.ndarray:
    """Sorted, unique vertex-id sequence mimicking a frontier queue.

    ``skew`` > 0 biases ids toward 0 (what degree-relabeling produces);
    skew == 0 gives the paper's "uniform, slightly skewed" distribution
    (Fig 5.2 / Table 5.3).
    """
    rng = np.random.default_rng(seed)
    if skew > 0.0:
        u = rng.random(min(4 * n, universe)) ** (1.0 + skew)
        ids = np.unique((u * universe).astype(np.uint64))
    else:
        ids = np.unique(rng.integers(0, universe, size=min(2 * n, universe * 2)))
    if ids.shape[0] > n:
        ids = np.sort(rng.choice(ids, size=n, replace=False))
    return ids.astype(np.uint32)


def empirical_entropy_bits(values: np.ndarray) -> float:
    """Shannon entropy (bits/symbol) of a discrete stream (paper eq. (2))."""
    _, counts = np.unique(values, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())
