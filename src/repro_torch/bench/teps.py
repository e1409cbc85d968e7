"""Graph500 TEPS helpers (the port's copy of ``benchmarks/teps.py``)."""

from __future__ import annotations

import numpy as np


def valid_roots(g, n_roots: int, seed: int = 1) -> np.ndarray:
    """Graph500 search keys: sampled uniformly, WITHOUT replacement, from
    vertices with at least one edge (the spec's validity condition — an
    isolated root would trivially 'traverse' zero edges)."""
    rng = np.random.default_rng(seed)
    cand = np.nonzero(g.degrees() > 0)[0]
    if cand.size < n_roots:
        raise ValueError(
            f"graph has only {cand.size} non-isolated vertices; "
            f"cannot draw {n_roots} distinct valid roots"
        )
    return rng.choice(cand, size=n_roots, replace=False).astype(np.int32)


def harmonic_mean(xs) -> float:
    """The spec's TEPS statistic (insensitive to a few fast outliers)."""
    return len(xs) / sum(1.0 / x for x in xs)
