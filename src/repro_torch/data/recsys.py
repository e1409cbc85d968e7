"""Zipf categorical click-log generator (Criteo-like synthetic stream)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClickLogConfig:
    table_sizes: tuple[int, ...]
    batch: int
    seed: int = 0
    zipf_alpha: float = 1.05


def batch_at(cfg: ClickLogConfig, step: int) -> dict[str, np.ndarray]:
    """Deterministic (cfg, step) -> {ids (B, F), labels (B,)}.

    Ids are Zipf-skewed (hot rows dominate, like real CTR traffic) via an
    inverse-CDF power transform — no giant probability vectors needed.
    """
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    f = len(cfg.table_sizes)
    u = rng.random((cfg.batch, f))
    skew = u ** (cfg.zipf_alpha + 1.0)  # mass near 0 = hot rows
    sizes = np.asarray(cfg.table_sizes)
    ids = np.minimum((skew * sizes).astype(np.int64), sizes - 1)
    # labels correlate with a hash of the first few fields (learnable signal)
    h = (ids[:, :4].sum(axis=1) % 7) < 3
    noise = rng.random(cfg.batch) < 0.1
    labels = (h ^ noise).astype(np.float32)
    return {"ids": ids.astype(np.int32), "labels": labels}
