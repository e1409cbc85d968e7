"""Synthetic LM token pipeline: deterministic, double-buffered.

Tokens are a structured synthetic language (Zipf unigrams + short-range
copy structure) so a small model's loss visibly decreases — enough signal
to validate the end-to-end training driver without external datasets.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_alpha: float = 1.1
    copy_prob: float = 0.3  # prob. a token copies the token 4 back


def batch_at(cfg: TokenPipelineConfig, step: int) -> dict[str, np.ndarray]:
    """The batch for a given step — pure function of (cfg, step)."""
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    ranks = np.arange(1, min(cfg.vocab, 1 << 14) + 1, dtype=np.float64)
    p = ranks**-cfg.zipf_alpha
    p /= p.sum()
    toks = rng.choice(len(ranks), size=(cfg.batch, cfg.seq_len), p=p).astype(np.int32)
    copy = rng.random((cfg.batch, cfg.seq_len)) < cfg.copy_prob
    copy[:, :4] = False
    rolled = np.roll(toks, 4, axis=1)
    toks = np.where(copy, rolled, toks)
    return {"tokens": toks % cfg.vocab}


class DoubleBufferedLoader:
    """Background-thread prefetch of the next batch (paper §6.5.2's
    comm/compute overlap, applied to the host input pipeline)."""

    def __init__(self, cfg: TokenPipelineConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            try:
                self._q.put(batch_at(self.cfg, step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __next__(self) -> dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
