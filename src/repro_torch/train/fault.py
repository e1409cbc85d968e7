"""Fault tolerance: step watchdog, straggler detection, restart policy.

The port's counterpart of ``repro/train/fault.py``:

* deterministic data (``data/*``: batch = f(config, step)) + atomic
  checkpoints (:mod:`repro_torch.train.checkpoint`) give **restart-exact**
  recovery;
* :class:`StepWatchdog` flags hung steps and straggler steps (> k x the
  rolling median), the trigger for a preemptive checkpoint and reschedule;
* :func:`resume_or_init` is the single entry point the launcher uses: it
  either restores the newest complete checkpoint or initializes fresh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train import checkpoint


@dataclasses.dataclass
class StepWatchdog:
    """Rolling-median step timer with straggler / hang classification."""

    straggler_factor: float = 3.0
    hang_timeout_s: float = 300.0
    window: int = 32

    def __post_init__(self):
        self._times: list[float] = []
        self._t0: float | None = None
        self.stragglers: list[int] = []
        self.step_idx = 0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> str:
        """Record one step; returns 'ok' | 'straggler'."""
        if self._t0 is None:
            raise RuntimeError("start() not called")
        dt = time.monotonic() - self._t0
        self._t0 = None
        verdict = "ok"
        if len(self._times) >= 5:
            med = sorted(self._times)[len(self._times) // 2]
            if dt > self.straggler_factor * med:
                verdict = "straggler"
                self.stragglers.append(self.step_idx)
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        self.step_idx += 1
        return verdict

    def is_hung(self) -> bool:
        return self._t0 is not None and (time.monotonic() - self._t0) > self.hang_timeout_s


def resume_or_init(init_fn: Callable[[], Any], ckpt_dir: str,
                   shardings: Any | None = None) -> tuple[Any, int]:
    """Restore the newest complete checkpoint, or initialize fresh.

    Returns (state, start_step).  With ``shardings`` given (a device, or a
    grid's per-rank device list: :func:`checkpoint.restore_sharded`), the
    restored state is placed there whatever the saver's rank count; without
    it, the leaves are CPU tensors."""
    step = checkpoint.latest_step(ckpt_dir)
    if step is None:
        return init_fn(), 0
    like = init_fn()  # structure donor (shapes/dtypes/tree)
    if shardings is not None:
        state = checkpoint.restore_sharded(like, step, ckpt_dir, shardings)
    else:
        state = checkpoint.restore(like, step, ckpt_dir)
    return state, step + 1
