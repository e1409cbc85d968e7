"""Benchmarks of the port: the Graph500, distributed, algebra, GNN, LM
serving and recsys harnesses, the paper's studies, and the timing helpers
they share."""

from __future__ import annotations

import subprocess
import time

import torch


def cards() -> list[str]:
    """Every card's name and power limit as ``nvidia-smi`` gives them, one
    entry a card in ``nvidia-smi``'s order (the device names where
    ``nvidia-smi`` cannot run)."""
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    return lines or [torch.cuda.get_device_name(k) for k in range(torch.cuda.device_count())]


def card(device=None) -> str:
    """The first card's name and power limit as ``nvidia-smi`` gives them
    (:func:`cards`), or ``cpu`` for a CPU device."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    return cards()[0]


def mean_us(fn, reps: int, device) -> float:
    """Mean microseconds of one call of ``fn`` over ``reps`` calls after one
    warm-up call: CUDA events on a card (its time, host launch cost
    included), the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e6 / reps
