"""Where the host time of a kernel wrapper call goes, piece by piece.

Times ``pack_planes`` on ``--planes`` bool planes of ``--n`` values and
``popcount_planes`` on their packed words (by default the density oracle's
main shape at scale 22: (8, 4,194,304) bool, (8, 131,072) words), each
piece with ``time.perf_counter`` over ``--reps`` calls in rounds of 100
(the card is synchronized between rounds, outside the timing, so no
launch waits for a full queue):

- ``whole_call``: the wrapper;
- ``without_launch``: the wrapper with ``kernels.launch`` replaced by a
  no-op: its checks, its output allocation and the rest of its Python;
- ``launch``: ``kernels.launch`` with the arguments the wrapper gave it;
- ``current_stream``: ``torch.cuda.current_stream().cuda_stream``;
- ``ctypes_call``: the C entry point alone, with those arguments (it
  launches the kernel);
- ``launch_counter``: one increment of ``kernels.LAUNCHES``;
- ``empty_loop``: the loop itself.

The arguments are recorded from one real wrapper call, so the pieces
follow the wrappers as they change.  Prints the card (``nvidia-smi`` name
and power limit) and one JSON object of microseconds per call.

    python -m repro_torch.bench.host_floor [--planes 8] [--n 4194304] [--reps 1000]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch import kernels
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.popcount import ops as pc_ops

ROUND = 100  # launches queued between synchronizations


def _recorded(call):
    """``call()``'s result and the arguments it handed ``kernels.launch``
    (the result is kept, so the pointers in the arguments stay valid)."""
    seen = []
    real = kernels.launch
    kernels.launch = lambda *args: seen.append(args)
    try:
        out = call()
    finally:
        kernels.launch = real
    (args,) = seen
    return out, args


def _without_launch(call):
    def run():
        real = kernels.launch
        kernels.launch = lambda *args: None
        try:
            call()
        finally:
            kernels.launch = real
    return run


def us_per_call(fn, reps: int) -> float:
    fn()
    total = 0.0
    for done in range(0, reps, ROUND):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(min(ROUND, reps - done)):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e6


def pieces(call, reps: int) -> dict[str, float]:
    """Host microseconds per call of the wrapper ``call`` and its pieces."""
    _keep, (kernel, name, argtypes, *cargs) = _recorded(call)  # cargs point into _keep
    fn = kernels.cfunc(name, argtypes)
    stream = torch.cuda.current_stream().cuda_stream

    def count():
        kernels.LAUNCHES[kernel] += 1

    times = {
        "whole_call": call,
        "without_launch": _without_launch(call),
        "launch": lambda: kernels.launch(kernel, name, argtypes, *cargs),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes_call": lambda: fn(*cargs, stream),
        "launch_counter": count,
        "empty_loop": lambda: None,
    }
    return {piece: us_per_call(f, reps) for piece, f in times.items()}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--planes", type=int, default=8)
    ap.add_argument("--n", type=int, default=4_194_304)
    ap.add_argument("--reps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_floor: times the CUDA wrappers and needs a card")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    frontier = torch.rand((args.planes, args.n), generator=gen, device="cuda") < 0.1
    words = bp_ops.pack_planes(frontier, 1)
    summary = {
        "card": card(), "reps": args.reps,
        "pack": {"shape": list(frontier.shape),
                 **pieces(lambda: bp_ops.pack_planes(frontier, 1), args.reps)},
        "popcount_planes": {"shape": list(words.shape),
                            **pieces(lambda: pc_ops.popcount_planes(words), args.reps)},
    }
    print(f"card: {summary['card']}")
    for name in ("pack", "popcount_planes"):
        print(f"host us per {name} call at {tuple(summary[name]['shape'])}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in summary[name].items() if k != "shape"))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
