"""Where the host time of a kernel wrapper call goes, piece by piece.

Times ``pack_planes`` on ``--planes`` bool planes of ``--n`` values and
``popcount_planes`` on their packed words (by default the density oracle's
main shape at scale 22: (8, 4,194,304) bool, (8, 131,072) words),
``unpack_planes`` on ``--planes`` x ``--unpack-words`` words at b = 1 (a
rank's column bitmaps on the 2x2 grid: (8, 65,536)) and ``quantize`` on
``--quant-n`` float32 values (GraphCast's owned chunk on the 2x2 grid:
11,264 rows x 512), each piece with ``time.perf_counter`` over ``--reps``
calls in rounds of 100 (the inputs' card is synchronized between rounds,
outside the timing, so no launch waits for a full queue):

- ``whole_call``: the wrapper;
- ``without_launch``: the wrapper with ``kernels.launch`` replaced by a
  no-op: its checks, its output allocation and the rest of its Python;
- ``launch``: ``kernels.launch`` with the arguments the wrapper gave it;
- ``current_stream``: ``torch.cuda.current_stream(device).cuda_stream``;
- ``raw_stream``: the same handle as ``kernels.launch`` reads it
  (``kernels.current_stream``: ``torch._C._cuda_getCurrentRawStream``);
- ``device_check``: the comparison ``kernels.launch`` makes of the
  inputs' device index with the current device's;
- ``device_guard``: entering and leaving ``torch.cuda.device`` of the
  inputs' card, which ``kernels.launch`` does when that card is not the
  current one;
- ``ctypes_call``: the C entry point alone, with those arguments, with
  the inputs' card current (it launches the kernel);
- ``launch_counter``: one increment of ``kernels.LAUNCHES``;
- ``empty_loop``: the loop itself.

The arguments are recorded from one real wrapper call, so the pieces
follow the wrappers as they change.  The four calls run with their inputs
on the current card (``cuda:0``); with two cards or more they run again
with their inputs on ``cuda:1`` while ``cuda:0`` stays current, the case
in which ``kernels.launch`` enters the guard.  Prints the cards
(``nvidia-smi`` name and power limit) and one JSON object of microseconds
per call.

    python -m repro_torch.bench.host_floor [--planes 8] [--n 4194304]
        [--unpack-words 65536] [--quant-n 5767168] [--reps 1000]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import kernels
from repro_torch.bench import cards
from repro_torch.kernels.bitpack import ops as bp_ops
from repro_torch.kernels.popcount import ops as pc_ops
from repro_torch.kernels.quant import ops as q_ops

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


def us_per_call(fn, reps: int, device: torch.device) -> float:
    fn()
    total = 0.0
    for done in range(0, reps, ROUND):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(min(ROUND, reps - done)):
            fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return total / reps * 1e6


def _guard(device: torch.device) -> None:
    with torch.cuda.device(device):
        pass


def pieces(call, reps: int) -> dict[str, float]:
    """Host microseconds per call of the wrapper ``call`` and its pieces."""
    _keep, (kernel, name, argtypes, device, *cargs) = _recorded(call)  # cargs point into _keep
    fn = kernels.cfunc(name, argtypes)
    stream = kernels.current_stream(device)

    def count():
        kernels.LAUNCHES[kernel] += 1

    def ctypes_call():
        fn(*cargs, stream)

    times = {
        "whole_call": call,
        "without_launch": _without_launch(call),
        "launch": lambda: kernels.launch(kernel, name, argtypes, device, *cargs),
        "current_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "raw_stream": lambda: kernels.current_stream(device),
        "device_check": lambda: device.index == torch._C._cuda_getDevice(),
        "device_guard": lambda: _guard(device),
        "ctypes_call": ctypes_call,
        "launch_counter": count,
        "empty_loop": lambda: None,
    }
    out = {}
    for piece, f in times.items():
        if piece == "ctypes_call":  # the C call launches on the current device
            with torch.cuda.device(device):
                out[piece] = us_per_call(f, reps, device)
        else:
            out[piece] = us_per_call(f, reps, device)
    return out


def calls(device: torch.device, args) -> dict:
    """The four wrapper calls on inputs made on ``device``: name -> (input,
    call)."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    frontier = torch.rand((args.planes, args.n), generator=gen, device=device) < 0.1
    words = bp_ops.pack_planes(frontier, 1)
    bitmaps = torch.randint(-2**31, 2**31 - 1, (args.planes, args.unpack_words),
                            generator=gen, device=device, dtype=torch.int64).to(torch.int32)
    x = torch.randn(args.quant_n, generator=gen, device=device)
    return {
        "pack": (frontier, lambda: bp_ops.pack_planes(frontier, 1)),
        "popcount_planes": (words, lambda: pc_ops.popcount_planes(words)),
        "unpack_planes": (bitmaps, lambda: bp_ops.unpack_planes(bitmaps, 1)),
        "quantize": (x, lambda: q_ops.quantize(x)),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--planes", type=int, default=8)
    ap.add_argument("--n", type=int, default=4_194_304)
    ap.add_argument("--unpack-words", type=int, default=65_536)
    ap.add_argument("--quant-n", type=int, default=5_767_168)
    ap.add_argument("--reps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_floor: times the CUDA wrappers and needs a card")

    torch.cuda.set_device(0)
    devices = [torch.device("cuda", k) for k in range(min(2, torch.cuda.device_count()))]
    summary = {"cards": cards(), "reps": args.reps, "current_device": 0}
    for dev in devices:
        where = "same_device" if dev.index == 0 else "other_device"
        summary[where] = {"inputs_on": str(dev)}
        for name, (t, call) in calls(dev, args).items():
            summary[where][name] = {"shape": list(t.shape), **pieces(call, args.reps)}
    print("cards: " + "; ".join(summary["cards"]))
    for where in ("same_device", "other_device"):
        for name, res in summary.get(where, {}).items():
            if name != "inputs_on":
                print(f"host us per {name} call at {tuple(res['shape'])}, inputs on "
                      f"{summary[where]['inputs_on']}, cuda:0 current: " + ", ".join(
                          f"{k} {v:.3f}" for k, v in res.items() if k != "shape"))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
