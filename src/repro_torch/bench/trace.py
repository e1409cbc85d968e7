"""Where a Graph500 batch's device time goes: one traced ``bfs()`` batch.

Builds the graph as the harness does, runs one untimed warm-up batch,
then traces one batch of ``--batch`` roots with ``torch.profiler`` and
prints the device time by kernel (top rows of ``key_averages``), the
device-busy total and the idle share of the batch's wall time.

    python -m repro_torch.bench.trace --scale 22 [--out trace.json]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.bench import graph500, teps
from repro_torch.core import bfs as bfsmod


def _device_us(evt) -> float:
    return evt.self_device_time_total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None, help="chrome trace output path")
    args = ap.parse_args(argv)

    setup = graph500.build(args.scale, device="cuda")
    roots = teps.valid_roots(setup.g, 2 * args.batch, seed=2)

    def batch(r):
        return bfsmod.bfs(setup.src, setup.dst, r, setup.g.n, policy="direction_opt",
                          expand=setup.expand, device=setup.device, block=setup.block)

    batch(roots[: args.batch])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = batch(roots[args.batch :])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # kernels are the device-side entries; a CPU op's device time repeats
    # its kernels', so only kernels are summed into the busy time
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=_device_us, reverse=True)
    ops = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA),
                 key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in kernels)
    print(f"# scale {args.scale} batch {args.batch} levels {res.n_levels} on "
          f"{torch.cuda.get_device_name(0)}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}")
    table = {}
    for kind, evts in (("kernels", kernels), ("ops", ops)):
        print(f"## {kind} by device time")
        table[kind] = []
        for e in evts[:15]:
            table[kind].append({"name": e.key[:120], "calls": e.count,
                                "device_ms": _device_us(e) / 1e3,
                                "share": _device_us(e) / busy_us if busy_us else 0.0})
            print(f"{_device_us(e) / 1e3:10.3f} ms {e.count:6d} x  {e.key[:100]}")
    if args.out:
        prof.export_chrome_trace(args.out)
    out = {"scale": args.scale, "batch": args.batch, "levels": res.n_levels,
           "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "idle_share": 1 - busy_us / wall_us, "top": table}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
