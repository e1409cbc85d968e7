"""Where a Graph500 batch's device time goes: one traced batch.

Builds the graph as the harness does, runs one untimed warm-up batch,
then traces one batch (per ``--algebra``: ``bfs`` by default, ``--batch``
roots under ``direction_opt``; or any of ``sssp``, ``cc``, ``pagerank``,
one after another on the same graph, each with the batch, level cap and
policy of :mod:`repro_torch.bench.algebras`) with ``torch.profiler`` and
prints the device time by kernel and by PyTorch op (top rows of
``key_averages``), the device-busy total and the idle share of the batch's
wall time.  With ``--grid RxC`` the batch is the distributed BFS on a
simulated grid (``--mode``, ``hybrid``), and the trace
also gives the device time of the pack and unpack kernels and of the
kernels launched inside the fixed-capacity compaction and inside the local
expansion, each as a share of the busy time.  The last two come from
profiler ranges around ``compact_ids`` and the backend's push/pull, set
only for the trace.  A range's device span (its first kernel's start to its
last kernel's end, idle gaps included) is printed apart, as a share of
the wall time.  With ``--gnn`` the traced call is one int8 2D forward of
``--arch`` (GraphCast by default; NequIP's payload stays fp32) of
:mod:`repro_torch.bench.gnn` at ``--refine`` (after one warm-up forward),
with the quantize kernel's and the matrix products' device time apart;
with ``--gnn-train`` it is one loss-and-gradient call of the 2D train step
at :mod:`repro_torch.bench.gnn_train`'s depth and payload for the arch
(GraphCast 4 layers, int8; EGNN and NequIP at their depth, fp32), with the
gathers' and the segment sums' kernels apart as well.

    python -m repro_torch.bench.trace --scale 22 [--grid 2x2] [--out trace.json]
    python -m repro_torch.bench.trace --scale 22 --algebra sssp cc pagerank [--grid 2x2]
    python -m repro_torch.bench.trace --gnn [--refine 6] [--arch egnn]
    python -m repro_torch.bench.trace --gnn-train [--refine 6] [--arch nequip]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time

import torch

from repro_torch.bench import algebras, distributed, graph500, teps
from repro_torch.bench import gnn as gnn_bench
from repro_torch.bench import gnn_train
from repro_torch.comm import SimGrid
from repro_torch.core import bfs as bfsmod
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.core import expand as expand_mod
from repro_torch.kernels.bitpack import ops as bp_ops


def _device_us(evt) -> float:
    return evt.self_device_time_total


def _ranged(name, fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    return run


@contextlib.contextmanager
def _phase_ranges():
    """Profiler ranges around the compaction and the local expansion, for
    the traced batch only."""
    saved = [(bp_ops, "compact_ids", bp_ops.compact_ids)]
    bp_ops.compact_ids = _ranged("range/compaction", bp_ops.compact_ids)
    for backend in expand_mod.BACKENDS.values():
        for meth in ("push_planes", "pull_planes", "push_value_planes",
                     "pull_value_planes"):
            saved.append((backend, meth, None))
            setattr(backend, meth, _ranged("range/expansion", getattr(backend, meth)))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--batch", type=int, default=8,
                    help="roots per BFS batch (the algebras take their own)")
    ap.add_argument("--grid", default=None, help="R x C: trace the distributed BFS")
    ap.add_argument("--mode", default="auto", choices=["raw", "bitmap", "auto", "btfly"])
    ap.add_argument("--algebra", nargs="+", default=["bfs"],
                    choices=["bfs", "sssp", "cc", "pagerank"])
    ap.add_argument("--out", default=None, help="chrome trace output path (last algebra)")
    ap.add_argument("--gnn", action="store_true",
                    help="trace one int8 2D GNN forward instead (bench.gnn)")
    ap.add_argument("--gnn-train", action="store_true",
                    help="trace one 2D GNN train step's forward and backward "
                         "instead (bench.gnn_train)")
    ap.add_argument("--arch", default="graphcast", choices=gnn_train.ARCHS,
                    help="--gnn, --gnn-train: the GNN arch")
    ap.add_argument("--refine", type=int, default=6,
                    help="--gnn, --gnn-train: multimesh refinement")
    args = ap.parse_args(argv)

    if args.gnn or args.gnn_train:
        return [_trace_gnn(args)]
    if args.grid:
        g, _, _ = graph500.generate(args.scale)
        st = distributed.setup(g, SimGrid(*distributed.parse_grid(args.grid)), "hybrid")
    else:
        setup = graph500.build(args.scale, device="cuda")
        g = setup.g
    roots = teps.valid_roots(g, 2 * max(args.batch, *algebras.BATCH.values()), seed=2)
    return [_trace(args, alg, st if args.grid else setup, roots) for alg in args.algebra]


def _trace_gnn(args) -> dict:
    """Warm up on one int8 2D forward of ``--arch`` (``--grid``, default
    2x2), trace the next; the quantize kernel's and the matrix products'
    device time are printed apart.  With ``--gnn-train`` the call is the
    train step's loss and gradients (``gnn_dist.value_and_grad_2d`` at
    ``gnn_train.arch_layers`` layers, int8 for ``gnn_train.INT8_ARCHS``)."""
    from repro_torch.models import gnn_dist

    rows, cols = distributed.parse_grid(args.grid or "2x2")
    layers = gnn_train.arch_layers(args.arch) if args.gnn_train else None
    st = gnn_bench.setup(args.arch, refine=args.refine, grid=(rows, cols), layers=layers)
    quantize = (args.arch in gnn_train.INT8_ARCHS if args.gnn_train
                else args.arch not in gnn_dist.FP32_PAYLOAD)
    if args.gnn_train:
        part = st.bg.part
        targets = gnn_dist.shard_targets(
            st.grid, gnn_train.make_targets(part.n, st.cfg.d_out, 0), part)

        def call():
            return gnn_dist.value_and_grad_2d(st.grid, st.cfg, st.params, st.h_own, st.src_l,
                                              st.dst_l, targets, part,
                                              gnn_dist.Dist2DConfig(quantize_payload=quantize),
                                              pos=st.pos)
        what = f"{st.cfg.n_layers}-layer train step (forward + backward)"
    else:
        def call():
            return gnn_bench.forward_2d(st, quantize)
        what = "forward"
    call()
    prof, wall_us, _ = _profiled(call)
    title = (f"{st.cfg.name} 2D {what}, {'int8' if quantize else 'fp32'} payload, refinement "
             f"{args.refine}, grid {rows}x{cols}, ranks simulated on one card")
    classes = {"quantize": lambda k: "quantize_kernel" in k,
               "gemm": lambda k: "gemm" in k}
    if args.gnn_train:  # the gathers (index_select) and the segment sums and
        # gathers' backward (index_add_)
        classes.update({"gather": lambda k: "gather_kernel" in k or "indexselect" in k,
                        "index_add": lambda k: "indexfunc" in k})
    return _report(prof, wall_us, title,
                   {"gnn": st.cfg.name, "refine": args.refine, "grid": f"{rows}x{cols}",
                    "train": args.gnn_train, "layers": getattr(st.cfg, "n_layers", None)},
                   phases=False, trace_out=args.out, classes=classes)


def _trace(args, alg: str, where, roots) -> dict:
    """Warm up on one batch, trace the next; print and return the table."""
    if alg == "bfs":
        b, policy, max_levels = args.batch, "direction_opt", 1024
    else:
        b, policy, max_levels = algebras.BATCH[alg], algebras.POLICY, algebras.MAX_LEVELS[alg]
    if args.grid:
        cfg = dbfs.DistBFSConfig(mode=args.mode, policy=policy, expand="hybrid",
                                 algebra=alg, max_levels=max_levels)
        fn = dbfs.build_bfs(where.grid, where.bg, cfg)

        def batch(r):
            return fn(*where.blocks, r)[2]
    else:
        def batch(r):
            return bfsmod.bfs(where.src, where.dst, r, where.g.n, policy=policy,
                              expand=where.expand, device=where.device,
                              block=where.block, algebra=alg,
                              max_levels=max_levels).n_levels

    batch(roots[:b])
    ranges = _phase_ranges() if args.grid else contextlib.nullcontext()
    with ranges:
        prof, wall_us, levels = _profiled(lambda: batch(roots[b:2 * b]))
    what = f"grid {args.grid} ({args.mode}), ranks simulated on one card" if args.grid \
        else "one device"
    title = f"{alg} ({policy}) scale {args.scale} batch {b} levels {levels} {what}"
    out = {"scale": args.scale, "algebra": alg, "policy": policy, "batch": b,
           "grid": args.grid, "levels": levels}
    return _report(prof, wall_us, title, out, phases=bool(args.grid), trace_out=args.out)


def _profiled(fn):
    """Trace one call of ``fn`` -> (profiler, wall us, its result)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us, res


def busy_ms(prof) -> float:
    """Device-busy time of a trace: the sum of its kernels' device time."""
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("range/")) / 1e3


def idle_share(fn) -> dict:
    """Trace one call of ``fn`` -> its wall and device-busy ms and the share
    of the wall time the device sat idle."""
    prof, wall_us, _ = _profiled(fn)
    busy = busy_ms(prof)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy, "idle_share": 1 - busy * 1e3 / wall_us}


def _report(prof, wall_us: float, title: str, out: dict, phases: bool,
            trace_out: str | None, classes=None) -> dict:
    """Print and return the traced call's device time by kernel and by op,
    its busy time and idle share, the grid BFS's phases (``phases``), and
    the device time of each kernel class (``classes``: name -> predicate on
    the lowercased kernel name); write the chrome trace to ``trace_out``."""
    events = prof.key_averages()
    # kernels are the device-side entries; a CPU op's device time repeats
    # its kernels', so only kernels are summed into the busy time (the
    # device-side spans of the profiler ranges are not kernels)
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    # a range's host-side entry sums the kernels launched inside it; its
    # device-side entry is the span from its first kernel to its last
    spans = {e.key: _device_us(e) / 1e3 for e in on_device if e.key.startswith("range/")}
    in_range = {e.key: e.device_time_total / 1e3 for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA
                and e.key.startswith("range/")}
    kernels = sorted((e for e in on_device if not e.key.startswith("range/")),
                     key=_device_us, reverse=True)
    ops = sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("range/")), key=_device_us, reverse=True)
    busy_us = busy_ms(prof) * 1e3
    print(f"# {title} on {torch.cuda.get_device_name(0)}: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}")
    table = {}
    for kind, evts in (("kernels", kernels), ("ops", ops)):
        print(f"## {kind} by device time")
        table[kind] = []
        for e in evts[:15]:
            table[kind].append({"name": e.key[:120], "calls": e.count,
                                "device_ms": _device_us(e) / 1e3,
                                "share": _device_us(e) / busy_us if busy_us else 0.0})
            print(f"{_device_us(e) / 1e3:10.3f} ms {e.count:6d} x  {e.key[:100]}")
    out.update(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               idle_share=1 - busy_us / wall_us, top=table)
    if phases:
        def kernel_ms(pred):
            return sum(_device_us(e) for e in kernels if pred(e.key)) / 1e3

        shares = {
            "pack": kernel_ms(lambda k: "pack_kernel" in k and "unpack" not in k),
            "unpack": kernel_ms(lambda k: "unpack_kernel" in k),
            "compaction": in_range.get("range/compaction", 0.0),
            "expansion": in_range.get("range/expansion", 0.0),
        }
        print("## phases (kernel device ms, share of busy): " + ", ".join(
            f"{k} {v:.3f} ({v * 1e3 / busy_us:.4f})" for k, v in shares.items()))
        print("## range spans (device ms, share of wall): " + ", ".join(
            f"{k[6:]} {v:.3f} ({v * 1e3 / wall_us:.4f})" for k, v in sorted(spans.items())))
        out["phases_ms"] = shares
        out["span_ms"] = {k[6:]: v for k, v in spans.items()}
    if classes:
        cls = {name: sum(_device_us(e) for e in kernels if pred(e.key.lower())) / 1e3
               for name, pred in classes.items()}
        print("## kernel classes (device ms, share of busy): " + ", ".join(
            f"{k} {v:.3f} ({v * 1e3 / busy_us:.4f})" for k, v in cls.items()))
        out["classes_ms"] = cls
    if trace_out:
        prof.export_chrome_trace(trace_out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
