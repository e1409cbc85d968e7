"""Dry-run of every (arch x shape x mesh) cell: each cell's program run once
on ``meta`` arguments, its FLOPs, bytes, peak memory and collectives
counted.

The port's counterpart of ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell on a forced 512-device host mesh and reads
XLA's ``memory_analysis``, ``cost_analysis`` and the collectives of the
HLO.  An eager PyTorch program has no compiler's analyses, so the port
runs the cell's ``fn`` -- the port's own step, at global shapes -- once on
its ``meta`` arguments (shapes and dtypes, no storage, no kernel) under a
dispatch mode of its own (:func:`count_program`), which sees every aten op
of the run, backward included:

* ``flops``: the products' FLOPs by ``torch.utils.flop_counter``, 2*M*N*K
  per product, forward and backward: the convention of the catalogue's
  ``model_flops``.  Elementwise ops count zero, unlike XLA's
  ``cost_analysis``;
* ``bytes_accessed``: over every aten op that is not a view (nor a bare
  allocation, ``empty*``), the bytes of its tensor inputs and outputs;
* ``output_bytes`` and ``temp_bytes``: the peak of the bytes allocated
  during the run and alive at once, tracked per storage (a view or an
  in-place op allocates nothing), less the bytes of the outputs (an output
  that is, or views, an argument adds none);
* the collectives: the 2D cells (``ogb_products``) run their train step on
  a ``SimGrid`` of the mesh's grid, whose collectives
  :func:`repro_torch.launch.roofline.count_collectives` counts -- they are
  what the grid actually executed, the port's counterpart of the HLO's.

The graph500 cells (the paper's workload) run their distributed BFS on a
``meta`` ``SimGrid`` of every rank of the mesh.  A ``meta`` tensor has no
value, so the BFS runs one level, with each adaptive exchange running
every rung of its ladder over every group and every pass the policy
uses: the while body that the reference's HLO holds once, its ``lax.switch``
branches and ``cond`` branches all present
(:mod:`repro_torch.core.distributed_bfs`,
:meth:`repro_torch.comm.engine.AdaptiveExchange.dispatch`).  Its
collectives per kind, FLOPs and bytes are multiplied by the cell's
``loop_mult`` (8), as the reference's ``parse_collectives`` and
``terms_from_compiled`` do; ``memory`` is not.  The counts are products'
FLOPs only, and the BFS has no product: its ``flops``, ``compute_s`` and
``useful_flop_ratio`` are 0.  ``output_bytes`` and ``temp_bytes`` are the
global program's peak over every rank of the grid.

``argument_bytes`` is per rank: each argument's shard under its placement
spec (:func:`repro_torch.launch.mesh.shard_shape`).  ``output_bytes`` and
``temp_bytes`` are the global program's, the per-device ``cost`` and
``roofline`` shares the counted totals over the mesh's chips
(:func:`repro_torch.launch.roofline.terms_from_counts`).  ``compile_s`` is
0 (nothing is compiled) and ``generated_code_bytes`` null.

The LM prefill and decode cells run the sharded serving program
(:mod:`repro_torch.models.transformer_sharded`: FSDP x TP under the cell's
param specs, the decode cache's sequence over TP) on a ``meta``
``SimGrid`` of every rank of the mesh, counted as one layer times the
cell's ``loop_mult`` (its depth) plus the embedding and the head once --
the layer scan's body times ``loop_mult``, as the reference's
``parse_collectives`` counts it -- from two runs, with one layer and with
none; ``memory`` is the one-layer run's.  Their ``output_bytes`` and
``temp_bytes`` are the global program's over every rank.

The LM ``train_4k`` cells run the sharded train step
(:func:`repro_torch.train.step.make_sharded_train_step`: FSDP x TP under
the cell's param specs, the batch over the grid rows) on a ``meta``
``SimGrid`` of every rank, counted as the serving cells are: one layer's
forward, its recomputation in the backward (``remat``: the layer's FSDP
gathers and TP sums again, up to its last saved tensor) and its backward
(the gathers' reduce-scatters, the sums' transposes) times ``loop_mult``,
plus once a step the embedding, the vocabulary-parallel loss and head,
the gradient sums over the replicated leaves (three ``psum``s at most, an
axis each), the norm's ``psum`` and AdamW over every layer's slices.  The
loss's chunks are not recomputed on ``meta``.

The AutoInt and single-device GNN cells still run one device's program:
the port has no sharded runtime for them, so their ``collective_bytes`` is
0.  Their ``fn`` does not depend on the mesh: under ``--both-meshes`` the
second mesh reuses the count of a cell whose arguments have the same
shapes.

One divergence from the reference's record: ``output_bytes`` is the
storage behind the outputs, not their own size.  An output that views a
larger tensor counts that tensor's storage, which the eager program keeps
alive (XLA frees what an output does not need).

Usage (no card needed: every argument is on ``meta``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --report

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__variant].json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.comm.engine import nbytes_of
from repro_torch.configs import common as cfgs
from repro_torch.launch import cells as cellslib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")

#: ops that allocate and move no byte
_ALLOC_ONLY = {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
               "aten::new_empty_strided"}


@dataclasses.dataclass
class ProgramCounts:
    flops: float  # products only, forward and backward
    bytes_accessed: float  # inputs + outputs of every op that is not a view
    output_bytes: int  # the outputs' storages allocated in the run
    temp_bytes: int  # peak bytes alive at once, less output_bytes
    peak_bytes: int
    seconds: float  # the counted run's wall time
    collectives: roofline.CollectiveStats


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree.leaves(x) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    """A key that identifies ``t``'s storage (shared by its views), or
    ``None`` for a tensor without one."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class _Counter(TorchDispatchMode):
    """Bytes of every op that is not a view, and the bytes allocated in the
    run and alive at once, per storage: a storage is allocated by the first
    output on it that is not an alias of an input, and freed when the last
    tensor on it dies.  The storages of ``args`` (and of anything from
    before the run that an op aliases) are not counted."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.live: dict[int, list[int]] = {}  # storage -> [nbytes, tensors on it]
        self.external = {_storage(t) for t in _tensors(args)}
        self.current = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not func.is_view and func._schema.name not in _ALLOC_ONLY:
            self.bytes += sum(nbytes_of(t) for t in ins) + sum(nbytes_of(t) for t in outs)
        in_keys = {_storage(t) for t in ins}
        for t in outs:
            self._hold(t, in_keys)
        return out

    def _hold(self, t: torch.Tensor, in_keys) -> None:
        key = _storage(t)
        if key is None or key in self.external:
            return
        if key not in self.live:
            if key in in_keys:  # aliases a tensor from before the run
                # forgotten when this alias dies: its storage's address may
                # then serve a new one (a later alias re-adds it)
                self.external.add(key)
                weakref.finalize(t, self.external.discard, key)
                return
            n = t.untyped_storage().nbytes()
            self.live[key] = [n, 0]
            self.current += n
            self.peak = max(self.peak, self.current)
        self.live[key][1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if not entry[1]:
            self.current -= entry[0]
            del self.live[key]


def count_program(fn, args, grid=None) -> ProgramCounts:
    """Run ``fn(*args)`` once (on ``meta`` arguments: shapes only) and count
    its FLOPs, bytes and peak memory; with ``grid``, also the collectives
    that grid runs (:func:`repro_torch.launch.roofline.count_collectives`)."""
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        coll = (stack.enter_context(roofline.count_collectives(grid)) if grid is not None
                else roofline.CollectiveStats(per_op={}, total_bytes=0, n_ops=0))
        flops = stack.enter_context(FlopCounterMode(display=False))
        mode = stack.enter_context(_Counter(args))
        out = fn(*args)
        kept = {}
        for t in _tensors(out):
            key = _storage(t)
            if key in mode.live:
                kept[key] = mode.live[key][0]
        peak = mode.peak
    output_bytes = sum(kept.values())
    return ProgramCounts(flops=float(flops.get_total_flops()), bytes_accessed=float(mode.bytes),
                         output_bytes=output_bytes, temp_bytes=peak - output_bytes,
                         peak_bytes=peak, seconds=time.perf_counter() - t0, collectives=coll)


def argument_bytes(args, in_shardings, mesh: meshlib.Mesh) -> int:
    """One rank's bytes of the arguments: each leaf's shard under its spec."""
    total = 0
    for arg, specs in zip(args, in_shardings, strict=True):
        for x, sp in zip(tree.leaves(arg), meshlib.spec_leaves(specs), strict=True):
            total += math.prod(meshlib.shard_shape(x.shape, sp, mesh)) * x.element_size()
    return total


def _scaled(one: ProgramCounts, none: ProgramCounts, layers: int) -> ProgramCounts:
    """The counts of a program of ``layers`` identical layers from its run
    with one layer (``one``) and with none (``none``): the embedding and
    head once, the layer's difference ``layers`` times; the peak memory is
    the one-layer run's."""
    def mult(a, b):
        return b + layers * (a - b)

    kinds = set(one.collectives.per_op) | set(none.collectives.per_op)
    coll = roofline.CollectiveStats(
        per_op={k: mult(one.collectives.per_op.get(k, 0), none.collectives.per_op.get(k, 0))
                for k in sorted(kinds)},
        total_bytes=mult(one.collectives.total_bytes, none.collectives.total_bytes),
        n_ops=mult(one.collectives.n_ops, none.collectives.n_ops),
        grid_per_op={k: mult(one.collectives.grid_per_op.get(k, 0),
                             none.collectives.grid_per_op.get(k, 0)) for k in sorted(kinds)})
    return ProgramCounts(flops=mult(one.flops, none.flops),
                         bytes_accessed=mult(one.bytes_accessed, none.bytes_accessed),
                         output_bytes=one.output_bytes, temp_bytes=one.temp_bytes,
                         peak_bytes=one.peak_bytes, seconds=one.seconds + none.seconds,
                         collectives=coll)


def _count(cell: cellslib.Cell, mesh: meshlib.Mesh, variant: str,
           cache: dict | None) -> ProgramCounts:
    """The cell's counts.  A 2D cell and a BFS cell run on the mesh's grid
    and are counted each time, an LM train, prefill or decode cell as one
    layer times its depth plus the rest once (:func:`_scaled`); the
    others' ``fn`` does not depend on the mesh, and ``cache`` keeps their
    counts by arch, shape, variant and argument shapes."""
    if cell.kind in ("graph_train_2d", "bfs"):
        grid = cellslib.make_grid(mesh, cellslib.META)
        return count_program(functools.partial(cell.fn, grid=grid), cell.args, grid)
    if cell.kind in ("prefill", "decode") or (cell.kind == "train" and
                                              cfgs.get(cell.arch_id).family == "lm"):
        grid = cellslib.make_grid(mesh, cellslib.META)
        one, none = (count_program(functools.partial(cell.fn, grid=grid, layers=k), cell.args,
                                   grid) for k in (1, 0))
        return _scaled(one, none, int(cell.meta["loop_mult"]))
    cache = {} if cache is None else cache
    key = (cell.arch_id, cell.shape_name, variant,
           tuple((tuple(x.shape), x.dtype) for x in tree.leaves(list(cell.args))))
    if key not in cache:
        cache[key] = count_program(cell.fn, cell.args)
    return cache[key]


def ledger_against_count(st, roots, mode: str = "auto",
                         policy: str = "top_down") -> roofline.CommStatsComparison:
    """One batch of the distributed BFS from ``roots`` on the grid of ``st``
    (a :class:`repro_torch.bench.distributed.DistSetup`) with a fresh
    ``CommStats`` ledger, under :func:`~repro_torch.launch.roofline.count_collectives`:
    the ledger against what the grid ran.  On a grid of one process per
    rank, this process's ledger against its own count."""
    from repro_torch.comm import CommStats
    from repro_torch.core import distributed_bfs as dbfs

    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=st.expand,
                             row_axes=st.grid.row_axes)
    stats = CommStats()
    fn = dbfs.build_bfs(st.grid, st.bg, cfg, stats=stats)
    with roofline.count_collectives(st.grid) as counted:
        fn(*st.blocks, roots)
    return roofline.compare_comm_stats(stats, counted)


def batch_against_level(st, roots, mode: str = "auto", policy: str = "top_down"):
    """One batch of the distributed BFS from ``roots`` on the grid of ``st``
    (a :class:`repro_torch.bench.distributed.DistSetup` on a ``SimGrid``)
    under :func:`~repro_torch.launch.roofline.count_collectives`, and the
    count of one level at the same shapes on ``meta`` (every rung of each
    adaptive exchange, every pass of ``policy``; what the dry-run counts).
    Returns (the batch's count, the level's count, the batch's depth): the
    batch's bytes per kind are at most the level's times the depth, and
    equal to them under a plan with one format per exchange."""
    from repro_torch.comm import SimGrid
    from repro_torch.core import distributed_bfs as dbfs

    cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand=st.expand,
                             row_axes=st.grid.row_axes)
    with roofline.count_collectives(st.grid) as counted:
        depth = dbfs.build_bfs(st.grid, st.bg, cfg)(*st.blocks, roots)[2]
    grid = SimGrid(st.grid.rows, st.grid.cols, "meta", row_fold=st.grid.row_fold)
    blocks = [[torch.empty_like(x, device="meta") for x in b] for b in st.blocks]
    root = torch.empty(np.shape(roots), dtype=torch.int32, device="meta")
    with roofline.count_collectives(grid) as level:
        dbfs.build_bfs(grid, st.bg, cfg)(*blocks, root)
    return counted, level, depth


def proc_ledger_check(grid, spec: dict) -> dict:
    """One process of a grid: the Kronecker graph of ``spec["scale"]``
    (edgefactor 16, seed 1) partitioned onto the grid (``spec["expand"]``
    containers), then :func:`ledger_against_count` for each of
    ``spec["modes"]`` from ``spec["roots"]``.  Returns this rank and, per
    mode, the comparison's fields, ``match`` and ``diff``."""
    from repro_torch.bench import distributed, graph500

    st = distributed.setup(graph500.generate(spec["scale"])[0], grid, spec["expand"])
    out = {"rank": grid.local_ranks[0]}
    for mode in spec["modes"]:
        cmp = ledger_against_count(st, spec["roots"], mode, spec.get("policy", "top_down"))
        out[mode] = dataclasses.asdict(cmp) | {"match": cmp.match, "diff": cmp.diff()}
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             variant: str = "baseline", *, mesh: meshlib.Mesh | None = None,
             cache: dict | None = None) -> dict:
    """Dry-run one cell on a production mesh (or on ``mesh``) and write its
    record to ``out_dir``; a failure is the cell's ``error``, not the
    caller's.  ``cache``, a dict the caller keeps across calls, lets a
    second mesh reuse the count of a cell that does not depend on it."""
    m = mesh or meshlib.make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(k) for k in m.axis_sizes)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "error",
                 "variant": variant}
    t0 = time.time()
    try:
        cell = cellslib.build_cell(arch, shape, m, variant=variant)
        if cell.kind == "skip":
            rec.update(status="skip", skip_reason=cell.skip_reason)
            return _write(rec, out_dir)
        rec["meta"] = {k: (float(v) if isinstance(v, (int, float)) else v)
                       for k, v in cell.meta.items()}
        arg_bytes = argument_bytes(cell.args, cell.in_shardings, m)
        counts = _count(cell, m, variant, cache)
        # a BFS cell's meta run is one level: scaled to the cell's depth
        loop_mult = float(cell.meta["loop_mult"]) if cell.kind == "bfs" else 1.0
        terms = roofline.terms_from_counts(counts, m.size, float(cell.meta["model_flops"]),
                                           loop_mult=loop_mult)
        rec.update(
            lower_s=counts.seconds,
            compile_s=0.0,
            memory={"output_bytes": counts.output_bytes, "temp_bytes": counts.temp_bytes,
                    "argument_bytes": arg_bytes, "generated_code_bytes": None},
            cost={"flops": counts.flops, "bytes_accessed": counts.bytes_accessed},
            roofline={
                "compute_s": terms.compute_s,
                "memory_s": terms.memory_s,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
                "model_flops": terms.model_flops,
                "hlo_flops_scaled": terms.hlo_flops,
                "hlo_bytes_scaled": terms.hlo_bytes,
                "collective_bytes": terms.collective_bytes,
                "collective_breakdown": {k: int(loop_mult * v)
                                         for k, v in counts.collectives.per_op.items()},
                "useful_flop_ratio": terms.useful_flop_ratio,
                "roofline_fraction": terms.roofline_fraction,
            },
            status="ok",
        )
    except Exception as e:  # noqa: BLE001 -- per-cell isolation is the point
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 3)
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if rec.get("variant", "baseline") == "baseline" else f"__{rec['variant']}"
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = rec["status"]
    extra = rec.get("skip_reason", rec.get("error", ""))[:90]
    dom = rec.get("roofline", {}).get("dominant", "")
    print(f"[{status:7s}] {rec['arch']:22s} {rec['shape']:14s} {rec['mesh']:8s} "
          f"{rec.get('total_s', 0):8.2f}s {dom:10s} {extra}", flush=True)
    return rec


def report(out_dir: str) -> dict[str, dict[str, int]]:
    """Print the records' tally, in all and per mesh, and every error;
    returns the tallies.  ``not_run`` counts records that carry the key
    (every cell is counted, so it stays 0 for records this module writes)."""
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                rows.append(json.load(f))

    def tally(rs) -> dict[str, int]:
        return {"cells": len(rs),
                "ok": sum(r["status"] == "ok" and "not_run" not in r for r in rs),
                "not_run": sum("not_run" in r for r in rs),
                "skip": sum(r["status"] == "skip" for r in rs),
                "error": sum(r["status"] == "error" for r in rs)}

    out = {"all": tally(rows)}
    for name in sorted({r["mesh"] for r in rows}):
        out[name] = tally([r for r in rows if r["mesh"] == name])
    for name, t in out.items():
        head = "cells:" if name == "all" else f"  {name}:"
        print(f"{head} {t['cells']}  ok={t['ok']} not_run={t['not_run']} skip={t['skip']} "
              f"error={t['error']}")
    for r in rows:
        if r["status"] == "error":
            print(f"  ERROR {r['arch']}/{r['shape']}/{r['mesh']}: {r.get('error')}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description="dry-run the cell catalogue on meta")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    if args.report:
        report(args.out)
        return

    pods = [args.multipod] if not args.both_meshes else [False, True]
    if args.all:
        t0 = time.perf_counter()
        cache: dict = {}
        for arch, shape in cellslib.all_cells():
            for mp in pods:
                run_cell(arch, shape, mp, args.out, variant=args.variant, cache=cache)
        report(args.out)
        print(f"wall: {time.perf_counter() - t0:.1f}s")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    cache = {}
    for mp in pods:
        run_cell(args.arch, args.shape, mp, args.out, variant=args.variant, cache=cache)


if __name__ == "__main__":
    main()
