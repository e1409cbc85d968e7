"""The four-card check: the paper's distributed BFS, SSSP and the GNN train
step as one process per card over NCCL, held against ``SimGrid``; and LM
serving and training sharded FSDP x TP over the four cards, held against
one card.

    python -m repro_torch.bench.multicard                     # 4 cards, nccl, scale 22
    python -m repro_torch.bench.multicard --case lm           # the LM case instead
    python -m repro_torch.bench.multicard --case lm-train     # the LM train case instead
    python -m repro_torch.bench.multicard --backend gloo      # 4 processes on one card
    python -m repro_torch.bench.multicard --device cpu --backend gloo --scale 12 \\
        --refine 2 --smoke                                     # 4 CPU processes
    python -m repro_torch.bench.multicard --device cpu --backend gloo --case lm --smoke
    python -m repro_torch.bench.multicard --device cpu --backend gloo --case lm-train --smoke

In order:

1. the cards: every card's name and power limit (``nvidia-smi``), peer
   access for each pair (``torch.cuda.can_device_access_peer``) and
   ``nvidia-smi topo -m``;
2. the Graph500 Kronecker graph of ``--scale`` (edgefactor 16, seed 1) and
   :data:`N_ROOTS` valid roots (seed 2), generated once here and read by the
   workers from a file in a temporary directory;
3. four processes (:func:`repro_torch.comm.procgrid.spawn`, rank p on
   ``cuda:p`` under nccl), each holding its rank of a 2x2 and then of a
   1x4 :class:`~repro_torch.comm.procgrid.ProcessGrid`: after one uncounted
   warm-up batch a grid, the roots in batches of :data:`BATCH` under
   ``direction_opt`` + ``hybrid`` for each wire plan of :data:`BFS_CASES`,
   and one SSSP batch (:data:`SSSP_CASE`) on 2x2, the launch counts read
   around the counted batches only; one more ``auto`` batch on 2x2 is
   traced on rank 0 (device time in NCCL's kernels, the port's, and the
   rest);
4. the same batches on a ``SimGrid`` on the first device, and the checks:
   every process's value and level planes (SHA-256 of their bytes), level
   counts and merged ledger equal ``SimGrid``'s, batch for batch; every
   BFS plan gives the same trees, and those trees are valid (Graph500
   validation on the host; SSSP: ``algebras.sssp_certificate``); every
   kernel of :data:`PATH` launched in every process; under nccl each
   process reports its own card current and its blocks on it, four cards
   in all;
5. one process, ``cuda:0`` current: the single-device BFS of the first
   batch on ``cuda:1`` and on ``cuda:3`` gives ``cuda:0``'s planes, and its
   kernels launched (each on its tensors' card, :func:`kernels.launch`);
6. the GraphCast train step (``bench.gnn_train``: 4 layers, ``--refine``,
   published widths unless ``--smoke``) as four processes, fp32 then int8
   payloads, one step each after a warm-up: the fp32 outputs, loss and
   gradients within :data:`GNN_FP32_REL` of ``SimGrid``'s, the int8 loss
   within :data:`TRAIN_INT8_LOSS_REL` of the fp32 one, its gradients finite
   and nonzero, ``quantize`` launched in every process.

7. the LM case (``--case lm``, in place of steps 2-6): :data:`LM_CASES`
   served as four processes by the grid engine (``bench.serve.proc_serve``:
   each process draws only its slices of the weights), the serving cell's
   traffic of ``bench.serve.CELLS`` (8 requests of 16-64 prompt tokens, 16
   new tokens, 8 slots of a 2,048-token cache).  A case held against one
   card is first served by the one-device engine on the first card, its
   logits and fed tokens kept a tick: the processes' greedy tokens must
   equal it and each tick's logits lie within :data:`LM_LOGIT_REL` of its
   peak.  The 1x4 deepseek-coder-33b processes then serve twice more on the
   same weights: with TF32 products (a control that must read above
   :data:`LM_LOGIT_REL`) and in bf16 (within :data:`LM_BF16_RATIO` times
   the one-card bf16 engine's own gap to its fp32 logits), each slot
   compared while both runs fed it the same tokens.  deepseek-coder-33b at
   its full 62 layers (bf16, 1x4) does not fit on one card and is timed:
   tokens/s, median ms per tick (rank 0), every card's peak memory while
   drawing the weights and while serving, each process's host microseconds
   a kernel launch; after each case :data:`LM_TRACE` more ticks are traced
   on rank 0 (wall ms, kernels and device ms a tick in NCCL's kernels,
   matrix products and the rest).

8. the LM train case (``--case lm-train``, in place of steps 2-6):
   gemma-2b at all 18 layers and published widths, bf16 compute over fp32
   parameters, ``remat`` on, as four processes on a 2x2 grid (FSDP x TP,
   the ``train_4k`` placement; ``bench.lm_train.proc_train``: each process
   draws only its slices), rows of 4,096 tokens, the cell's global batch
   of 256 cut to :data:`LM_TRAIN`'s 8 (4 a row): :data:`LM_TRAIN` steps,
   the first a warm-up, then one more traced on rank 0 (device ms in
   NCCL's kernels, matrix products and the rest).  Every process's loss
   must be finite and equal rank 0's.  Beside it, against one card
   (``cuda:0``): the first step of gemma-2b cut to :data:`LM_TRAIN_CUT`'s
   depth in fp32, TF32 off, as the four processes on 2x2 and on 1x4 and
   as a ``SimGrid`` 2x2 on ``cuda:0``, held against the one-device loss,
   gradient and norm (each within :data:`LM_TRAIN_REL`) and AdamW step
   (:func:`repro_torch.bench.lm_train.held_against`); and at full depth
   in bf16 on :data:`LM_TRAIN_BF16_BATCH` rows, the processes' first loss
   and gradient norm within :data:`LM_BF16_RATIO` times one card's own
   bf16-to-fp32 gap of one card's bf16 ones.

It prints, per case, each batch's seconds (its slowest process) and the
harmonic-mean TEPS beside ``SimGrid``'s, the ledger's bytes by phase and
format, and the train step's seconds beside ``SimGrid``'s; under nccl the
transports NCCL reports choosing (``NCCL_DEBUG=INFO`` of the workers, into
files of the temporary directory) and any warning it gave.  The last line
is one JSON object of every number.
Any mismatch exits nonzero, and no process it started outlives it.  On a
CPU device, or under gloo on one card, the checks of step 5 and of the
processes' cards are left out, and nothing is traced.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.bench import algebras, cards, distributed, gnn_train, graph500, teps
from repro_torch.bench import gnn as gnn_bench
from repro_torch.bench import lm_train
from repro_torch.bench import serve as serve_bench
from repro_torch.comm import SimGrid, procgrid
from repro_torch.core import bfs as bfsmod
from repro_torch.graphgen import builder
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

SCALE = 22
BATCH = 8
N_ROOTS = 16
#: the wire plans each grid runs, every one under direction_opt + hybrid
BFS_CASES = {(2, 2): ("raw", "bitmap", "auto", "btfly"), (1, 4): ("auto", "btfly")}
#: SSSP on the 2x2 grid, one batch (chip_smoke.PROC_CASES's)
SSSP_CASE = {"mode": "auto", "policy": "top_down", "algebra": "sssp"}
#: the kernels of the single-device BFS, of the distributed BFS and of SSSP
GRAPH500_PATH = ("pack", "popcount_planes", "frontier_mask", "spmv_min_planes",
                 "spmv_pull_min_planes")
PATH = GRAPH500_PATH + ("unpack", "gspmm_min_planes", "interleave_values")
#: the train step: fp32 against SimGrid (the same float32 products, index_add_
#: summing by atomics in another order on a card), int8 against fp32 (the
#: reference's own bar, tests/test_dist.py:137) -- chip_smoke.py's bounds
GNN_FP32_REL = 1e-5
TRAIN_INT8_LOSS_REL = 0.05
GRAPH_FIELDS = ("row_ptr", "col_idx", "src", "dst")
#: seconds each spawn, and each collective in it, may take: a hang fails
#: the run well inside a chip call's limit
SPAWN_TIMEOUT_S = 900.0
#: the LM case, four processes a row: (arch, layers, compute dtype, grid,
#: held against one card, the variants of ``bench.serve.VARIANTS`` the same
#: processes serve after the timed run, each against one card)
LM_CASES = (("deepseek-coder-33b", 8, "fp32", (1, 4), True, ("tf32", "bf16")),
            ("deepseek-coder-33b", 8, "fp32", (2, 2), True, ()),
            ("dbrx-132b", 2, "fp32", (2, 2), True, ()),
            ("deepseek-coder-33b", 62, "bf16", (1, 4), False, ()))
#: fp32 logits of the processes against the one-card engine's, over its
#: peak: the same float32 products split over four cards and summed in
#: another order (NCCL moves them; the grid adds in group order), TF32 off.
#: Sound runs read 1.6e-6 to 2.3e-6; the TF32 variant must lie above it
LM_LOGIT_REL = 1e-5
#: the bf16 variant against the one-card bf16 engine: within this many
#: times the one-card bf16 engine's own gap to its fp32 logits (both where
#: the runs fed equal tokens): the grid's bf16 rounding adds noise of
#: bf16's own size, a fault far more (tests/test_torch_lm_sharded.py holds
#: the grid on the CPU to the same rule)
LM_BF16_RATIO = 2.0
#: the LM train case at four cards: gemma-2b's published widths and depth,
#: bf16 compute; rows of the train_4k cells' 4,096 tokens, their global
#: batch of 256 cut to 8, what the cards hold (fp32 params, m, v and
#: gradient 12.1 GB a card, the new state beside the old one, each
#: layer's recomputation and the loss's chunks); 4 steps, the first the
#: warm-up
LM_TRAIN = {"arch": "gemma-2b", "layers": 18, "dtype": "bf16", "batch": 8, "seq": 4096,
            "steps": 4}
#: the cut-depth fp32 cases against one card's step: gemma-2b's widths at
#: 2 layers (5.1 GB of fp32 params), 4 rows of 1,024 tokens (one card
#: holds the one-device step's state, new state and fp32 logits)
LM_TRAIN_CUT = {"arch": "gemma-2b", "layers": 2, "dtype": "fp32", "batch": 4, "seq": 1024}
#: loss, norm, every gradient leaf (over its peak) and the AdamW step's
#: parameters where the reference's |g| exceeds 1e-4 of its peak, against
#: one card in fp32 with TF32 off: float32 products split over four cards
#: and summed in another order
LM_TRAIN_REL = 1e-5
#: elsewhere the first AdamW step moves by about lr * sign(g), a sign a
#: sum in another order can flip: within this many times lr
LM_TRAIN_LR = 2.0
#: rows of the full-depth bf16 comparison (one card holds 2 with remat)
LM_TRAIN_BF16_BATCH = 2
#: ticks of a throwaway engine before the timed serving, in each process
LM_WARMUP = 4
#: ticks traced on rank 0 after the serving (device ms by class)
LM_TRACE = 4


def case_key(shape, case: dict) -> str:
    alg = case.get("algebra", "bfs")
    return f"{shape[0]}x{shape[1]} {alg} {case['mode']} {case['policy']}"


def grid_cases() -> list:
    """[(shape, [case, ...]), ...]: every grid's cases, each with the number
    of batches it runs."""
    out = []
    for shape, modes in BFS_CASES.items():
        cases = [{"mode": m, "policy": "direction_opt", "batches": N_ROOTS // BATCH}
                 for m in modes]
        if shape == (2, 2):
            cases.append({**SSSP_CASE, "batches": 1})
        out.append((shape, cases))
    return out


def digest(value: torch.Tensor, level: torch.Tensor) -> str:
    """SHA-256 of the planes' bytes, with their shapes."""
    h = hashlib.sha256()
    for t in (value, level):
        a = t.cpu().numpy()
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_graph(g: builder.CSRGraph, directory: str) -> str:
    path = os.path.join(directory, "graph.npz")
    np.savez(path, n=g.n, m_input=g.m_input, **{k: getattr(g, k) for k in GRAPH_FIELDS})
    return path


def load_graph(path: str) -> builder.CSRGraph:
    with np.load(path) as f:
        return builder.CSRGraph(n=int(f["n"]), m_input=int(f["m_input"]),
                                **{k: f[k] for k in GRAPH_FIELDS})


def run_batches(st: distributed.DistSetup, roots: np.ndarray, case: dict,
                launched: collections.Counter) -> list[dict]:
    """``case``'s batches of ``roots`` (:data:`BATCH` roots each) on the
    set-up grid, each one's launch
    counts added to ``launched``: per batch the seconds (slowest process),
    level count, merged ledger, planes' digest and planes (on the grid's
    device)."""
    case = dict(case)
    runs = []
    for b in range(case.pop("batches")):
        kernels.reset_launches()
        r = distributed.run_case(st, roots[b * BATCH:(b + 1) * BATCH], **case)
        launched.update(kernels.LAUNCHES)
        runs.append({"batch_s": r["batch_s"], "n_levels": r["n_levels"], "stats": r["stats"],
                     "digest": digest(r["value"], r["level"]),
                     "value": r["value"], "level": r["level"]})
    return runs


def kernel_class(name: str, port: set) -> str:
    if name.lower().startswith("nccl"):
        return "nccl"
    return "port" if name in port else "other"


def traced_batch(st: distributed.DistSetup, roots: np.ndarray, case: dict) -> dict | None:
    """One batch of ``case`` on every process, traced by ``torch.profiler``
    in the process of rank 0: its seconds and device ms by class (NCCL's
    kernels, the port's, the rest); None in the other processes."""
    if 0 not in st.grid.local_ranks:
        distributed.run_case(st, roots, **case)
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        r = distributed.run_case(st, roots, **case)
    port = kernels.source_kernels()
    ms: dict[str, float] = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            ms[kernel_class(kernels.kernel_name(e.key), port)] += e.self_device_time_total / 1e3
    return {"case": case_key((st.grid.rows, st.grid.cols), case), "batch_s": r["batch_s"],
            "device_ms": dict(ms)}


def proc_cases(grid, spec: dict) -> dict:
    """One process of the four: its rank of each grid of ``spec["grids"]``
    (the spawned grid first, then a new ``ProcessGrid`` of the same
    processes for each other shape), one uncounted warm-up batch a grid,
    then every case's batches (:func:`run_batches`, the planes left out of
    the result); on the spawned grid a traced ``auto`` batch after them.
    Returns the process's card, the device its blocks lie on per grid, the
    counted launches and each case's batches."""
    from repro_torch.comm.procgrid import ProcessGrid

    g = load_graph(spec["graph"])
    roots = np.asarray(spec["roots"], np.int32)
    cuda = grid.device.type == "cuda"
    out = {"rank": grid.rank, "device": str(grid.device),
           "current_device": torch.cuda.current_device() if cuda else None,
           "card": distributed.device_name(grid.device), "blocks": {}, "cases": {},
           "traced": None}
    launched: collections.Counter = collections.Counter()
    for shape, cases in spec["grids"]:
        shape = tuple(shape)
        pg = grid if shape == (grid.rows, grid.cols) else ProcessGrid(*shape, device=grid.device)
        st = distributed.setup(g, pg, "hybrid")
        out["blocks"][f"{shape[0]}x{shape[1]}"] = str(st.blocks[0][pg.rank].device)
        first = {k: v for k, v in cases[0].items() if k != "batches"}
        distributed.run_case(st, roots[:BATCH], **first)  # warm-up
        for case in cases:
            runs = run_batches(st, roots, case, launched)
            out["cases"][case_key(shape, case)] = [
                {k: v for k, v in r.items() if k not in ("value", "level")} for r in runs]
        if pg is grid and cuda:
            out["traced"] = traced_batch(st, roots[:BATCH],
                                         {"mode": "auto", "policy": "direction_opt"})
        del st
    out["launches"] = dict(launched)
    return out


def nccl_env(directory: str) -> dict:
    """NCCL's INFO log of the workers' set-up, one file a process in
    ``directory``: it names the transport of each connection."""
    return {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT",
            "NCCL_DEBUG_FILE": os.path.join(directory, "nccl.%h.%p.log")}


def nccl_report(directory: str) -> dict:
    """The transports NCCL chose (``via X`` of its connection lines,
    counted), its version line and its warnings, from the logs of
    :func:`nccl_env`."""
    via: collections.Counter = collections.Counter()
    warnings, version = [], None
    for name in sorted(os.listdir(directory)):
        if not name.startswith("nccl."):
            continue
        with open(os.path.join(directory, name), errors="replace") as f:
            for line in f:
                m = re.search(r" via (\S+)", line)
                if m:
                    via[m.group(1)] += 1
                if " WARN " in line:
                    warnings.append(line.strip())
                if version is None and "NCCL version" in line:
                    version = line.split("NCCL version", 1)[1].strip()
    return {"via": dict(via), "version": version, "warnings": warnings[:20]}


def transport_label(via: dict, topo: str, nvlink: str) -> str:
    """What the exchanges went over, from NCCL's own report, and the links
    ``nvidia-smi`` shows (``NV#`` in the topology matrix, or the first
    card's active NVLink links)."""
    kinds = sorted({v.split("/")[0] for v in via})
    links = sorted(set(re.findall(r"\bNV\d+\b", topo)))
    rates = re.findall(r"Link \d+: ([\d.]+ GB/s)", nvlink)
    if links:
        over = f"NVLink ({', '.join(links)} in nvidia-smi topo -m)"
    elif rates:
        over = f"NVLink ({len(rates)} links of cuda:0 active at {', '.join(sorted(set(rates)))})"
    else:
        over = "peer-to-peer (nvidia-smi did not show the links)"
    if not kinds:
        return "NCCL reported no transport"
    if kinds == ["P2P"]:
        return f"NCCL P2P ({', '.join(sorted(via))}): card to card over {over}"
    return f"NCCL {', '.join(sorted(via))}: NOT only card to card (shared memory or network)"


def _smi(*args: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return f"nvidia-smi {' '.join(args)} could not run"
    return (out.stdout + out.stderr).strip()


def print_cards() -> dict:
    """Step 1: the cards, their peer access, the topology and the first
    card's NVLink links."""
    names = cards()
    n = torch.cuda.device_count()
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for a in range(n) for b in range(n) if a != b}
    topo, nvlink = _smi("topo", "-m"), _smi("nvlink", "--status", "-i", "0")
    print(f"cards ({n}), nvidia-smi name and power limit: " + "; ".join(names))
    print("peer access: " + ", ".join(f"{k} {v}" for k, v in peer.items()))
    print("nvidia-smi topo -m:\n" + topo)
    print("nvidia-smi nvlink --status -i 0:\n" + nvlink)
    return {"cards": names, "peer_access": peer, "topo": topo, "nvlink": nvlink}


class Checks:
    """Failures gathered over the run; the run exits nonzero if any."""

    def __init__(self):
        self.failures: list[str] = []

    def expect(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            print(f"MISMATCH: {what}")


def bfs_step(args, g, roots, dev, backend, tmp, checks: Checks) -> tuple[dict, list]:
    """Steps 3 and 4: the process grid's batches against SimGrid's.  Returns
    the report and the BFS trees, (parent, level) host planes a batch,
    which every case and process gave."""
    spec = {"graph": save_graph(g, tmp), "roots": roots.tolist(), "grids": grid_cases()}
    env = nccl_env(tmp) if backend == "nccl" else None
    t0 = time.perf_counter()
    procs = procgrid.spawn(proc_cases, 2, 2, backend=backend, device=args.device,
                           args=(spec,), env=env, timeout_s=SPAWN_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    sim, sim_launched, planes = {}, collections.Counter(), {}
    for shape, cases in spec["grids"]:
        st = distributed.setup(g, SimGrid(*shape, device=dev), "hybrid")
        first = {k: v for k, v in cases[0].items() if k != "batches"}
        distributed.run_case(st, roots[:BATCH], **first)  # warm-up, as the workers
        for case in cases:
            key = case_key(shape, case)
            sim[key] = run_batches(st, roots, case, sim_launched)
            planes[key] = [(r.pop("value").cpu().numpy(), r.pop("level").cpu().numpy())
                           for r in sim[key]]
        del st
    for key, want in sim.items():
        for proc in procs:
            got = proc["cases"][key]
            for b, (x, w) in enumerate(zip(got, want)):
                where = f"{key} batch {b} rank {proc['rank']}"
                checks.expect(x["digest"] == w["digest"], f"{where}: planes differ from SimGrid")
                checks.expect(x["n_levels"] == w["n_levels"],
                              f"{where}: {x['n_levels']} levels, SimGrid {w['n_levels']}")
                checks.expect(x["stats"].table() == w["stats"].table(),
                              f"{where}: merged ledger differs from SimGrid's")
    bfs_keys = [k for k in sim if " bfs " in k]
    for key in bfs_keys[1:]:
        checks.expect([r["digest"] for r in sim[key]] == [r["digest"] for r in sim[bfs_keys[0]]],
                      f"{key}: trees differ from {bfs_keys[0]}'s")
    trees = planes[bfs_keys[0]]
    times = [r["batch_s"] for r in sim[bfs_keys[0]]]
    v = graph500.verdicts(g, roots, trees, times, BATCH, True)
    checks.expect(v["n_valid"] == len(roots), f"invalid BFS trees: {v['failures']}")
    (sssp_key,) = [k for k in sim if " sssp " in k]
    src, dst = torch.as_tensor(g.src, device=dev), torch.as_tensor(g.dst, device=dev)
    failures = algebras.sssp_certificate(src, dst, g.n, roots[:BATCH],
                                         torch.as_tensor(planes[sssp_key][0][0], device=dev))
    checks.expect(not failures, f"{sssp_key}: certificate failures {failures[:4]}")
    del src, dst
    for proc in procs if dev.type == "cuda" else ():  # CPU tensors launch no kernel
        missing = [k for k in PATH if proc["launches"].get(k, 0) == 0]
        checks.expect(not missing, f"rank {proc['rank']}: kernels never launched {missing}")
    report = {"spawn_s": spawn_s, "validated_trees": v["n_valid"], "cases": {},
              "processes": [{k: p[k] for k in ("rank", "device", "current_device", "card",
                                                 "blocks", "launches")} for p in procs],
              "traced": procs[0]["traced"]}
    for key, want in sim.items():
        got = procs[0]["cases"][key]
        batch_s = [r["batch_s"] for r in got]
        rec = {"batch_s": batch_s, "simgrid_batch_s": [r["batch_s"] for r in want],
               "n_levels": [r["n_levels"] for r in got],
               "bytes": distributed.zone_bytes([r["stats"] for r in got]),
               "ledger_views": distributed.ledger_views([r["stats"] for r in got])}
        if " bfs " in key:
            te = v["traversed_edges"]
            rec["teps"] = teps.harmonic_mean(
                [te[i] / (batch_s[i // BATCH] / BATCH) for i in range(len(roots))])
            rec["simgrid_teps"] = teps.harmonic_mean(
                [te[i] / (rec["simgrid_batch_s"][i // BATCH] / BATCH)
                 for i in range(len(roots))])
        report["cases"][key] = rec
    return report, trees


def off_current_device(g, roots, checks: Checks) -> dict:
    """Step 5: with ``cuda:0`` current, the single-device BFS of ``roots``
    on ``cuda:1`` and on ``cuda:3`` against the same BFS on ``cuda:0``."""
    torch.cuda.set_device(0)
    out, want = {}, None
    for k in (0, 1, 3):
        setup = graph500.place(g, "hybrid", f"cuda:{k}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = bfsmod.bfs(setup.src, setup.dst, roots, g.n, policy="direction_opt",
                         expand="hybrid", device=setup.device, block=setup.block)
        got = (res.parent.cpu(), res.level.cpu())
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        missing = [name for name in GRAPH500_PATH if launches.get(name, 0) == 0]
        checks.expect(not missing, f"bfs on cuda:{k}: kernels never launched {missing}")
        checks.expect(res.parent.device == setup.device,
                      f"bfs on cuda:{k}: planes on {res.parent.device}")
        checks.expect(torch.cuda.current_device() == 0,
                      f"bfs on cuda:{k} left cuda:{torch.cuda.current_device()} current")
        if want is None:
            want = got
        else:
            checks.expect(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"bfs on cuda:{k}: planes differ from cuda:0's")
        out[f"cuda:{k}"] = {"launches": launches, "n_levels": res.n_levels,
                            "seconds": seconds}
        del setup, res
    return out


def train_gaps(runs, sim) -> tuple[float, float, float]:
    """(outputs, loss, gradients) of the processes' captured step against
    ``sim``'s: max abs gaps over the outputs' and the gradients' peaks, the
    loss's relative gap."""
    out_peak = max(float(np.abs(o).max()) for o in sim["out"])
    out = max(float(np.abs(run["captured"]["out"][run["rank"]] - sim["out"][run["rank"]]).max())
              for run in runs) / out_peak
    loss = max(abs(run["captured"]["loss"] - sim["loss"]) for run in runs) / abs(sim["loss"])
    g_peak = max(float(np.abs(g).max()) for g in sim["grads"])
    grads = max(float(np.abs(a - b).max())
                for a, b in zip(runs[0]["captured"]["grads"], sim["grads"])) / g_peak
    return out, loss, grads


def train_step(args, dev, backend, checks: Checks) -> dict:
    """Step 6: the GraphCast train step on the four processes against
    SimGrid's."""
    layers = gnn_train.LAYERS
    st = gnn_bench.setup("graphcast", args.refine, (2, 2), 0, args.smoke, dev, layers)
    sim = [gnn_train.train(st, 1, q, 0, capture=True) for q in (False, True)]
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    spec = {"refine": args.refine, "seed": 0, "smoke": args.smoke, "layers": layers,
            "steps": 1, "capture": True,
            "cases": [{"arch": "graphcast", "quantize": q} for q in (False, True)]}
    t0 = time.perf_counter()
    procs = procgrid.spawn(gnn_train.proc_train, 2, 2, backend=backend, device=args.device,
                           args=(spec,), timeout_s=SPAWN_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    fp32, int8 = ([p[k] for p in procs] for k in range(2))
    fp32_gaps = train_gaps(fp32, sim[0]["captured"])
    checks.expect(max(fp32_gaps) <= GNN_FP32_REL,
                  f"train fp32 (outputs, loss, gradients) {fp32_gaps} from SimGrid's > "
                  f"{GNN_FP32_REL}")
    loss8, loss32 = int8[0]["captured"]["loss"], sim[0]["captured"]["loss"]
    rel = abs(loss8 - loss32) / abs(loss32)
    checks.expect(rel < TRAIN_INT8_LOSS_REL,
                  f"train int8 loss {loss8} vs fp32 {loss32}: {rel} >= {TRAIN_INT8_LOSS_REL}")
    grads = int8[0]["captured"]["grads"]
    checks.expect(all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in grads),
                  "train int8: a gradient leaf is non-finite or zero")
    for run in int8 if dev.type == "cuda" else ():
        checks.expect(run["launches"].get("quantize", 0) > 0,
                      f"train int8 rank {run['rank']}: quantize never launched")
    return {"fp32_gaps": fp32_gaps, "int8_loss": loss8, "fp32_loss": loss32,
            "int8_loss_rel": rel, "int8_gaps": train_gaps(int8, sim[1]["captured"]),
            "step_s": {"fp32": max(r["steps"][0]["step_s"] for r in fp32),
                       "int8": max(r["steps"][0]["step_s"] for r in int8)},
            "simgrid_step_s": {"fp32": sim[0]["steps"][0]["step_s"],
                               "int8": sim[1]["steps"][0]["step_s"]},
            "parts_s": {k: max(r["steps"][0][k] for r in int8)
                        for k in ("fwd_bwd_s", "pmean_s", "adamw_s")},
            "simgrid_parts_s": {k: sim[1]["steps"][0][k]
                                for k in ("fwd_bwd_s", "pmean_s", "adamw_s")},
            "peak_bytes": [r["peak_bytes"] for r in int8],
            "devices": [r["device"] for r in int8], "spawn_s": spawn_s,
            "launches": [r["launches"] for r in int8]}


def lm_reference(arch: str, layers: int, dtype: str, dev, path: str, smoke: bool = False) -> dict:
    """The one-card engine on ``arch`` cut to ``layers`` (``smoke``: at
    its smoke widths) in ``dtype`` serving the cell's traffic, its logits
    and fed tokens a tick saved to ``path`` (.npz)."""
    cell = serve_bench.CELLS[arch]
    cfg, params = serve_bench.model(arch, layers, smoke, dtype=dtype, device=dev)
    prompts = serve_bench.prompts(cfg.vocab, cell["requests"], *cell["prompt_len"])
    t0 = time.perf_counter()
    res = serve_bench.serve(cfg, params, prompts, serve_bench.SLOTS, cell["max_seq"],
                            cell["max_new"], device=dev, keep_logits=True)
    np.savez(path, logits=np.stack(res["logits"]), fed=np.stack(res["fed"]))
    out = {"tokens": [r.out for r in res["requests"]], "ticks": res["ticks"],
           "tokens_per_s": res["tokens_per_s"], "median_tick_ms": res["median_tick_ms"],
           "peak_bytes": res["peak_bytes"], "path": path, "seconds": time.perf_counter() - t0}
    del res, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"lm {arch} {layers} layers {dtype}: one card's engine in {out['seconds']:.1f} s",
          flush=True)
    return out


def lm_step(args, dev, backend, tmp, checks: Checks) -> dict:
    """Step 7: :data:`LM_CASES` on four processes, against one card where
    the case has a reference."""
    report, refs = {}, {}

    def reference(arch, layers, dtype):
        if (arch, layers, dtype) not in refs:
            refs[arch, layers, dtype] = lm_reference(
                arch, layers, dtype, dev, os.path.join(tmp, f"{arch}-{layers}-{dtype}.npz"),
                args.smoke)
        return refs[arch, layers, dtype]

    for arch, layers, dtype, shape, against, variants in LM_CASES:
        cell = serve_bench.CELLS[arch]
        key = f"{arch} {layers} layers {dtype} {shape[0]}x{shape[1]}"
        ref = reference(arch, layers, dtype) if against else None
        vrefs = {v: reference(arch, layers, serve_bench.VARIANTS[v][0]) for v in variants}
        cfg = serve_bench.config(arch, layers, args.smoke, dtype)
        prompts = [p.tolist() for p in serve_bench.prompts(cfg.vocab, cell["requests"],
                                                           *cell["prompt_len"])]
        spec = {"arch": arch, "layers": layers, "smoke": args.smoke, "dtype": dtype, "seed": 0,
                "slots": serve_bench.SLOTS, "max_seq": cell["max_seq"],
                "max_new": cell["max_new"], "prompts": prompts, "warmup": LM_WARMUP,
                "log_every": 16, "trace": LM_TRACE,
                "reference": ref["path"] if ref else None,
                "variants": [(v, r["path"]) for v, r in vrefs.items()]}
        print(f"lm {key}: {shape[0] * shape[1]} processes", flush=True)
        t0 = time.perf_counter()
        runs = procgrid.spawn(serve_bench.proc_serve, *shape, backend=backend,
                              device=args.device, args=(spec,), timeout_s=SPAWN_TIMEOUT_S,
                              env=nccl_env(tmp) if backend == "nccl" else None)
        rec = {"spawn_s": time.perf_counter() - t0,
               **{k: runs[0][k] for k in ("ticks", "generated_tokens", "tokens_per_s",
                                          "median_tick_ms", "wall_s")},
               "init_s": [r["init_s"] for r in runs],
               "init_peak_bytes": [r["init_peak_bytes"] for r in runs],
               "peak_bytes": [r["peak_bytes"] for r in runs],
               "launch_us": [r["launch_us"] for r in runs],
               "devices": [r["device"] for r in runs], "trace": runs[0].get("trace")}
        for r in runs:
            checks.expect(r["tokens"] == runs[0]["tokens"],
                          f"{key}: rank {r['rank']} picked other tokens than rank 0")
            checks.expect(all(len(t) == cell["max_new"] for t in r["tokens"]),
                          f"{key}: rank {r['rank']} left requests unfinished")
        if ref:
            rec["logit_gap"] = max(r["logit_gap"] for r in runs)
            rec["reference"] = {k: ref[k] for k in ("ticks", "tokens_per_s", "median_tick_ms",
                                                    "peak_bytes", "seconds")}
            checks.expect(runs[0]["tokens"] == ref["tokens"],
                          f"{key}: tokens {runs[0]['tokens']} vs one card {ref['tokens']}")
            checks.expect(all(r["ref_ticks"] == r["ticks"] for r in runs),
                          f"{key}: {runs[0]['ticks']} ticks vs one card {ref['ticks']}")
            checks.expect(rec["logit_gap"] <= LM_LOGIT_REL,
                          f"{key}: logits {rec['logit_gap']} of the one-card peak > "
                          f"{LM_LOGIT_REL}")
        rec["variants"] = {v: lm_variant(key, v, [r["variants"][v] for r in runs], vrefs[v],
                                         refs, arch, layers, dev, checks) for v in variants}
        report[key] = rec
    return report


def lm_variant(key: str, name: str, runs: list, ref: dict, refs: dict, arch: str, layers: int,
               dev, checks: Checks) -> dict:
    """A variant's checks: the processes agree with each other, and the
    ``tf32`` control lies above :data:`LM_LOGIT_REL` (the bound tells TF32
    products from fp32 ones) or the ``bf16`` logits lie within
    :data:`LM_BF16_RATIO` times the one-card bf16 engine's own gap to its
    fp32 logits."""
    rec = {"logit_gap": max(r["logit_gap"] for r in runs),
           "compared": [r["compared"] for r in runs], "pairs": [r["pairs"] for r in runs],
           "tokens_equal": sum(a == b for a, b in zip(runs[0]["tokens"], ref["tokens"])),
           "requests": len(ref["tokens"])}
    for r in runs:
        checks.expect(r["tokens"] == runs[0]["tokens"],
                      f"{key} {name}: processes picked different tokens")
        checks.expect(r["ticks"] == r["ref_ticks"],
                      f"{key} {name}: {r['ticks']} ticks vs one card {r['ref_ticks']}")
    if name == "tf32":  # TF32 is the card's: on the CPU the control is only printed
        checks.expect(dev.type != "cuda" or rec["logit_gap"] > LM_LOGIT_REL,
                      f"{key} tf32: the control's logits lie within {rec['logit_gap']} of the "
                      f"one-card peak, under the fp32 bound {LM_LOGIT_REL}")
    else:
        with np.load(ref["path"]) as lo, np.load(refs[arch, layers, "fp32"]["path"]) as hi:
            rec["one_card_gap"] = serve_bench.agreeing_gap(
                list(lo["logits"]), list(lo["fed"]), hi["logits"], hi["fed"], slice(None))[0]
        rec["bound"] = LM_BF16_RATIO * rec["one_card_gap"]
        checks.expect(rec["logit_gap"] <= rec["bound"],
                      f"{key} bf16: logits {rec['logit_gap']} of the one-card bf16 peak > "
                      f"{LM_BF16_RATIO} x the one-card bf16 gap to fp32 {rec['one_card_gap']}")
    return rec


def lm_train_step(args, dev, backend, tmp, checks: Checks) -> dict:
    """Step 8: the LM train case (:data:`LM_TRAIN`), and its cut-depth and
    bf16 cases against one card; ``--smoke`` runs every case at gemma-2b's
    smoke widths and depth, 4 rows of 65 tokens."""
    def sized(case):
        if not args.smoke:
            return dict(case)
        return dict(case, layers=None, smoke=True, batch=4, seq=65,
                    **({"steps": 3} if "steps" in case else {}))

    main, cut = sized(LM_TRAIN), sized(LM_TRAIN_CUT)
    report: dict = {}
    t0 = time.perf_counter()
    with lm_train.no_tf32():  # one card's fp32 step, its gradient saved for the processes
        cfg = serve_bench.config(cut["arch"], cut.get("layers"), args.smoke, "fp32")
        params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        toks = torch.as_tensor(lm_train.token_rows(cfg, cut["batch"], cut["seq"], 0), device=dev)
        ref = lm_train.reference_grads(cfg, params, toks, os.path.join(tmp, "lm-train-ref.pt"))
        grid = SimGrid(2, 2, dev)
        specs = tsh.serving_specs(cfg, grid)
        report["simgrid 2x2"] = lm_train.held_against(
            cfg, grid, specs, tstep.shard_state(cfg, grid, tstep.init_state(params), specs),
            toks, ref)
    del params, grid
    full = {}
    for dtype in ("bf16", "fp32"):  # one card at full depth on the bf16 case's rows
        with lm_train.no_tf32():
            cfg = serve_bench.config(main["arch"], main.get("layers"), args.smoke, dtype)
            params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
            rows = torch.as_tensor(lm_train.token_rows(cfg, LM_TRAIN_BF16_BATCH, main["seq"], 0),
                                   device=dev)
            loss, grads = tstep.value_and_grad(lambda p, b: tfm.loss_fn(cfg, p, b), params,
                                               {"tokens": rows})
            full[dtype] = {"loss": float(loss), "grad_norm": float(adamw.global_norm(grads))}
        del params, grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    report["one_card_s"] = time.perf_counter() - t0
    print(f"lm-train: one card's references in {report['one_card_s']:.1f} s", flush=True)
    check = dict(cut, seed=0, reference=ref)
    cases = [dict(check, shape=[2, 2]), dict(check, shape=[1, 4]),
             dict(main, shape=[2, 2], batch=LM_TRAIN_BF16_BATCH, loss_only=True, seed=0),
             dict(main, shape=[2, 2], seed=0, trace=True, log=True)]
    t0 = time.perf_counter()
    runs = procgrid.spawn(lm_train.proc_train, 2, 2, backend=backend, device=args.device,
                          args=({"cases": cases},), timeout_s=SPAWN_TIMEOUT_S,
                          env=nccl_env(tmp) if backend == "nccl" else None)
    report["spawn_s"] = time.perf_counter() - t0
    for name, k in (("2x2", 0), ("1x4", 1)):
        report[name] = {key: max(r["cases"][k][key] for r in runs)
                        for key in ("loss_rel", "norm_rel", "grad_rel", "param_rel", "param_lr")}
    for name, rec in report.items():
        if name in ("2x2", "1x4", "simgrid 2x2"):
            checks.expect(max(rec["loss_rel"], rec["norm_rel"], rec["grad_rel"],
                              rec["param_rel"]) <= LM_TRAIN_REL and rec["param_lr"] <= LM_TRAIN_LR,
                          f"lm-train {name} fp32 against one card: {rec} (bounds {LM_TRAIN_REL}, "
                          f"{LM_TRAIN_LR} lr)")
    bf = [r["cases"][2] for r in runs]
    one_gap = {k: abs(full["bf16"][k] - full["fp32"][k]) for k in ("loss", "grad_norm")}
    report["bf16"] = {"loss": bf[0]["loss"], "grad_norm": bf[0]["grad_norm"], "one_card": full,
                      "gap": {k: abs(bf[0][k] - full["bf16"][k]) for k in ("loss", "grad_norm")},
                      "one_card_gap": one_gap}
    for k in ("loss", "grad_norm"):
        checks.expect(all(r[k] == bf[0][k] for r in bf),
                      f"lm-train bf16: the processes' {k} differ: {[r[k] for r in bf]}")
        checks.expect(report["bf16"]["gap"][k] <= LM_BF16_RATIO * one_gap[k],
                      f"lm-train bf16 {k}: {bf[0][k]} vs one card's {full['bf16'][k]}, gap "
                      f"{report['bf16']['gap'][k]} > {LM_BF16_RATIO} x one card's own bf16-to-fp32 "
                      f"gap {one_gap[k]}")
    timed = [r["cases"][3] for r in runs]
    rec = timed[0]
    for r in timed:
        checks.expect(all(np.isfinite(r["loss"])) and r["loss"] == rec["loss"],
                      f"lm-train: rank {r['rank']} losses {r['loss']} vs rank 0's {rec['loss']}")
    report["timed"] = {
        **{k: rec[k] for k in ("loss", "grad_norm", "step_s", "median_step_s",
                               "tokens_per_step")},
        "tokens_per_s": rec["tokens_per_step"] / rec["median_step_s"],
        "init_s": [r["init_s"] for r in timed], "peak_bytes": [r["peak_bytes"] for r in timed],
        "collective_bytes": [r["collective_bytes"] for r in timed], "trace": rec.get("trace"),
        "case": {k: main.get(k) for k in ("arch", "layers", "dtype", "batch", "seq", "steps")}}
    report["devices"] = [r["device"] for r in runs]
    return report


def print_lm_train(rep: dict, where: str, card_name: str) -> None:
    for name in ("simgrid 2x2", "2x2", "1x4"):
        r = rep[name]
        print(f"lm-train fp32 cut depth {name} against one card (TF32 off): loss "
              f"{r['loss_rel']:.3e}, norm {r['norm_rel']:.3e}, gradients {r['grad_rel']:.3e} of "
              f"the peak, AdamW step {r['param_rel']:.3e} of the peak where |g| > 1e-4 of its "
              f"peak and {r['param_lr']:.3f} lr elsewhere (bounds {LM_TRAIN_REL}, "
              f"{LM_TRAIN_LR} lr); on {card_name}")
    b = rep["bf16"]
    print(f"lm-train bf16 full depth, {LM_TRAIN_BF16_BATCH} rows, 2x2: loss {b['loss']:.6f} vs "
          f"one card {b['one_card']['bf16']['loss']:.6f} (gap {b['gap']['loss']:.3e}; one card's "
          f"bf16-to-fp32 gap {b['one_card_gap']['loss']:.3e}), grad norm {b['grad_norm']:.6f} vs "
          f"{b['one_card']['bf16']['grad_norm']:.6f} (gap {b['gap']['grad_norm']:.3e}; one card's "
          f"{b['one_card_gap']['grad_norm']:.3e}); bound {LM_BF16_RATIO} x one card's gap")
    t = rep["timed"]
    c = t["case"]
    tr = t["trace"]
    traced = ("" if not tr else f"; a traced step on rank 0: wall {tr['wall_ms']:.1f} ms, device "
              "ms " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(tr["device_ms"].items()))
              + f", NCCL share {tr['nccl_share']:.4f}")
    print(f"lm-train {c['arch']} {c['layers'] or 'all'} layers {c['dtype']} 2x2, {c['batch']} rows "
          f"of {c['seq']} tokens: losses {[round(x, 6) for x in t['loss']]}, steps "
          f"{[round(x, 4) for x in t['step_s']]} s, median {t['median_step_s']:.4f} s a step "
          f"after the first, {t['tokens_per_s']:.1f} tokens/s ({where}); peak GiB a card "
          f"[{_gib(t['peak_bytes'])}]{traced}; on {card_name}")
    for k, cb in enumerate(t["collective_bytes"]):
        print(f"lm-train collective bytes of one step, process {k}: {cb}")


def _gib(xs) -> str:
    return ", ".join("not measured (CPU)" if x is None else f"{x / 2**30:.2f}" for x in xs)


def print_lm(lm: dict, where: str, card_name: str) -> None:
    for key, rec in lm.items():
        ref = rec.get("reference")
        against = (f"; greedy tokens equal to one card's, logits within "
                   f"{rec['logit_gap']:.3e} of its peak (bound {LM_LOGIT_REL}); one card "
                   f"{ref['tokens_per_s']:.2f} tokens/s, median {ref['median_tick_ms']:.3f} ms "
                   f"a tick, peak GiB {_gib([ref['peak_bytes']])}" if ref else "")
        peaks, init = _gib(rec["peak_bytes"]), _gib(rec["init_peak_bytes"])
        tr = rec.get("trace")
        traced = ("" if not tr else f"; {tr['ticks']} traced ticks on rank 0: wall "
                  f"{tr['wall_ms']:.3f} ms a tick, {tr['kernels_per_tick']:.1f} kernels a "
                  f"tick, device ms a tick " + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(tr["device_ms"].items())))
        launch = ("" if rec["launch_us"][0] is None else "; host us a kernel launch "
                  + ", ".join(f"{x:.3f}" for x in rec["launch_us"]))
        print(f"lm {key}: {rec['ticks']} ticks, {rec['generated_tokens']} tokens, "
              f"{rec['tokens_per_s']:.2f} tokens/s, median {rec['median_tick_ms']:.3f} ms a "
              f"tick (rank 0; {where}); peak GiB a card serving [{peaks}], drawing the "
              f"weights [{init}]{against}{traced}{launch}; on {card_name}")
        for name, v in rec["variants"].items():
            side = "above" if v["logit_gap"] > LM_LOGIT_REL else "NOT above"
            bound = (f"{side} the fp32 bound {LM_LOGIT_REL}" if name == "tf32" else
                     f"bound {v['bound']:.3e} = {LM_BF16_RATIO} x the one-card bf16 engine's "
                     f"gap to its fp32 logits {v['one_card_gap']:.3e}")
            dtype = serve_bench.VARIANTS[name][0]
            print(f"lm {key} then {name}: logits within {v['logit_gap']:.3e} of the one-card "
                  f"{dtype} engine's peak ({bound}) over {v['compared']} of {v['pairs']} "
                  f"(tick, slot) pairs fed alike; {v['tokens_equal']} of {v['requests']} "
                  f"requests' tokens equal to one card's")


def print_report(bfs: dict, where: str, sim_where: str) -> None:
    for key, rec in bfs["cases"].items():
        teps_part = (f"; TEPS {rec['teps']:.6e} vs SimGrid {rec['simgrid_teps']:.6e}"
                     if "teps" in rec else "")
        print(f"{key}: batches {[round(t, 4) for t in rec['batch_s']]} s ({where}, slowest "
              f"process) vs {[round(t, 4) for t in rec['simgrid_batch_s']]} s ({sim_where}); "
              f"levels {rec['n_levels']}{teps_part}")
        for zone, fmts in sorted(rec["bytes"].items()):
            parts = ", ".join(f"{f} {b:,}" for f, b in sorted(fmts.items()))
            print(f"    {zone:18s} {sum(fmts.values()):>14,} B  ({parts})")
    traced = bfs["traced"]
    if traced:
        ms = traced["device_ms"]
        total = sum(ms.values())
        print(f"traced batch on rank 0 ({traced['case']}, {traced['batch_s']:.4f} s): device "
              f"ms {', '.join(f'{k} {v:.3f}' for k, v in sorted(ms.items()))}; share NCCL "
              f"{ms.get('nccl', 0) / total:.4f}, port kernels {ms.get('port', 0) / total:.4f}, "
              f"other {ms.get('other', 0) / total:.4f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--scale", type=int, default=SCALE)
    ap.add_argument("--refine", type=int, default=6, help="the train step's multimesh")
    ap.add_argument("--smoke", action="store_true",
                    help="the train step and the LM case at smoke widths")
    ap.add_argument("--case", default="graph", choices=["graph", "lm", "lm-train"],
                    help="the graph cases (steps 2-6), the LM case (step 7) or the LM "
                         "train case (step 8)")
    args = ap.parse_args(argv)

    dev = torch.device("cuda" if args.device is None else args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("multicard: no CUDA device is available")
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    summary: dict = {"scale": args.scale, "backend": args.backend, "device": str(dev)}
    if cuda:
        summary.update(print_cards())
        procgrid.check_transport(args.backend, 4, torch.cuda.device_count())
    checks = Checks()
    graph, lm, lmt = args.case == "graph", args.case == "lm", args.case == "lm-train"
    with tempfile.TemporaryDirectory(prefix="multicard-") as tmp:
        if graph:
            t0 = time.perf_counter()
            g = graph500.generate(args.scale, 16, 1)[0]
            roots = teps.valid_roots(g, N_ROOTS, seed=2)
            summary["generation_s"] = time.perf_counter() - t0
            bfs, trees = bfs_step(args, g, roots, dev, args.backend, tmp, checks)
            summary["bfs"] = bfs
        if lm:
            summary["lm"] = lm_step(args, dev, args.backend, tmp, checks)
        if lmt:
            summary["lm_train"] = lm_train_step(args, dev, args.backend, tmp, checks)
        if args.backend == "nccl":
            summary["nccl"] = nccl_report(tmp)
    procs = summary["bfs"]["processes"] if graph else []
    if args.backend == "nccl":
        devices = [p["device"] for p in procs]
        for p in procs:
            checks.expect(p["current_device"] == p["rank"]
                          and set(p["blocks"].values()) == {f"cuda:{p['rank']}"}
                          and p["device"] == f"cuda:{p['rank']}",
                          f"rank {p['rank']}: current device {p['current_device']}, grid on "
                          f"{p['device']}, blocks on {p['blocks']}")
        for key, rec in summary.get("lm", {}).items():
            checks.expect(rec["devices"] == [f"cuda:{k}" for k in range(len(rec["devices"]))],
                          f"lm {key}: the processes ran on {rec['devices']}")
        if lmt:
            got = summary["lm_train"]["devices"]
            checks.expect(got == [f"cuda:{k}" for k in range(4)],
                          f"lm-train: the processes ran on {got}")
        if graph:
            checks.expect(len(set(devices)) == 4, f"the processes share cards: {devices}")
        summary["transport"] = transport_label(summary["nccl"]["via"], summary["topo"],
                                               summary["nvlink"])
        where = f"4 processes on 4 cards over nccl, {summary['transport']}"
    elif cuda:
        where = "4 processes on one card over gloo (host memory)"
    else:
        where = "4 processes on the CPU over gloo"
    if args.backend == "nccl":
        rep = summary["nccl"]
        print(f"NCCL {rep['version']}: transports {rep['via']}; warnings {rep['warnings']}")
    if lm:
        print_lm(summary["lm"], where, "; ".join(summary.get("cards", [])) or str(dev))
    if lmt:
        print_lm_train(summary["lm_train"], where,
                       "; ".join(summary.get("cards", [])) or str(dev))
    train = None
    if graph:
        sim_where = f"SimGrid on {dev}"
        print(f"# multicard scale {args.scale} ({g.n:,} vertices, {len(g.src):,} stored "
              f"edges), {len(roots)} roots in batches of {BATCH}, direction_opt + hybrid: "
              f"{where}")
        for p in procs:
            print(f"rank {p['rank']}: {p['card']}, current device {p['current_device']}, "
                  f"blocks {p['blocks']}, launches {p['launches']}")
        print_report(bfs, where, sim_where)
        if cuda and torch.cuda.device_count() >= 4:
            summary["off_current_device"] = off_current_device(g, roots[:BATCH], checks)
            print("single process, cuda:0 current: bfs of the first batch on cuda:1 and "
                  "cuda:3 equal to cuda:0's: " + "; ".join(
                      f"{k} {v['seconds']:.4f} s, launches {v['launches']}"
                      for k, v in summary["off_current_device"].items()))
        train = train_step(args, dev, args.backend, checks)
        summary["train"] = train
        print(f"train (GraphCast {gnn_train.LAYERS} layers, refinement {args.refine}, 2x2): "
              f"fp32 gaps to SimGrid (outputs, loss, gradients) "
              f"{', '.join(f'{x:.3e}' for x in train['fp32_gaps'])} (bound {GNN_FP32_REL}); "
              f"int8 loss {train['int8_loss']:.6f} vs fp32 {train['fp32_loss']:.6f} (rel "
              f"{train['int8_loss_rel']:.3e}, bound {TRAIN_INT8_LOSS_REL}); step s fp32 "
              f"{train['step_s']['fp32']:.4f}, int8 {train['step_s']['int8']:.4f} ({where}, "
              f"slowest process; parts {train['parts_s']}) vs SimGrid "
              f"{train['simgrid_step_s']['int8']:.4f} (parts {train['simgrid_parts_s']}); "
              f"peak bytes {train['peak_bytes']}")
        summed: collections.Counter = collections.Counter()
        for counts in [p["launches"] for p in procs] + train["launches"]:
            summed.update(counts)
        summary["launches_summed"] = dict(summed)
        print(f"launches, the four processes summed (BFS and SSSP batches, int8 train step): "
              f"{summary['launches_summed']}")
    procgrid.require_no_children()
    summary["failures"] = checks.failures
    summary["where"] = where
    print(json.dumps(summary, default=str))
    if checks.failures:
        print(f"multicard: {len(checks.failures)} mismatch(es)", file=sys.stderr)
        raise SystemExit(1)
    if graph:
        summary["trees"] = trees
    return summary


if __name__ == "__main__":
    main()
