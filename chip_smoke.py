#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's paths on one NVIDIA card: the single-device Graph500
BFS, the paper's frontier and codec study, the 2D-distributed BFS on a
simulated grid under the direct and the butterfly wire plans, the
frontier algebras on both, the 2D GNN forward with int8 payloads, the
GNN training step on the simulated grid and on one process per rank, the
equivariant GNNs (EGNN, NequIP) forward and trained, the LM archs
served through the slot-batched decode engine, the AutoInt recommender
served, trained and driven through the training launcher, the
launch layer (the id-stream helpers, the cell catalogue) and the
dry-run (the ``CommStats`` ledger against the collectives the grid ran,
cells counted on ``meta``):

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. holds every kernel against its plain PyTorch version on the card, for
   exact equality, at ragged small shapes (pack and popcount_planes on
   inputs that take both their 16-byte and scalar routes: n = 0..15 mod
   16, w = 0..3 mod 4, w = 0, views 1 byte or 1 word into their storage,
   all-ones words, 1 to 17 planes, a uint8 byte of 2; frontier_mask and
   interleave_values at 1 to 17 planes, ragged widths, all-zero and
   all-set masks, misaligned views, interleave_values into an output
   filled with a sentinel that every column with a zero byte keeps; the SpMV
   kernels on SPMV_CASES: 1 to 17 planes, K from 1 to 64, unsorted and
   all-sentinel rows, empty and full frontiers, offset slab views) and at
   the single-device path's shapes (B=8 planes of the scale-S graph, its
   hybrid slab, a real frontier and unreached plane), and times kernel
   (CUDA events, and the profiler's device time) and plain version
   (popcount_planes also at CC's single plane); popcount_blocks on inputs
   that take both of its routes (W = 1, 7, 1,500, 3 x 1,024 + 3, views one
   word into their storage); and the launch's routing on one card: inside
   a side stream, ``unpack`` hands its C entry point that stream (the
   current stream of its tensors' card) with that card current, and its
   output is exact once the stream is synchronized;
4. runs the Graph500 harness (scale S, edgefactor 16, seed 1, 64 valid
   roots in batches of 8, ``direction_opt`` + ``hybrid``, every tree
   validated) with the launch counts zeroed just before and read just
   after; every kernel of the path must have launched;
5. the paper's frontier and codec study (Fig 5.2, Tables 5.3-5.5:
   ``repro_torch.bench.frontier_stats`` and ``.codecs``) at the reference's
   defaults (scale 14, root 0) and on the scale-S graph of step 4 from its
   first valid root, counts zeroed before and read after: each level's
   count comes from ``DensityOracle.local_count`` on the card (pack and
   ``popcount_blocks``, at least one launch a level); the rows are printed,
   the codec speeds labelled with the host CPU.  Then popcount_blocks at
   the densest level's packed frontier, at one 1024-word block (the
   launch's floor) and at the scale-26 shape, exact and timed beside its
   bound, and ``local_count`` on the card against the bit sums;
6. partitions the same graph onto a simulated 2x2 grid and runs the
   distributed BFS (``auto`` + ``direction_opt`` + ``hybrid``) on 16 of
   the roots in batches of 8, counts zeroed before and read after: every
   tree valid, every kernel of the path launched, the first batch equal to
   the single-device run; the first batch again under ``raw`` gives the
   per-phase bytes of both wire plans.  Before the counted run, one batch
   records the inputs the path gives each kernel (a rank's frontier
   planes, its column slice, unreached plane and slab, the id streams at
   every bucket it used, what it unpacks); each is held against its plain
   version exactly and timed beside its bound, as is unpack on a 16-bit id
   stream at cap 16,384;
7. the butterfly wire plan (``btfly``) on step 6's 2x2 set-up: one batch
   records the inputs the path gives pack and unpack (stage bitmaps,
   PFOR16 gaps, packed floors), each held against its plain version
   exactly and timed beside its bound; then the 16 roots under ``btfly``
   + ``direction_opt`` + ``hybrid``, counts zeroed before and read after:
   every tree valid, every batch equal to ``auto``'s, every kernel of the
   path launched; the first batch again under ``top_down`` and
   ``bottom_up``; the bytes per zone and per stage zone, batch times, TEPS
   and the idle share of a traced batch beside ``auto``'s; one batch on a
   2x3 grid of the same graph (fold, one stage, unfold; 2**18-multiple
   chunks) equal to the single-device run; one SSSP batch equal to
   ``auto``'s; and at scale 18 (2x2, 4 hub roots, every policy) the
   ledger equal to the host replay ``bench.bfs_comm.simulate_batch`` zone
   for zone and stage for stage, the replay's document passing
   ``bench.check_comm``;
8. the process grid: 4 worker processes on the one card, one rank each of
   a 2x2 grid over ``torch.distributed`` with gloo, exchanging through
   host memory (``repro_torch.comm.procgrid``; the kernels are built by
   step 2 before they start), at scale 18, one batch of 8 roots each of
   ``auto`` + ``direction_opt`` + ``hybrid``, ``btfly`` + ``direction_opt``
   + ``hybrid`` and ``sssp`` under ``auto``, after one uncounted warm-up
   batch, the counts zeroed in each worker before and read after: values,
   levels and level counts bit-identical to ``SimGrid`` on the card for the
   same roots, every tree valid (SSSP: its certificate), the workers'
   merged ledger equal to ``SimGrid``'s record for record, every kernel of
   the distributed path launched in each worker; the batch times beside
   ``SimGrid``'s, the staging share, and ``tree_betweenness`` of the first
   batch on the card equal to the same function on the CPU;
9. cross-checks at scale 16: ``top_down``, ``bottom_up`` and
   ``direction_opt`` on the card, single-device and on the 2x2 grid under
   ``raw``, ``bitmap``, ``auto`` and ``btfly``, and ``direction_opt`` on
   the CPU give bit-identical parents, levels and level counts; so do
   ``sssp`` and ``cc`` under every policy on the card, single-device and
   on the grid under every plan, against ``top_down`` on the CPU;
10. the frontier algebras at scale S (``hybrid`` + ``top_down``): the value
   kernel ``gspmm_min_planes`` and its ``interleave_values`` helper against
   their plain versions at the path's own inputs (a real SSSP level of 8
   planes, push and pull, both ops; one rank's slab of the 2x2 grid with its
   bases; CC's single plane), timed beside their bounds (the helper also
   at an all-set mask, beside the transpose call that computes it there,
   with the columns it writes, the 32-byte sectors of x they touch and the
   sector-granular floor); then ``sssp`` (8 roots), ``cc`` and ``pagerank`` (one
   plane each) on one device, counts zeroed before each run and read
   after, checked on the card (SSSP shortest-path certificates, CC labels,
   PageRank against a float64 power iteration) and against scipy (one
   root's Dijkstra, the connected components); the same runs on the 2x2
   grid under ``auto`` equal the single-device ones (PageRank within a
   float32 bound), and the first SSSP batch again under ``raw`` gives the
   per-phase bytes of both plans;
11. the 2D GNN forward at full width (``repro_torch.bench.gnn``: GraphCast,
   16 layers, d_hidden 512, 227 variables, on the refinement-6 multimesh,
   40,962 nodes, over a simulated 2x2 grid): one int8 forward records the
   inputs the path gives the ``quantize`` kernel (the owned chunk and the
   all-to-all chunks), each held against its plain version exactly and
   timed beside its byte bound, as are ragged and half-way inputs; then 4
   int8 requests, one fp32 forward and the single-device forward with the
   counts zeroed before and read after: ``quantize`` launched, every output
   finite, the fp32 2D output within ``GNN_FP32_REL`` of the single-device
   one, and the int8 output within ``GNN_INT8_L2`` relative L2 of fp32;
12. the GNN training step (``repro_torch.bench.gnn_train``): step 11's
   GraphCast at its published width, depth cut to 4 layers (the saved
   activations of 16 do not fit the card), cross-entropy over its 227
   classes with targets from seed 0, over the simulated 2x2 grid: the fp32
   2D loss and ``pmean``ed gradients against ``gnn.loss_fn``'s autograd on
   the single device over the padded multimesh (within ``GNN_FP32_REL`` of
   the gradients' peak); one uncounted int8 loss-and-gradient call records
   the inputs the train path gives ``quantize``, each held against its plain
   version exactly and timed beside its byte bound; then 4 int8 train steps
   (forward + backward, gradient ``pmean``, AdamW with WSD) with the counts
   zeroed before and read after: ``quantize`` launched, the first loss
   within 5% of fp32, every gradient finite and nonzero, the loss after 3
   AdamW updates below the first; ``dp_allreduce_int8`` over the 4 ranks of
   a 4x1 grid on the fp32 step's per-rank gradients, within the int8 bound
   of their fp32 mean, its ledger's int8 wire 3.879x fewer bytes than the
   fp32 all-reduce's; and the process grid: 4 worker processes on the card
   over gloo run one fp32 and one int8 train step, each after a warm-up:
   the fp32 forward outputs, loss and gradients within ``GNN_FP32_REL`` of
   ``SimGrid``'s, the int8 loss within 5% of the fp32 one and its gradients
   finite and nonzero (their gaps to ``SimGrid``'s int8 printed), the int8
   step's time beside ``SimGrid``'s and the staging share printed; the
   seconds per step, the bytes and the peak memory beside the card;
13. EGNN (4 layers, d_hidden 64) and NequIP (5 layers, 32 channels per l,
   l <= 2, 8 radial functions, cutoff 5) at their published widths on the
   refinement-6 multimesh, its vertices on the unit sphere as positions,
   over a simulated 2x2 grid: (1) one EGNN int8 forward records the inputs
   the path gives ``quantize`` (the owned ``[h, x]`` chunk and the
   all-to-all chunks), each held against its plain version exactly and
   timed beside its byte bound; then 4 int8 requests, one fp32 forward and
   the single-device forward, counts zeroed before and read after:
   ``quantize`` launched, every output finite, fp32 2D within
   ``GNN_FP32_REL`` of single-device, int8 within ``GNN_INT8_L2`` relative
   L2 of fp32 (the coordinates are quantized with the features, as in the
   reference); (2) the same forwards of NequIP: no ``quantize`` launch,
   and its forward asked for int8 equal to its fp32 forward bit for bit
   (under deterministic kernels); (3) positions rotated (EGNN: and
   shifted): both models' single-device and 2D outputs invariant and EGNN's
   single-device coordinates moved with them, within ``EQUIV_REL`` of each
   peak; (4) the fp32 2D loss and ``pmean``ed gradients (cross-entropy over
   16 classes, targets from seed 0) within ``GNN_FP32_REL`` of the
   gradients' peak from single-device autograd over the padded multimesh,
   both under deterministic kernels; then 4 AdamW steps (WSD, as in step
   12): the loss after 3 updates below the first, every gradient finite
   and nonzero but those of the leaves the loss does not read (zero in the
   single-device gradients too); (5) one fp32 step of each arch on 4
   worker processes over gloo under deterministic kernels: outputs, loss
   and gradients within ``GNN_FP32_REL`` of ``SimGrid``'s; (6) 4 steps of
   ``train.step.make_train_step`` on the ``molecule`` batch
   (``data.graphs.molecule_batch(128, 30, 64, 16)``, float targets: MSE)
   for both archs: the loss falls, the gradient norms are finite.  Seconds
   per forward and per step, bytes, peak memory and the gaps beside the
   card;
14. LM serving through the slot-batched decode engine
   (``repro_torch.bench.serve``; no kernel of the ten runs on this path, as
   in the reference), one model at a time, random fp32 weights from a CUDA
   generator and bf16 compute as the configs set them: (1) gemma-2b at its
   published widths and full depth (18 layers, 3.03B parameters) serves 12
   requests of 16-256 prompt tokens and 32 new tokens over 8 slots of a
   32,768-token cache (the ``decode_32k`` shape's length, its batch of 128
   cut to 8 slots), counts zeroed before and read after: every request
   finishes with 32 tokens below the vocab and the engine drains; (2) in
   fp32 with TF32 off, a 64-token prompt alone in the 8-slot engine: its
   first token is the argmax of ``forward``'s last position, the last prompt
   tick's logits within ``SERVE_FP32_REL`` of the peak of ``forward``'s,
   and its tokens the same beside 7 other requests; (3) minicpm-2b (40
   layers), deepseek-coder-33b (8 of 62), dbrx-132b (2 of 40) and
   deepseek-v2-236b (2 of 60) at their published widths serve 8 requests of
   16-64 prompt tokens and 16 new tokens over 8 slots of a 2,048-token
   cache, every request finishing; then each one's decode on one slot equals
   its teacher-forced ``forward`` in fp32 (the MoE archs with a capacity
   factor of their expert count, drop-free) within ``SERVE_FP32_REL`` of
   the peak at every position (the logits of the vocab: padded ones hold
   -1e9); (4) gemma-2b and dbrx-132b cut to 2 layers, fp32 with TF32 off,
   served on a ``SimGrid`` 2x2 on the card by the grid engine (the weights
   placed FSDP x TP by ``param_specs``, the cache's slots over the rows and
   its sequence over the columns: ``models.transformer_sharded``) and by
   the one-device engine: the same tokens, and every tick's logits within
   ``SERVE_GRID_REL`` of the one-device engine's peak.  Ticks,
   generated tokens per second, the median ms per tick, the weights' bytes
   and the peak memory beside the card;
15. AutoInt (``repro_torch.bench.recsys``; no kernel of the ten runs on
   this path, as in the reference) at its published widths (39 fields,
   d 16, 3 interaction layers of 2 heads at 32, MLP 256-128), random
   weights from a CUDA generator, fp32 with TF32 off, counts zeroed before
   the step and read after: (1) the full 173,588,480-row fp32 table on the
   card: ``forward`` at ``serve_p99`` (512) and ``serve_bulk`` (262,144)
   finite, ``embedding_bag`` of the 512-row batch equal to
   ``table[ids + offsets]``, the dense part (interaction and MLP) within
   ``RECSYS_FP32_REL`` of the same function on the CPU on a copy of the
   gathered rows; (2) the int8 table (``table_quant``) at the full row
   count: the forward at 512 within ``RECSYS_FP32_REL`` of the fp32 forward
   on the dequantized gathered rows; (3) ``retrieval_scores`` over
   1,000,000 candidates of the last field within ``RECSYS_FP32_REL`` of
   ``user_vector . table[rows]`` in float64, 16 of them scored alone the
   same; (4) ``train_batch`` (65,536) over the table with each size cut by
   4: the table's gradient zero on every row the batch did not touch and
   nonzero on the touched ones, every leaf the loss reads nonzero, then 4
   ``make_train_step`` steps with finite losses and gradient norms; (5)
   ``launch.train.main`` in process under deterministic kernels: an
   uninterrupted 20-step autoint run's last checkpoint (step 19) removed,
   as if killed before writing it, the same command resumes at step 10 and
   ends on that run's state bit for bit; minicpm-2b and graphcast 10 steps
   each with finite losses and the summary line.  The ms per batch (median
   of 3 after a warm-up), samples per second, lookup bytes and peak memory
   of each cell (the serve cells also with the int8 table) beside the card;
16. the launch layer, counts zeroed before the step and read after: (1)
   ``kernels.bitpack.ops.pack_sorted_ids`` / ``unpack_sorted_ids`` on CUDA
   id streams of capacity ``ID_STREAM_CAP`` at every width class and at
   the counts ``ID_STREAM_COUNTS`` (0, 1, a full 1,024-chunk, capacity),
   words and ids bit for bit against the plain versions (the same calls on
   CPU copies) and the ids round-tripped, and ``compact_ids`` at the same
   counts; pack and unpack must have launched; (2) the 43 cells of
   ``launch.cells.all_cells()`` built on ``meta`` for both production
   meshes: 38 built, 5 skips, every argument a meta tensor whose spec
   divides its shape on the mesh, each cell's ``model_flops`` printed; (3) ``LAUNCH_CELLS`` built at a one-card (1, 1)
   mesh, each ``fn`` run once on its meta arguments and once on arguments
   made on the card from a seed (AutoInt with its full 173,588,480-row
   table): the outputs' shapes and dtypes those of the meta run, every float
   finite, and for the two GNN train steps the loss within ``LAUNCH_REL`` of
   the same cell's on the CPU (TF32 off); the roofline constants beside the
   card;
17. the dry-run (``repro_torch.launch.dryrun``), counts zeroed before the
   step and read after: (1) step 6's ``raw`` batch and its counted
   ``auto`` batches ran under ``launch.roofline.count_collectives``; the
   ledgers against those counts (``compare_comm_stats``), per op kind,
   one rank's bytes and the sum over the grid; (2) the same check for
   ``raw``, ``bitmap`` and ``auto`` (``direction_opt``, ``hybrid``, 4 hub
   roots) on the reference test's partition, n = 2**16 on the 2x2 grid on
   the card; pack, unpack, popcount_planes, the push and pull SpMV and
   frontier_mask must have launched; (3) ``run_cell`` for
   ``DRYRUN_CELLS`` on meta on the host, each record printed on one line:
   the LM prefill, the 2D cell and the graph500 cell counted (temp bytes,
   collective bytes -- the LM prefill's of its sharded program on every
   rank of the two-pod mesh, one layer times its depth --, FLOPs but for
   the BFS, which has no products), the graph500 cell's collectives per kind
   those of the reference's compiled program (``GRAPH500_HLO``), the LM
   skip a skip, and no kernel launched; (4) check 2's partition with
   ``top_down`` for ``raw``, ``bitmap`` and ``auto``: a real batch's
   collectives per kind against one level counted on ``meta`` at the same
   shapes times the batch's depth, equal for ``raw`` and ``bitmap``, at
   most that for ``auto``.

    python3 chip_smoke.py [--scale 22]

It exits non-zero, printing no result, when CUDA is unavailable or the
repo's package is missing.  The last two lines before the final one are
the per-kernel JSON line and the card's name and power limit; the final
line is ``{"ok": true, "device": {...}}``.  It fails, too, if a process it
started (a worker of the process grid, or the resource tracker that the
spawn method starts) is still alive before the result is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

CHECK_SCALE = 16  # the cross-check's graph, small enough for the CPU run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores: the
#                        published 32-bit scalar rate the integer ops are held to
INF = 2**31 - 1
GRID = (2, 2)  # the simulated grid of the distributed path
DIST_ROOTS = 16
#: the butterfly's C = 3 grid (fold, one stage, unfold); its chunks are
#: 2**18-multiples, the least that keeps every bucket capacity of the
#: ladders a 1,024-multiple at scale 22 (the default 1,024-multiple chunk,
#: 699,392, gives s // 256 = 2,732, which the ladder refuses, as the
#: reference's does)
BTFLY_C3 = (2, 3)
BTFLY_C3_CHUNK_MULTIPLE = 1 << 18
#: the ledger's check against the host replay: a scale small enough for
#: the replay's numpy (seconds), with sparse buckets on every wire
LEDGER_SCALE = 18
LEDGER_BATCH = 4
#: the process grid (step 8): one process per rank of GRID on the one card,
#: gloo through host memory; scale 18 keeps its batches to seconds while
#: the row wires still take their sparse buckets
PROC_SCALE = 18
PROC_CASES = ({"mode": "auto", "policy": "direction_opt"},
              {"mode": "btfly", "policy": "direction_opt"},
              {"mode": "auto", "policy": "top_down", "algebra": "sssp"})
REPLACES = {
    "pack": "src/repro/kernels/bitpack/bitpack.py:50",
    "unpack": "src/repro/kernels/bitpack/bitpack.py:72",
    "popcount_blocks": "src/repro/kernels/popcount/popcount.py:32",
    "popcount_planes": "src/repro/kernels/popcount/popcount.py:50",
    "spmv_min": "src/repro/kernels/spmv/spmv.py:203",
    "spmv_min_planes": "src/repro/kernels/spmv/spmv.py:171",
    "spmv_pull_min": "src/repro/kernels/spmv/pull.py:122",
    "spmv_pull_min_planes": "src/repro/kernels/spmv/pull.py:89",
    "gspmm_min_planes": "src/repro/kernels/spmv/spmv.py:127",
    "quantize": "src/repro/kernels/quant/quant.py:31",
    # no Pallas entry of its own: it takes the place of the frontier-bit
    # reads inside the ELL kernels (rows 5-9; the push body's first)
    "frontier_mask": "src/repro/kernels/spmv/spmv.py:59 (helper of the ELL kernels, no "
                     "Pallas entry)",
    # the value gather's plane-interleaved copy of x (the Pallas kernel
    # keeps each plane's values resident in VMEM instead)
    "interleave_values": "src/repro/kernels/spmv/spmv.py:80 (helper of the value gather, no "
                         "Pallas entry)",
}
SOURCES = {
    "pack": "src/repro_torch/kernels/csrc/bitpack.cu",
    "unpack": "src/repro_torch/kernels/csrc/bitpack.cu",
    "popcount_blocks": "src/repro_torch/kernels/csrc/popcount.cu",
    "popcount_planes": "src/repro_torch/kernels/csrc/popcount.cu",
    "spmv_min": "src/repro_torch/kernels/csrc/spmv.cu",
    "spmv_min_planes": "src/repro_torch/kernels/csrc/spmv.cu",
    "spmv_pull_min": "src/repro_torch/kernels/csrc/spmv.cu",
    "spmv_pull_min_planes": "src/repro_torch/kernels/csrc/spmv.cu",
    "gspmm_min_planes": "src/repro_torch/kernels/csrc/spmv.cu",
    "quantize": "src/repro_torch/kernels/csrc/quant.cu",
    "frontier_mask": "src/repro_torch/kernels/csrc/spmv.cu",
    "interleave_values": "src/repro_torch/kernels/csrc/spmv.cu",
}
#: the kernels each main path must launch
GRAPH500_PATH = ("pack", "popcount_planes", "frontier_mask", "spmv_min_planes",
                 "spmv_pull_min_planes")
DIST_PATH = GRAPH500_PATH + ("unpack",)
#: the min algebras' paths (SSSP's 8 planes go through the frontier mask and
#: the interleaved values, CC's one plane probes its bitmap); PageRank's sum
#: reduce runs the plain gspmm by design (as the reference on every
#: platform), so it needs pack and popcount only
ALGEBRA_PATHS = {"sssp": ("gspmm_min_planes", "frontier_mask", "interleave_values", "pack",
                          "popcount_planes"),
                 "cc": ("gspmm_min_planes", "pack", "popcount_planes"),
                 "pagerank": ("pack", "popcount_planes")}
#: PageRank on the grid against one device: float32 sums over a vertex's
#: in-edges in another order, a few ulp of relative error per vertex
PAGERANK_GRID_L1 = 1e-5
GNN_PATH = ("quantize",)
#: the paper's frontier and codec study: each level's count by local_count
STUDY_PATH = ("pack", "popcount_blocks")
STUDY_SCALE = 14  # the reference harnesses' default scale
STUDY_LEVEL = 3  # the codec study's frontier (the reference's default level)
#: popcount_blocks beside its main input: one 1024-word block (the launch's
#: fixed cost on this card) and the packed frontier of a scale-26 graph
#: (Graph500's smallest class)
BLOCK_INPUTS = {"one block": 1024, "scale-26 shape": (1 << 26) // 32}
#: fp32 2D against single-device GraphCast: the same float32 products, the
#: aggregates summed in another order (per block, then over the grid's
#: columns) through 16 residual layers whose outputs reach ~1e12 (random
#: weights, no normalisation, as in the reference): the max abs gap over the
#: output's max abs (~2e-6 at refinement 4 on the CPU, 3.361e-6 and
#: 3.465e-6 on the H100 at refinement 6), held to the fp32 bar of the tests
GNN_FP32_REL = 1e-5
#: int8 payloads against fp32: the reference's own bar (tests/test_dist.py,
#: on the loss), here on the outputs' relative L2
GNN_INT8_L2 = 0.05
#: device operations per quantized value (abs, max, divide, rint, two
#: clamps, convert), for the bound; the bytes bound it
QUANT_OPS_PER_VALUE = 7
#: the GNN training step (step 12): step 11's GraphCast, its depth cut from
#: 16 to 4 layers (the saved activations: ~1.85 GB a rank and layer on the
#: 2x2 grid, so 16 layers need ~118 GB and 4 need ~30 GB of the card's 80)
TRAIN_LAYERS = 4
#: counted int8 train steps: the 4th step's loss follows 3 AdamW updates
TRAIN_STEPS = 4
#: the int8 train loss against fp32: the reference's own bar
#: (tests/test_dist.py:137)
TRAIN_INT8_LOSS_REL = 0.05
#: the process grid's run of the train step (step 12, check 6): 4 workers
#: on the one card over gloo, each case one uncounted warm-up and one train
#: step.  fp32 is held to SimGrid's within GNN_FP32_REL; the int8 step to
#: the int8 bar against SimGrid's fp32 loss: index_add_'s atomics sum in
#: another order in each run, and a float-order flip upstream of a
#: quantizer moves a code by one step (scale/127 of its group), which the
#: following layers carry (on an H100 80GB HBM3 at 700 W the two grids'
#: int8 outputs came 1.1-1.4% of their peak apart, the losses 2e-5-8e-5)
TRAIN_PROC_SPEC = {"refine": 6, "seed": 0, "smoke": False, "layers": TRAIN_LAYERS,
                   "steps": 1, "cases": [{"arch": "graphcast", "quantize": False},
                                         {"arch": "graphcast", "quantize": True}],
                   "capture": True}
#: the equivariant archs (step 13), at their published widths and depths
EQUIVARIANT_ARCHS = ("egnn", "nequip")
#: rotation and shift invariance (equivariance of EGNN's coordinates): the
#: reference's bar (tests/test_models.py, atol 1e-4), here over the
#: output's peak
EQUIV_REL = 1e-4
#: the fixed proper rotation (about z by 0.7, then about x by -1.2, the
#: reference's two test angles) and EGNN's shift (the reference's)
EQUIV_ANGLES = (0.7, -1.2)
EGNN_SHIFT = (1.0, -2.0, 0.5)
#: the process grid's run of the equivariant archs' train step (step 13,
#: check 5): 4 workers on the one card over gloo, one fp32 step each with
#: no warm-up (nothing of it is timed against another run), under
#: deterministic kernels, held to SimGrid's (run so too) within
#: GNN_FP32_REL.  With the card's atomic sums NequIP's gradients
#: moved 3.9e-5 of their peak between two runs of the same step (H100 80GB
#: HBM3, 700 W): its outputs reach ~7e5, so the cross-entropy's softmax is
#: saturated and a node whose two largest logits nearly tie turns a float
#: rounding into a change of its gradient term
EQUIV_PROC_SPEC = {"refine": 6, "seed": 0, "smoke": False, "layers": None, "steps": 1,
                   "warmup": 0,
                   "cases": [{"arch": "egnn", "quantize": False, "deterministic": True},
                             {"arch": "nequip", "quantize": False, "deterministic": True}],
                   "capture": True}
#: the molecule shape (configs/common.py GNN_SHAPES): 128 molecules of 30
#: atoms and 64 edges, 16 features; float targets (the MSE branch)
MOLECULE = (128, 30, 64, 16)
#: LM serving (step 14): gemma-2b at full depth first, then the other four
#: archs at their serving cells' depths (bench.serve.CELLS)
SERVE_ARCHS = ("gemma-2b", "minicpm-2b", "deepseek-coder-33b", "dbrx-132b", "deepseek-v2-236b")
#: decode against the teacher-forced forward in fp32 with TF32 off: the
#: same products in other shapes and orders (M = 8 or 1 rows against the
#: prompt's), over the logits' peak (~1e-6 at the smoke widths on the CPU)
SERVE_FP32_REL = 1e-4
#: gemma-2b's check (2): the prompt, the new tokens, the cache length
SERVE_CHECK_PROMPT = 64
SERVE_CHECK_NEW = 4
SERVE_CHECK_SEQ = 128
#: the cut archs' teacher-forced prompt.  The MoE archs take a capacity
#: factor of n_experts there, which makes every expert's capacity the whole
#: routing group, so no choice is dropped (one slot decodes with cap 1, its
#: group): the reference's drop-free factor of 8 leaves deepseek-v2-236b's
#: 32-token group a capacity of 9 per expert, which its random router
#: overflows (the forward then drops choices that decode keeps)
SERVE_TF_PROMPT = 32
#: check (4): the grid engine on a SimGrid 2x2 against the one-device
#: engine, both fp32 with TF32 off (the same products split over ranks and
#: summed in another order), over the logits' peak
SERVE_GRID_ARCHS = ("gemma-2b", "dbrx-132b")
SERVE_GRID_LAYERS = 2
SERVE_GRID_REL = 1e-4
SERVE_GRID_CELL = {"requests": 6, "prompt_len": (8, 24), "max_new": 4, "max_seq": 64}


#: LM training on a SimGrid 2x2 (step 18): gemma-2b's published widths at
#: 2 layers (5.1 GB of fp32 params: the one-device state, its new state
#: and the grid's fit on the card beside the fp32 logits), fp32 with TF32
#: off against the one-device step (the same products split over ranks
#: and summed in another order), over each leaf's peak; 2 steps
TRAIN_GRID_LAYERS = 2
TRAIN_GRID_BATCH = 4
TRAIN_GRID_SEQ = 512
TRAIN_GRID_REL = 1e-5
TRAIN_GRID_STEPS = 2


#: AutoInt (step 15): the published config's fused table, fp32 on the card
#: against the CPU (TF32 off: the same float32 products in other orders,
#: over the output's peak; the repo's fp32 bar), timed calls per cell after
#: a warm-up, and train steps
RECSYS_ROWS = 173_588_480
RECSYS_FP32_REL = 1e-5
RECSYS_REPS = 3
RECSYS_STEPS = 4


#: the launch layer (step 16): id streams at the largest capacity a wire
#: format takes, at each ragged count; the cells run on the card at a
#: (1, 1) mesh, and the bar of their fp32 loss against the CPU's
ID_STREAM_CAP = 1 << 16
ID_STREAM_COUNTS = (0, 1, 1024, ID_STREAM_CAP)
LAUNCH_PATH = ("pack", "unpack")
LAUNCH_CELLS = ("gat-cora/full_graph_sm", "egnn/molecule", "autoint/serve_p99")
LAUNCH_REL = 1e-5

#: the dry-run (step 17): the reference test's partition (n = 2**16 on
#: 2x2, a scale-16 graph here) under each wire plan, and four cells'
#: records: an LM prefill on the two-pod mesh, an LM skip, a 2D cell and
#: the paper's cell at a (2, 2) mesh (at 16x16 the 2D cell takes ~100 s of
#: host time; PERF.md)
DRYRUN_SCALE = 16
DRYRUN_PLANS = ("raw", "bitmap", "auto")
DRYRUN_CELLS = (("gemma-2b", "prefill_32k", "2x16x16"), ("minicpm-2b", "long_500k", "2x16x16"),
                ("graphcast", "ogb_products", "2x2"), ("graph500", "scale22", "2x2"))
#: graph500/scale22 on a (2, 2) mesh: the collectives of the reference's
#: compiled program per kind, ``parse_collectives(hlo, loop_mult=8)``
#: (tests/test_torch_dryrun.py holds the port's record equal to them)
GRAPH500_HLO = {"all-gather": 2_916_608, "all-to-all": 76_054_912,
                "collective-permute": 8_388_608, "all-reduce": 192}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


def same_quant(q, s, qr, sr) -> bool:
    """Codes equal; scales and dequantized values equal, with NaN at the
    same places (a group with a NaN or an inf dequantizes to NaN)."""
    from repro_torch.kernels.quant import ref as q_ref

    def same_nan(a, b):
        return same(a.isnan(), b.isnan()) and same(a.nan_to_num(), b.nan_to_num())

    return (same(q, qr) and same_nan(s, sr)
            and same_nan(q_ref.dequantize(q, s), q_ref.dequantize(qr, sr)))


def expect(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {what}")


def _min_algebra(op: str, max_weight: int):
    """The min algebra whose value gather is ``op``: SSSP (``minplus``) or
    CC (``copy``)."""
    from repro_torch.core import algebra

    return algebra.SsspAlgebra(max_weight=max_weight) if op == "minplus" else algebra.CcAlgebra()


def offset_view(t, elems: int = 1):
    """A contiguous copy of ``t`` that starts ``elems`` elements into its
    storage (so its base is not 16-byte aligned)."""
    import torch

    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    buf[elems:] = t.reshape(-1)
    return buf[elems:].view(t.shape)


def pack_ragged_inputs(gen, dev) -> list:
    """(label, values, b) inputs that take both routes of the pack kernel:
    bool and uint8 planes with n = 0..15 (mod 16), one plane view 1 byte
    into its storage, all-ones planes, uint8 planes holding 2 (a nonzero
    byte packs as 1), uint8 values at b = 4 (cast to int32 by the wrapper);
    int32 values at every width with n = 0..3 (mod 4) and a view one word
    in; B in {1, 3, 8, 17}."""
    import torch
    from repro_torch.kernels.bitpack import ref as bp_ref

    cases = []
    for planes in (1, 3, 8, 17):
        for n in (16, 1024, 4096, 9216, *(2048 + r for r in range(1, 16)), 1, 1000, 5000):
            bits = torch.rand((planes, n), generator=gen, device=dev) < 0.3
            cases += [(f"bool B={planes} n={n}", bits, 1),
                      (f"uint8 B={planes} n={n}", bits.to(torch.uint8), 1)]
        bits = torch.rand((planes, 4111), generator=gen, device=dev) < 0.3
        cases += [(f"bool B={planes} 1 byte in", offset_view(bits), 1),
                  (f"bool B={planes} 1 byte in, n % 16 == 0", offset_view(bits[:, :4096]), 1),
                  (f"all-ones B={planes}", torch.ones((planes, 3088), dtype=torch.bool,
                                                      device=dev), 1),
                  (f"uint8 of 2 B={planes}", 2 * bits.to(torch.uint8), 1),
                  (f"uint8 of 2 B={planes}, n % 16 == 0", 2 * bits[:, :4096].to(torch.uint8), 1),
                  (f"uint8 b=4 B={planes}", torch.randint(0, 16, (planes, 1000), generator=gen,
                                                          device=dev, dtype=torch.uint8), 4)]
        for b in bp_ref.B_CLASSES:
            for n in (4, 1024, 4100, 1001, 1022, 1023, 1025):
                vals = torch.randint(0, 2**b if b < 31 else 2**31 - 1, (planes, n),
                                     generator=gen, device=dev, dtype=torch.int64)
                cases.append((f"int32 b={b} B={planes} n={n}", vals.to(torch.int32), b))
            vals = torch.randint(0, 2**b if b < 31 else 2**31 - 1, (planes, 4096),
                                 generator=gen, device=dev, dtype=torch.int64)
            cases.append((f"int32 b={b} B={planes} 1 word in",
                          offset_view(vals.to(torch.int32)), b))
    return cases


def unpack_ragged_inputs(gen, dev) -> list:
    """(label, words, b) inputs of unpack at every width: 1 to 8 planes of 1
    to 5 chunks, 70,000 one-chunk planes (past the 65,535 of a y grid
    dimension) and a words view one word into its storage (the scalar-load
    route at b > 1)."""
    import torch
    from repro_torch.kernels.bitpack import ref as bp_ref

    cases = []
    for b in bp_ref.B_CLASSES:
        for planes, chunks in ((1, 1), (3, 5), (7, 2), (8, 3), (70_000, 1)):
            w = torch.randint(-2**31, 2**31 - 1, (planes, chunks * 32 * b), generator=gen,
                              device=dev, dtype=torch.int64).to(torch.int32)
            cases.append((f"b={b} B={planes} chunks={chunks}", w, b))
        w = torch.randint(-2**31, 2**31 - 1, (3, 2 * 32 * b), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        cases.append((f"b={b} B=3 1 word in", offset_view(w), b))
    return cases


def popcount_ragged_inputs(gen, dev) -> list:
    """(label, words) inputs that take both routes of popcount_planes: w =
    0..3 (mod 4), w = 0, views one word into their storage, all-ones words
    (a plane's count reaches 32 w), B in {1, 3, 8, 17}."""
    import torch

    cases = []
    for planes in (1, 3, 8, 17):
        for w in (0, 1, 7, 1024, 1500, 1501, 1502, 1503, 32768, 131072):
            words = torch.randint(-2**31, 2**31 - 1, (planes, w), generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int32)
            cases.append((f"B={planes} w={w}", words))
        for w in (1024, 1501):
            words = torch.randint(-2**31, 2**31 - 1, (planes, w), generator=gen, device=dev,
                                  dtype=torch.int64).to(torch.int32)
            cases.append((f"B={planes} w={w} 1 word in", offset_view(words)))
        cases.append((f"all-ones B={planes}", torch.full((planes, 4100), -1, dtype=torch.int32,
                                                         device=dev)))
    return cases


def blocks_ragged_inputs(gen, dev) -> list:
    """(label, words) inputs of popcount_blocks that take both of its routes
    (16-byte loads over the full 1024-word blocks of an aligned base, scalar
    loads for the ragged last block and a misaligned base): W = 1, 7, 1,500,
    3 x 1,024 + 3 and whole blocks, views one word into their storage,
    all-ones words."""
    import torch

    cases = []
    for w in (1, 7, 1024, 1500, 3 * 1024 + 3, 5000, 8192, 33 * 1024):
        words = torch.randint(-2**31, 2**31 - 1, (w,), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        cases.append((f"w={w}", words))
        if w in (1500, 3 * 1024 + 3, 8192):
            cases.append((f"w={w} 1 word in", offset_view(words)))
    cases.append(("all-ones w=4100", torch.full((4100,), -1, dtype=torch.int32, device=dev)))
    return cases


#: the plane counts the two ELL helpers are held to on ragged inputs: part
#: of one mask byte, a full byte, one bit past it, two full bytes, one bit
#: past them
HELPER_PLANES = (2, 7, 8, 9, 16, 17)
#: a column the interleave kernel must leave as it found it
SENTINEL = -5


def mask_ragged_inputs(gen, dev) -> list:
    """(label, f_words) inputs of frontier_mask: B in HELPER_PLANES (and 1),
    n_cols of 1, 3, 5 and 9 chunks (none a multiple of 4,096), random,
    all-zero and all-set words."""
    import torch

    cases = []
    for planes in (1, *HELPER_PLANES):
        for chunks in (1, 3, 5, 9):
            words = torch.randint(-2**31, 2**31 - 1, (planes, 32 * chunks), generator=gen,
                                  device=dev, dtype=torch.int64).to(torch.int32)
            cases.append((f"B={planes} n={1024 * chunks}", words))
        cases += [(f"all-zero B={planes}", torch.zeros((planes, 160), dtype=torch.int32,
                                                       device=dev)),
                  (f"all-set B={planes}", torch.full((planes, 160), -1, dtype=torch.int32,
                                                     device=dev))]
    return cases


def interleave_ragged_inputs(gen, dev) -> list:
    """(label, x, mask) inputs of interleave_values that take both of its
    routes (4-column vectors and scalars): B in HELPER_PLANES; n_x = n_cols,
    n_x below and above n_cols, widths that are not multiples of 4 (a
    ragged tail), a width below 4; random (every third byte 0), all-zero and
    all-set masks (all-set sets the bits of planes past B too); x one word
    and the mask one byte into their storage."""
    import torch

    cases = []
    for planes in HELPER_PLANES:
        groups = -(-planes // 8)
        for n_x, n_cols in ((4096, 4096), (5001, 5120), (5120, 4099), (4100, 5120), (3, 1024)):
            x = torch.randint(0, INF, (planes, n_x), generator=gen, device=dev,
                              dtype=torch.int32)
            x[:, ::5] = INF
            m = torch.randint(0, 256, (groups, n_cols), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.uint8)
            m[:, ::3] = 0
            tag = f"B={planes} n_x={n_x} n_cols={n_cols}"
            cases += [(tag, x, m),
                      (f"all-zero {tag}", x, torch.zeros_like(m)),
                      (f"all-set {tag}", x, torch.full_like(m, 255))]
            if n_x == n_cols == 4096:
                cases += [(f"{tag} x 1 word in", offset_view(x), m),
                          (f"{tag} mask 1 byte in", x, offset_view(m))]
    return cases


def check_helpers_ragged(dev) -> set:
    """frontier_mask and interleave_values against their plain versions,
    exactly, on their ragged inputs; interleave_values writes into an
    output filled with SENTINEL and must leave every column whose mask
    byte is 0 as it was.  Returns the interleave routes taken."""
    import torch
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    gen = torch.Generator(device=dev).manual_seed(4)
    for label, f in mask_ragged_inputs(gen, dev):
        expect(same(sp_ops.frontier_mask(f), sp_ref.frontier_mask(f)), ("frontier_mask", label))
    routes = set()
    for label, x, m in interleave_ragged_inputs(gen, dev):
        want = sp_ref.interleave_values(x, m)
        written = interleaved_columns(m, x.shape[1]) > 0
        xi = torch.full(want.shape, SENTINEL, dtype=torch.int32, device=dev)
        sp_ops._interleave_into(x, m, xi)
        expect(same(xi[written], want[written]) and bool((xi[~written] == SENTINEL).all()),
               ("interleave_values", label))
        expect(same(sp_ops.interleave_values(x, m)[written], want[written]),
               ("interleave_values wrapper", label))
        routes.add(sp_ops.interleave_vec(x, m))
    return routes


def check_launch_stream() -> str:
    """The single-card half of the launch routing (``kernels.launch``): a
    wrapper called inside a side stream of its tensors' card hands the C
    entry point that stream, with that card current (no guard entered),
    and its output equals the plain version once the stream is
    synchronized.  Returns the line to print."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref

    dev = torch.device("cuda", torch.cuda.current_device())
    words = torch.randint(-2**31, 2**31 - 1, (8, 65536), device=dev,
                          dtype=torch.int64).to(torch.int32)
    side = torch.cuda.Stream(dev)
    seen, real = [], kernels.cfunc

    def cfunc(name, argtypes):
        fn = real(name, argtypes)

        def call(*args):
            seen.append((args[-1], torch.cuda.current_device()))
            return fn(*args)
        return call

    torch.cuda.synchronize()
    kernels.cfunc = cfunc
    try:
        with torch.cuda.stream(side):
            got = bp_ops.unpack_planes(words, 1)
    finally:
        kernels.cfunc = real
    side.synchronize()
    if seen != [(side.cuda_stream, dev.index)]:
        raise AssertionError(f"launch routing: the C call took (stream, current device) "
                             f"{seen}, want [({side.cuda_stream}, {dev.index})]")
    expect(same(got, bp_ref.unpack_planes(words, 1)), "unpack in a side stream")
    return (f"launch routing: unpack inside a side stream of {dev} launched on that stream "
            f"with {dev} current (no guard), output exact")


def check_ragged() -> None:
    """Exact kernel-vs-plain agreement on small ragged shapes: pack,
    popcount_planes, interleave_values and popcount_blocks on inputs that
    take both of their routes (16-byte vectors and scalars), frontier_mask
    beside them; unpack, popcount_words; the SpMV kernels on SPMV_CASES."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref
    from repro_torch.kernels.popcount import ops as pc_ops, ref as pc_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    routes = {"pack": set(), "popcount_planes": set()}
    for label, vals, b in pack_ragged_inputs(gen, dev):
        expect(same(bp_ops.pack_planes(vals, b), bp_ref.pack_planes(vals, b)), ("pack", label))
        if b < 32:
            routes["pack"].add(kernels.vec_rows(vals))
    for label, words in popcount_ragged_inputs(gen, dev):
        expect(same(pc_ops.popcount_planes(words), pc_ref.popcount_planes(words)),
               ("popcount_planes", label))
        routes["popcount_planes"].add(kernels.vec_rows(words))
    routes["interleave_values"] = check_helpers_ragged(dev)
    expect(all(r == {0, 1} for r in routes.values()), ("both routes launched", routes))
    for label, w, b in unpack_ragged_inputs(gen, dev):
        expect(same(bp_ops.unpack_planes(w, b), bp_ref.unpack_planes(w, b)), ("unpack", label))
    words = torch.randint(-2**31, 2**31 - 1, (5, 1500), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    expect(same(pc_ops.popcount_words(words), pc_ref.popcount_words(words)), 'popcount_words')
    routes["popcount_blocks"] = set()
    for label, w in blocks_ragged_inputs(gen, dev):
        expect(same(pc_ops.popcount_blocks(w), pc_ref.popcount_blocks(w)),
               ("popcount_blocks", label))
        routes["popcount_blocks"].add(int(w.data_ptr() % 16 == 0 and w.numel() >= 1024))
    expect(routes["popcount_blocks"] == {0, 1}, ("popcount_blocks routes", routes))
    check_spmv_cases("cuda")


#: the ELL kernels' ragged inputs: (label, planes, K, rows, frontier density,
#: unreached share, slab handed over 4 bytes into its buffer).  Planes 1, 3,
#: 8, 9, 17 cross the mask's byte and pass boundaries; K = 8 and 64 take the
#: 16-byte slab loads, K = 1 and 13 and the offset views the scalar ones.
SPMV_CASES = [
    *((f"B={b} K={k}", b, k, 1000 + 97 * b + k, 0.2, 0.5, False)
      for b in (1, 3, 8, 9, 17) for k in (1, 8, 13, 64)),
    ("empty frontier", 8, 8, 3001, 0.0, 0.5, False),
    ("full frontier", 8, 8, 3001, 1.0, 0.5, False),
    ("pull: every row reached", 8, 8, 3001, 0.2, 0.0, False),
    ("pull: no row reached", 9, 8, 3001, 0.2, 1.0, False),
    ("offset view B=8 K=8", 8, 8, 2000, 0.2, 0.5, True),
    ("offset view B=3 K=64", 3, 64, 500, 0.2, 0.5, True),
    ("offset view B=1 K=8", 1, 8, 2000, 0.2, 0.5, True),
    ("B=11 K=13", 11, 13, 3001, 0.2, 0.5, False),
    ("77 rows, fewer than a block", 3, 1, 77, 0.2, 0.5, False),
]
SPMV_N_REAL = 4500  # columns; the slab's sentinel, n_cols pads it to 5,120
SPMV_BASES = ((0, 0), (123457, 98765))
SPMV_MAX_WEIGHT = 29


def spmv_case(i: int) -> dict:
    """Case ``i`` of SPMV_CASES as numpy arrays from seed ``i``: a slab with
    30% sentinel slots, its first third of rows sorted and the rest not,
    every 7th row of the rest all sentinels; frontier and unreached bits;
    values (n_x = SPMV_N_REAL - 10 < n_cols, so the tail reads INF) with
    every 7th column at INF - 0..39 (minplus saturation at INF - w)."""
    label, planes, k, n_rows, density, unreached, offset = SPMV_CASES[i]
    rng = np.random.default_rng(i)
    n = SPMV_N_REAL
    nbr = rng.integers(0, n, size=(n_rows, k)).astype(np.int32)
    nbr[rng.random((n_rows, k)) < 0.3] = n
    nbr[:n_rows // 3].sort(axis=1)
    nbr[n_rows // 3::7] = n
    x = rng.integers(0, INF, size=(planes, n - 10)).astype(np.int32)
    x[:, ::7] = INF - rng.integers(0, 40, size=x[:, ::7].shape)
    return {"label": label, "nbr": nbr, "offset": offset,
            "f_bits": rng.random((planes, n)) < density,
            "u_bits": rng.random((planes, n_rows)) < unreached, "x": x}


def spmv_case_tensors(case: dict, dev):
    """(nbr, f_words, u_words, x, n_cols) on ``dev``; an offset case's slab
    is a contiguous view 4 bytes into a larger buffer."""
    import torch
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref

    nbr = torch.from_numpy(case["nbr"]).to(dev)
    if case["offset"]:
        buf = torch.empty(nbr.numel() + 1, dtype=torch.int32, device=dev)
        buf[1:] = nbr.reshape(-1)
        nbr = buf[1:].view(nbr.shape)
    f = bp_ops.pack_planes(torch.from_numpy(case["f_bits"]).to(dev), 1)
    u = bp_ops.pack_planes(torch.from_numpy(case["u_bits"]).to(dev), 1)
    return nbr, f, u, torch.from_numpy(case["x"]).to(dev), bp_ref.chunk_pad(SPMV_N_REAL)


def interleaved_columns(mask, n_x: int):
    """(groups, n_x) int32 set-bit counts of the mask bytes of the columns
    that hold values: ``interleave_values`` writes the columns whose count
    is nonzero (the value gather reads the copy of no other)."""
    import torch

    m = mask[:, :n_x].to(torch.int32)
    bits = sum((m >> q) & 1 for q in range(8))
    return torch.nn.functional.pad(bits, (0, n_x - bits.shape[1]))


def check_spmv_cases(dev) -> None:
    """Every SpMV wrapper on ``dev`` against its plain version, exactly, on
    every SPMV_CASES input: the frontier mask, push and pull over B planes
    and over plane 0, and the value gather (both ops, zero and nonzero
    bases, push and pull)."""
    import torch
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    for i in range(len(SPMV_CASES)):
        case = spmv_case(i)
        nbr, f, u, x, n_cols = spmv_case_tensors(case, dev)
        tag = (case["label"], tuple(nbr.shape), f.shape[0])
        expect(same(sp_ops.frontier_mask(f), sp_ref.frontier_mask(f)), ("mask", tag))
        mask = sp_ref.frontier_mask(f)
        written = interleaved_columns(mask, x.shape[1]) > 0
        expect(same(sp_ops.interleave_values(x, mask)[written],
                    sp_ref.interleave_values(x, mask)[written]), ("interleave", tag))
        expect(same(sp_ops.spmv_min_planes(nbr, f, n_cols),
                    sp_ref.spmv_min_planes(nbr, f, n_cols)), ("push", tag))
        expect(same(sp_ops.spmv_pull_min_planes(nbr, f, u, n_cols),
                    sp_ref.spmv_pull_min_planes(nbr, f, u, n_cols)), ("pull", tag))
        expect(same(sp_ops.spmv_min(nbr, f[0], n_cols), sp_ref.spmv_min(nbr, f[0], n_cols)),
               ("push one plane", tag))
        expect(same(sp_ops.spmv_pull_min(nbr, f[0], u[0], n_cols),
                    sp_ref.spmv_pull_min(nbr, f[0], u[0], n_cols)), ("pull one plane", tag))
        for op in ("copy", "minplus"):
            alg = _min_algebra(op, SPMV_MAX_WEIGHT)
            for base in SPMV_BASES:
                for uw in (None, u):
                    got = sp_ops.gspmm_planes(nbr, f, x, n_cols, alg, row_base=base[0],
                                              col_base=base[1], u_words=uw)
                    want = sp_ref.gspmm_min_planes(nbr, f, x, n_cols, op, SPMV_MAX_WEIGHT,
                                                   *base, uw)
                    expect(same(got, want), ("gspmm", op, base, uw is None, tag))
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _row(name, kern, plain, nbytes, ops_n, shape, reps=50, view=None) -> dict:
    """Check ``kern`` against ``plain`` exactly (on ``view`` of both, where
    given), time both (CUDA events, and the profiler's device time over as
    many calls) and bound the work: the larger of the bytes over the memory
    rate and the integer operations over the 32-bit scalar rate."""
    import torch
    from repro_torch import kernels

    a, b = kern(), plain()
    if view is not None:
        a, b = view(a), view(b)
    torch.cuda.synchronize()
    expect(same(a, b), (name, shape))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / ALU_OPS_PER_S * 1e3
    ms = time_ms(kern, reps)
    dev_ms, by_kernel = kernels.device_ms(kern, reps)
    return {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": None,
        "max_abs_err": int((a.to(torch.int64) - b.to(torch.int64)).abs().max()),
        "ms": ms, "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
        "plain_ms": time_ms(plain, 5), "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "shape": shape,
    }


#: the keys a kernel's other inputs keep in its JSON row
SUB_KEYS = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")


def brief(r: dict) -> dict:
    return {key: r[key] for key in SUB_KEYS}


def describe(r: dict, card: str, where: str = "") -> str:
    return (f"kernel {r['name']}{where}: exact at {r['shape']}; {r['ms'] * 1e3:.2f} us "
            f"(device {r['device_ms'] * 1e3:.2f} us) vs plain {r['plain_ms'] * 1e3:.2f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) on {card}")


def main_shape_rows(setup, roots):
    """Kernel vs plain version at the single-device path's shapes: B=8
    planes of the graph, its slab, and the frontier/unreached planes of a
    real batch at its densest level (timed) and at level 1 (a sparse
    frontier); the single-plane entries on plane 0.  Returns the rows and
    the single-device BFS of ``roots``."""
    import torch
    from repro_torch.core import bfs as bfsmod
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref
    from repro_torch.kernels.popcount import ops as pc_ops, ref as pc_ref
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    n = setup.g.n
    nbr = setup.block.nbr
    res = bfsmod.bfs(setup.src, setup.dst, roots, n, policy="direction_opt",
                     expand="hybrid", device="cuda", block=setup.block)
    level = res.level
    sizes = torch.stack([(level == d).sum() for d in range(1, res.n_levels + 1)])
    dense = int(sizes.argmax()) + 1
    n_cp = bp_ref.chunk_pad(n)
    r, k = nbr.shape
    rows = {}
    for d in sorted({1, dense}):
        frontier = level == d
        unreached = (level < 0) | (level > d)
        f = bp_ops.pack_planes(frontier, 1)
        u = bp_ops.pack_planes(unreached, 1)
        planes, wf, wu = frontier.shape[0], f.shape[1], u.shape[1]
        live = int(unreached.any(dim=0).sum())  # pull reads only these slab rows
        live0 = int(unreached[0].sum())
        shape = {"planes": planes, "n": n, "slab": [r, k], "level": d,
                 "frontier": int(frontier.sum()), "unreached": int(unreached.sum())}
        checks = {
            "pack": (lambda: bp_ops.pack_planes(frontier, 1),
                     lambda: bp_ref.pack_planes(frontier, 1),
                     planes * n + planes * wf * 4, 2 * planes * n_cp),
            "popcount_planes": (lambda: pc_ops.popcount_planes(f),
                                lambda: pc_ref.popcount_planes(f),
                                planes * wf * 4 + planes * 4, 2 * planes * wf),
            "spmv_min_planes": (lambda: sp_ops.spmv_min_planes(nbr, f, n_cp),
                                lambda: sp_ref.spmv_min_planes(nbr, f, n_cp),
                                r * k * 4 + planes * wf * 4 + planes * r * 4,
                                4 * r * k * planes),
            "spmv_min": (lambda: sp_ops.spmv_min(nbr, f[0], n_cp),
                         lambda: sp_ref.spmv_min(nbr, f[0], n_cp),
                         r * k * 4 + wf * 4 + r * 4, 4 * r * k),
            "spmv_pull_min_planes": (
                lambda: sp_ops.spmv_pull_min_planes(nbr, f, u, n_cp),
                lambda: sp_ref.spmv_pull_min_planes(nbr, f, u, n_cp),
                live * k * 4 + planes * (wf + wu) * 4 + planes * r * 4,
                4 * int(unreached.sum()) * k),
            "spmv_pull_min": (lambda: sp_ops.spmv_pull_min(nbr, f[0], u[0], n_cp),
                              lambda: sp_ref.spmv_pull_min(nbr, f[0], u[0], n_cp),
                              live0 * k * 4 + (wf + wu) * 4 + r * 4, 4 * live0 * k),
            # the words in, one byte per column out; shift, and, or per bit
            "frontier_mask": (lambda: sp_ops.frontier_mask(f), lambda: sp_ref.frontier_mask(f),
                              planes * wf * 4 + -(-planes // 8) * n_cp, 3 * planes * n_cp),
        }
        for name, (kern, plain, nbytes, ops_n) in checks.items():
            row = _row(name, kern, plain, nbytes, ops_n, shape)
            if d == dense:
                rows[name] = row
        if d == dense:
            f1 = f[:1]  # CC's single plane
            rows["popcount_planes"]["other_shapes"] = [brief(_row(
                "popcount_planes", lambda: pc_ops.popcount_planes(f1),
                lambda: pc_ref.popcount_planes(f1), wf * 4 + 4, 2 * wf,
                {**shape, "planes": 1}))]

    return rows, res


@contextlib.contextmanager
def capture_path_inputs(names=DIST_PATH):
    """Record the inputs the distributed path gives each of its kernels.

    While active, every call of a wrapper of ``names`` (DIST_PATH's, less
    the mask that runs inside the ELL wrappers) that launches its kernel
    is passed through; per kernel and distinct argument shapes the
    arguments of the call with the most nonzero entries in its data input
    (the frontier for the SpMV kernels) are kept.  Yields the dict
    ``(name, signature) -> args``."""
    import torch
    from repro_torch.kernels.bitpack import ops as bp_ops
    from repro_torch.kernels.popcount import ops as pc_ops
    from repro_torch.kernels.spmv import ops as sp_ops

    hooks = {"pack": (bp_ops, "pack_planes", 0), "unpack": (bp_ops, "unpack_planes", 0),
             "popcount_planes": (pc_ops, "popcount_planes", 0),
             "spmv_min_planes": (sp_ops, "spmv_min_planes", 1),
             "spmv_pull_min_planes": (sp_ops, "spmv_pull_min_planes", 1)}
    hooks = {name: hook for name, hook in hooks.items() if name in names}
    kept, weights = {}, {}

    def recorder(name, fn, data):
        def run(*args):
            if args[data].numel() and not (name in ("pack", "unpack") and args[1] == 32):
                sig = (name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                                   for a in args),
                       str(args[0].dtype))
                w = int(torch.count_nonzero(args[data]))
                if w >= weights.get(sig, -1):
                    kept[sig], weights[sig] = args, w
            return fn(*args)
        return run

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in hooks.values()]
    for name, (mod, attr, data) in hooks.items():
        setattr(mod, attr, recorder(name, getattr(mod, attr), data))
    try:
        yield kept
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def kept_rows(kept) -> dict:
    """Every kernel against its plain version on the inputs one distributed
    batch gave it (``capture_path_inputs``), timed beside its bound.
    Returns name -> rows, the one moving the most bytes first."""
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref
    from repro_torch.kernels.popcount import ops as pc_ops, ref as pc_ref
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    fns = {"pack": (bp_ops.pack_planes, bp_ref.pack_planes),
           "unpack": (bp_ops.unpack_planes, bp_ref.unpack_planes),
           "popcount_planes": (pc_ops.popcount_planes, pc_ref.popcount_planes),
           "spmv_min_planes": (sp_ops.spmv_min_planes, sp_ref.spmv_min_planes),
           "spmv_pull_min_planes": (sp_ops.spmv_pull_min_planes,
                                    sp_ref.spmv_pull_min_planes)}

    def work(name, args, out):  # (bytes moved, integer operations)
        if name == "pack":
            x = args[0]
            return x.numel() * x.element_size() + out.numel() * 4, 2 * x.numel()
        if name == "unpack":
            return args[0].numel() * 4 + out.numel() * out.element_size(), 2 * out.numel()
        if name == "popcount_planes":
            return args[0].numel() * 4 + out.numel() * 4, 2 * args[0].numel()
        nbr, f = args[0], args[1]
        r, k = nbr.shape
        if name == "spmv_min_planes":
            return r * k * 4 + f.numel() * 4 + out.numel() * 4, 4 * r * k * f.shape[0]
        unreached = bp_ref.unpack_planes(args[2], 1)[:, :r]
        live = int(unreached.any(dim=0).sum())  # pull reads only these slab rows
        return (live * k * 4 + (f.numel() + args[2].numel()) * 4 + out.numel() * 4,
                4 * int(unreached.sum()) * k)

    rows: dict[str, list] = {}
    for (name, sig, dtype), args in sorted(kept.items(), key=lambda kv: str(kv[0])):
        kern, plain = fns[name]
        nbytes, ops_n = work(name, args, kern(*args))
        row = _row(name, lambda: kern(*args), lambda: plain(*args), nbytes, ops_n,
                   {"args": [list(a) if isinstance(a, tuple) else a for a in sig],
                    "dtype": dtype})
        rows.setdefault(name, []).append(row)
    for name in rows:
        rows[name].sort(key=lambda r: r["bound_ms"], reverse=True)
    return rows


def dist_shape_rows(kept, level, s) -> dict:
    """``kept_rows`` of the auto path's inputs, and unpack on a 16-bit id
    stream at cap 16,384 (a bucket of the column ladder at s = 2**20) of
    the level-1 frontier."""
    import torch
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref

    rows = kept_rows(kept)
    ids, counts = bp_ops.compact_ids(level[:, :s] == 1, 16384, fill=s)  # rank 0's chunk
    low = (bp_ops.gaps_from_sorted(ids, counts) & 0xFFFF).to(torch.int32)
    id_words = bp_ops.pack_planes(low, 16)
    rows["unpack"].append(_row(
        "unpack", lambda: bp_ops.unpack_planes(id_words, 16),
        lambda: bp_ref.unpack_planes(id_words, 16),
        id_words.numel() * 4 + id_words.numel() * 2 * 4, 2 * id_words.numel() * 2,
        {"args": [list(id_words.shape), 16], "dtype": "torch.int32", "cap": 16384,
         "level": 1}))
    payload = torch.randint(0, 2**31 - 1, (level.shape[0], 16384), device="cuda",
                            dtype=torch.int32)
    expect(bp_ops.unpack_planes(payload, 32) is payload, "unpack b=32 is the identity")
    for name in rows:
        rows[name].sort(key=lambda r: r["bound_ms"], reverse=True)
    return rows


def require_launched(counts: dict, kernels_of_path, path: str) -> None:
    missing = [k for k in kernels_of_path if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of the {path} path never launched: {missing}")


def require_no_children() -> None:
    """Every process this one started has ended and been reaped."""
    from repro_torch.comm.procgrid import require_no_children as check

    check()


@contextlib.contextmanager
def capture_blocks():
    """While active, keep every input the path gives ``popcount_blocks``."""
    from repro_torch.kernels.popcount import ops as pc_ops

    kept = []
    real = pc_ops.popcount_blocks

    def run(words):
        kept.append(words)
        return real(words)

    pc_ops.popcount_blocks = run
    try:
        yield kept
    finally:
        pc_ops.popcount_blocks = real


def check_local_count() -> None:
    """The density oracle's ``local_count`` on the card equals the sum of its
    bits: n not a multiple of the 1024-bit chunk, packed words not a multiple
    of the 1024-word block, and a scale-22 plane; densities 0 to 1."""
    import torch
    from repro_torch.core import traversal

    gen = torch.Generator(device="cuda").manual_seed(6)
    for n in (3000, 33 * 1024, 1 << 22):
        oracle = traversal.DensityOracle(n)
        for density in (0.0, 0.01, 0.5, 1.0):
            bits = torch.rand(n, generator=gen, device="cuda") < density
            got = oracle.local_count(bits)
            expect(got.dtype == torch.int32 and got.device.type == "cuda"
                   and int(got) == int(bits.sum()), ("local_count", n, density, int(got)))


def blocks_row(words, shape) -> dict:
    """``popcount_blocks`` against its plain version at the study path's own
    input (``words``: a level's frontier packed by ``local_count``), and at
    BLOCK_INPUTS (random words, seed 5), each timed beside its byte bound
    (every word read once, one int32 written a block).  The one-block time
    is the row's ``floor``: the launch's fixed cost on this card.  Returns
    the main row and the others."""
    import torch
    from repro_torch.kernels.popcount import ops as pc_ops, ref as pc_ref

    def row(w, shape):
        blocks = -(-w.numel() // pc_ref.BLOCK_WORDS)
        return _row("popcount_blocks", lambda: pc_ops.popcount_blocks(w),
                    lambda: pc_ref.popcount_blocks(w), w.numel() * 4 + blocks * 4,
                    2 * w.numel(), {"words": w.numel(), **shape})

    main = row(words, shape)
    gen = torch.Generator(device="cuda").manual_seed(5)
    others = [row(torch.randint(-2**31, 2**31 - 1, (w,), generator=gen, device="cuda",
                                dtype=torch.int64).to(torch.int32), {"input": what})
              for what, w in BLOCK_INPUTS.items()]
    main["floor_ms"], main["floor_device_ms"] = others[0]["ms"], others[0]["device_ms"]
    main["other_shapes"] = [brief(r) for r in others]
    return main, others


def print_study(profile: dict, rows: list, frontier, repeat: int, scale, card) -> None:
    """The Fig 5.2 / Table 5.3 rows of ``profile`` and the Table 5.4 / 5.5
    rows of the codec study, the C/D speeds labelled with the host CPU."""
    from repro_torch.bench import codecs as study_codecs, frontier_stats

    print(f"frontier study (Fig 5.2 / Table 5.3), scale {scale} root {profile['root']}: "
          f"n={profile['n']:,} m={profile['m']:,} {profile['n_levels']} levels, each "
          f"level's count by local_count (pack + popcount_blocks) on {card}")
    for line in frontier_stats.rows(profile):
        print(f"  {line}")
    print(f"codec study (Tables 5.4 / 5.5), scale {scale} root {profile['root']}: frontier "
          f"stream = level {STUDY_LEVEL}, {frontier.size:,} ids; zipf-index stream "
          f"{study_codecs.zipf_index_stream().size:,} values; C/D speeds in MI/s on the "
          f"host CPU {study_codecs.host_cpu()} (not the card), {repeat} repeats")
    for line in study_codecs.csv_lines(rows):
        print(f"  {line}")


def study_step(setup, roots, card) -> tuple[dict, dict]:
    """The paper's frontier and codec study (``repro_torch.bench.
    frontier_stats`` and ``.codecs``), with the launch counts zeroed before
    and read after: at the reference's defaults (scale STUDY_SCALE, seed 1,
    root 0), then on the scale-S graph already built, from the first of its
    valid roots.  ``local_count`` must launch ``popcount_blocks`` at least
    once a level.  Then ``popcount_blocks`` at the densest level's packed
    frontier (``blocks_row``) and ``local_count`` against the bit sums.
    Returns the path's launch counts and the kernel's JSON row."""
    from repro_torch import kernels
    from repro_torch.bench import codecs as study_codecs, frontier_stats
    from repro_torch.kernels.popcount import ref as pc_ref

    t0 = time.perf_counter()
    root = int(roots[0])
    on_setup = {"block": setup.block, "policy": "direction_opt", "expand": "hybrid"}
    kernels.reset_launches()
    small = frontier_stats.run(STUDY_SCALE, device="cuda")
    small_frontier = study_codecs.extract_frontier_stream(STUDY_SCALE, STUDY_LEVEL,
                                                          device="cuda")
    small_rows = study_codecs.run(STUDY_SCALE, frontier=small_frontier)
    with capture_blocks() as kept:
        big = frontier_stats.profile(setup.src, setup.dst, setup.g.n, setup.g.m, root,
                                     device="cuda", **on_setup)
    big_frontier = study_codecs.frontier_ids(setup.src, setup.dst, setup.g.n, root,
                                             STUDY_LEVEL, "cuda", **on_setup)
    big_rows = study_codecs.run(frontier=big_frontier, repeat=1)
    counts = dict(kernels.LAUNCHES)
    require_launched(counts, STUDY_PATH, "frontier study")
    levels = small["n_levels"] + big["n_levels"]
    if counts["popcount_blocks"] < levels:
        raise AssertionError(f"popcount_blocks launched {counts['popcount_blocks']} times "
                             f"over {levels} levels")
    print_study(small, small_rows, small_frontier, 3, STUDY_SCALE, card)
    print_study(big, big_rows, big_frontier, 1, setup.scale, card)
    print(f"launches on the study path ({levels} levels): {counts}")

    check_local_count()
    dense = max(range(len(kept)), key=lambda i: int(kept[i].count_nonzero()))
    words = kept[dense]
    row, others = blocks_row(words, {"input": f"level {dense + 1} of the scale-{setup.scale} "
                                              f"study, packed by local_count",
                                     "frontier": int(pc_ref.popcount_blocks(words).sum())})
    for r in (row, *others):
        print(describe(r, card))
    print("local_count on the card (n = 3,000, 33 x 1,024, 2**22; densities 0, 0.01, 0.5, 1): "
          "equal to the bit sums")
    print(f"study step: {time.perf_counter() - t0:.1f}s")
    return counts, row


def distributed_step(setup, roots, single, card) -> dict:
    """The distributed path at full width: the scale-S graph on a simulated
    2x2 grid, auto + direction_opt + hybrid on DIST_ROOTS roots in batches
    of 8 with the launch counts zeroed before and read after.  The first
    batch under raw runs first (and warms the path up); its bytes are
    printed beside auto's; then one auto batch records the inputs each
    kernel gets (``dist_shape_rows`` checks and times them).  Returns the
    path's launch counts, those rows and the grid set-up."""
    from repro_torch import kernels
    from repro_torch.bench import distributed
    from repro_torch.comm import SimGrid
    from repro_torch.launch import roofline

    t0 = time.perf_counter()
    st = distributed.setup(setup.g, SimGrid(*GRID, device="cuda"), "hybrid")
    print(f"distributed: {GRID[0]}x{GRID[1]} grid, partition {st.partition_s:.3f}s "
          f"containers {st.containers_s:.3f}s (chunk s={st.bg.part.chunk:,}, "
          f"block edges {st.bg.e_counts.ravel().tolist()})")
    droots = roots[:DIST_ROOTS]
    with roofline.count_collectives(st.grid) as raw_counted:
        raw = distributed.search(st, droots[:8], batch=8, mode="raw", validate_trees=False)
    with capture_path_inputs() as kept:
        distributed.search(st, droots[:8], batch=8, mode="auto", policy="direction_opt",
                           validate_trees=False)
    # the mask kernel runs inside the ELL wrappers, on their frontier words
    missing = sorted(set(DIST_PATH) - {"frontier_mask"} - {name for name, _, _ in kept})
    if missing:
        raise AssertionError(f"the distributed path gave no input to {missing}")
    rows = dist_shape_rows(kept, single.level, st.bg.part.chunk)
    del kept
    for name, rs in rows.items():
        for r in rs:
            print(describe(r, card, " (distributed, rank inputs)"))
    kernels.reset_launches()
    with roofline.count_collectives(st.grid) as auto_counted:
        out = distributed.search(st, droots, batch=8, mode="auto", policy="direction_opt")
    counts = dict(kernels.LAUNCHES)
    print(f"launches on the distributed path ({sum(out['depths'])} levels over "
          f"{len(out['depths'])} batches): {counts}")
    require_launched(counts, DIST_PATH, "distributed")
    if out["n_valid"] != out["n_roots"]:
        raise AssertionError(f"invalid distributed trees: {out['failures']}")
    n = setup.g.n
    parent, level = out["trees"][0]
    if not (np.array_equal(parent, single.parent[:, :n].cpu().numpy())
            and np.array_equal(level, single.level[:, :n].cpu().numpy())):
        raise AssertionError("distributed first batch differs from the single-device run")
    if not (np.array_equal(raw["trees"][0][0], parent)
            and np.array_equal(raw["trees"][0][1], level)):
        raise AssertionError("raw and auto wire plans give different trees")
    print(f"distributed scale {setup.scale} (auto, direction_opt, hybrid): "
          f"{out['n_valid']}/{out['n_roots']} trees valid, first batch equal to the "
          f"single-device run; batches {[round(t, 4) for t in out['batch_s']]} s, depths "
          f"{out['depths']}; TEPS harmonic mean {out['teps_harmonic_mean']:.6e} "
          f"({GRID[0] * GRID[1]} ranks simulated on one card, not a multi-card figure) "
          f"on {card}")
    auto_z = distributed.zone_bytes(out["stats"][:1])
    raw_z = distributed.zone_bytes(raw["stats"])
    print("bytes over links, all ranks, first batch (raw vs auto, ratio raw/auto):")
    for zone in sorted(set(auto_z) | set(raw_z)):
        a, r = sum(auto_z.get(zone, {}).values()), sum(raw_z.get(zone, {}).values())
        ratio = f"{r / a:.3f}" if a else "-"
        print(f"  {zone:18s} raw {r:>14,}  auto {a:>14,}  ratio {ratio}  "
              f"auto formats {auto_z.get(zone, {})}")
    total_a = sum(sum(z.values()) for z in auto_z.values())
    total_r = sum(sum(z.values()) for z in raw_z.values())
    print(f"  {'total':18s} raw {total_r:>14,}  auto {total_a:>14,}  ratio "
          f"{total_r / total_a:.3f}")
    print(f"distributed step: {time.perf_counter() - t0:.1f}s")
    counted = {"raw": (raw["stats"], raw_counted), "auto": (out["stats"], auto_counted)}
    return counts, rows, st, out, counted


def print_zones(plans: dict) -> None:
    """Bytes over links, all ranks, per zone (the butterfly's stage zones
    apart, then their sum) for each plan's ledgers, the first plan's
    formats beside."""
    from repro_torch.bench import bfs_comm, distributed

    by_plan = {plan: distributed.zone_bytes(ledgers) for plan, ledgers in plans.items()}
    names = sorted(set().union(*by_plan.values()))
    head = "  ".join(f"{plan:>14s}" for plan in by_plan)
    print(f"  {'zone':26s} {head}  formats ({next(iter(by_plan))})")
    for zone in names:
        vals = "  ".join(f"{sum(z.get(zone, {}).values()):>14,}" for z in by_plan.values())
        print(f"  {zone:26s} {vals}  {next(iter(by_plan.values())).get(zone, {})}")
    staged = sorted({bfs_comm.split_phase(z)[0] for z in names if bfs_comm.split_phase(z)[1]})
    for zone in staged:
        sums = [sum(sum(v.values()) for k, v in z.items() if bfs_comm.split_phase(k)[0] == zone)
                for z in by_plan.values()]
        print(f"  {zone + ' (all stages)':26s} " + "  ".join(f"{v:>14,}" for v in sums))
    totals = [sum(sum(z.values()) for z in zb.values()) for zb in by_plan.values()]
    print(f"  {'total':26s} " + "  ".join(f"{t:>14,}" for t in totals))


def ledger_check(card) -> None:
    """The btfly ledger on the card against the host replay at LEDGER_SCALE
    on the 2x2 grid, LEDGER_BATCH hub roots, every policy: zone for zone
    and stage for stage (``bench.bfs_comm.device_terms`` against
    ``replay_terms`` of ``simulate_batch``); then the replay's BENCH_comm
    document at that size passes ``bench.check_comm``."""
    from repro_torch.bench import bfs_comm, check_comm
    from repro_torch.bench import run as bench_run
    from repro_torch.comm import CommStats, SimGrid
    from repro_torch.core import bfs as bfsmod, csr
    from repro_torch.core import distributed_bfs as dbfs

    r, c = GRID
    prebuilt = bfs_comm.build_replay_graph(LEDGER_SCALE, r, c)
    g = prebuilt[0]
    roots = bfsmod.hub_roots(g.degrees(), LEDGER_BATCH)
    levels = {}
    rep = {p: bfs_comm.simulate_batch(LEDGER_SCALE, r, c, LEDGER_BATCH, policy=p, graph=g,
                                      level_cache=levels)
           for p in bfs_comm.POLICIES}
    depth = max(int(levels[int(x)].max()) for x in roots)
    grid = SimGrid(r, c, "cuda")
    bg = csr.partition_2d(g, r, c)
    blocks = dbfs.shard_blocked(grid, bg, dbfs.DistBFSConfig(expand="hybrid"))
    for policy in bfs_comm.POLICIES:
        stats = CommStats()
        cfg = dbfs.DistBFSConfig(mode="btfly", policy=policy, expand="hybrid",
                                 max_levels=depth)
        dbfs.build_bfs(grid, bg, cfg, stats=stats)(*blocks, roots)
        got = bfs_comm.device_terms(stats, r, c)
        want = bfs_comm.replay_terms(rep[policy], "btfly", bg.part.chunk)
        if got != want or not got["stages"]:
            raise AssertionError(f"btfly ledger ({policy}) differs from the replay: "
                                 f"{got} != {want}")
        print(f"ledger scale {LEDGER_SCALE} 2x2 B={LEDGER_BATCH} btfly {policy} on {card}: "
              f"row {got['row_bytes']:,} B, consensus {got['consensus_bytes']:,} B, "
              f"{len(got['stages'])} (zone, stage, format) sums: equal to the host replay")
    table, policy_levels = bfs_comm.run(LEDGER_SCALE, r, c, prebuilt=prebuilt)
    batch = bfs_comm.run_batch(LEDGER_SCALE, r, c, prebuilt=prebuilt)
    n_stages, n_batch = check_comm.verify(bench_run.bench_comm_doc(
        LEDGER_SCALE, r, c, table, policy_levels, batch))
    print(f"check_comm on the scale-{LEDGER_SCALE} document: {n_stages} stage and {n_batch} "
          "batch entries within the static byte model")


def btfly_step(setup, roots, single, st, auto, card) -> tuple[dict, dict]:
    """The butterfly wire plan on the distributed path's 2x2 set-up ``st``:
    one batch records the inputs it gives pack and unpack (held against
    their plain versions and timed), then DIST_ROOTS roots in batches of 8
    under btfly + direction_opt + hybrid with the launch counts zeroed
    before and read after, every tree valid and equal to ``auto``'s (and
    so, for the first batch, to the single-device run); the first batch
    again under top_down and bottom_up; the bytes per zone and stage, batch
    times, TEPS and idle share beside ``auto``'s; one batch on the 2x3 grid
    (fold, one stage, unfold) equal to the single-device run; one SSSP batch
    equal to auto's; and ``ledger_check``.  Returns the path's launch
    counts and the pack and unpack rows."""
    from repro_torch import kernels
    from repro_torch.bench import algebras, distributed, trace
    from repro_torch.comm import SimGrid
    from repro_torch.core import distributed_bfs as dbfs

    t0 = time.perf_counter()
    droots = roots[:DIST_ROOTS]
    n = setup.g.n
    with capture_path_inputs(("pack", "unpack")) as kept:
        distributed.search(st, droots[:8], batch=8, mode="btfly", policy="direction_opt",
                           validate_trees=False)
    rows = kept_rows(kept)
    del kept
    for name, rs in rows.items():
        for r in rs:
            print(describe(r, card, " (btfly, rank inputs)"))
    kernels.reset_launches()
    out = distributed.search(st, droots, batch=8, mode="btfly", policy="direction_opt")
    counts = dict(kernels.LAUNCHES)
    print(f"launches on the btfly path ({sum(out['depths'])} levels over "
          f"{len(out['depths'])} batches): {counts}")
    require_launched(counts, DIST_PATH, "btfly")
    if out["n_valid"] != out["n_roots"]:
        raise AssertionError(f"invalid btfly trees: {out['failures']}")
    for k, ((p, lv), (pa, la)) in enumerate(zip(out["trees"], auto["trees"])):
        if not (np.array_equal(p, pa) and np.array_equal(lv, la)):
            raise AssertionError(f"btfly batch {k} differs from auto")
    for policy in ("top_down", "bottom_up"):
        other = distributed.search(st, droots[:8], batch=8, mode="btfly", policy=policy,
                                   validate_trees=False)
        if not all(np.array_equal(a, b) for a, b in zip(other["trees"][0], out["trees"][0])):
            raise AssertionError(f"btfly {policy} differs from btfly direction_opt")
    print(f"btfly scale {setup.scale} (direction_opt, hybrid, 2x2): {out['n_valid']}/"
          f"{out['n_roots']} trees valid, every batch equal to auto's and the first to the "
          f"single-device run; top_down and bottom_up equal too")
    idle = {}
    for mode in ("auto", "btfly"):
        fn = dbfs.build_bfs(st.grid, st.bg, dbfs.DistBFSConfig(
            mode=mode, policy="direction_opt", expand="hybrid"))
        idle[mode] = trace.idle_share(lambda: fn(*st.blocks, droots[8:16]))
    ranks = f"{GRID[0] * GRID[1]} ranks simulated on one card, not a multi-card figure"
    for mode, o in (("auto", auto), ("btfly", out)):
        print(f"  {mode:6s} batches {[round(t, 4) for t in o['batch_s']]} s, TEPS harmonic "
              f"mean {o['teps_harmonic_mean']:.6e}; traced batch wall "
              f"{idle[mode]['wall_ms']:.3f} ms, busy {idle[mode]['busy_ms']:.3f} ms, idle "
              f"share {idle[mode]['idle_share']:.4f} ({ranks}) on {card}")
    print("bytes over links, all ranks, first batch (auto vs btfly):")
    print_zones({"auto": auto["stats"][:1], "btfly": out["stats"][:1]})

    st3 = distributed.setup(setup.g, SimGrid(*BTFLY_C3, device="cuda"), "hybrid",
                            chunk_multiple=BTFLY_C3_CHUNK_MULTIPLE)
    c3 = distributed.search(st3, droots[:8], batch=8, mode="btfly", policy="direction_opt",
                            validate_trees=False)
    del st3
    if not (np.array_equal(c3["trees"][0][0], single.parent[:, :n].cpu().numpy())
            and np.array_equal(c3["trees"][0][1], single.level[:, :n].cpu().numpy())):
        raise AssertionError("btfly on the 2x3 grid differs from the single-device run")
    print(f"btfly 2x3 (chunk multiple {BTFLY_C3_CHUNK_MULTIPLE}: fold, one stage, unfold): "
          f"first batch equal to the single-device run in {c3['batch_s'][0]:.4f} s "
          f"(6 ranks simulated on one card); bytes over links, all ranks:")
    print_zones({"btfly 2x3": c3["stats"]})

    sssp = {mode: algebras.run_grid(st, "sssp", droots[:8], mode=mode)
            for mode in ("auto", "btfly")}
    a, b = sssp["auto"], sssp["btfly"]
    if not (same(a["value"], b["value"]) and same(a["level"], b["level"])
            and a["n_levels"] == b["n_levels"]):
        raise AssertionError("SSSP under btfly differs from auto")
    print(f"sssp btfly 2x2 (8 roots, top_down): equal to auto ({a['n_levels']} levels; "
          f"{b['batch_s']:.4f} s vs auto {a['batch_s']:.4f} s, 4 ranks simulated on one card)")
    ledger_check(card)
    print(f"btfly step: {time.perf_counter() - t0:.1f}s")
    return counts, rows


def procgrid_step(card) -> dict:
    """The process grid (``ProcessGrid``): GRID's ranks as 4 worker
    processes on the one card over gloo, at PROC_SCALE, one batch of 8
    roots per PROC_CASES entry after an uncounted warm-up, each worker's
    counts zeroed before and read after.  Every case equals ``SimGrid`` on
    the card (values, levels, level count, the merged ledger record for
    record), every tree is valid (SSSP: its certificate on the card), every
    kernel of the distributed path launched in each worker; the batch times
    and staging share are printed beside ``SimGrid``'s, and the first
    batch's ``tree_betweenness`` on the card equals the CPU's.  Returns the
    workers' launch counts, summed."""
    import torch

    from repro_torch.bench import algebras, distributed, graph500, teps
    from repro_torch.comm import SimGrid, procgrid
    from repro_torch.core import validate
    from repro_torch.core.centrality import tree_betweenness

    t0 = time.perf_counter()
    g = graph500.generate(PROC_SCALE, 16, 1)[0]
    roots = teps.valid_roots(g, 8, seed=2)
    spec = {"scale": PROC_SCALE, "roots": roots.tolist(), "cases": PROC_CASES,
            "warmup": PROC_CASES[:1]}
    t1 = time.perf_counter()
    procs = procgrid.spawn(distributed.proc_cases, *GRID, backend="gloo", device="cuda",
                           args=(spec,), timeout_s=300)
    spawn_s = time.perf_counter() - t1
    st = distributed.setup(g, SimGrid(*GRID, device="cuda"), "hybrid")
    distributed.run_case(st, roots, **PROC_CASES[0])  # the workers' warm-up
    sim = [distributed.run_case(st, roots, **case) for case in PROC_CASES]
    where = (f"{GRID[0] * GRID[1]} processes on one card over host memory (gloo), not a "
             "multi-card figure")
    src = torch.as_tensor(g.src, device="cuda")
    dst = torch.as_tensor(g.dst, device="cuda")
    for k, (case, want) in enumerate(zip(PROC_CASES, sim)):
        name = "/".join(case.values())
        got = procs[0]["cases"][k]
        if not (np.array_equal(got["value"], want["value"].cpu().numpy())
                and np.array_equal(got["level"], want["level"].cpu().numpy())):
            raise AssertionError(f"process grid {name}: planes differ from SimGrid")
        for proc in procs:
            c = proc["cases"][k]
            if c["n_levels"] != want["n_levels"]:
                raise AssertionError(f"process grid {name} rank {proc['rank']}: "
                                     f"{c['n_levels']} levels, SimGrid {want['n_levels']}")
            if c["stats"].table() != want["stats"].table():
                raise AssertionError(f"process grid {name} rank {proc['rank']}: merged "
                                     "ledger differs from SimGrid's")
        if case.get("algebra") == "sssp":
            failures = algebras.sssp_certificate(src, dst, g.n, roots,
                                                 torch.as_tensor(got["value"], device="cuda"))
        else:
            failures = [f"root {r}: {v.failures}" for r, v in (
                (int(r), validate.validate_bfs_tree(g, got["value"][i], int(r), got["level"][i]))
                for i, r in enumerate(roots)) if not v.ok]
        if failures:
            raise AssertionError(f"process grid {name}: invalid trees {failures[:4]}")
        staging = max(p["cases"][k]["staging_s"] for p in procs)
        print(f"process grid {name} scale {PROC_SCALE} 2x2 (8 roots, {want['n_levels']} "
              f"levels): equal to SimGrid (planes, level count, {len(want['stats'].records())} "
              f"ledger records), trees valid; batch {got['batch_s']:.4f} s ({where}) vs "
              f"SimGrid {want['batch_s']:.4f} s (4 ranks simulated in one process); staging "
              f"{staging:.4f} s, share {staging / got['batch_s']:.4f}, on {card}")
    for proc in procs:
        require_launched(proc["launches"], DIST_PATH + ALGEBRA_PATHS["sssp"],
                         f"process grid (rank {proc['rank']})")
    total: dict = {}
    for proc in procs:
        for name, n in proc["launches"].items():
            total[name] = total.get(name, 0) + n
    print(f"launches on the process grid, per worker: "
          f"{[proc['launches'] for proc in procs]}")
    parent, level = procs[0]["cases"][0]["value"], procs[0]["cases"][0]["level"]
    bc = tree_betweenness(torch.as_tensor(parent, device="cuda"),
                          torch.as_tensor(level, device="cuda"), g.n)
    if not torch.equal(bc.cpu(), tree_betweenness(parent, level, g.n)):
        raise AssertionError("tree_betweenness on the card differs from the CPU")
    top = torch.sort(bc, descending=True, stable=True).indices[:5].cpu().tolist()
    print(f"tree_betweenness on the card (8 trees, one index_add_ a level): equal to the "
          f"CPU; top vertices {top}, centrality {[float(bc[v]) for v in top]}")
    print(f"process grid step: {time.perf_counter() - t0:.1f}s (spawn and the workers' "
          f"runs {spawn_s:.1f}s) on {card}")
    return total


def cross_check(card) -> None:
    """Scale CHECK_SCALE: every policy on the card, single-device and on the
    2x2 grid under every wire plan, equals direction_opt on the CPU."""
    from repro_torch.bench import graph500, teps
    from repro_torch.comm import SimGrid
    from repro_torch.core import bfs as bfsmod, csr
    from repro_torch.core import distributed_bfs as dbfs

    small = graph500.build(CHECK_SCALE, 16, 1, "hybrid", "cuda")
    small_cpu = graph500.build(CHECK_SCALE, 16, 1, "hybrid", "cpu")
    sroots = teps.valid_roots(small.g, 8, seed=2)
    results = {}
    for policy in ("top_down", "bottom_up", "direction_opt"):
        r = bfsmod.bfs(small.src, small.dst, sroots, small.g.n, policy=policy,
                       expand="hybrid", device="cuda", block=small.block)
        results[f"cuda/{policy}"] = (r.parent.cpu(), r.level.cpu(), r.n_levels)
    r = bfsmod.bfs(small_cpu.src, small_cpu.dst, sroots, small_cpu.g.n,
                   policy="direction_opt", expand="hybrid", device="cpu",
                   block=small_cpu.block)
    results["cpu/direction_opt"] = (r.parent, r.level, r.n_levels)
    grid = SimGrid(*GRID, device="cuda")
    bg = csr.partition_2d(small.g, *GRID)
    n = small.g.n
    blocks = dbfs.shard_blocked(grid, bg, dbfs.DistBFSConfig(expand="hybrid"))
    for mode in ("raw", "bitmap", "auto", "btfly"):
        for policy in ("top_down", "bottom_up", "direction_opt"):
            cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand="hybrid")
            parent, level, depth = dbfs.build_bfs(grid, bg, cfg)(*blocks, sroots)
            results[f"cuda/2x2/{mode}/{policy}"] = (parent[:, :n].cpu(), level[:, :n].cpu(),
                                                    depth)
    base = results["cpu/direction_opt"]
    for key, (parent, level, depth) in results.items():
        if not (same(parent, base[0]) and same(level, base[1]) and depth == base[2]):
            raise AssertionError(f"{key} differs from cpu/direction_opt at scale "
                                 f"{CHECK_SCALE}")
    print(f"cross-check scale {CHECK_SCALE} on {card}: {len(results)} runs identical "
          f"{sorted(results)} (parents, levels, n_levels={base[2]})")
    for alg, aroots in (("sssp", sroots), ("cc", sroots[:1])):
        r = bfsmod.bfs(small_cpu.src, small_cpu.dst, aroots, n, policy="top_down",
                       expand="hybrid", device="cpu", block=small_cpu.block, algebra=alg,
                       max_levels=1024)
        base = (r.parent, r.level, r.n_levels)
        runs = {}
        for policy in ("top_down", "bottom_up", "direction_opt"):
            r = bfsmod.bfs(small.src, small.dst, aroots, n, policy=policy, expand="hybrid",
                           device="cuda", block=small.block, algebra=alg, max_levels=1024)
            runs[f"cuda/{policy}"] = (r.parent.cpu(), r.level.cpu(), r.n_levels)
            for mode in ("raw", "bitmap", "auto", "btfly"):
                cfg = dbfs.DistBFSConfig(mode=mode, policy=policy, expand="hybrid",
                                         algebra=alg, max_levels=1024)
                value, level, depth = dbfs.build_bfs(grid, bg, cfg)(*blocks, aroots)
                runs[f"cuda/2x2/{mode}/{policy}"] = (value[:, :n].cpu(), level[:, :n].cpu(),
                                                     depth)
        for key, (value, level, depth) in runs.items():
            if not (same(value, base[0]) and same(level, base[1]) and depth == base[2]):
                raise AssertionError(f"{alg} {key} differs from cpu/top_down at scale "
                                     f"{CHECK_SCALE}")
        print(f"cross-check {alg} scale {CHECK_SCALE} (B={len(aroots)}) on {card}: "
              f"{len(runs)} card runs identical to cpu/top_down (n_levels={base[2]})")


@contextlib.contextmanager
def capture_gspmm():
    """While active, keep a copy of the arguments of every min-reduce
    ``gspmm_planes`` call, one a level, under ``levels``; and the one with
    the most frontier bits set (the densest level the path gave it) as
    ``weight`` / ``args`` / ``kw``."""
    from repro_torch.kernels.popcount import ref as pc_ref
    from repro_torch.kernels.spmv import ops as sp_ops

    kept = {"levels": []}
    real = sp_ops.gspmm_planes

    def run(nbr, f_words, x, n_cols, alg, **kw):
        w = int(pc_ref.popcount_planes(f_words).sum())
        if alg.reduce == "min":
            call = {"weight": w, "args": (nbr, f_words.clone(), x.clone(), n_cols, alg),
                    "kw": kw}
            kept["levels"].append(call)
            if w >= kept.get("weight", -1):
                kept.update(call)
        return real(nbr, f_words, x, n_cols, alg, **kw)

    sp_ops.gspmm_planes = run
    try:
        yield kept
    finally:
        sp_ops.gspmm_planes = real


def _x_read(nbr, f, n_cols: int, u=None) -> int:
    """Value entries the gather needs: ``x[p, c]`` for each set bit ``c`` of
    frontier ``p`` that a row it still reads holds as a neighbour (every
    row in push; in pull, the rows unreached in plane ``p``)."""
    import torch

    from repro_torch.kernels.spmv import ref as sp_ref

    r = nbr.shape[0]
    bits = sp_ref.frontier_bit(f, torch.arange(n_cols, device=f.device), n_cols)
    if u is not None:
        live = sp_ref.frontier_bit(u, torch.arange(r, device=u.device), r)
    need = torch.zeros_like(bits)
    for p in range(bits.shape[0]):
        c = (nbr if u is None else nbr[live[p]]).reshape(-1).to(torch.int64)
        need[p, c[(c >= 0) & (c < n_cols)]] = True
    return int((need & bits).sum())


def gspmm_rows(kept, setup, st, kept_cc) -> tuple[dict, list, list]:
    """``gspmm_min_planes`` against its plain version on the inputs of a real
    SSSP level: the captured (8, n) push (minplus, and the same inputs with
    ``copy``), the pull with the level's unreached vertices, and the same
    level cut to one rank's column slice and slab on the grid (rank (1, 1),
    nonzero bases); and on CC's own single plane at its densest level.
    Returns the main row, the other single-device rows, the rank rows and
    the row of the values' interleaving kernel on the main input."""
    import torch
    from repro_torch.kernels.bitpack import ops as bp_ops, ref as bp_ref
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    nbr, f, x, n_cols, sssp = kept["args"]
    n = setup.g.n
    unreached = (x[:, :n] == INF).contiguous()
    level_shape = {"planes": x.shape[0], "n": n, "frontier": kept["weight"],
                   "unreached": int(unreached.sum())}

    def row(nbr, f, x, n_cols, op, u=None, bases=(0, 0), shape=None):
        alg = _min_algebra(op, sssp.max_weight)
        r, k = nbr.shape
        planes = x.shape[0]
        rows_read = r if u is None else int(bp_ref.unpack_planes(u, 1)[:, :r].any(0).sum())
        nbytes = (rows_read * k * 4 + f.numel() * 4 + _x_read(nbr, f, n_cols, u) * 4
                  + planes * r * 4 + (0 if u is None else u.numel() * 4))
        ops_n = rows_read * k * ((12 if op == "minplus" else 0) + 6 * planes)
        return _row("gspmm_min_planes",
                    lambda: sp_ops.gspmm_planes(nbr, f, x, n_cols, alg, row_base=bases[0],
                                                col_base=bases[1], u_words=u),
                    lambda: sp_ref.gspmm_min_planes(nbr, f, x, n_cols, op,
                                                    sssp.max_weight, *bases, u),
                    nbytes, ops_n, {**shape, "op": op, "slab": [r, k],
                                    "pull": u is not None, "bases": list(bases)})

    u = bp_ops.pack_planes(unreached, 1)
    main = row(nbr, f, x, n_cols, "minplus", shape=level_shape)
    mask = sp_ops.frontier_mask(f)
    interleave = interleave_rows(x, mask, level_shape)
    others = [row(nbr, f, x, n_cols, "copy", shape=level_shape),
              row(nbr, f, x, n_cols, "minplus", u, shape=level_shape),
              row(nbr, f, x, n_cols, "copy", u, shape=level_shape)]
    nbr1, f1, x1, n_cols1, _ = kept_cc["args"]
    others.append(row(nbr1, f1, x1, n_cols1, "copy",
                      shape={"planes": 1, "n": n, "frontier": kept_cc["weight"],
                             "algebra": "cc"}))
    part = st.bg.part
    i, j = 1, 1
    q = i * part.cols + j
    pad = part.n - n  # the grid's padded vertices: no frontier bit, INF values
    bits = torch.nn.functional.pad(bp_ops.unpack_planes(f, 1)[:, :n], (0, pad))
    x_all = torch.nn.functional.pad(x[:, :n], (0, pad), value=INF)
    f_col = bp_ops.pack_planes(bits[:, j * part.n_c:(j + 1) * part.n_c].contiguous(), 1)
    x_col = x_all[:, j * part.n_c:(j + 1) * part.n_c].contiguous()
    u_row = bp_ops.pack_planes((x_all[:, i * part.n_r:(i + 1) * part.n_r] == INF)
                               .contiguous(), 1)
    slab = st.blocks[2][q]
    bases = (i * part.n_r, j * part.n_c)
    rank_shape = {**level_shape, "rank": [i, j]}
    rank = [row(slab, f_col, x_col, part.n_c, op, uw, bases, rank_shape)
            for op in ("minplus", "copy") for uw in (None, u_row)]
    main["levels"] = layout_levels(kept["levels"])
    return main, others, rank, interleave


def x_sectors(mask, n_x: int) -> int:
    """The 32-byte sectors of x (8 columns of a plane, rows starting at a
    sector) that hold a value whose mask bit is set: what a sector-granular
    read of the set bits costs."""
    import torch

    m = mask[:, :n_x].to(torch.int32)
    m = torch.nn.functional.pad(m, (0, (-m.shape[1]) % 8))
    return sum(int(((m >> q) & 1).view(m.shape[0], -1, 8).any(-1).sum()) for q in range(8))


def interleave_rows(x, mask, shape) -> dict:
    """The interleave kernel against its plain version on the captured SSSP
    level (only the columns it writes compared), and on the same x under an
    all-set mask, where it computes the plane transpose: one PyTorch call,
    timed beside it as the row's library time (CUDA events and the
    profiler's device time).  Bound: the mask read once, the set bits of the
    columns it writes read once (4 bytes each) and their 32 bytes written
    once.  The row also carries the sector-granular floor of its input: the
    mask, the 32-byte sectors of x holding a set bit, the columns' 32 bytes."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    groups, n_x = mask.shape[0], x.shape[1]

    def row(m, what):
        copied = interleaved_columns(m, n_x)
        written = copied > 0
        columns, sectors = int(written.sum()), x_sectors(m, n_x)
        floor = m.numel() + 32 * sectors + 32 * columns
        return _row("interleave_values", lambda: sp_ops.interleave_values(x, m),
                    lambda: sp_ref.interleave_values(x, m),
                    m.numel() + int(copied.sum()) * 4 + columns * 32, 0,
                    {**shape, "mask": what, "x": list(x.shape), "columns": columns,
                     "set_bits": int(copied.sum()), "x_sectors": sectors, "floor_bytes": floor,
                     "floor_ms": floor / HBM_BYTES_PER_S * 1e3},
                    view=lambda t: t[written])

    main = row(mask, "sssp level")
    full = torch.full_like(mask, 0xFF)
    every = row(full, "all set")
    padded = torch.nn.functional.pad(x, (0, 0, 0, 8 * groups - x.shape[0]), value=INF)

    def library():
        return padded.view(groups, 8, n_x).transpose(1, 2).contiguous()

    expect(same(library(), sp_ops.interleave_values(x, full)), "interleave_values all set")
    main["library_ms"] = every["library_ms"] = time_ms(library, 50)
    every["library_device_ms"] = kernels.device_ms(library, 50)[0]
    main["library_input"] = "the all-set mask (other_shapes[0])"
    main["other_shapes"] = [{**brief(every), "library_ms": every["library_ms"],
                             "library_device_ms": every["library_device_ms"]}]
    return main


def layout_levels(calls) -> list[dict]:
    """The value gather at every level of the captured batch in both value
    layouts, each exact against the plain version: the wrapper's (in push
    at B > 1 the plane-interleaved copy, its time included) and the values
    read as they are.  Times by CUDA events and profiler device time."""
    from repro_torch import kernels
    from repro_torch.kernels.spmv import ops as sp_ops, ref as sp_ref

    levels = []
    for i, call in enumerate(calls):
        nbr, f, x, n_cols, alg = call["args"]
        rb, cb = call["kw"].get("row_base", 0), call["kw"].get("col_base", 0)
        op, mw = ("minplus", alg.max_weight) if alg.uses_weights else ("copy", 31)
        want = sp_ref.gspmm_min_planes(nbr, f, x, n_cols, op, mw, rb, cb)
        layouts = {
            "wrapper": lambda: sp_ops.gspmm_planes(nbr, f, x, n_cols, alg, row_base=rb,
                                                   col_base=cb),
            "as_is": lambda: sp_ops._gather(nbr, f, x, None, n_cols, op, mw, rb, cb,
                                            interleaved=False),
        }
        columns = int((interleaved_columns(sp_ops.frontier_mask(f), x.shape[1]) > 0).sum())
        entry = {"level": i + 1, "frontier": call["weight"], "columns": columns}
        for name, fn in layouts.items():
            expect(same(fn(), want), ("gspmm_min_planes layout", name, i + 1))
            entry[f"{name}_ms"] = time_ms(fn, 20)
            entry[f"{name}_device_ms"], entry[f"{name}_device_ms_by_kernel"] = \
                kernels.device_ms(fn, 20)
        levels.append(entry)
    return levels


def _scipy_graph(g):
    """The stored edges as a scipy matrix of their hashed SSSP weights."""
    import scipy.sparse as sp

    from repro_torch.core import algebra

    w = algebra.edge_weight(g.src, g.dst).astype(np.float64)
    return sp.csr_matrix((w, (g.src, g.dst)), shape=(g.n, g.n))


def algebra_step(setup, roots, st, card) -> tuple[dict, dict, dict]:
    """The frontier algebras at the smoke's scale (hybrid + top_down): the
    value kernel at the path's own inputs, then sssp / cc / pagerank on one
    device and on the 2x2 grid with their checks.  Returns the launch counts
    per path and the JSON rows of the value kernel and of its interleaving
    helper."""
    import torch
    from scipy.sparse import csgraph

    from repro_torch import kernels
    from repro_torch.bench import algebras, distributed
    from repro_torch.core import bfs as bfsmod

    t0 = time.perf_counter()
    g = setup.g
    aroots = {a: roots[:algebras.BATCH[a]] for a in algebras.ALGEBRAS}
    # an SSSP batch first (the warm-up): it records the densest level's
    # value-gather inputs
    with capture_gspmm() as kept:
        algebras.run_single(setup, "sssp", aroots["sssp"])
    with capture_gspmm() as kept_cc:
        algebras.run_single(setup, "cc", aroots["cc"])
    main, others, rank, interleave = gspmm_rows(kept, setup, st, kept_cc)
    del kept, kept_cc
    for r in [main, *others, *rank, interleave]:
        print(describe(r, card))
    for r in (interleave, *interleave["other_shapes"]):
        sh = r["shape"]
        lib = (f"; the transpose call {r['library_ms'] * 1e3:.2f} us (device "
               f"{r['library_device_ms'] * 1e3:.2f})" if "library_device_ms" in r else "")
        print(f"interleave_values, {sh['mask']} mask: {sh['columns']:,} columns written, "
              f"{sh['set_bits']:,} set bits in {sh['x_sectors']:,} 32-byte sectors of x; "
              f"sector-granular floor {sh['floor_bytes'] / 1e6:.3f} MB = "
              f"{sh['floor_ms'] * 1e3:.2f} us; kernel {r['ms'] * 1e3:.2f} us (device "
              f"{r['device_ms'] * 1e3:.2f}){lib} on {card}")
    for e in main["levels"]:
        copy = e["wrapper_device_ms_by_kernel"].get("interleave_values_kernel", 0.0)
        print(f"gspmm_min_planes sssp level {e['level']} ({e['frontier']} frontier bits in "
              f"{e['columns']} columns): "
              f"wrapper {e['wrapper_ms'] * 1e3:.2f} us (device "
              f"{e['wrapper_device_ms'] * 1e3:.2f}, copy {copy * 1e3:.2f}), values as they are "
              f"{e['as_is_ms'] * 1e3:.2f} us (device {e['as_is_device_ms'] * 1e3:.2f})")
    sums = {key: sum(e[key] for e in main["levels"]) * 1e3
            for key in ("wrapper_ms", "wrapper_device_ms", "as_is_ms", "as_is_device_ms")}
    print(f"gspmm_min_planes sssp batch, sum over levels: wrapper {sums['wrapper_ms']:.2f} us "
          f"(device {sums['wrapper_device_ms']:.2f}), values as they are "
          f"{sums['as_is_ms']:.2f} us (device {sums['as_is_device_ms']:.2f}) on {card}")
    main["other_shapes"] = [brief(r) for r in others]
    main["distributed_shapes"] = [brief(r) for r in rank]

    launches = {"algebras": {}, "algebras_grid": {}}
    single, grid = {}, {}
    for where, runs, fn in (("algebras", single, lambda a, r: algebras.run_single(setup, a, r)),
                            ("algebras_grid", grid, lambda a, r: algebras.run_grid(st, a, r))):
        for alg in algebras.ALGEBRAS:
            kernels.reset_launches()
            runs[alg] = fn(alg, aroots[alg])
            counts = dict(kernels.LAUNCHES)
            need = ALGEBRA_PATHS[alg]
            if where == "algebras_grid":
                need = need + ("unpack",)
            require_launched(counts, need, f"{alg} ({where})")
            for name, c in counts.items():
                launches[where][name] = launches[where].get(name, 0) + c
            print(f"{alg} ({where}, B={len(aroots[alg])}): {runs[alg]['n_levels']} levels, "
                  f"{runs[alg]['batch_s']:.4f} s, launches {counts} on {card}")

    failures = []
    for alg in algebras.ALGEBRAS:
        v = algebras.check(setup, alg, aroots[alg], single[alg])
        failures += [f"{alg}: {x}" for x in v["failures"]]
        if alg == "pagerank":
            print(f"pagerank: L1 {v['l1_to_float64']:.6e} to the float64 iteration "
                  f"({v['float64_iterations']} iterations; bound {algebras.PAGERANK_L1})")
    print(f"sssp: shortest-path certificates checked on the card for roots "
          f"{aroots['sssp'].tolist()}")
    root = int(aroots["sssp"][0])
    t1 = time.perf_counter()
    mat = _scipy_graph(g)
    dist = csgraph.dijkstra(mat, indices=root)
    dist = np.where(np.isinf(dist), INF, dist).astype(np.int64)
    if not np.array_equal(single["sssp"]["value"][0].cpu().numpy().astype(np.int64), dist):
        failures.append(f"sssp root {root} differs from scipy dijkstra")
    n_comp, comp = csgraph.connected_components(mat, directed=False)
    del mat
    mins = np.full(n_comp, g.n, np.int64)
    np.minimum.at(mins, comp, np.arange(g.n))
    if not np.array_equal(single["cc"]["value"][0].cpu().numpy(), mins[comp]):
        failures.append("cc differs from scipy connected_components")
    print(f"scipy: dijkstra from root {root} and connected_components ({n_comp:,} "
          f"components) checked in {time.perf_counter() - t1:.1f}s")

    for alg in ("sssp", "cc"):
        a, b = single[alg], grid[alg]
        if not (same(a["value"], b["value"]) and same(a["level"], b["level"])
                and a["n_levels"] == b["n_levels"]):
            failures.append(f"{alg}: the grid differs from one device")
    one = single["pagerank"]["value"]
    if st.bg.part.n != g.n:  # PageRank's 1/n: one device over the grid's padded n
        one = bfsmod.bfs(setup.src, setup.dst, aroots["pagerank"], st.bg.part.n,
                         expand="hybrid", device="cuda", algebra="pagerank",
                         max_levels=algebras.MAX_LEVELS["pagerank"]).parent[:, :g.n]
    l1 = float((one.double() - grid["pagerank"]["value"].double()).abs().sum())
    if l1 > PAGERANK_GRID_L1:
        failures.append(f"pagerank: grid vs one device L1 {l1} > {PAGERANK_GRID_L1}")
    print(f"grid vs one device: sssp and cc bit-identical; pagerank L1 {l1:.6e} "
          f"(bound {PAGERANK_GRID_L1})")
    if failures:
        raise AssertionError(f"algebra checks failed: {failures}")

    raw = algebras.run_grid(st, "sssp", aroots["sssp"], mode="raw")
    if not same(raw["value"], grid["sssp"]["value"]):
        raise AssertionError("sssp: raw and auto wire plans give different distances")
    auto_z = distributed.zone_bytes([grid["sssp"]["stats"]])
    raw_z = distributed.zone_bytes([raw["stats"]])
    print(f"sssp bytes over links, all ranks, first batch (raw {raw['batch_s']:.4f} s vs "
          f"auto {grid['sssp']['batch_s']:.4f} s):")
    for zone in sorted(set(auto_z) | set(raw_z)):
        a, r = sum(auto_z.get(zone, {}).values()), sum(raw_z.get(zone, {}).values())
        ratio = f"{r / a:.3f}" if a else "-"
        print(f"  {zone:20s} raw {r:>14,}  auto {a:>14,}  ratio {ratio}  "
              f"auto formats {auto_z.get(zone, {})}")
    total_a = sum(sum(z.values()) for z in auto_z.values())
    total_r = sum(sum(z.values()) for z in raw_z.values())
    print(f"  {'total':20s} raw {total_r:>14,}  auto {total_a:>14,}  ratio "
          f"{total_r / total_a:.3f}")
    for alg in ("cc", "pagerank"):
        z = distributed.zone_bytes([grid[alg]["stats"]])
        print(f"{alg} bytes over links, all ranks (auto): "
              f"{ {k: sum(v.values()) for k, v in sorted(z.items())} }")
    print(f"algebra step: {time.perf_counter() - t0:.1f}s")
    return launches, main, interleave


def check_quantize_ragged() -> None:
    """The quantize kernel against its plain version exactly on ragged
    inputs: N = 128, N not a multiple of 1024, an all-zero group, scales
    1e-3 to 1e3, 3, 7, 9 and 4,097 groups (not multiples of the G groups a
    warp takes a step), groups with a NaN, a +inf and a -inf (each dequantizes to
    NaN, as in the reference), and half-way values (a group with max 127,
    so scale 1.0: 0.5, 1.5, 2.5 give 0, 2, 2); a misaligned input raises."""
    import torch
    from repro_torch.kernels.quant import ops as q_ops, ref as q_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for n, scale in ((128, 1.0), (128 * 13, 1e-3), (1024 * 5 + 128 * 3, 1e3), (1024, 7.0)):
        cases.append(torch.randn(n, generator=gen, device="cuda") * scale)
    cases[-1][256:384] = 0.0  # an all-zero group
    for groups in (3, 7, 9, 4097):  # tails of the G groups a warp takes a step
        cases.append(torch.randn(128 * groups, generator=gen, device="cuda") * groups)
    bad = torch.randn(384, generator=gen, device="cuda")
    bad[5], bad[130], bad[300] = float("nan"), float("inf"), -float("inf")
    cases.append(bad)
    ties = torch.zeros(256, device="cuda")
    ties[:7] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    ties[128:131] = torch.tensor([-127.0, 63.5, 64.5])
    cases.append(ties)
    for x in cases:
        (q, s), (qr, sr) = q_ops.quantize(x), q_ref.quantize(x)
        expect(same_quant(q, s, qr, sr), ("quantize", x.numel()))
    q, s = q_ops.quantize(bad)  # the reference's answer, independently of the plain version
    expect(bool(s[0].isnan() and s[1:].isinf().all()
                and q_ops.dequantize(q, s).isnan().all()),
           ("quantize non-finite", s.tolist()))
    q, s = q_ops.quantize(ties)
    expect(q[:7].tolist() == [127, 0, 2, 2, 0, -2, -2] and q[128:131].tolist() == [-127, 64, 64]
           and s.tolist() == [1.0, 1.0], ("quantize ties", q[:7].tolist()))
    try:
        q_ops.quantize(cases[1][1:129])
    except ValueError:
        pass
    else:
        raise AssertionError("quantize took a misaligned input")
    torch.cuda.synchronize()


@contextlib.contextmanager
def capture_quantize():
    """While active, keep the last input of each distinct size that the
    path gives ``quantize``."""
    from repro_torch.kernels.quant import ops as q_ops

    kept = {}
    real = q_ops.quantize

    def run(x):
        kept[x.numel()] = x.detach()
        return real(x)

    q_ops.quantize = run
    try:
        yield kept
    finally:
        q_ops.quantize = real


def _quant_row(x, shape, reps=50) -> dict:
    """The quantize kernel against its plain version on ``x``: codes and
    scales equal, both timed, beside the byte bound (each value read once
    as float32 and written once as int8, one float32 scale per group)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.quant import ops as q_ops, ref as q_ref

    (q, s), (qr, sr) = q_ops.quantize(x), q_ref.quantize(x)
    torch.cuda.synchronize()
    expect(same_quant(q, s, qr, sr), ("quantize", shape))
    n = x.numel()
    bytes_ms = (4 * n + n + 4 * (n // q_ref.GROUP)) / HBM_BYTES_PER_S * 1e3
    ops_ms = QUANT_OPS_PER_VALUE * n / ALU_OPS_PER_S * 1e3
    err = max(int((q.to(torch.int32) - qr.to(torch.int32)).abs().max()),
              float((s - sr).abs().max()))
    ms = time_ms(lambda: q_ops.quantize(x), reps)
    dev_ms, by_kernel = kernels.device_ms(lambda: q_ops.quantize(x), reps)
    return {
        "name": "quantize", "route": "cuda", "source": SOURCES["quantize"],
        "replaces": REPLACES["quantize"], "launches": None, "max_abs_err": err,
        "ms": ms, "device_ms": dev_ms, "device_ms_by_kernel": by_kernel,
        "plain_ms": time_ms(lambda: q_ref.quantize(x), 5),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "shape": shape,
    }


def gnn_step(card) -> tuple[dict, dict]:
    """The 2D GNN forward at full width on the refinement-6 multimesh over a
    simulated 2x2 grid: the quantize kernel at the path's own inputs, then
    the counted requests and their checks.  Returns the path's launch counts
    and the kernel's JSON row."""
    from repro_torch import kernels
    from repro_torch.bench import gnn as gnn_bench

    t0 = time.perf_counter()
    st = gnn_bench.setup(device="cuda")
    part = st.bg.part
    print(f"gnn: {st.cfg.name} {st.cfg.n_layers} layers d_hidden {st.cfg.d_hidden} "
          f"d_in/out {st.cfg.d_in}/{st.cfg.d_out} on the refinement-{st.refine} multimesh "
          f"(n={st.n:,}, m={st.edges.shape[0]:,}) over a {GRID[0]}x{GRID[1]} grid: chunk "
          f"{part.chunk:,}, n_pad {part.n:,}, e_cap {st.bg.e_cap:,}, block edges "
          f"{st.bg.e_counts.ravel().tolist()}; multimesh + partition {st.mesh_s:.3f}s")
    with capture_quantize() as kept:
        gnn_bench.forward_2d(st, True)
    if not kept:
        raise AssertionError("the GNN path gave the quantize kernel no input")
    rows = []
    for n, x in sorted(kept.items()):
        what = ("owned chunk" if n == part.chunk * st.cfg.d_hidden else
                "all-to-all chunks" if n == part.chunk * part.cols * st.cfg.d_hidden else
                "payload")
        rows.append(_quant_row(x, {"n": n, "input": what}))
    del kept
    check_quantize_ragged()
    for r in rows:
        print(describe(r, card))
    print("ragged shapes: quantize (N = 128, 1,664, 5,504, 1,024 with a zero group, "
          "128 x 3, 7, 9, 4,097 groups, 384 with NaN/+inf/-inf groups, half-way values): "
          "exact")

    kernels.reset_launches()
    res = gnn_bench.run(st, requests=4)
    counts = dict(kernels.LAUNCHES)
    print(f"launches on the GNN path (1 warm-up + 4 int8 forwards, 1 fp32, single-device): "
          f"{counts}; per int8 forward {res['launches_per_forward']}")
    require_launched(counts, GNN_PATH, "GNN")
    if not res["finite"]:
        raise AssertionError("gnn: non-finite outputs")
    gap = res["fp32_vs_single_max_abs"] / res["single_max_abs"]
    if not gap <= GNN_FP32_REL:
        raise AssertionError(f"gnn: fp32 2D vs single-device max abs gap "
                             f"{res['fp32_vs_single_max_abs']} over max |out| "
                             f"{res['single_max_abs']} = {gap} > {GNN_FP32_REL}")
    if not res["int8_rel_l2"] < GNN_INT8_L2:
        raise AssertionError(f"gnn: int8 vs fp32 relative L2 {res['int8_rel_l2']} >= "
                             f"{GNN_INT8_L2}")
    print(f"gnn forwards: int8 {[round(t, 4) for t in res['int8_s']]} s, fp32 "
          f"{res['fp32_s']:.4f} s, single-device {res['single_s']:.4f} s "
          f"({GRID[0] * GRID[1]} ranks simulated on one card) on {card}")
    print(f"gnn payload bytes per forward (every rank's share of every exchange): int8 "
          f"{res['int8_payload_bytes']:,} vs fp32 {res['fp32_payload_bytes']:,} "
          f"({res['fp32_payload_bytes'] / res['int8_payload_bytes']:.3f}x)")
    print(f"gnn checks: int8 vs fp32 relative L2 {res['int8_rel_l2']:.6e} (bound "
          f"{GNN_INT8_L2}); fp32 2D vs single-device max abs {res['fp32_vs_single_max_abs']:.6e}"
          f" of max |out| {res['single_max_abs']:.6e} ({gap:.3e}, bound {GNN_FP32_REL})")
    print(f"gnn step: {time.perf_counter() - t0:.1f}s")
    main = rows[0]
    main["other_shapes"] = [brief(r) for r in rows[1:]]
    main["launches_per_forward"] = res["launches_per_forward"]
    return counts, main


def int8_mean_bound(xs) -> "torch.Tensor":
    """The largest error of ``allreduce_int8``'s mean of the per-rank (n,)
    vectors ``xs`` against their exact mean: each rank's 128-value groups
    quantized (half a step, max|group| / 254, each), the reduced chunk
    quantized again (half a step of its group, whose max is at most the
    exact sum's plus the first errors), over the group size; 0.1% for the
    float rounding of the sums and scales."""
    import torch

    def half_step(x):
        return (x.abs().reshape(-1, 128).amax(1) / 254).repeat_interleave(128)

    first = sum(half_step(x) for x in xs)
    total = torch.stack(xs).sum(0)
    second = ((total.abs() + first).reshape(-1, 128).amax(1) / 254).repeat_interleave(128)
    return 1.001 * (first + second) / len(xs)


def padded_batch(st, targets_np) -> dict:
    """The single-device loss batch over ``st``'s padded multimesh: every
    rank block's edges at their global ids (padding edges at the sentinel
    n), the fields, the positions (zero on the padded vertices) and the
    targets, on the grid's device."""
    import torch
    from repro_torch.models import gnn

    part, bg, dev = st.bg.part, st.bg, st.grid.device
    r, c = part.rows, part.cols
    src = np.where(bg.src_local < part.n_c,
                   bg.src_local + (np.arange(c) * part.n_c)[None, :, None], part.n).reshape(-1)
    dst = np.where(bg.dst_local < part.n_r,
                   bg.dst_local + (np.arange(r) * part.n_r)[:, None, None], part.n).reshape(-1)
    pos = np.zeros((part.n, 3), np.float32)
    pos[: st.n] = st.verts
    return {"graph": gnn.Graph(nf=torch.from_numpy(st.nf).to(dev),
                               src=torch.from_numpy(src).to(dev),
                               dst=torch.from_numpy(dst).to(dev),
                               pos=torch.from_numpy(pos).to(dev)),
            "targets": torch.from_numpy(targets_np).to(dev)}


def train_step(card) -> tuple[dict, list]:
    """The GNN training step at full width (4 layers) on the refinement-6
    multimesh over a simulated 2x2 grid, then over 4 processes: the six
    checks of the module docstring's step 12.  Returns the launch counts
    (the counted int8 steps and the int8 all-reduce; the process grid's
    workers summed apart) and the quantize rows at the train path's inputs."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.bench import gnn as gnn_bench, gnn_train, multicard
    from repro_torch.comm import CommStats, SimGrid, procgrid
    from repro_torch.comm.engine import AdaptiveExchange
    from repro_torch.comm.grid import ROW_AXIS, pmean_trees
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.optim import grad_compress
    from repro_torch.train import step as tstep

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    st = gnn_bench.setup(device="cuda", layers=TRAIN_LAYERS)
    grid, part, cfg = st.grid, st.bg.part, st.cfg
    targets_np = gnn_train.make_targets(part.n, cfg.d_out, 0)
    targets = gnn_dist.shard_targets(grid, targets_np, part)
    n_params = sum(x.numel() for x in tree.leaves(st.params))
    print(f"train: {cfg.name} {cfg.n_layers} layers (cut from 16) d_hidden {cfg.d_hidden} "
          f"d_in/out {cfg.d_in}/{cfg.d_out}, {n_params:,} parameters, cross-entropy over "
          f"{cfg.d_out} classes, on the refinement-{st.refine} multimesh (n={st.n:,}, "
          f"m={st.edges.shape[0]:,}) over a {GRID[0]}x{GRID[1]} grid: chunk {part.chunk:,}, "
          f"n_pad {part.n:,}, e_cap {st.bg.e_cap:,}")

    def value_and_grad(quantize):
        return gnn_dist.value_and_grad_2d(grid, cfg, st.params, st.h_own, st.src_l, st.dst_l,
                                          targets, part,
                                          gnn_dist.Dist2DConfig(quantize_payload=quantize))

    # 1. fp32 2D against single-device autograd over the padded multimesh
    value_and_grad(False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    loss32, per_rank, out32 = value_and_grad(False)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t1
    peak_2d = torch.cuda.max_memory_allocated()
    mean32 = pmean_trees(grid, per_rank)[0]
    sim32 = {"loss": float(loss32), "out": [o.cpu().numpy() for o in out32],
             "grads": [g.cpu().numpy() for g in tree.leaves(mean32)]}
    del out32
    batch = padded_batch(st, targets_np)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    loss1, grads1 = tstep.value_and_grad(lambda p, b: gnn.loss_fn(cfg, p, b), st.params, batch)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t1
    peak_1 = torch.cuda.max_memory_allocated()
    del batch
    want = tree.leaves(grads1)
    g_peak = max(float(w.abs().max()) for w in want)
    gaps = [float((a - w).abs().max()) / g_peak for a, w in zip(tree.leaves(mean32), want)]
    loss_gap = abs(float(loss32) - float(loss1)) / abs(float(loss1))
    if not (max(gaps) <= GNN_FP32_REL and loss_gap <= GNN_FP32_REL):
        raise AssertionError(f"train: fp32 2D vs single-device: loss {float(loss32)} vs "
                             f"{float(loss1)}, worst leaf gap {max(gaps)} of the gradients' "
                             f"peak {g_peak} > {GNN_FP32_REL}")
    print(f"train check 1: fp32 2D loss {float(loss32):.6f} vs single-device {float(loss1):.6f} "
          f"(rel {loss_gap:.3e}); gradients' worst leaf max abs gap {max(gaps):.3e} of their "
          f"peak {g_peak:.6e} (bound {GNN_FP32_REL}); forward+backward fp32 2D {fp32_s:.4f} s "
          f"(4 ranks simulated on one card), single-device {single_s:.4f} s; peak memory 2D "
          f"{peak_2d / 2**30:.2f} GiB, single-device {peak_1 / 2**30:.2f} GiB, on {card}")
    del grads1, want

    # 4. the quantize kernel at the train path's inputs
    with capture_quantize() as kept:
        value_and_grad(True)
    kept_rows = {n: x for n, x in kept.items()}
    del kept

    # 2 and 3. the int8 train steps, counted
    res = gnn_train.train(st, TRAIN_STEPS, True, 0, warmup=0, capture=True)
    counts = dict(res["launches"])
    require_launched(counts, GNN_PATH, "GNN training")
    cap = res["captured"]
    losses = [s["loss"] for s in res["steps"]]
    rel = abs(cap["loss"] - float(loss32)) / abs(float(loss32))
    if not rel < TRAIN_INT8_LOSS_REL:
        raise AssertionError(f"train: int8 loss {cap['loss']} vs fp32 {float(loss32)}: "
                             f"{rel} >= {TRAIN_INT8_LOSS_REL}")
    bad = [k for k, g in enumerate(cap["grads"]) if not (np.isfinite(g).all() and np.abs(g).max() > 0)]
    if bad:
        raise AssertionError(f"train: int8 gradient leaves {bad} non-finite or zero")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall over 3 AdamW steps: {losses}")
    print(f"train checks 2-4: int8 loss {cap['loss']:.6f} vs fp32 {float(loss32):.6f} (rel "
          f"{rel:.3e}, bound {TRAIN_INT8_LOSS_REL}); {len(cap['grads'])} gradient leaves finite "
          f"and nonzero; losses over {TRAIN_STEPS} steps {losses} (3 AdamW updates); "
          f"launches {counts}")
    step_s = [s["step_s"] for s in res["steps"]]
    print(f"train int8 steps ({GRID[0] * GRID[1]} ranks simulated on one card): "
          f"{[round(t, 4) for t in step_s]} s; forward+backward "
          f"{[round(s['fwd_bwd_s'], 4) for s in res['steps']]}, pmean "
          f"{[round(s['pmean_s'], 4) for s in res['steps']]}, AdamW "
          f"{[round(s['adamw_s'], 4) for s in res['steps']]}; peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB, on {card}")
    print(f"train bytes per step: forward int8 {res['fwd_int8_bytes']:,} vs fp32 "
          f"{res['fwd_fp32_bytes']:,} ({res['fwd_fp32_bytes'] / res['fwd_int8_bytes']:.3f}x); "
          f"backward fp32 {res['bwd_fp32_bytes']:,}; gradient pmean fp32 "
          f"{res['grad_pmean_bytes']:,}")

    # 5. the int8 error-feedback all-reduce over 4x1 on the per-rank gradients
    g41 = SimGrid(4, 1, device="cuda")
    grads = g41.local(lambda p: per_rank[p])
    stats, stats32 = CommStats(), CommStats()
    kernels.reset_launches()
    with capture_quantize() as kept:
        mean8, _ = grad_compress.dp_allreduce_int8(
            g41, grads, g41.local(lambda p: grad_compress.init(grads[p])), ROW_AXIS, stats=stats)
    counts["quantize"] = counts.get("quantize", 0) + kernels.LAUNCHES["quantize"]
    for n, x in kept.items():
        kept_rows.setdefault(n, x)
    del kept
    worst = 0.0
    for k, leaves in enumerate(zip(*(tree.leaves(grads[p]) for p in range(4)))):
        xs = [grad_compress._pad_to(x, 4 * 128)[0] for x in leaves]
        n = leaves[0].numel()
        exact = torch.stack(xs).sum(0)[:n] / 4
        got = tree.leaves(mean8[0])[k].reshape(-1)
        bound = int8_mean_bound(xs)[:n]
        worst = max(worst, float(((got - exact).abs() / bound.clamp(min=1e-30)).max()))
        AdaptiveExchange("grad/pmean", g41, ROW_AXIS, stats=stats32).psum(xs, fmt="fp32")
    if not worst <= 1.0:
        raise AssertionError(f"train: int8 all-reduce mean off its fp32 mean by {worst} of "
                             "the int8 bound")
    int8_bytes = sum(rec.nbytes for rec in stats.records())
    fp32_bytes = sum(rec.hlo_bytes for rec in stats32.records())
    if not round(fp32_bytes / int8_bytes, 3) == 3.879:
        raise AssertionError(f"train: int8 wire {int8_bytes} vs fp32 {fp32_bytes}")
    print(f"train check 5: dp_allreduce_int8 over 4x1 ({len(tree.leaves(mean8[0]))} leaves): "
          f"mean within {worst:.3f} of the int8 bound of the fp32 mean; wire per rank int8 "
          f"{int8_bytes:,} B (codes + scales, all-to-all + all-gather) vs fp32 all-reduce "
          f"{fp32_bytes:,} B ({fp32_bytes / int8_bytes:.3f}x)")
    del grads, mean8, per_rank, g41

    rows = []
    for n, x in sorted(kept_rows.items()):
        rows.append(_quant_row(x, {"n": n, "input": "train path"}))
    del kept_rows
    for r in rows:
        print(describe(r, card, " (train path)"))

    # 6. the process grid: 4 workers on the card over gloo, fp32 then int8
    sim_step_s = res["steps"][0]["step_s"]
    del st, res
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    procs = procgrid.spawn(gnn_train.proc_train, *GRID, backend="gloo", device="cuda",
                           args=(TRAIN_PROC_SPEC,), timeout_s=600)
    spawn_s = time.perf_counter() - t1

    fp32_runs, int8_runs = ([p[k] for p in procs] for k in range(2))
    fp32_gaps = multicard.train_gaps(fp32_runs, sim32)
    if not max(fp32_gaps) <= GNN_FP32_REL:
        raise AssertionError(f"train: process grid fp32 against SimGrid (outputs, loss, "
                             f"gradients): {fp32_gaps} > {GNN_FP32_REL}")
    int8_gaps = multicard.train_gaps(int8_runs, cap)
    int8_loss = int8_runs[0]["captured"]["loss"]
    rel = abs(int8_loss - sim32["loss"]) / abs(sim32["loss"])
    finite = all(np.isfinite(g).all() and np.abs(g).max() > 0
                 for g in int8_runs[0]["captured"]["grads"])
    if not (rel < TRAIN_INT8_LOSS_REL and finite):
        raise AssertionError(f"train: process grid int8 loss {int8_loss} vs fp32 "
                             f"{sim32['loss']} ({rel}), gradients finite and nonzero: {finite}")
    total: dict = {}
    for run in int8_runs:
        for name, v in run["launches"].items():
            total[name] = total.get(name, 0) + v
    require_launched(total, GNN_PATH, "GNN training on the process grid")
    proc_s = max(run["steps"][0]["step_s"] for run in int8_runs)
    staging = max(run["staging_s"] for run in int8_runs)
    print(f"train check 6: process grid ({GRID[0] * GRID[1]} processes on one card over host "
          f"memory, gloo): fp32 outputs, loss and gradients within "
          f"{', '.join(f'{x:.3e}' for x in fp32_gaps)} of SimGrid's (bound {GNN_FP32_REL}); "
          f"int8 loss {int8_loss:.6f} within {rel:.3e} of the fp32 (bound "
          f"{TRAIN_INT8_LOSS_REL}), gradients finite and nonzero, and "
          f"{', '.join(f'{x:.3e}' for x in int8_gaps)} from SimGrid's int8 (outputs, loss, "
          f"gradients); on {card}")
    print(f"train process grid steps: fp32 {fp32_runs[0]['steps'][0]['step_s']:.4f} s, int8 "
          f"{proc_s:.4f} s vs SimGrid int8 {sim_step_s:.4f} s ({proc_s / sim_step_s:.2f}x); "
          f"staging {staging:.4f} s, share {staging / proc_s:.4f}; peak memory per process "
          f"{[round(run['peak_bytes'] / 2**30, 2) for run in int8_runs]} GiB; launches per "
          f"worker {[run['launches'] for run in int8_runs]}; spawn and runs {spawn_s:.1f}s, "
          f"on {card}")
    print(f"train step: {time.perf_counter() - t0:.1f}s")
    return {"train": counts, "train_procgrid": total}, rows


def equivariance_rotation() -> np.ndarray:
    """The fixed proper rotation of the equivariance checks."""
    a, b = EQUIV_ANGLES
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    return (rz @ rx).astype(np.float32)


def nequip_int8_check(st) -> tuple[bool, int]:
    """NequIP's 2D forward asked for int8 and its fp32 forward, each under
    ``gnn_train.deterministic`` (the card's atomic sums would differ from
    run to run): (bit for bit equal, quantize launches of the int8-asked
    forward)."""
    import torch
    from repro_torch import kernels
    from repro_torch.bench import gnn as gnn_bench, gnn_train

    with gnn_train.deterministic():
        before = kernels.LAUNCHES.get("quantize", 0)
        q = gnn_bench.forward_2d(st, True)
        launched = kernels.LAUNCHES.get("quantize", 0) - before
        f = gnn_bench.forward_2d(st, False)
    return bool(torch.equal(q, f)), launched


def equivariance_gaps(st) -> dict:
    """Rotate the positions by :func:`equivariance_rotation` (EGNN: and
    shift them by :data:`EGNN_SHIFT`) and rerun the fp32 forwards: the max
    abs gaps, over each output's peak, of the single-device and 2D outputs
    (invariant) and, for EGNN, of the single-device coordinates against the
    rotated and shifted ones (equivariant)."""
    import torch
    from repro_torch.bench import gnn as gnn_bench
    from repro_torch.models import gnn, gnn_dist

    rot = equivariance_rotation()
    shift = np.float32(EGNN_SHIFT) if st.cfg.name == "egnn" else np.zeros(3, np.float32)
    moved = st.verts.astype(np.float32) @ rot.T + shift

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    with torch.inference_mode():
        if st.cfg.name == "egnn":
            (h1, x1), (h2, x2) = (gnn.egnn_forward(st.cfg, st.params, gnn_bench.single_graph(st, p))
                                  for p in (None, moved))
            want = x1 @ torch.from_numpy(rot.T).to(x1.device) + torch.from_numpy(shift).to(
                x1.device)
            gaps = {"single": rel(h2, h1), "coords": rel(x2, want)}
        else:
            one = gnn.forward(st.cfg, st.params, gnn_bench.single_graph(st))
            gaps = {"single": rel(gnn.forward(st.cfg, st.params,
                                              gnn_bench.single_graph(st, moved)), one)}
        out = gnn_bench.forward_2d(st, False)[: st.n]
        kept = st.pos
        pos = np.zeros((st.bg.part.n, 3), np.float32)
        pos[: st.n] = moved
        st.pos = gnn_dist.shard_nodes(st.grid, pos, st.bg.part)
        try:
            gaps["2d"] = rel(gnn_bench.forward_2d(st, False)[: st.n], out)
        finally:
            st.pos = kept
    return gaps


def _peak_mib() -> str:
    import torch

    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def equivariant_step(card) -> tuple[dict, list]:
    """EGNN and NequIP at their published widths on the refinement-6
    multimesh over a simulated 2x2 grid, then on 4 processes and on the
    molecule batch: the six checks of the module docstring's step 13.
    Returns the launch counts per path and the quantize rows at EGNN's
    inputs."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.bench import gnn as gnn_bench, gnn_train
    from repro_torch.comm import procgrid
    from repro_torch.comm.grid import pmean_trees
    from repro_torch.configs import common as configs
    from repro_torch.data import graphs
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches, rows, sim = {}, [], {}
    for arch in EQUIVARIANT_ARCHS:
        st = gnn_bench.setup(arch, device="cuda")
        part, cfg = st.bg.part, st.cfg
        n_params = sum(x.numel() for x in tree.leaves(st.params))
        print(f"{arch}: {cfg.n_layers} layers d_hidden {cfg.d_hidden} d_in/out "
              f"{cfg.d_in}/{cfg.d_out}, {n_params:,} parameters, on the refinement-{st.refine} "
              f"multimesh (n={st.n:,}, m={st.edges.shape[0]:,}, positions on the unit sphere) "
              f"over a {GRID[0]}x{GRID[1]} grid: chunk {part.chunk:,}, n_pad {part.n:,}, e_cap "
              f"{st.bg.e_cap:,}; multimesh + partition {st.mesh_s:.3f}s")

        # 1 and 2: the forwards (EGNN: quantize at its inputs first)
        if arch == "egnn":
            with capture_quantize() as kept:
                gnn_bench.forward_2d(st, True)
            if not kept:
                raise AssertionError("egnn: the int8 forward gave quantize no input")
            d = cfg.d_hidden
            for n, x in sorted(kept.items()):
                what = ("owned [h, x] chunk" if n == part.chunk * (d + 3) else
                        "all-to-all chunks" if n == part.cols * part.chunk * (d + 4) else
                        "payload")
                rows.append(_quant_row(x, {"n": n, "input": what}))
            del kept
            for r in rows:
                print(describe(r, card, " (EGNN path)"))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        res = gnn_bench.run(st, requests=4)
        counts = dict(kernels.LAUNCHES)
        launches[arch] = counts
        fwd_peak = _peak_mib()
        if not res["finite"]:
            raise AssertionError(f"{arch}: non-finite outputs")
        gap = res["fp32_vs_single_max_abs"] / res["single_max_abs"]
        if not gap <= GNN_FP32_REL:
            raise AssertionError(f"{arch}: fp32 2D vs single-device {gap} > {GNN_FP32_REL}")
        if arch == "egnn":
            require_launched(counts, GNN_PATH, "EGNN")
            if not res["int8_rel_l2"] < GNN_INT8_L2:
                raise AssertionError(f"egnn: int8 vs fp32 relative L2 {res['int8_rel_l2']} >= "
                                     f"{GNN_INT8_L2}")
            int8_note = (f"int8 vs fp32 relative L2 {res['int8_rel_l2']:.6e} (bound "
                         f"{GNN_INT8_L2}; the coordinates quantized with the features, as in "
                         f"the reference)")
        else:
            same, q_launched = nequip_int8_check(st)
            if counts.get("quantize", 0) or q_launched or not same:
                raise AssertionError(f"nequip: asked for int8 it launched quantize "
                                     f"{counts.get('quantize', 0)} + {q_launched} times, equal "
                                     f"to fp32 bit for bit: {same}")
            int8_note = ("asked for int8: 0 quantize launches, equal to its fp32 forward bit "
                         "for bit (deterministic index_add_)")
        print(f"{arch} forwards: int8 {[round(t, 4) for t in res['int8_s']]} s, fp32 "
              f"{res['fp32_s']:.4f} s, single-device {res['single_s']:.4f} s ({GRID[0] * GRID[1]} "
              f"ranks simulated on one card); payload bytes per forward int8 "
              f"{res['int8_payload_bytes']:,} vs fp32 {res['fp32_payload_bytes']:,}; peak memory "
              f"{fwd_peak}; launches {counts}; on {card}")
        print(f"{arch} checks 1-2: {int8_note}; fp32 2D vs single-device max abs "
              f"{res['fp32_vs_single_max_abs']:.6e} of max |out| {res['single_max_abs']:.6e} "
              f"({gap:.3e}, bound {GNN_FP32_REL}); outputs finite")
        del res

        # 3: equivariance on the card
        gaps = equivariance_gaps(st)
        if not max(gaps.values()) <= EQUIV_REL:
            raise AssertionError(f"{arch}: equivariance gaps {gaps} > {EQUIV_REL}")
        print(f"{arch} check 3: under a rotation{' and shift' if arch == 'egnn' else ''}, "
              f"outputs moved by {gaps['single']:.3e} (single-device) and {gaps['2d']:.3e} (2D)"
              + (f", coordinates off their rotated and shifted selves by {gaps['coords']:.3e}"
                 if arch == "egnn" else "")
              + f" of their peaks (bound {EQUIV_REL})")

        # 4: training on SimGrid: fp32 against single-device autograd (both
        # under deterministic kernels, which also give check 5's reference),
        # then AdamW steps with the card's default kernels, timed
        targets_np = gnn_train.make_targets(part.n, cfg.d_out, 0)
        targets = gnn_dist.shard_targets(st.grid, targets_np, part)
        torch.cuda.empty_cache()
        with gnn_train.deterministic():
            loss32, per_rank, out32 = gnn_dist.value_and_grad_2d(
                st.grid, cfg, st.params, st.h_own, st.src_l, st.dst_l, targets, part,
                gnn_dist.Dist2DConfig(), pos=st.pos)
            mean32 = tree.leaves(pmean_trees(st.grid, per_rank)[0])
            del per_rank
            torch.cuda.reset_peak_memory_stats()
            loss1, grads1 = tstep.value_and_grad(lambda p, b: gnn.loss_fn(cfg, p, b), st.params,
                                                 padded_batch(st, targets_np))
            torch.cuda.synchronize()
        peak_1 = _peak_mib()
        sim[arch] = {"loss": float(loss32), "out": [o.cpu().numpy() for o in out32],
                     "grads": [g.cpu().numpy() for g in mean32]}
        want = tree.leaves(grads1)
        g_peak = max(float(w.abs().max()) for w in want)
        leaf_gap = max(float((a - w).abs().max()) for a, w in zip(mean32, want)) / g_peak
        loss_gap = abs(float(loss32) - float(loss1)) / abs(float(loss1))
        unread = [k for k, w in enumerate(want) if not w.any()]
        if not (leaf_gap <= GNN_FP32_REL and loss_gap <= GNN_FP32_REL):
            raise AssertionError(f"{arch} train: fp32 2D vs single-device loss {float(loss32)} "
                                 f"vs {float(loss1)}, worst leaf gap {leaf_gap} of the "
                                 f"gradients' peak {g_peak} > {GNN_FP32_REL}")
        del grads1, want, mean32, out32
        torch.cuda.empty_cache()
        res = gnn_train.train(st, TRAIN_STEPS, False, 0, warmup=0, capture=True)
        cap = res["captured"]
        losses = [r["loss"] for r in res["steps"]]
        bad = [k for k, g in enumerate(cap["grads"])
               if not np.isfinite(g).all() or (k not in unread) != bool(np.abs(g).max() > 0)]
        if bad or not losses[-1] < losses[0]:
            raise AssertionError(f"{arch} train: leaves {bad} non-finite, or zero where the "
                                 f"single-device gradient is not (or the reverse); losses "
                                 f"{losses}")
        launches[f"{arch}_train"] = res["launches"]
        print(f"{arch} check 4: fp32 2D loss {float(loss32):.6f} vs single-device "
              f"{float(loss1):.6f} (rel {loss_gap:.3e}); gradients' worst leaf {leaf_gap:.3e} of "
              f"their peak {g_peak:.6e} (bound {GNN_FP32_REL}; both under deterministic "
              f"kernels); single-device peak memory {peak_1}; the AdamW steps' {len(cap['grads'])} "
              f"leaves finite, zero exactly where the loss does not read them ({unread}, as in "
              f"the reference); the loss falls")
        step_s = [r["step_s"] for r in res["steps"]]
        print(f"{arch} train steps (fp32 payloads, {GRID[0] * GRID[1]} ranks simulated on one "
              f"card): losses {losses}; {[round(t, 4) for t in step_s]} s; forward+backward "
              f"{[round(r['fwd_bwd_s'], 4) for r in res['steps']]}, pmean "
              f"{[round(r['pmean_s'], 4) for r in res['steps']]}, AdamW "
              f"{[round(r['adamw_s'], 4) for r in res['steps']]}; bytes per step forward "
              f"{res['fwd_fp32_bytes']:,}, backward {res['bwd_fp32_bytes']:,}, gradient pmean "
              f"{res['grad_pmean_bytes']:,}; peak memory {res['peak_bytes'] / 2**30:.2f} GiB; "
              f"on {card}")
        del st, res, targets
        torch.cuda.empty_cache()

    # 5: one fp32 step of each on 4 processes over gloo, against SimGrid's,
    # both under deterministic kernels
    t1 = time.perf_counter()
    procs = procgrid.spawn(gnn_train.proc_train, *GRID, backend="gloo", device="cuda",
                           args=(EQUIV_PROC_SPEC,), timeout_s=600)
    spawn_s = time.perf_counter() - t1
    for k, case in enumerate(EQUIV_PROC_SPEC["cases"]):
        arch, runs, want = case["arch"], [p[k] for p in procs], sim[case["arch"]]
        out_peak = max(float(np.abs(o).max()) for o in want["out"])
        out_gap = max(float(np.abs(run["captured"]["out"][run["rank"]]
                                   - want["out"][run["rank"]]).max()) for run in runs) / out_peak
        loss_gap = max(abs(run["captured"]["loss"] - want["loss"]) for run in runs) / abs(
            want["loss"])
        g_peak = max(float(np.abs(g).max()) for g in want["grads"])
        grad_gap = max(float(np.abs(a - b).max()) for a, b in zip(runs[0]["captured"]["grads"],
                                                                  want["grads"])) / g_peak
        if not max(out_gap, loss_gap, grad_gap) <= GNN_FP32_REL:
            raise AssertionError(f"{arch}: process grid against SimGrid (outputs, loss, "
                                 f"gradients, deterministic kernels): {out_gap}, {loss_gap}, "
                                 f"{grad_gap}")
        total: dict = {}
        for run in runs:
            for name, v in run["launches"].items():
                total[name] = total.get(name, 0) + v
        launches[f"{arch}_procgrid"] = total
        proc_s = max(run["steps"][0]["step_s"] for run in runs)
        staging = max(run["staging_s"] for run in runs)
        print(f"{arch} check 5: process grid ({GRID[0] * GRID[1]} processes on one card over "
              f"host memory, gloo), one fp32 step, deterministic kernels: outputs, loss and "
              f"gradients within {out_gap:.3e}, {loss_gap:.3e}, {grad_gap:.3e} of SimGrid's "
              f"(bound {GNN_FP32_REL}); step {proc_s:.4f} s (deterministic kernels), staging "
              f"{staging:.4f} s (share {staging / proc_s:.4f}); peak memory per process "
              f"{[round(run['peak_bytes'] / 2**30, 2) for run in runs]} GiB; on {card}")
    print(f"equivariant process grid: spawn and runs {spawn_s:.1f}s")
    del procs

    # 6: make_train_step on the molecule batch, one device, MSE
    mb = graphs.molecule_batch(*MOLECULE, seed=0)
    batch = {"graph": gnn.Graph(nf=torch.from_numpy(mb.nf).cuda(),
                                src=torch.from_numpy(mb.src).cuda(),
                                dst=torch.from_numpy(mb.dst).cuda(),
                                pos=torch.from_numpy(mb.pos).cuda()),
             "targets": torch.from_numpy(mb.targets).cuda()}
    for arch in EQUIVARIANT_ARCHS:
        cfg = configs.get(arch).model_config()
        fn = tstep.make_train_step(lambda p, b, cfg=cfg: gnn.loss_fn(cfg, p, b),
                                   adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50))
        state = tstep.init_state(gnn.init(cfg, torch.Generator().manual_seed(0), "cuda"))
        losses, norms, secs = [], [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t1)
        if not (losses[-1] < losses[0] and np.isfinite(norms).all()):
            raise AssertionError(f"{arch} molecule: losses {losses}, gradient norms {norms}")
        print(f"{arch} check 6: molecule batch ({MOLECULE[0]} molecules of {MOLECULE[1]} atoms "
              f"and {MOLECULE[2]} edges, MSE on float targets), {TRAIN_STEPS} steps of "
              f"make_train_step: losses {[round(x, 6) for x in losses]}, gradient norms finite "
              f"{[round(x, 4) for x in norms]}; {[round(t, 4) for t in secs]} s on {card}")
    print(f"equivariant step: {time.perf_counter() - t0:.1f}s")
    return launches, rows


@contextlib.contextmanager
def no_tf32():
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _rel(got, want, vocab: int) -> float:
    """Max abs gap over the peak of ``want``, on the logits of the vocab
    (the padded ones hold -1e9)."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got - want).abs().max() / want.abs().max())


def serve_step(card) -> dict:
    """The LM archs served through the engine: the three checks of the
    module docstring's step 14.  Returns the serve path's launch counts."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.bench import serve as serve_bench
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import engine as eng

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches: dict = {}
    for arch in SERVE_ARCHS:
        t1 = time.perf_counter()
        cell = serve_bench.CELLS[arch]
        cfg, params = serve_bench.model(arch, cell["layers"], device="cuda")
        n = sum(x.numel() for x in params["layers"].values()) + sum(
            params[k].numel() for k in ("embed", "final_norm", "lm_head"))
        if cfg.padded_vocab == cfg.vocab and n != cfg.n_params():
            raise AssertionError(f"{arch}: {n} parameters, the config counts {cfg.n_params()}")
        prompts = serve_bench.prompts(cfg.vocab, cell["requests"], *cell["prompt_len"])
        kernels.reset_launches()
        res = serve_bench.serve(cfg, params, prompts, serve_bench.SLOTS, cell["max_seq"],
                                cell["max_new"], device="cuda")
        for name, c in kernels.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + c
        e = res["engine"]
        outs = [r.out for r in res["requests"]]
        if not (all(r.done for r in res["requests"]) and not e.pending
                and all(r is None for r in e.slot_req)
                and all(len(o) == cell["max_new"] and max(o) < cfg.vocab for o in outs)):
            raise AssertionError(f"{arch}: requests unfinished or tokens out of range: {outs}")
        weights, copy = serve_bench.weight_bytes(params, e.params)
        print(f"{arch}: {cfg.n_layers} layers d_model {cfg.d_model}, bf16 compute, "
              f"{res['ticks']} ticks, {res['prompt_tokens']} prompt and "
              f"{res['generated_tokens']} generated tokens, {res['tokens_per_s']:.2f} generated "
              f"tokens/s, median {res['median_tick_ms']:.3f} ms per tick, wall "
              f"{res['wall_s']:.3f} s; weights {weights:,} B fp32 + {copy:,} B bf16 copy; peak "
              f"memory {res['peak_bytes'] / 2**30:.2f} GiB; on {card}; {len(outs)} requests "
              f"over {serve_bench.SLOTS} slots of a {cell['max_seq']:,}-token cache "
              f"({e.cache.numel() * e.cache.element_size():,} B), every one finished with "
              f"{cell['max_new']} tokens below the vocab")
        del res, e
        torch.cuda.empty_cache()

        with no_tf32():
            if arch == "gemma-2b":
                cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
                prompt = serve_bench.prompts(cfg.vocab, 1, SERVE_CHECK_PROMPT,
                                             SERVE_CHECK_PROMPT, seed=1)[0]
                ref = tfm.forward(cfg32, params, torch.from_numpy(prompt).cuda()[None])[0][0, -1]
                e = eng.Engine(cfg32, params, serve_bench.SLOTS, SERVE_CHECK_SEQ, device="cuda")
                solo = eng.Request(rid=0, prompt=prompt, max_new=SERVE_CHECK_NEW)
                e.submit(solo)
                while not solo.out:
                    e.tick()
                gap = _rel(e.logits[0], ref, cfg.vocab)
                e.run_until_drained()
                del e
                others = serve_bench.prompts(cfg.vocab, serve_bench.SLOTS - 1, 16,
                                             SERVE_CHECK_PROMPT, seed=2)
                e = eng.Engine(cfg32, params, serve_bench.SLOTS, SERVE_CHECK_SEQ, device="cuda")
                reqs = [eng.Request(rid=i, prompt=p, max_new=SERVE_CHECK_NEW)
                        for i, p in enumerate(others + [prompt])]
                for r in reqs:
                    e.submit(r)
                e.run_until_drained()
                del e
                first = int(torch.argmax(ref))
                if not (solo.out[0] == first and gap <= SERVE_FP32_REL
                        and reqs[-1].out == solo.out):
                    raise AssertionError(f"gemma-2b fp32: first token {solo.out[0]} vs the "
                                         f"forward's argmax {first}, logits gap {gap}, alone "
                                         f"{solo.out} vs beside 7 others {reqs[-1].out}")
                print(f"gemma-2b check 2 (fp32, TF32 off): a {SERVE_CHECK_PROMPT}-token prompt "
                      f"alone in the {serve_bench.SLOTS}-slot engine: first token {first} = the "
                      f"forward's argmax, the last prompt tick's logits {gap:.3e} of the "
                      f"forward's peak (bound {SERVE_FP32_REL}); tokens {solo.out}, the same "
                      f"beside {serve_bench.SLOTS - 1} other requests")
            else:
                cfg32 = dataclasses.replace(
                    cfg, compute_dtype=torch.float32,
                    capacity_factor=float(cfg.n_experts) if cfg.is_moe else cfg.capacity_factor)
                seq = torch.from_numpy(serve_bench.prompts(cfg.vocab, 1, SERVE_TF_PROMPT,
                                                           SERVE_TF_PROMPT, seed=1)[0]).cuda()
                ref = tfm.forward(cfg32, params, seq[None])[0][0]
                cache = tfm.init_cache(cfg32, 1, SERVE_TF_PROMPT, device="cuda")
                got = []
                for i in range(SERVE_TF_PROMPT):
                    logits, cache = tfm.decode_step(cfg32, params, cache, seq[i:i + 1],
                                                    torch.full((1,), i, device="cuda"))
                    got.append(logits[0])
                gap = _rel(torch.stack(got), ref, cfg.vocab)
                if not gap <= SERVE_FP32_REL:
                    raise AssertionError(f"{arch}: fp32 decode vs teacher forcing {gap}")
                drop_free = f", capacity factor {cfg.n_experts} (drop-free)" if cfg.is_moe else ""
                print(f"{arch} fp32 (TF32 off{drop_free}): "
                      f"decode on one slot over a {SERVE_TF_PROMPT}-token prompt against the "
                      f"teacher-forced forward, every position within {gap:.3e} of the "
                      f"logits' peak (bound {SERVE_FP32_REL})")
                del cache, got
        del params, ref
        torch.cuda.empty_cache()
        print(f"{arch}: {time.perf_counter() - t1:.1f}s")
    for name, c in serve_grid_check(card).items():
        launches[name] = launches.get(name, 0) + c
    print(f"serve launches (all five archs, and the grid engine): {launches or 'none'} (no "
          f"kernel of the ten is on this path, as in the reference)")
    print(f"serve step: {time.perf_counter() - t0:.1f}s")
    return launches


def serve_grid_check(card) -> dict:
    """Step 14 check (4): the grid engine on a SimGrid 2x2 against the
    one-device engine.  Returns the launch counts of the grid engine's run."""
    import torch
    from repro_torch import kernels
    from repro_torch.bench import serve as serve_bench
    from repro_torch.comm import SimGrid
    from repro_torch.models import transformer_sharded as tsh

    launches: dict = {}
    c = SERVE_GRID_CELL
    for arch in SERVE_GRID_ARCHS:
        t1 = time.perf_counter()
        with no_tf32():
            cfg, params = serve_bench.model(arch, SERVE_GRID_LAYERS, dtype="fp32", device="cuda")
            prompts = serve_bench.prompts(cfg.vocab, c["requests"], *c["prompt_len"])
            kw = dict(slots=serve_bench.SLOTS, max_seq=c["max_seq"], max_new=c["max_new"],
                      keep_logits=True)
            one = serve_bench.serve(cfg, params, prompts, device="cuda", **kw)
            grid = SimGrid(2, 2, "cuda")
            specs = tsh.serving_specs(cfg, grid)
            kernels.reset_launches()
            res = serve_bench.serve(cfg, tsh.shard_params(cfg, params, grid, specs), prompts,
                                    grid=grid, specs=specs, **kw)
            for name, k in kernels.LAUNCHES.items():
                launches[name] = launches.get(name, 0) + k
        want = [r.out for r in one["requests"]]
        got = [r.out for r in res["requests"]]
        full = [torch.from_numpy(x) for x in one["logits"]]
        rows = [torch.from_numpy(x) for x in res["logits"]]  # grid rank 0: slots 0-3
        gap = max(_gap(g, f[:g.shape[0]]) for g, f in zip(rows, full))
        if not (got == want and len(rows) == len(full) and gap <= SERVE_GRID_REL):
            raise AssertionError(f"{arch} grid engine 2x2: tokens {got} vs one device {want}, "
                                 f"logits gap {gap} (bound {SERVE_GRID_REL})")
        print(f"{arch} check 4 ({SERVE_GRID_LAYERS} layers, fp32, TF32 off): the grid engine on "
              f"a SimGrid 2x2 (FSDP x TP) gave the one-device engine's tokens for "
              f"{len(prompts)} requests over {res['ticks']} ticks, rank 0's logits within "
              f"{gap:.3e} of the peak (bound {SERVE_GRID_REL}); median ms per tick "
              f"{res['median_tick_ms']:.3f} vs {one['median_tick_ms']:.3f} on one device, "
              f"peak memory {res['peak_bytes'] / 2**30:.2f} GiB; on {card}; "
              f"{time.perf_counter() - t1:.1f}s")
        del one, res, params
        torch.cuda.empty_cache()
    return launches


def _gap(got, want) -> float:
    """Max abs gap over the peak of ``want`` (float64 on the CPU)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _capture(fn, *args):
    """``fn(*args)`` with its standard output kept, then echoed -> (result,
    the text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    text = buf.getvalue()
    print(text, end="")
    return res, text


def recsys_step(card) -> dict:
    """AutoInt at its published widths: the six checks of the module
    docstring's step 15.  Returns the recsys path's launch counts."""
    import functools
    import shutil
    import tempfile

    import torch
    from repro_torch import kernels, tree
    from repro_torch.bench import recsys as rb
    from repro_torch.bench.gnn_train import deterministic
    from repro_torch.launch import train as launcher
    from repro_torch.models import recsys
    from repro_torch.train import step as tstep

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    runs = []
    with no_tf32():
        # (1) the full fp32 table
        cfg = rb.config("serve_p99")
        params = rb.model(cfg, 0, "cuda")
        n = sum(x.numel() for x in tree.leaves(params))
        if n != cfg.n_params() or params["table"].shape != (RECSYS_ROWS, cfg.embed_dim):
            raise AssertionError(f"autoint: {n} parameters, table {params['table'].shape}; "
                                 f"the config counts {cfg.n_params()}")
        ids = rb.batch(cfg, rb.CELLS["serve_p99"]["batch"], 0, "cuda")["ids"]
        offs = recsys.field_offsets(cfg, "cuda")
        with torch.inference_mode():
            logits = recsys.forward(cfg, params, ids)
            emb = recsys.embedding_bag(params["table"], ids, offs)
            exact = torch.equal(emb, params["table"][(ids + offs[None]).long()])
            on_card = recsys.head(cfg, params, emb)
        dense = {k: tree.tree_map(lambda x: x.cpu(), v) for k, v in params.items() if k != "table"}
        gap = _gap(on_card, recsys.head(cfg, dense, emb.cpu()))
        if not (logits.shape == ids.shape[:1] and bool(torch.isfinite(logits).all()) and exact
                and gap <= RECSYS_FP32_REL):
            raise AssertionError(f"autoint fp32: logits {logits.shape} finite "
                                 f"{bool(torch.isfinite(logits).all())}, embedding_bag exact "
                                 f"{exact}, dense part card vs CPU {gap}")
        print(f"autoint check 1 (fp32, TF32 off): {cfg.total_rows:,}-row table "
              f"({params['table'].numel() * 4:,} B) and {n:,} parameters on the card; "
              f"embedding_bag of the {ids.shape[0]}-row batch equals table[ids + offsets] "
              f"exactly; the dense part on the card within {gap:.3e} of the CPU's on the same "
              f"gathered rows (bound {RECSYS_FP32_REL})")
        for cell in ("serve_p99", "serve_bulk"):
            runs.append(rb.run_cell(cfg, params, cell, rb.CELLS[cell]["batch"], 0, RECSYS_REPS,
                                    "cuda"))
        # (3) retrieval over 1,000,000 candidates of the last field
        q = rb.batch(cfg, 1, 0, "cuda")["ids"]
        n_cand = rb.CELLS["retrieval_cand"]["n_candidates"]
        cand = rb.candidates(cfg, n_cand, 0, "cuda")
        with torch.inference_mode():
            scores = recsys.retrieval_scores(cfg, params, q, cand)
            uv = recsys.user_vector(cfg, params, q)[0]
            # the last field's base row, reckoned apart from the code under test
            base = int(np.cumsum(cfg.resolved_tables())[-2])
            want = params["table"][cand.long() + base].double() @ uv.double()
            pick = torch.from_numpy(np.random.default_rng(0).choice(n_cand, 16, replace=False))
            alone = torch.cat([recsys.retrieval_scores(cfg, params, q, cand[i:i + 1])
                               for i in pick.tolist()])
        gap_r = _gap(scores, want)
        gap_1 = float((alone - scores[pick.cuda()]).abs().max() / scores.abs().max())
        if not (scores.shape == (n_cand,) and gap_r <= RECSYS_FP32_REL
                and gap_1 <= RECSYS_FP32_REL):
            raise AssertionError(f"retrieval: {scores.shape}, against user_vector . table[rows] "
                                 f"{gap_r}, 16 candidates alone {gap_1}")
        print(f"autoint check 3: retrieval_scores over {n_cand:,} candidates of the last field "
              f"({cfg.resolved_tables()[-1]} rows) within {gap_r:.3e} of user_vector . "
              f"table[rows] in float64, 16 of them scored alone within {gap_1:.3e} of the "
              f"peak (bound {RECSYS_FP32_REL})")
        runs.append(rb.run_cell(cfg, params, "retrieval_cand", 1, n_cand, RECSYS_REPS, "cuda"))
        del params, emb, dense, scores, want
        torch.cuda.empty_cache()

        # (2) the int8 table at the full row count
        cfg_q = rb.config("serve_p99", quant=True)
        params = rb.model(cfg_q, 0, "cuda")
        with torch.inference_mode():
            got = recsys.forward(cfg_q, params, ids)
            rows = (ids + offs[None]).long()
            deq = params["table"][rows].float() * params["table_scale"][rows][..., None]
            gap_q = _gap(got, recsys.head(cfg, params, deq))
        if not (params["table"].dtype == torch.int8 and bool(torch.isfinite(got).all())
                and gap_q <= RECSYS_FP32_REL):
            raise AssertionError(f"autoint int8: {params['table'].dtype}, against fp32 on the "
                                 f"dequantized rows {gap_q}")
        print(f"autoint check 2 (int8 table, {params['table'].numel():,} B + scales "
              f"{params['table_scale'].numel() * 4:,} B): the forward at {ids.shape[0]} within "
              f"{gap_q:.3e} of the fp32 forward on the dequantized gathered rows (bound "
              f"{RECSYS_FP32_REL})")
        for cell in ("serve_p99", "serve_bulk"):
            runs.append(rb.run_cell(cfg_q, params, cell, rb.CELLS[cell]["batch"], 0, RECSYS_REPS,
                                    "cuda"))
        del params, got, deq
        torch.cuda.empty_cache()

        # (4) training at 65,536 over the table cut by 4
        cfg_t = rb.config("train_batch")
        params = rb.model(cfg_t, 0, "cuda")
        b = rb.batch(cfg_t, rb.CELLS["train_batch"]["batch"], 0, "cuda")
        _, grads = tstep.value_and_grad(functools.partial(recsys.loss_fn, cfg_t), params, b)
        touched = torch.zeros(cfg_t.total_rows, dtype=torch.bool, device="cuda")
        touched[(b["ids"] + recsys.field_offsets(cfg_t, "cuda")[None]).long().reshape(-1)] = True
        nz = grads["table"].ne(0).any(dim=1)
        stray, hit, n_touched = (int((nz & ~touched).sum()), int((nz & touched).sum()),
                                 int(touched.sum()))
        zero_leaves = [k for k, g in enumerate(tree.leaves(grads))
                       if not bool(g.ne(0).any()) and g is not grads["w_user"]]
        if stray or not hit or zero_leaves or bool(grads["w_user"].ne(0).any()):
            raise AssertionError(f"train gradients: {stray} untouched rows nonzero, {hit} "
                                 f"touched rows nonzero, zero leaves {zero_leaves}")
        del grads, nz, touched
        r = rb.run_cell(cfg_t, params, "train_batch", rb.CELLS["train_batch"]["batch"], 0,
                        RECSYS_STEPS - 1, "cuda")
        if not (r["finite"] and len(r["losses"]) == RECSYS_STEPS):
            raise AssertionError(f"train: losses {r['losses']}, norms {r['grad_norms']}")
        print(f"autoint check 4 (train_batch, {cfg_t.total_rows:,} rows: each table cut by "
              f"{rb.CELLS['train_batch']['table_div']}): the table's gradient nonzero on {hit:,} "
              f"of the {n_touched:,} rows the batch touched and on "
              f"none of the others; every leaf but w_user (unread by the loss) nonzero; "
              f"{RECSYS_STEPS} steps: losses {[round(x, 6) for x in r['losses']]}, gradient "
              f"norms {[round(x, 4) for x in r['grad_norms']]}")
        runs.append(r)
        del params, b, r
        torch.cuda.empty_cache()

        # (5) the launcher with checkpoints, resumed and uninterrupted
        # an uninterrupted run checkpoints steps 9 and 19; with step 19's
        # removed, as if a kill had come before it was written, the same
        # command resumes at step 10 and must end on the same state
        with deterministic(), tempfile.TemporaryDirectory() as d:
            argv = ["--arch", "autoint", "--steps", "20", "--ckpt-every", "10",
                    "--log-every", "10", "--ckpt-dir", d]
            whole, _ = _capture(launcher.main, argv)
            shutil.rmtree(os.path.join(d, "step_000019"))
            resumed, text = _capture(launcher.main, argv)
            same_bits = all(torch.equal(x, y) for x, y in zip(tree.leaves(resumed["state"]),
                                                              tree.leaves(whole["state"])))
            if not (same_bits and resumed["start_step"] == 10
                    and "resumed from checkpoint at step 10" in text
                    and resumed["losses"] == whole["losses"][10:]):
                raise AssertionError(f"launcher resume: bits equal {same_bits}, start "
                                     f"{resumed['start_step']}")
            others = {}
            for arch in ("minicpm-2b", "graphcast"):
                res, text = _capture(launcher.main, ["--arch", arch, "--steps", "10",
                                                     "--log-every", "10"])
                if not (np.all(np.isfinite(res["losses"])) and len(res["losses"]) == 10
                        and " -> " in text and "stragglers: " in text):
                    raise AssertionError(f"launcher {arch}: {res['losses']}")
                others[arch] = (res["losses"][0], res["losses"][-1])
        print(f"autoint check 5 (launch.train, deterministic kernels): an uninterrupted "
              f"20-step run's step-19 checkpoint removed, its rerun resumed at step 10 and "
              f"ended on the same state bit for bit; minicpm-2b and graphcast 10 steps each, losses "
              f"finite ({', '.join(f'{a}: {x:.4f} -> {y:.4f}' for a, (x, y) in others.items())})")
    launches = dict(kernels.LAUNCHES)
    for r in runs:
        print(f"autoint {rb.describe(r, card)}")
    print(f"recsys launches: {launches or 'none'} (no kernel of the ten is on this path, as "
          f"in the reference)")
    print(f"recsys step: {time.perf_counter() - t0:.1f}s")
    return launches


def check_id_streams() -> int:
    """The id-stream helpers on CUDA against their plain versions (the same
    calls on CPU copies), bit for bit, at every width class and each count
    of ``ID_STREAM_COUNTS``: the packed words, the unpacked ids (equal to
    the stream, ``fill`` past the count) and ``compact_ids`` of a
    membership plane with as many members.  Returns the cases run."""
    import torch
    from repro_torch.kernels.bitpack import ops as bp_ops
    from repro_torch.kernels.bitpack.ref import B_CLASSES

    rng = np.random.default_rng(0)
    cap, n = ID_STREAM_CAP, 0
    for b in B_CLASSES:
        for count in ID_STREAM_COUNTS:
            # gaps that fit b bits (2**20 at b = 32); the ids are their sums
            # mod 2**32, as uint32 bit patterns
            gaps = rng.integers(0, ((1 << b) - 1 if b < 32 else 1 << 20) + 1, count)
            ids = np.zeros(cap, np.int64)
            ids[:count] = np.cumsum(gaps)
            ids = torch.from_numpy((ids & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
            cnt = torch.tensor(count, dtype=torch.int32, device="cuda")
            words = bp_ops.pack_sorted_ids(ids.cuda(), cnt, b)
            plain = bp_ops.pack_sorted_ids(ids, count, b)
            expect(same(words.cpu(), plain), f"pack_sorted_ids b={b} count={count}")
            back = bp_ops.unpack_sorted_ids(words, cnt, b, fill=-1).cpu()
            expect(same(back, bp_ops.unpack_sorted_ids(plain, count, b, fill=-1)),
                   f"unpack_sorted_ids b={b} count={count}")
            expect(same(back[:count], ids[:count]) and bool((back[count:] == -1).all()),
                   f"id stream round trip b={b} count={count}")
            n += 1
    for count in ID_STREAM_COUNTS:
        mask = torch.zeros(2 * cap, dtype=torch.bool)
        mask[torch.from_numpy(rng.choice(2 * cap, count, replace=False))] = True
        for capacity in (cap, max(count // 2, 1)):
            ids, cnt = bp_ops.compact_ids(mask.cuda(), capacity, fill=capacity)
            want_ids, want_cnt = bp_ops.compact_ids(mask, capacity, fill=capacity)
            expect(same(ids.cpu(), want_ids) and same(cnt.cpu(), want_cnt),
                   f"compact_ids count={count} capacity={capacity}")
            n += 1
    return n


def launch_cell_args(cell, device, seed: int):
    """A cell's arguments with values on ``device``: parameters from the
    arch's init, data from numpy, both from ``seed``, so that the CPU and
    the card get the same values (AutoInt's table is drawn on the device
    by a generator there)."""
    import torch
    from repro_torch.configs import common as cfgs
    from repro_torch.models import gnn, recsys
    from repro_torch.train import step as tstep

    spec = cfgs.get(cell.arch_id)
    p = spec.shape(cell.shape_name).params
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(a).to(device)

    if cell.kind == "graph_train":
        cfg = spec.model_config(d_in=p["d_feat"], d_out=p["n_classes"])
        state = tstep.init_state(gnn.init(cfg, torch.Generator().manual_seed(seed), device))
        graph = cell.args[1]["graph"]
        n, m = graph.nf.shape[0], graph.src.shape[0]
        batch = {"graph": gnn.Graph(
            nf=put(rng.standard_normal((n, p["d_feat"]), dtype=np.float32)),
            src=put(rng.integers(0, n, m, dtype=np.int32)),
            dst=put(rng.integers(0, n, m, dtype=np.int32)),
            pos=put(rng.standard_normal((n, 3), dtype=np.float32))),
            "targets": put(rng.integers(0, p["n_classes"], n, dtype=np.int32))}
        return state, batch
    if cell.kind == "serve":
        cfg = spec.model_config()
        params = recsys.init_params(cfg, torch.Generator(device).manual_seed(seed), device=device)
        b = cell.args[1].shape[0]
        ids = np.stack([rng.integers(0, k, b, dtype=np.int32) for k in cfg.resolved_tables()], 1)
        return params, put(ids)
    raise ValueError(f"{cell.cell_id}: no argument maker for kind {cell.kind!r}")


def _shapes(t) -> list:
    from repro_torch import tree

    return [(tuple(x.shape), x.dtype) for x in tree.leaves(t)]


def launch_step(card) -> dict:
    """The launch layer: the three checks of the module docstring's step
    16.  Returns the launch path's launch counts."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.launch import cells, mesh, roofline

    t0 = time.perf_counter()
    kernels.reset_launches()
    n_cases = check_id_streams()
    launches = dict(kernels.LAUNCHES)
    print(f"launch check 1: pack_sorted_ids / unpack_sorted_ids at widths 1..32 and counts "
          f"{list(ID_STREAM_COUNTS)} of a {ID_STREAM_CAP:,}-id stream, and compact_ids, "
          f"{n_cases} cases on the card equal to the plain versions bit for bit; launches "
          f"{launches}")
    require_launched(launches, LAUNCH_PATH, "launch")

    # (2) the catalogue on meta, both production meshes
    flops = None
    for multi_pod in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi_pod)
        t1 = time.perf_counter()
        built = [cells.build_cell(a, s, m) for a, s in cells.all_cells()]
        skips = [c for c in built if c.kind == "skip"]
        on_meta = all(x.device.type == "meta" for c in built for a in c.args
                      for x in tree.leaves(a))
        if (len(built) - len(skips), len(skips)) != (38, 5) or not on_meta:
            raise AssertionError(f"catalogue on {m}: {len(built) - len(skips)} built, "
                                 f"{len(skips)} skips, all arguments on meta {on_meta}")
        n_placed = 0
        for c in built:  # one spec per argument leaf, each dividing its shape
            for a, specs in zip(c.args, c.in_shardings or ()):
                xs, sps = tree.leaves(a), mesh.spec_leaves(specs)
                if len(xs) != len(sps):
                    raise AssertionError(f"{c.cell_id}: {len(xs)} leaves, {len(sps)} specs")
                for x, sp in zip(xs, sps):
                    mesh.shard_shape(x.shape, sp, m)
                    n_placed += 1
        got = {c.cell_id: c.meta.get("model_flops") for c in built}
        if flops is None:
            flops = got
            for c in built:
                print(f"  {c.cell_id} {c.kind}: "
                      + (c.skip_reason[:60] + "..." if c.kind == "skip"
                         else f"model_flops {c.meta['model_flops']:.6e}"))
        elif got != flops:
            raise AssertionError("model_flops differ between the production meshes")
        print(f"launch check 2: the catalogue on the {dict(m.shape)} mesh: "
              f"{len(built) - len(skips)} cells built on meta, {len(skips)} skips "
              f"({', '.join(c.cell_id for c in skips)}), {n_placed} arguments placed by "
              f"their specs, model_flops as above, in "
              f"{time.perf_counter() - t1:.1f}s")

    # (3) three cells at a one-card mesh
    one = mesh.make_mesh((1, 1), ("data", "model"))
    with no_tf32():
        for cid in LAUNCH_CELLS:
            cell = cells.build_cell(*cid.split("/"), one)
            want = cell.fn(*cell.args)
            args = launch_cell_args(cell, "cuda", 0)
            if _shapes(args) != _shapes(cell.args):
                raise AssertionError(f"{cid}: the arguments made on the card are not the "
                                     f"meta ones'")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t1
            ms = time_ms(lambda: cell.fn(*args), 5)
            floats = [x for x in tree.leaves(out) if x.is_floating_point()]
            finite = all(bool(torch.isfinite(x).all()) for x in floats)
            if _shapes(out) != _shapes(want) or not finite or not floats:
                raise AssertionError(f"{cid}: outputs {_shapes(out)} against the meta run's "
                                     f"{_shapes(want)}, finite {finite}")
            gap = ""
            if cell.kind == "graph_train":
                loss = float(out[1]["loss"])
                cpu = float(cell.fn(*launch_cell_args(cell, "cpu", 0))[1]["loss"])
                rel = abs(loss - cpu) / abs(cpu)
                if not rel <= LAUNCH_REL:
                    raise AssertionError(f"{cid}: loss {loss} on the card, {cpu} on the CPU")
                gap = f", loss {loss:.6f} within {rel:.3e} of the CPU's (bound {LAUNCH_REL})"
            print(f"launch check 3: {cid} ({cell.kind}) at the (1, 1) mesh: "
                  f"{len(_shapes(out))} outputs with the meta run's shapes and dtypes, "
                  f"finite{gap}; first call {first_s * 1e3:.3f} ms, then {ms:.3f} ms a call "
                  f"(CUDA events, mean of 5) on {card}")
            del args, out
            torch.cuda.empty_cache()
    launches = dict(kernels.LAUNCHES)
    print(f"roofline constants (NVIDIA H100 SXM5 datasheet): peak {roofline.PEAK_FLOPS:.4g} "
          f"FLOP/s bf16 dense, HBM {roofline.HBM_BW:.4g} B/s, NVLink {roofline.LINK_BW:.4g} "
          f"B/s a link; card {card}")
    print(f"launch path launches: {launches}")
    print(f"launch step: {time.perf_counter() - t0:.1f}s")
    return launches


def dryrun_step(card, scale: int, counted: dict) -> dict:
    """The dry-run: the three checks of the module docstring's step 17.
    ``counted`` holds step 6's ledgers and counts by plan.  Returns the
    dry-run path's launch counts."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.bench import distributed, graph500
    from repro_torch.comm import SimGrid
    from repro_torch.core import bfs
    from repro_torch.launch import dryrun, mesh, roofline

    t0 = time.perf_counter()
    kernels.reset_launches()
    # (1) step 6's raw batch and counted auto batches, counted as they ran
    for plan, (ledgers, count) in counted.items():
        cmp = roofline.compare_comm_stats(ledgers, count)
        if not cmp.match:
            raise AssertionError(f"scale-{scale} {plan}: the ledger and the grid's "
                                 f"collectives differ: {cmp.diff()}")
        print(f"dry-run check 1: scale {scale} 2x2 {plan} ({len(ledgers)} batch(es), "
              f"{count.n_ops} collectives): bytes per kind, one rank {cmp.parsed}, summed "
              f"over the grid {cmp.parsed_grid}: equal to the ledger's")
    # (2) the reference test's partition on the card, every plan
    g = graph500.generate(DRYRUN_SCALE)[0]
    st = distributed.setup(g, SimGrid(*GRID, device="cuda"), "hybrid")
    roots = bfs.hub_roots(g.degrees(), 4)
    for plan in DRYRUN_PLANS:
        cmp = dryrun.ledger_against_count(st, roots, plan, policy="direction_opt")
        if not cmp.match:
            raise AssertionError(f"n = 2**{DRYRUN_SCALE} {plan}: the ledger and the grid's "
                                 f"collectives differ: {cmp.diff()}")
        print(f"dry-run check 2: n = 2**{DRYRUN_SCALE} 2x2 {plan} (direction_opt, hybrid, 4 "
              f"hub roots): bytes per kind, one rank {cmp.parsed}, summed over the grid "
              f"{cmp.parsed_grid}: equal to the ledger's, {len(cmp.per_phase)} phases")
    # (4) a real batch against one level on meta times its depth
    t1 = time.perf_counter()
    for plan in DRYRUN_PLANS:
        counted, level, depth = dryrun.batch_against_level(st, roots, plan, "top_down")
        bound = {k: depth * v for k, v in level.per_op.items()}
        exact = plan != "auto"  # auto's level runs one rung, the count holds all
        ok = set(counted.per_op) == set(bound) and all(
            counted.per_op[k] == v if exact else counted.per_op[k] <= v
            for k, v in bound.items())
        print(f"dry-run check 4: n = 2**{DRYRUN_SCALE} 2x2 {plan} (top_down, 4 hub roots, "
              f"depth {depth}): batch {counted.per_op}, one meta level x depth {bound}: "
              f"{'equal' if exact else 'within'}")
        if not ok:
            raise AssertionError(f"n = 2**{DRYRUN_SCALE} {plan}: batch {counted.per_op} "
                                 f"against one level x {depth} {bound}")
    print(f"dry-run check 4: {time.perf_counter() - t1:.1f}s")
    launches = dict(kernels.LAUNCHES)
    print(f"dry-run path launches: {launches}")
    require_launched(launches, DIST_PATH, "dry-run")
    del st
    # (3) three cells' records, counted on meta
    with tempfile.TemporaryDirectory(prefix="dryrun-") as out:
        for arch, shape, mesh_name in DRYRUN_CELLS:
            sizes = tuple(int(k) for k in mesh_name.split("x"))
            axes = ("pod", "data", "model")[-len(sizes):]
            t1 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, False, out, mesh=mesh.make_mesh(sizes, axes))
            rec.pop("traceback", None)
            print(json.dumps(rec, default=str))
            skip = shape == "long_500k"
            if rec["status"] != ("skip" if skip else "ok"):
                raise AssertionError(f"{arch}/{shape} on {mesh_name}: {rec.get('error', rec)}")
            if not skip:
                roof = rec["roofline"]
                coll = roof["collective_bytes"]
                if (not rec["memory"]["temp_bytes"] > 0
                        or (rec["cost"]["flops"] > 0) != (arch != "graph500")
                        or not coll > 0
                        or (arch == "graph500" and roof["collective_breakdown"] != GRAPH500_HLO)):
                    raise AssertionError(f"{arch}/{shape}: memory {rec['memory']}, cost "
                                         f"{rec['cost']}, collectives "
                                         f"{roof['collective_breakdown']}")
            print(f"dry-run check 3: {arch}/{shape} on {mesh_name}: {rec['status']} in "
                  f"{time.perf_counter() - t1:.1f}s (meta, host CPU)")
    if dict(kernels.LAUNCHES) != launches:
        raise AssertionError("a cell's count on meta launched a kernel")
    print(f"dry-run step: {time.perf_counter() - t0:.1f}s")
    return launches


def train_grid_step(card) -> dict:
    """Step 18: the sharded LM train step on a SimGrid 2x2 against the
    one-device step.  Returns the grid run's launch counts."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.bench import lm_train
    from repro_torch.bench import serve as serve_bench
    from repro_torch.comm import SimGrid
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as tfm
    from repro_torch.models import transformer_sharded as tsh
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with no_tf32():
        cfg, params = serve_bench.model("gemma-2b", TRAIN_GRID_LAYERS, dtype="fp32",
                                        device="cuda")
        toks = [torch.as_tensor(lm_train.token_rows(cfg, TRAIN_GRID_BATCH, TRAIN_GRID_SEQ, k),
                                device="cuda") for k in range(TRAIN_GRID_STEPS)]

        def loss_fn(p, b):
            return tfm.loss_fn(cfg, p, b)

        loss, grads = tstep.value_and_grad(loss_fn, params, {"tokens": toks[0]})
        want = {"loss": float(loss), "grad_norm": float(adamw.global_norm(grads))}
        one_step = tstep.make_train_step(loss_fn, adamw.AdamWConfig())
        state, one = tstep.init_state(params), []
        for k in range(TRAIN_GRID_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = one_step(state, {"tokens": toks[k]})
            one.append((float(m["loss"]), float(m["grad_norm"]), time.perf_counter() - t1))
        del state, m
        grid = SimGrid(2, 2, "cuda")
        specs = tsh.serving_specs(cfg, grid)
        states = tstep.shard_state(cfg, grid, tstep.init_state(params), specs)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        got_loss, got, norm = tstep.sharded_value_and_grad(
            cfg, grid, specs, grid.local(lambda p: states[p].params),
            tsh.shard_rows(grid, toks[0]))
        def gap(a, b):  # on the card, in float64: the leaves reach 524M values
            return float((a.double() - b.double()).abs().max() / b.double().abs().max())

        gaps = [gap(tsh.unshard_leaf(grid, [t[k] for t in map(tree.leaves, got)], sp), g)
                for k, (g, sp) in enumerate(zip(tree.leaves(grads),
                                                meshlib.spec_leaves(specs)))]
        first = (abs(float(got_loss) - want["loss"]) / abs(want["loss"]),
                 abs(float(norm[0]) - want["grad_norm"]) / want["grad_norm"])
        del got, grads
        step = tstep.make_sharded_train_step(cfg, grid, specs, adamw.AdamWConfig())
        runs = []
        for k in range(TRAIN_GRID_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            states, m = step(states, tsh.shard_rows(grid, toks[k]))
            runs.append((float(m["loss"]), float(m["grad_norm"]), time.perf_counter() - t1))
        peak = torch.cuda.max_memory_allocated()
        launches = dict(kernels.LAUNCHES)
    step_gaps = [max(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / b[1])
                 for a, b in zip(runs, one)]
    if not (max(gaps + list(first) + step_gaps) <= TRAIN_GRID_REL):
        raise AssertionError(f"gemma-2b train step on a SimGrid 2x2: loss and norm gaps {first}, "
                             f"gradient leaves {gaps}, steps {step_gaps} (bound "
                             f"{TRAIN_GRID_REL})")
    print(f"step 18, gemma-2b ({TRAIN_GRID_LAYERS} layers, fp32, TF32 off, {TRAIN_GRID_BATCH} rows "
          f"of {TRAIN_GRID_SEQ} tokens): the sharded train step on a SimGrid 2x2 (FSDP x TP) "
          f"against the one-device step: loss {first[0]:.3e}, norm {first[1]:.3e}, every "
          f"gradient leaf within {max(gaps):.3e} of its peak, {TRAIN_GRID_STEPS} steps' losses "
          f"and norms within {max(step_gaps):.3e} (bound {TRAIN_GRID_REL}); losses "
          f"{[round(r[0], 6) for r in runs]}; s a step {[round(r[2], 4) for r in runs]} vs "
          f"{[round(r[2], 4) for r in one]} on one device; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches or 'none'}; on {card}; {time.perf_counter() - t0:.1f}s")
    del params, states
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--scale", type=int, default=22)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.bench import graph500, teps

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib, log = kernels.build()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f}s -> {lib.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    check_ragged()
    print("ragged shapes: pack (b=1..32, bool/uint8/int32), popcount_planes and "
          "interleave_values (B = 2..17, sentinel columns untouched) on both routes, "
          "frontier_mask, popcount_blocks (W = 1..33,792, 1 word in) on both routes, "
          "unpack (b=1..32, up to 70,000 planes, a view one word in), popcount_words, "
          "spmv push/pull (B planes and one): exact")
    print(check_launch_stream())

    setup = graph500.build(args.scale, 16, 1, "hybrid", "cuda")
    info = graph500.summary(setup)
    print(f"graph: scale {args.scale} n={info['n']:,} m_stored={info['m_stored']:,} "
          f"K={info['split_k']} slab_edges={info['slab_edges']:,} "
          f"residue_edges={info['residue_edges']:,} "
          f"({100 * info['residue_edges'] / info['m_stored']:.2f}% in the COO residue)")
    print(f"phases: generation {info['generation_s']:.3f}s kernel1 "
          f"{info['kernel1_s']:.3f}s containers {info['containers_s']:.3f}s")
    roots = teps.valid_roots(setup.g, 64, seed=2)

    rows, single = main_shape_rows(setup, roots[:8])
    for r in rows.values():
        print(describe(r, card))
    pc = rows["popcount_planes"]
    print(f"popcount_planes at one plane {pc['other_shapes'][0]['shape']}: "
          f"{pc['other_shapes'][0]['ms'] * 1e3:.2f} us (device "
          f"{pc['other_shapes'][0]['device_ms'] * 1e3:.2f} us), bound "
          f"{pc['other_shapes'][0]['bound_ms'] * 1e3:.2f} us on {card}")

    kernels.reset_launches()
    out = graph500.search(setup, roots, batch=8, policy="direction_opt")
    launches = {"graph500": dict(kernels.LAUNCHES)}
    levels = sum(out["depths"])
    print(f"phases: bfs {out['bfs_s']:.3f}s validation {out['validation_s']:.3f}s "
          f"(batches {[round(t, 4) for t in out['batch_s']]}, depths {out['depths']})")
    print(f"launches on the Graph500 path ({levels} levels over {len(out['depths'])} "
          f"batches): {launches['graph500']}")
    require_launched(launches["graph500"], GRAPH500_PATH, "Graph500")
    if out["n_valid"] != out["n_roots"]:
        raise AssertionError(f"invalid trees: {out['failures']}")
    print(f"Graph500 scale {args.scale}: {out['n_valid']}/{out['n_roots']} trees valid, "
          f"TEPS harmonic mean {out['teps_harmonic_mean']:.6e} on {card}")

    launches["study"], rows["popcount_blocks"] = study_step(setup, roots, card)
    launches["distributed"], dist_rows, st, auto, dist_counted = distributed_step(
        setup, roots, single, card)
    launches["btfly"], btfly_rows = btfly_step(setup, roots, single, st, auto, card)
    del auto
    launches["procgrid"] = procgrid_step(card)
    cross_check(card)
    alg_launches, rows["gspmm_min_planes"], rows["interleave_values"] = algebra_step(
        setup, roots, st, card)
    launches.update(alg_launches)
    del setup, st, single
    launches["gnn"], rows["quantize"] = gnn_step(card)
    train_launches, train_rows = train_step(card)
    launches.update(train_launches)
    rows["quantize"]["train_shapes"] = [brief(r) for r in train_rows]
    equiv_launches, egnn_rows = equivariant_step(card)
    launches.update(equiv_launches)
    rows["quantize"]["egnn_shapes"] = [brief(r) for r in egnn_rows]
    launches["serve"] = serve_step(card)
    launches["recsys"] = recsys_step(card)
    launches["launch"] = launch_step(card)
    launches["dryrun"] = dryrun_step(card, args.scale, dist_counted)
    launches["lmtrain"] = train_grid_step(card)

    # unpack runs on the distributed path only: its row is the input that
    # moves the most bytes; every kernel lists its distributed inputs
    rows["unpack"] = dict(dist_rows["unpack"][0])
    for name, rs in dist_rows.items():
        rows[name]["distributed_shapes"] = [brief(r) for r in rs]
    for name, rs in btfly_rows.items():
        rows[name]["btfly_shapes"] = [brief(r) for r in rs]
    for name, r in rows.items():
        per_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        r["launches"] = sum(per_path.values())
        r["launches_by_path"] = per_path
    require_no_children()
    print(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
