"""The port's ``launch/dryrun.py`` and the collective count of
``launch/roofline.py`` against the reference's conventions.

Each case is the counterpart of one in ``tests/test_roofline.py`` or of
the end-to-end dry-run case of ``tests/test_cells.py``:

* ``count_collectives`` on a 4x1 ``SimGrid``: each collective's bytes,
  per rank (all-reduces doubled, the HLO convention of
  ``parse_collectives``) and summed over the grid (``test_parse_*``);
* ``compare_comm_stats`` for ``raw``, ``bitmap`` and ``auto`` on a 2x2
  ``SimGrid`` over the reference test's ``Partition2D(n=1 << 16)``, with a
  single root as there and with a batch of 4, and ``match`` / ``diff``
  equal to ``repro.launch.roofline.CommStatsComparison``'s on the same
  dicts (``test_comm_stats_match_hlo_all_modes``); one ``auto`` batch on a
  2x2 ``ProcessGrid`` over gloo, each process's ledger against its count;
* ``count_program`` exact on a hand-written product, relu, sum and
  backward, and ``terms_from_counts``' arithmetic;
* ``run_cell`` on the cells of the reference's end-to-end case: an LM
  prefill cell counted, an LM skip, a 2D cell's collectives, a graph500
  cell ``not_run``.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.configs import common as jcfgs
from repro.launch import roofline as jroofline
from repro_torch.bench import distributed, graph500
from repro_torch.comm import SimGrid, procgrid
from repro_torch.core import bfs
from repro_torch.core.csr import Partition2D
from repro_torch.launch import cells, dryrun, mesh, roofline

#: the keys of the reference's record (``repro/launch/dryrun.py``)
MEMORY_KEYS = ("output_bytes", "temp_bytes", "argument_bytes", "generated_code_bytes")
ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "dominant", "model_flops",
                 "hlo_flops_scaled", "hlo_bytes_scaled", "collective_bytes",
                 "collective_breakdown", "useful_flop_ratio", "roofline_fraction")
BFS_PHASES = {"bfs/column", "bfs/row", "bfs/transpose", "bfs/termination"}
MODES = ("raw", "bitmap", "auto")
TWO_BY_TWO = mesh.make_mesh((2, 2), ("data", "model"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def scale16():
    """The reference test's partition: n = 2**16 on 2x2 (a scale-16
    Kronecker graph, so that the BFS has values to run on)."""
    g = graph500.generate(16)[0]
    st = distributed.setup(g, SimGrid(2, 2, "cpu"), "coo")
    assert st.bg.part == Partition2D(n=1 << 16, n_orig=1 << 16, rows=2, cols=2)
    return st


# ---------------------------------------------------------------------------
# the collective count
# ---------------------------------------------------------------------------


def test_count_collectives_exact_bytes():
    grid = SimGrid(4, 1, "cpu")
    rows = grid.local(lambda p: torch.full((1024,), float(p)))
    with roofline.count_collectives(grid) as counted:
        total = grid.psum(rows, "data")
        gathered = grid.all_gather(grid.local(lambda p: torch.zeros(8, 2)), "data")
        swapped = grid.all_to_all(grid.local(lambda p: torch.zeros(8, dtype=torch.int32)),
                                  "data")
        shifted = grid.ppermute(grid.local(lambda p: torch.zeros(16, dtype=torch.int64)),
                                "data", [(a, (a + 1) % 4) for a in range(4)])
        grid.assemble(rows, dim=0)  # host bookkeeping: not a collective
    assert float(total[0][0]) == 6.0 and gathered[0].shape == (32, 2)
    assert swapped[3].shape == (8,) and shifted[1].shape == (16,)
    assert counted.per_op == {"all-reduce": 8192, "all-gather": 32 * 2 * 4,
                              "all-to-all": 8 * 4, "collective-permute": 16 * 8}
    assert counted.grid_per_op == {k: 4 * v for k, v in counted.per_op.items()}
    assert counted.total_bytes == sum(counted.per_op.values()) and counted.n_ops == 4
    assert counted.breakdown().startswith("all-gather:0.0MB")
    # restored on exit: the grid's own methods, nothing counted
    assert not {"psum", "all_gather", "ppermute"} & set(vars(grid))
    grid.psum(rows, "data")
    assert counted.n_ops == 4


def test_count_collectives_over_some_groups():
    """pmax / pmin are all-reduces; a call over some of an axis's groups
    counts one rank of the first and the ranks of all of them."""
    grid = SimGrid(2, 2, "cpu")
    xs = grid.local(lambda p: torch.zeros(3, dtype=torch.int32))
    with roofline.count_collectives(grid) as counted:
        grid.pmax(xs, "model", [[2, 3]])
        grid.pmin(xs, "data")
    assert counted.per_op == {"all-reduce": 2 * 12 + 2 * 12}
    assert counted.grid_per_op == {"all-reduce": 2 * 12 * 2 + 2 * 12 * 4}


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_compare_comm_stats_matches(scale16, mode, batch):
    roots = bfs.hub_roots(scale16.g.degrees(), batch)
    roots = np.int32(roots[0]) if batch == 1 else roots
    cmp = dryrun.ledger_against_count(scale16, roots, mode)
    assert cmp.match, (mode, cmp.diff())
    assert cmp.expected and cmp.expected_grid == {k: 4 * v for k, v in cmp.expected.items()}
    if batch == 1:  # every BFS exchange zone is in the ledger
        assert set(cmp.per_phase) == BFS_PHASES, cmp.per_phase
    else:  # payloads attributed per plane, summing back to the calls' bytes
        assert {p.split("@")[0] for p in cmp.per_phase} == BFS_PHASES
        assert any("@p3" in p for p in cmp.per_phase)
    # match and diff as the reference's on the same dicts, and a miss
    ref = jroofline.CommStatsComparison(cmp.expected, cmp.parsed, cmp.per_phase)
    assert ref.match and ref.diff() == cmp.diff() == {}
    off = dict(cmp.parsed, **{"all-to-all": cmp.parsed["all-to-all"] + 4})
    bad = roofline.CommStatsComparison(cmp.expected, off, cmp.per_phase,
                                       cmp.expected_grid, cmp.parsed_grid)
    ref = jroofline.CommStatsComparison(cmp.expected, off, cmp.per_phase)
    assert not bad.match and not ref.match and bad.diff() == ref.diff()
    bad.parsed_grid = dict(cmp.parsed_grid, **{"all-gather": 1})
    assert set(bad.diff()) == {"all-to-all", "all-gather (grid)"}


def test_compare_comm_stats_on_the_process_grid(scale16):
    """One ``auto`` batch on a 2x2 grid of gloo processes: each process's
    ledger against its own count, and the count the same on every rank
    (one rank's bytes) as the simulated grid's."""
    roots = bfs.hub_roots(scale16.g.degrees(), 4)
    want = dryrun.ledger_against_count(scale16, roots, "auto")
    spec = {"scale": 16, "expand": "coo", "modes": ["auto"], "roots": roots}
    outs = procgrid.spawn(dryrun.proc_ledger_check, 2, 2, device="cpu", args=(spec,),
                          timeout_s=240)
    assert [o["rank"] for o in outs] == [0, 1, 2, 3]
    for o in outs:
        got = o["auto"]
        assert got["match"] and got["diff"] == {}, (o["rank"], got["diff"])
        assert got["parsed"] == want.parsed
        assert got["parsed_grid"] == got["parsed"]  # one rank per process


# ---------------------------------------------------------------------------
# the program count
# ---------------------------------------------------------------------------


def _toy(x, w):
    w = w.detach().requires_grad_()
    h = (x @ w).relu()
    loss = h.sum()
    (g,) = torch.autograd.grad(loss, w)
    return loss, g


def test_count_program_on_a_toy():
    """(64 x 128) @ (128 x 32), relu, sum and the gradient of w, f32.  Ops:
    mm, relu, sum, ones_like (the seed), threshold_backward and mm; the
    views (detach, expand, t) count nothing."""
    m, k, n = 64, 128, 32
    x = torch.empty(m, k, device="meta")
    w = torch.empty(k, n, device="meta")
    c = dryrun.count_program(_toy, (x, w))
    assert c.flops == 2 * m * k * n * 2  # forward and w's gradient
    mk, kn, mn = 4 * m * k, 4 * k * n, 4 * m * n
    assert c.bytes_accessed == ((mk + kn + mn) + 2 * mn + (mn + 4) + (4 + 4) + 3 * mn
                                + (mk + mn + kn))
    # loss and g are new storages; the peak holds relu's output (saved for
    # its backward), loss, the seed, threshold_backward's output and g
    assert c.output_bytes == 4 + kn
    assert c.peak_bytes == mn + 4 + 4 + mn + kn
    assert c.temp_bytes == c.peak_bytes - c.output_bytes
    assert c.collectives.total_bytes == 0 and c.seconds > 0
    # an output that is an argument, or views one, adds no output bytes
    alias = dryrun.count_program(lambda a, b: (a, b[1:], a + 1), (x, w))
    assert alias.output_bytes == mk and alias.bytes_accessed == 2 * mk


def test_terms_from_counts_arithmetic():
    counted = roofline.CollectiveStats(per_op={"all-gather": 100}, total_bytes=100, n_ops=1)
    counts = dryrun.ProgramCounts(flops=4 * roofline.PEAK_FLOPS, bytes_accessed=8 * roofline.HBM_BW,
                                  output_bytes=0, temp_bytes=0, peak_bytes=0, seconds=0.0,
                                  collectives=counted)
    t = roofline.terms_from_counts(counts, chips=4, model_flops=2 * roofline.PEAK_FLOPS)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 100 / roofline.LINK_BW)
    assert (t.hlo_flops, t.hlo_bytes, t.collective_bytes) == (
        roofline.PEAK_FLOPS, 2 * roofline.HBM_BW, 100)
    assert t.dominant == "memory" and t.useful_flop_ratio == 0.5
    assert t.roofline_fraction == 0.5 / 2.0


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _stored(rec, out_dir) -> dict:
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name)) as f:
        return json.load(f)


def test_run_cell_lm_prefill_and_skip(tmp_path, capsys):
    rec = dryrun.run_cell("gemma-2b", "prefill_32k", True, str(tmp_path))
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16", rec.get("traceback")
    assert rec["compile_s"] == 0.0 and rec["lower_s"] > 0
    assert set(MEMORY_KEYS) <= set(rec["memory"]) and set(ROOFLINE_KEYS) <= set(rec["roofline"])
    assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["generated_code_bytes"] is None
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    roof = rec["roofline"]
    assert roof["collective_bytes"] == 0 and roof["collective_breakdown"] == {}
    assert roof["hlo_flops_scaled"] == rec["cost"]["flops"] / 512
    assert roof["model_flops"] == rec["meta"]["model_flops"]
    assert _stored(rec, str(tmp_path)) == json.loads(json.dumps(rec, default=str))

    skip = dryrun.run_cell("minicpm-2b", "long_500k", True, str(tmp_path))
    want = jcfgs.get("minicpm-2b").shape("long_500k").skip_reason
    assert skip["status"] == "skip" and skip["skip_reason"] == want
    capsys.readouterr()
    tally = dryrun.report(str(tmp_path))
    assert tally["all"] == {"cells": 2, "ok": 1, "not_run": 0, "skip": 1, "error": 0}
    assert "ok=1 not_run=0 skip=1 error=0" in capsys.readouterr().out


def test_run_cell_2d_collectives_equal_the_count(tmp_path):
    """gat-cora's ``ogb_products`` train step on meta at a (2, 2) mesh: its
    record's collective bytes are what the grid ran, counted again here."""
    rec = dryrun.run_cell("gat-cora", "ogb_products", False, str(tmp_path), mesh=TWO_BY_TWO)
    assert rec["status"] == "ok" and rec["mesh"] == "2x2", rec.get("traceback")
    cell = cells.build_cell("gat-cora", "ogb_products", TWO_BY_TWO)
    grid = cells.make_grid(TWO_BY_TWO, cells.META)
    counts = dryrun.count_program(lambda *a: cell.fn(*a, grid=grid), cell.args, grid)
    roof = rec["roofline"]
    assert roof["collective_bytes"] > 0
    assert roof["collective_bytes"] == counts.collectives.total_bytes
    assert roof["collective_breakdown"] == counts.collectives.per_op
    assert set(roof["collective_breakdown"]) == {"all-gather", "all-to-all", "all-reduce",
                                                 "collective-permute"}
    assert counts.collectives.grid_per_op == {k: 4 * v for k, v in
                                              counts.collectives.per_op.items()}
    assert rec["cost"] == {"flops": counts.flops, "bytes_accessed": counts.bytes_accessed}
    assert rec["memory"]["output_bytes"] == counts.output_bytes > 0


def test_run_cell_graph500_not_run(tmp_path):
    rec = dryrun.run_cell("graph500", "scale22", False, str(tmp_path), mesh=TWO_BY_TWO)
    assert rec["status"] == "ok" and rec["not_run"] == dryrun.NOT_RUN
    assert "cost" not in rec and "roofline" not in rec
    e_cap = int(rec["meta"]["e_cap"])
    # src and dst blocks (2, 2, e_cap) int32 split over (data, model), the root
    assert rec["memory"] == {"argument_bytes": 2 * e_cap * 4 + 4}
    assert dryrun.report(str(tmp_path))["2x2"]["not_run"] == 1
