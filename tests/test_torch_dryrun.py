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
  prefill cell counted (its output the last position's logits only, its
  sharded program's collectives), an LM skip, a 2D cell's collectives;
* the distributed BFS on ``meta`` (one level, every rung of each adaptive
  exchange) against the reference's compiled HLO, in one JAX subprocess
  with 4 forced host devices: at n = 2**16 on 2x2 under ``raw``,
  ``bitmap`` and ``auto``, ``parse_collectives(hlo, 1.0)`` per kind; and
  the ``graph500/scale22`` cell (baseline and ``bitmaponly``) on a 2x2
  mesh, ``parse_collectives(hlo, 8.0)`` per kind;
* a real batch's collectives against that one-level count times its depth.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import common as jcfgs
from repro.launch import roofline as jroofline
from repro_torch.bench import distributed, graph500
from repro_torch.comm import AdaptiveExchange, CommStats, SimGrid, procgrid
from repro_torch.configs import common as configs
from repro_torch.core import bfs
from repro_torch.core import distributed_bfs as dbfs
from repro_torch.core.csr import Partition2D
from repro_torch.launch import cells, dryrun, mesh, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


#: the reference's HLO collectives, per op kind: the BFS at n = 2**16 on
#: 2x2 per plan (loop body once) and the graph500/scale22 cell per variant
#: (loop_mult 8), printed as JSON by a subprocess of 4 host devices
JAX_HLO = """
import json
import jax, jax.numpy as jnp
from repro import compat
from repro.core import csr, distributed_bfs as dbfs
from repro.launch import cells, roofline
mesh = jax.make_mesh((2, 2), ("data", "model"))
part = csr.Partition2D(n=1 << 16, n_orig=1 << 16, rows=2, cols=2)
blk = jax.ShapeDtypeStruct((2, 2, 4096), jnp.int32)
out = {}
for mode in ("raw", "bitmap", "auto"):
    fn = dbfs.build_bfs(mesh, part, dbfs.DistBFSConfig(mode=mode))
    hlo = jax.jit(fn).lower(blk, blk, jax.ShapeDtypeStruct((), jnp.int32)).compile().as_text()
    out[mode] = roofline.parse_collectives(hlo, 1.0).per_op
for variant in ("baseline", "bitmaponly"):
    cell = cells.build_cell("graph500", "scale22", mesh, variant=variant)
    with compat.set_mesh(mesh):
        lowered = jax.jit(cell.fn, in_shardings=cell.in_shardings).lower(*cell.args)
    hlo = lowered.compile().as_text()
    out["scale22/" + variant] = roofline.parse_collectives(hlo, cell.meta["loop_mult"]).per_op
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_hlo() -> dict:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", JAX_HLO], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout[-2000:]}\nSTDERR:\n{out.stderr[-3000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


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
    # the sharded serving program on every rank of the mesh (FSDP x TP)
    breakdown = roof["collective_breakdown"]
    assert set(breakdown) == {"all-gather", "all-reduce", "all-to-all"}
    assert all(v > 0 for v in breakdown.values())
    assert roof["collective_bytes"] == sum(breakdown.values())
    assert roof["hlo_flops_scaled"] == rec["cost"]["flops"] / 512
    assert roof["model_flops"] == rec["meta"]["model_flops"]
    assert _stored(rec, str(tmp_path)) == json.loads(json.dumps(rec, default=str))

    # prefill keeps the last position's (B, V_pad) logits only
    cfg = configs.get("gemma-2b").model_config()
    batch = configs.get("gemma-2b").shape("prefill_32k").params["global_batch"]
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    assert rec["memory"]["output_bytes"] == batch * cfg.padded_vocab * itemsize

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


@pytest.mark.parametrize("variant", ["baseline", "bitmaponly"])
def test_run_cell_graph500_equals_the_hlo(tmp_path, jax_hlo, variant):
    """The paper's cell on a 2x2 mesh: one level on meta, every rung,
    times the cell's loop_mult, per kind equal to the reference's compiled
    program's collectives; no product FLOPs, the peak of the global
    program, the arguments per rank as before."""
    rec = dryrun.run_cell("graph500", "scale22", False, str(tmp_path), variant=variant,
                          mesh=TWO_BY_TWO)
    assert rec["status"] == "ok" and "not_run" not in rec, rec.get("traceback")
    assert set(MEMORY_KEYS) <= set(rec["memory"]) and set(ROOFLINE_KEYS) <= set(rec["roofline"])
    roof = rec["roofline"]
    assert roof["collective_breakdown"] == jax_hlo[f"scale22/{variant}"]
    assert roof["collective_bytes"] == sum(jax_hlo[f"scale22/{variant}"].values())
    assert rec["meta"]["loop_mult"] == 8.0
    assert rec["cost"]["flops"] == 0 and roof["compute_s"] == 0
    assert roof["useful_flop_ratio"] == 0
    assert roof["hlo_bytes_scaled"] == 8 * rec["cost"]["bytes_accessed"] / 4
    assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["output_bytes"] > 0
    e_cap = int(rec["meta"]["e_cap"])
    # src and dst blocks (2, 2, e_cap) int32 split over (data, model), the root
    assert rec["memory"]["argument_bytes"] == 2 * e_cap * 4 + 4
    tally = dryrun.report(str(tmp_path))
    assert tally["2x2"] == {"cells": 1, "ok": 1, "not_run": 0, "skip": 0, "error": 0}


# ---------------------------------------------------------------------------
# the distributed BFS on meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_meta_level_equals_the_hlo(jax_hlo, mode):
    """The reference test's partition on a meta 2x2 grid: one level, each
    adaptive exchange with every branch, is the while body of the
    reference's compiled program, byte for byte per kind."""
    grid = SimGrid(2, 2, "meta")
    part = Partition2D(n=1 << 16, n_orig=1 << 16, rows=2, cols=2)
    blk = grid.local(lambda q: torch.empty(4096, dtype=torch.int32, device="meta"))
    fn = dbfs.build_bfs(grid, part, dbfs.DistBFSConfig(mode=mode))
    with roofline.count_collectives(grid) as counted:
        parent, level, depth = fn(blk, blk, torch.empty((), dtype=torch.int32, device="meta"))
    assert counted.per_op == jax_hlo[mode]
    assert depth == 1 and parent.shape == level.shape == (1 << 16,)
    assert parent.device.type == "meta"


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_batch_within_level_count_times_depth(scale16, mode, batch):
    """A real batch on the CPU grid sends, per kind, the one-level meta
    count times its depth: exactly for the single-format plans, at most
    that for ``auto`` (a level runs one rung where the count holds all)."""
    roots = bfs.hub_roots(scale16.g.degrees(), batch)
    roots = np.int32(roots[0]) if batch == 1 else roots
    counted, level, depth = dryrun.batch_against_level(scale16, roots, mode)
    assert depth > 1 and set(counted.per_op) == set(level.per_op)
    bound = {k: depth * v for k, v in level.per_op.items()}
    if mode == "auto":
        assert all(counted.per_op[k] <= bound[k] for k in bound), (counted.per_op, bound)
        assert counted.per_op["all-to-all"] < bound["all-to-all"]
    else:
        assert counted.per_op == bound


def _exchange(grid, stats=None):
    return AdaptiveExchange("bfs/column", grid, "data", None, stats)


def test_dispatch_on_meta_runs_every_branch_over_every_group():
    grid = SimGrid(2, 2, "meta")
    stats = CommStats()
    ex = _exchange(grid, stats)
    ran = []

    def branch(k):
        def run(groups):
            ran.append((k, groups))
            return ex.all_gather(grid.local(lambda p: torch.empty(8, device="meta")),
                                 fmt=f"f{k}", groups=groups)
        return run

    bucket = grid.local(lambda p: torch.empty((), dtype=torch.int32, device="meta"))
    out = ex.dispatch(bucket, [branch(0), branch(1), branch(2)])
    assert ran == [(k, grid.groups("data")) for k in range(3)]
    assert all(o.shape == (16,) and o.device.type == "meta" for o in out)
    # the trace-time ledger: the consensus and every rung
    assert {r.fmt for r in stats.records()} == {"consensus", "f0", "f1", "f2"}


def test_dispatch_refuses_meta_mixed_with_another_device():
    grid = SimGrid(2, 2, "cpu")
    bucket = grid.local(lambda p: torch.zeros((), dtype=torch.int32))
    bucket[0] = torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        _exchange(grid).dispatch(bucket, [lambda gs: [None] * 4, lambda gs: [None] * 4])


def test_validate_roots_on_meta():
    """Shape and dtype only, as the reference checks a traced root."""
    root = bfs.validate_roots(torch.empty(4, dtype=torch.int64, device="meta"), 16)
    assert root.device.type == "meta" and root.dtype == torch.int32 and root.shape == (4,)
    with pytest.raises(TypeError):
        bfs.validate_roots(torch.empty((), device="meta"), 16)
    with pytest.raises(ValueError):
        bfs.validate_roots(torch.empty(2, 2, dtype=torch.int32, device="meta"), 16)
    with pytest.raises(ValueError):
        bfs.validate_roots(torch.empty(0, dtype=torch.int32, device="meta"), 16)
