"""Roofline terms of one cell on the H100, and the collectives a grid ran.

The port's counterpart of ``repro/launch/roofline.py``: the card's peaks
and :class:`RooflineTerms`, three terms per (arch x shape x mesh), in
seconds:

    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bytes/s
    collective = collective bytes / link bytes/s

Hardware: NVIDIA H100 SXM5 80 GB (NVIDIA's H100 datasheet): 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink's 900 GB/s
over 18 fourth-generation links, 50 GB/s a link.  ``HBM_BW`` is the rate
the kernel bounds of ``chip_smoke.py`` use.

The reference reads a compiled XLA program: ``parse_collectives`` sums the
collectives of its HLO text, ``terms_from_compiled`` takes FLOPs and bytes
from ``cost_analysis``, and ``compare_comm_stats`` holds the ``CommStats``
ledger against the parsed collectives.  An eager PyTorch program has no
HLO; what it runs is what the grid executes.  So here

* :func:`count_collectives` wraps the seven collectives of one grid
  instance (``all_gather``, ``all_to_all``, ``psum``, ``pmax``, ``pmin``,
  ``ppermute``, ``reduce_scatter``) and counts every call into a
  :class:`CollectiveStats`, in the reference's conventions: one rank's
  result-shape bytes per call, the all-reduces doubled (the ring
  convention of ``comm.stats.HLO_FACTOR``), and beside them the same bytes
  summed over every rank that ran the call;
* :func:`compare_comm_stats` holds a ledger against such a count, per op
  kind, per rank and summed over the grid;
* :func:`terms_from_counts` makes the terms from the counts of a program
  run on ``meta`` (:func:`repro_torch.launch.dryrun.count_program`).

``_shape_bytes`` and ``parse_collectives`` read HLO text and have no
counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect

from repro_torch.comm.engine import nbytes_of
from repro_torch.comm.stats import HLO_FACTOR

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores / card
HBM_BW = 3.35e12  # bytes / s / card (HBM3)
LINK_BW = 50e9  # bytes / s / NVLink link (900 GB/s over 18 links)

#: a grid's collectives -> the op kind the reference's HLO names them by
GRID_COLLECTIVES = {
    "all_gather": "all-gather",
    "all_to_all": "all-to-all",
    "psum": "all-reduce",
    "pmax": "all-reduce",
    "pmin": "all-reduce",
    "ppermute": "collective-permute",
    "reduce_scatter": "reduce-scatter",
}


@dataclasses.dataclass
class CollectiveStats:
    per_op: dict[str, int]  # op kind -> one rank's bytes (all-reduce doubled)
    total_bytes: int
    n_ops: int
    #: op kind -> the same bytes summed over every rank that ran each call
    grid_per_op: dict[str, int] = dataclasses.field(default_factory=dict)

    def breakdown(self) -> str:
        return ", ".join(f"{k}:{v / 1e6:.1f}MB" for k, v in sorted(self.per_op.items()))

    def add(self, kind: str, nbytes: int, grid_bytes: int) -> None:
        """One call of ``kind``: one rank's result bytes and their sum over
        the ranks that ran it, both before the all-reduce factor."""
        factor = HLO_FACTOR.get(kind, 1)
        self.per_op[kind] = self.per_op.get(kind, 0) + factor * nbytes
        self.grid_per_op[kind] = self.grid_per_op.get(kind, 0) + factor * grid_bytes
        self.total_bytes += factor * nbytes
        self.n_ops += 1


@contextlib.contextmanager
def count_collectives(grid):
    """Count every collective ``grid`` runs inside the block.

    Wraps the seven collectives of this grid instance (not its class) and
    restores them on exit; yields the :class:`CollectiveStats` the calls
    fill.  A call's one rank is the first local rank of the first group it
    ran over, as ``AdaptiveExchange`` records it; its grid bytes add the
    result of every local rank of those groups.  The grid's host
    bookkeeping (``assemble``, ``gather_objects``, ``barrier``) is not a
    collective of the program and is not counted.  An eager run executes
    every level and every layer, so no loop multiplier is needed, with one
    exception: the distributed BFS on a ``meta`` grid runs one level (each
    adaptive exchange with every branch), the while body the reference's
    HLO holds once, and the dry-run scales that count by the cell's
    ``loop_mult`` as ``parse_collectives`` does."""
    counted = CollectiveStats(per_op={}, total_bytes=0, n_ops=0)
    saved = {name: grid.__dict__.get(name) for name in GRID_COLLECTIVES}

    def wrap(name: str, kind: str):
        run = getattr(grid, name)
        sig = inspect.signature(run)

        def counted_call(*args, **kwargs):
            out = run(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            groups = bound.arguments.get("groups") or grid.groups(bound.arguments["axis"])
            local = set(grid.local_ranks)
            ranks = [p for g in groups for p in g if p in local]
            if not ranks:  # no rank of this process took part
                return out
            counted.add(kind, nbytes_of(out[ranks[0]]), sum(nbytes_of(out[p]) for p in ranks))
            return out

        return counted_call

    for name, kind in GRID_COLLECTIVES.items():
        setattr(grid, name, wrap(name, kind))
    try:
        yield counted
    finally:
        for name, prev in saved.items():
            if prev is None:
                del grid.__dict__[name]
            else:
                setattr(grid, name, prev)


@dataclasses.dataclass
class CommStatsComparison:
    """CommStats-expected vs counted collective bytes, per op kind."""

    expected: dict[str, int]  # op kind -> one rank's bytes, from CommStats
    parsed: dict[str, int]  # op kind -> one rank's bytes, from count_collectives
    per_phase: dict[str, int]  # CommStats phase -> bytes
    #: the same per op kind summed over every rank of every call: the
    #: ledger's ``grid_bytes`` (all-reduces doubled) and the count's
    expected_grid: dict[str, int] = dataclasses.field(default_factory=dict)
    parsed_grid: dict[str, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def _diff(a: dict, b: dict) -> dict[str, tuple[int, int]]:
        return {k: (a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))
                if a.get(k, 0) != b.get(k, 0)}

    @property
    def match(self) -> bool:
        return not self.diff()

    def diff(self) -> dict[str, tuple[int, int]]:
        """Op kind -> (expected, counted) where they differ; a difference
        of the grid sums is keyed ``"<kind> (grid)"``."""
        out = self._diff(self.expected, self.parsed)
        out.update({f"{k} (grid)": v
                    for k, v in self._diff(self.expected_grid, self.parsed_grid).items()})
        return out


def compare_comm_stats(stats, counted: CollectiveStats) -> CommStatsComparison:
    """Check CommStats accounting against the collectives the grid ran.

    ``stats`` is the :class:`repro_torch.comm.CommStats` of a run, or a
    sequence of them (the batches of one run); ``counted`` what
    :func:`count_collectives` counted over the same run.  Both take one
    rank's result-shape bytes per call with the ring all-reduce doubled,
    so the totals agree per op kind if every collective of the program
    went through the ledger; the grid sums are held the same way.
    """
    ledgers = [stats] if hasattr(stats, "per_op") else list(stats)
    expected: dict[str, int] = {}
    per_phase: dict[str, int] = {}
    grid: dict[str, int] = {}
    for ledger in ledgers:
        for k, v in ledger.per_op().items():
            expected[k] = expected.get(k, 0) + v
        for k, v in ledger.per_phase().items():
            per_phase[k] = per_phase.get(k, 0) + v
        for r in ledger.records():
            grid[r.collective] = (grid.get(r.collective, 0)
                                  + r.grid_bytes * HLO_FACTOR.get(r.collective, 1))
    return CommStatsComparison(expected=expected, parsed=dict(counted.per_op),
                               per_phase=per_phase, expected_grid=grid,
                               parsed_grid=dict(counted.grid_per_op))


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float  # loop-scaled, per device
    hlo_bytes: float
    collective_bytes: float
    model_flops: float  # analytic (6ND etc.), GLOBAL
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / (program FLOPs x chips): recomputation, dispatch
        and mask waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute roofline fraction if the program ran at its bound:
        (MODEL_FLOPS / peak-of-all-chips) / bound-time."""
        ideal_s = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal_s / self.bound_s if self.bound_s else 0.0


def terms_from_counts(counts, chips: int, model_flops: float,
                      loop_mult: float = 1.0) -> RooflineTerms:
    """The three terms from the counts of a program run once on ``meta``
    (:class:`repro_torch.launch.dryrun.ProgramCounts`).

    A cell's ``fn`` is one program at global shapes, so a device's FLOPs
    and bytes are the counted totals over ``chips``; ``compute_s`` and
    ``memory_s`` are those shares over ``PEAK_FLOPS`` and ``HBM_BW``, as in
    the reference.  ``collective_s`` is the counted per-rank collective
    bytes over ``LINK_BW``.  FLOPs, bytes and collective bytes are
    multiplied by ``loop_mult``, as ``terms_from_compiled`` does.  An eager
    run counts every iteration it executes, so the default is 1; the
    distributed BFS is the exception: on ``meta`` it runs one level, not
    the loop, and its cells pass their ``loop_mult`` (the reference
    applies one because ``cost_analysis`` visits a while-body once).
    """
    flops = counts.flops * loop_mult / chips
    bytes_ = counts.bytes_accessed * loop_mult / chips
    coll = int(counts.collectives.total_bytes * loop_mult)
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_ / HBM_BW,
        collective_s=coll / LINK_BW,
        hlo_flops=flops,
        hlo_bytes=bytes_,
        collective_bytes=coll,
        model_flops=model_flops,
        chips=chips,
    )
