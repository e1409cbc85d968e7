"""CommStats: the byte ledger of every wire exchange.

The port's counterpart of ``repro/comm/stats.py``, with one difference of
meaning.  The reference records at trace time, once per branch of the
program (a set keyed by phase, format, collective and part).  The port's
ledger records what each level actually sent: every collective call adds
its bytes to its key, so a level that ran the 4096-id bucket shows up under
``pfor16[4096]`` and a level that fell to the bitmap under ``bitmap``, and
``count`` counts the calls.

Byte conventions per call are the reference's: ``nbytes`` is one rank's
result-shape bytes (all-reduces are doubled in :attr:`hlo_bytes`, the ring
convention), ``moved_bytes`` what crosses a link for that rank (self-sends
and the own chunk of a gather excluded).  The ``grid_*`` fields add up the
same two over every rank that ran the call — what a host replay of the
whole grid counts (``benchmarks/bfs_comm.py``).
"""

from __future__ import annotations

import dataclasses

#: multiplier applied per collective kind (ring all-reduce moves ~2x the
#: operand: reduce phase + broadcast phase)
HLO_FACTOR = {"all-reduce": 2}

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class ExchangeRecord:
    phase: str  # logical exchange zone, e.g. "bfs/column"
    fmt: str  # wire-format name, e.g. "pfor16[1024]" / "bitmap"
    collective: str  # collective kind (see COLLECTIVE_KINDS)
    part: str  # payload component: "words" | "meta" | "bucket" | ...
    nbytes: int = 0  # one rank's result-shape bytes, summed over calls
    count: int = 0  # calls
    moved_bytes: int = 0  # one rank's link bytes, summed over calls
    grid_bytes: int = 0  # nbytes summed over every rank of every call
    grid_moved_bytes: int = 0  # moved_bytes summed the same way

    @property
    def hlo_bytes(self) -> int:
        """``nbytes`` with the all-reduce ring factor."""
        return self.nbytes * HLO_FACTOR.get(self.collective, 1)


class CommStats:
    """Per-call exchange-byte ledger; see the module docstring."""

    def __init__(self) -> None:
        self._records: dict[tuple[str, str, str, str], ExchangeRecord] = {}

    def record(self, phase: str, fmt: str, collective: str, part: str, nbytes: int,
               moved_bytes: int | None = None, ranks: int = 1) -> None:
        """Add one call that ``ranks`` ranks ran, each with a result of
        ``nbytes`` bytes of which ``moved_bytes`` crossed a link."""
        assert collective in COLLECTIVE_KINDS, collective
        moved = nbytes if moved_bytes is None else moved_bytes
        key = (phase, fmt, collective, part)
        rec = self._records.setdefault(key, ExchangeRecord(*key))
        rec.nbytes += int(nbytes)
        rec.count += 1
        rec.moved_bytes += int(moved)
        rec.grid_bytes += int(nbytes) * ranks
        rec.grid_moved_bytes += int(moved) * ranks

    def records(self) -> list[ExchangeRecord]:
        return [self._records[k] for k in sorted(self._records)]

    def table(self) -> list[dict]:
        """JSON-friendly dump."""
        return [dataclasses.asdict(r) | {"hlo_bytes": r.hlo_bytes} for r in self.records()]
