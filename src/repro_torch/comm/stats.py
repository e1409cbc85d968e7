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
whole grid counts (:mod:`repro_torch.bench.bfs_comm`).  The replay itself
fills a ledger through :meth:`CommStats.add`, with bytes that are already
totals over the grid and already cross links.

On a grid of one process per rank
(:class:`repro_torch.comm.procgrid.ProcessGrid`) each process records its
own rank's calls.  Every call the engine records carries a call index
(:meth:`CommStats.call_index`), the same in every process, and
:meth:`CommStats.gather` merges the processes' calls into the ledger one
process holding every rank records: for each (call index, key) one call,
one rank's ``nbytes`` and ``moved_bytes``, the ``grid_*`` fields summed
over the processes.  Calls recorded through :meth:`CommStats.add` carry
no index and take no part in the merge.
"""

from __future__ import annotations

import contextlib
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
        # (call index, key, nbytes, moved_bytes, ranks) of every indexed call
        self._calls: list[tuple] = []
        self._top = 0  # top-level exchanges so far
        self._scope: list[int] | None = None  # [exchange, next position]

    def record(self, phase: str, fmt: str, collective: str, part: str, nbytes: int,
               moved_bytes: int | None = None, ranks: int = 1,
               call: tuple[int, int] | None = None) -> None:
        """Add one call that ``ranks`` ranks ran, each with a result of
        ``nbytes`` bytes of which ``moved_bytes`` crossed a link; ``call``
        is its call index, for :meth:`gather`."""
        assert collective in COLLECTIVE_KINDS, collective
        moved = nbytes if moved_bytes is None else moved_bytes
        key = (phase, fmt, collective, part)
        self._accumulate(key, int(nbytes), int(moved), int(nbytes) * ranks,
                         int(moved) * ranks)
        if call is not None:
            self._calls.append((call, key, int(nbytes), int(moved), ranks))

    def _accumulate(self, key, nbytes: int, moved: int, grid_bytes: int,
                    grid_moved: int, count: int = 1) -> None:
        rec = self._records.setdefault(key, ExchangeRecord(*key))
        rec.nbytes += nbytes
        rec.count += count
        rec.moved_bytes += moved
        rec.grid_bytes += grid_bytes
        rec.grid_moved_bytes += grid_moved

    # -- call indices and the merge over processes ---------------------------

    def call_index(self) -> tuple[int, int]:
        """The index of the next call: (top-level exchange, position in it).
        Outside :meth:`exchange` every call is an exchange of its own."""
        if self._scope is None:
            self._top += 1
            return (self._top - 1, 0)
        self._scope[1] += 1
        return (self._scope[0], self._scope[1] - 1)

    @contextlib.contextmanager
    def exchange(self):
        """One top-level exchange (an adaptive dispatch): its calls share
        the exchange's index.  Yields ``branch()``, which each branch calls
        before it runs, so that every branch numbers its calls from the
        same position whichever groups chose it.  Exchanges do not nest."""
        if self._scope is not None:
            raise RuntimeError("an exchange inside an exchange: call indices would clash")
        self._scope = scope = [self._top, 0]
        self._top += 1
        start: list[int] = []

        def branch() -> None:
            if not start:
                start.append(scope[1])
            scope[1] = start[0]

        try:
            yield branch
        finally:
            self._scope = None

    def calls(self) -> list[tuple]:
        """This ledger's indexed calls: (call index, key, nbytes,
        moved_bytes, ranks)."""
        return list(self._calls)

    @classmethod
    def merged(cls, parts) -> "CommStats":
        """The ledger of the calls of several processes (each a
        :meth:`calls` list): one call per (call index, key), one rank's
        ``nbytes`` and ``moved_bytes``, the ``grid_*`` fields summed."""
        calls: dict = {}
        for part in parts:
            seen = set()
            for call, key, nbytes, moved, ranks in part:
                tag = (tuple(call), tuple(key))
                if tag in seen:
                    raise ValueError(f"call {tag} recorded twice by one process")
                seen.add(tag)
                c = calls.setdefault(tag, [nbytes, moved, 0, 0])
                if (c[0], c[1]) != (nbytes, moved):
                    raise ValueError(f"call {tag}: ranks disagree on its bytes "
                                     f"({c[0]}, {c[1]}) vs ({nbytes}, {moved})")
                c[2] += nbytes * ranks
                c[3] += moved * ranks
        out = cls()
        for (_, key), (nbytes, moved, grid_bytes, grid_moved) in sorted(calls.items()):
            out._accumulate(key, nbytes, moved, grid_bytes, grid_moved)
        return out

    def gather(self, grid) -> "CommStats":
        """The merged ledger of every process of ``grid`` (a collective over
        the whole grid outside the ledger: every process calls it)."""
        return self.merged(grid.gather_objects(self._calls))

    def add(self, phase: str, fmt: str, collective: str, nbytes: int,
            part: str = "words", count: int = 1) -> None:
        """Accumulate ``nbytes`` over ``count`` op instances, already totaled
        over the grid and all true link traffic (the host replay's zones):
        every byte field takes them."""
        assert collective in COLLECTIVE_KINDS, collective
        key = (phase, fmt, collective, part)
        self._accumulate(key, int(nbytes), int(nbytes), int(nbytes), int(nbytes), count)

    def records(self) -> list[ExchangeRecord]:
        return [self._records[k] for k in sorted(self._records)]

    # -- views ---------------------------------------------------------------

    def _sum_by(self, key, value) -> dict:
        out: dict = {}
        for r in self.records():
            out[key(r)] = out.get(key(r), 0) + value(r)
        return out

    def per_phase(self) -> dict[str, int]:
        """phase -> bytes (HLO convention, all-reduce doubled)."""
        return self._sum_by(lambda r: r.phase, lambda r: r.hlo_bytes)

    def per_phase_moved(self) -> dict[str, int]:
        """phase -> link bytes (self-sends excluded, no HLO factor)."""
        return self._sum_by(lambda r: r.phase, lambda r: r.moved_bytes)

    def per_phase_fmt(self) -> dict[str, dict[str, int]]:
        """phase -> fmt -> bytes, HLO convention (the replay's tables)."""
        out: dict[str, dict[str, int]] = {}
        for (phase, fmt), v in self._sum_by(lambda r: (r.phase, r.fmt),
                                            lambda r: r.hlo_bytes).items():
            out.setdefault(phase, {})[fmt] = v
        return out

    def per_op(self) -> dict[str, int]:
        """collective kind -> bytes, HLO convention."""
        return self._sum_by(lambda r: r.collective, lambda r: r.hlo_bytes)

    @property
    def total_bytes(self) -> int:
        return sum(r.hlo_bytes for r in self.records())

    @property
    def total_moved_bytes(self) -> int:
        """Link bytes of one rank's calls (identity permute pairs excluded)."""
        return sum(r.moved_bytes for r in self.records())

    def table(self) -> list[dict]:
        """JSON-friendly dump."""
        return [dataclasses.asdict(r) | {"hlo_bytes": r.hlo_bytes} for r in self.records()]
