"""ProcessGrid: an R x C grid of ranks, one OS process per rank, over
``torch.distributed``.

The counterpart of JAX's ``shard_map`` over real devices.  Each process
holds one rank (``local_ranks == [dist.get_rank()]``) and runs the same
per-rank body as :class:`repro_torch.comm.grid.SimGrid`, on per-rank lists
whose only entry is its own; the collectives have ``SimGrid``'s semantics
(tiled ``all_gather`` / ``all_to_all`` / ``reduce_scatter`` on dim 0,
``psum`` / ``pmax`` / ``pmin``, ``ppermute`` with zeros for a rank no pair
sends to), so the two grids give the same trees bit for bit and, merged,
the same ledger (:meth:`repro_torch.comm.stats.CommStats.gather`).

The grid sits over an initialized default process group of world size
R*C, rank ``p = i*C + j``.  It creates the row, column and whole-grid
subgroups with ``dist.new_group``, in one order in every process.  Float
sums are gathered (a reduce-scatter's slices by an all-to-all) and added
in group order, as ``SimGrid`` adds them, so that they do not depend on
the backend's reduction order; integer and boolean reductions are
all-reduces.  Bool tensors travel as ``uint8``.

The transport is the default group's backend, and nothing swaps it:

* **gloo** — tensors on the CPU go to the collective as they are.  CUDA
  tensors are staged explicitly through host memory: copied down, run
  through the collective, copied back.  This is the one-card rehearsal: R*C
  processes share one card and exchange over host memory, and
  :attr:`ProcessGrid.staging_s` accumulates the copies' time.
* **nccl** — device tensors go straight to the collective; each rank needs
  a card of its own (``cuda:<rank>``: :func:`rank_device`), and the grid
  raises when R*C exceeds ``torch.cuda.device_count()``.  Each process
  makes its card current before it joins the group and binds the group to
  it (``device_id``), and the grid runs one all-reduce on each of its
  groups when it is built, so that every communicator is set up with all
  its members before a ``ppermute`` leaves one out.

A rank's compute stays on its device: the grid never moves it to the CPU.
:func:`spawn` starts the R*C processes with a ``file://`` rendezvous and
returns each rank's result.
"""

from __future__ import annotations

import datetime
import multiprocessing.resource_tracker
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.comm.grid import Grid, split_rows


def check_transport(backend: str, world: int, cards: int) -> None:
    """NCCL puts each rank on a card of its own: refuse more ranks than cards."""
    if backend == "nccl" and world > cards:
        raise ValueError(f"nccl needs one card per rank: {world} ranks, {cards} "
                         "card(s); rehearse on one card with backend='gloo'")


def rank_device(backend: str, rank: int, device=None) -> torch.device:
    """The device of rank ``rank``'s tensors under ``backend``.

    nccl: every rank on a card of its own, ``cuda:<rank>``.  ``None`` and
    ``"cuda"`` without an index mean that card; an explicit ``cuda:k`` must
    be it, and any other device raises.  gloo: ``device`` as
    :func:`repro_torch.resolve_device` takes it (every rank on one card, or
    on the CPU)."""
    if backend == "nccl":
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError(f"nccl moves CUDA tensors: give the grid a CUDA device, not {dev}")
        if dev.index is not None and dev.index != rank:
            raise ValueError(f"under nccl rank {rank} runs on cuda:{rank}, not on {dev}")
        return torch.device("cuda", rank)
    if backend == "gloo":
        return resolve_device(device)
    raise ValueError(f"unsupported backend {backend!r}: gloo or nccl")


class ProcessGrid(Grid):
    """This process's rank of an R x C grid over the default process group.

    ``device`` as :func:`rank_device` takes it (``None`` means ``cuda``,
    ``cuda:<rank>`` under nccl); ``row_fold`` as for
    :class:`repro_torch.comm.grid.Grid`."""

    def __init__(self, rows: int, cols: int, *, row_fold=None, device=None):
        super().__init__(rows, cols, row_fold)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("ProcessGrid needs an initialized default process group "
                               "(torch.distributed.init_process_group)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a {rows}x{cols} grid needs a world of {self.size} "
                             f"processes, the default group has {world}")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend()).lower()
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        check_transport(self.backend, world, cards)
        self.device = rank_device(self.backend, self.rank, device)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.staging_s = 0.0  # host<->device copies of the staged transport
        # one subgroup per communicator group, created in the same order in
        # every process; the whole grid is the default group
        self._groups: dict[str, tuple[list[int], object]] = {}
        for kind, axis in (("row", self.row_axes), ("col", "model")):
            for g in self.all_groups(axis):
                pg = dist.new_group(g)
                if self.rank in g:
                    self._groups[kind] = (g, pg)
        self._groups["all"] = (list(range(self.size)), dist.group.WORLD)
        if self.backend == "nccl":
            # NCCL sets a group's communicator up at its first call, with
            # every member; a ppermute batch that leaves a member out would
            # wait for it forever, so each group has its first call here
            probe = torch.zeros(1, device=self.device)
            for kind in ("all", "row", "col"):
                dist.all_reduce(probe, group=self._groups[kind][1])

    def __repr__(self) -> str:
        fold = "" if self.row_fold is None else f", row_fold={self.row_fold}"
        return (f"ProcessGrid({self.rows}x{self.cols}, rank {self.rank}, {self.backend}, "
                f"{self.device}{fold})")

    @property
    def local_ranks(self) -> list[int]:
        return [self.rank]

    def groups(self, axis) -> list[list[int]]:
        return [self._groups[self._axis(axis)][0]]

    # -- transport ----------------------------------------------------------

    def _down(self, x: torch.Tensor) -> torch.Tensor:
        """A rank's tensor as the collective takes it."""
        t = x.contiguous()
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()
            t0 = time.perf_counter()
            t = t.cpu()
            self.staging_s += time.perf_counter() - t0
        return t

    def _up(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A collective's result back on the rank's device, in ``dtype``."""
        if self.staged:
            t0 = time.perf_counter()
            t = t.to(self.device)
            torch.cuda.current_stream(self.device).synchronize()
            self.staging_s += time.perf_counter() - t0
        return t.view(torch.bool) if dtype == torch.bool else t

    def _mine(self, axis, groups) -> tuple[list[int], object] | None:
        """This rank's group of ``axis`` and its process group, or ``None``
        when ``groups`` leaves it out."""
        g, pg = self._groups[self._axis(axis)]
        if groups is not None and g not in [list(x) for x in groups]:
            return None
        return g, pg

    def _gather(self, x: torch.Tensor, g: list[int], pg) -> torch.Tensor:
        """Every member's tensor stacked in group order, ``(len(g),
        *x.shape)``, on this rank's device (one copy back when staged)."""
        if len(g) == 1:
            return x[None]
        t = self._down(x)
        parts = [torch.empty_like(t) for _ in g]
        if t.numel():
            dist.all_gather(parts, t, group=pg)
        return self._up(torch.stack(parts), x.dtype)

    # -- collectives over per-rank lists -------------------------------------

    def all_gather(self, xs: Sequence, axis, groups=None) -> list:
        """Tiled all-gather: the group's values concatenated along dim 0, in
        axis-index order."""
        out = self._new()
        mine = self._mine(axis, groups)
        if mine is not None:
            x = xs[self.rank]
            out[self.rank] = torch.cat(list(self._gather(x, *mine)), dim=0)
        return out

    def all_to_all(self, xs: Sequence, axis, groups=None) -> list:
        """Tiled all-to-all, split and concatenated on dim 0: this rank
        receives its chunk of every member's value, in sender order."""
        out = self._new()
        mine = self._mine(axis, groups)
        if mine is None:
            return out
        (g, pg), x = mine, xs[self.rank]
        if x.shape[0] % len(g):
            raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) does not split over "
                             f"{len(g)} ranks")
        if len(g) == 1:
            out[self.rank] = x.clone()
            return out
        t = self._down(x)
        got = torch.empty_like(t)
        if t.numel():
            dist.all_to_all_single(got, t, group=pg)
        out[self.rank] = self._up(got, x.dtype)
        return out

    def _reduce(self, xs, axis, groups, op, reduce_op) -> list:
        out = self._new()
        mine = self._mine(axis, groups)
        if mine is None:
            return out
        (g, pg), x = mine, xs[self.rank]
        if x.is_floating_point() or len(g) == 1:
            # in group order, as SimGrid adds: bit-identical float sums
            parts = self._gather(x, g, pg)
            acc = x if len(g) == 1 else parts[0]
            for y in parts[1:]:
                acc = op(acc, y)
        else:
            t = self._down(x)
            if not self.staged:  # the all-reduce writes in place
                t = t.clone()
            if t.numel():
                dist.all_reduce(t, op=reduce_op, group=pg)
            acc = self._up(t, x.dtype)
        out[self.rank] = acc
        return out

    def psum(self, xs: Sequence, axis, groups=None) -> list:
        return self._reduce(xs, axis, groups, torch.add, dist.ReduceOp.SUM)

    def reduce_scatter(self, xs: Sequence, axis, groups=None) -> list:
        """Tiled reduce-scatter on dim 0: an all-to-all hands this rank
        every member's chunk of its slice, added in group order (the bits
        of ``SimGrid``'s; a float reduce-scatter of the backend would add
        in its own order)."""
        out = self._new()
        mine = self._mine(axis, groups)
        if mine is None:
            return out
        (g, pg), x = mine, xs[self.rank]
        parts = split_rows(x, len(g))
        if len(g) > 1:
            t = self._down(x)
            got = torch.empty_like(t)
            if t.numel():
                dist.all_to_all_single(got, t, group=pg)
            parts = split_rows(self._up(got, x.dtype), len(g))
        acc = parts[0]
        for y in parts[1:]:
            acc = torch.add(acc, y)
        out[self.rank] = acc
        return out

    def pmax(self, xs: Sequence, axis, groups=None) -> list:
        return self._reduce(xs, axis, groups, torch.maximum, dist.ReduceOp.MAX)

    def pmin(self, xs: Sequence, axis, groups=None) -> list:
        return self._reduce(xs, axis, groups, torch.minimum, dist.ReduceOp.MIN)

    def ppermute(self, xs: Sequence, axis, perm, groups=None) -> list:
        """``perm``: (src, dst) pairs of axis indices, sent with
        ``batch_isend_irecv``; a member no pair sends to receives zeros,
        and an identity pair hands the rank its own tensor (no copy)."""
        out = self._new()
        mine = self._mine(axis, groups)
        if mine is None:
            return out
        (g, pg), x = mine, xs[self.rank]
        a = g.index(self.rank)
        sends = [dst for src, dst in perm if src == a and dst != a]
        recv_from = [src for src, dst in perm if dst == a and src != a]
        ops, buf = [], None
        if (sends or recv_from) and x.numel():
            t = self._down(x)
            for dst in sends:
                ops.append(dist.P2POp(dist.isend, t, g[dst], group=pg))
            if recv_from:
                buf = torch.empty_like(t)
                ops.append(dist.P2POp(dist.irecv, buf, g[recv_from[0]], group=pg))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if any(src == dst == a for src, dst in perm):
            out[self.rank] = x
        elif recv_from:
            out[self.rank] = x.clone() if buf is None else self._up(buf, x.dtype)
        else:
            out[self.rank] = torch.zeros_like(x)
        return out

    # -- outside the ledger ---------------------------------------------------

    def assemble(self, xs: Sequence, dim: int = 1) -> torch.Tensor:
        """Every rank's tensor concatenated along ``dim`` in rank order, on
        every process (the global output of the program, not one of its
        collectives)."""
        g, pg = self._groups["all"]
        return torch.cat(list(self._gather(xs[self.rank], g, pg)), dim=dim)

    def gather_objects(self, obj) -> list:
        """Every process's picklable ``obj``, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


# ---------------------------------------------------------------------------
# launching R*C processes
# ---------------------------------------------------------------------------


def _worker(fn, rank: int, rows: int, cols: int, backend: str, device, init: str,
            row_fold, timeout_s: float, env: dict, results, args) -> None:
    try:
        os.environ.update(env)
        n = rows * cols
        if device is None or torch.device(device).type == "cuda":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        else:
            torch.set_num_threads(1)
        bind = {}
        if backend == "nccl":  # the rank's card current, and the group bound to it
            bind["device_id"] = rank_device(backend, rank, device)
            torch.cuda.set_device(bind["device_id"])
        dist.init_process_group(backend, init_method=f"file://{init}", world_size=n,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
                                **bind)
        try:
            out = fn(ProcessGrid(rows, cols, row_fold=row_fold, device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # every failure goes back to the caller, then ends the process
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, rows: int, cols: int, *, backend: str = "gloo", device=None,
          init_file: str | None = None, row_fold=None, args: tuple = (),
          timeout_s: float = 900.0, grace_s: float = 20.0, env: dict | None = None) -> list:
    """Run ``fn(grid, *args)`` in R*C new processes, one rank each, and
    return each rank's result in rank order.

    Each process initializes the default group (``backend``, a ``file://``
    rendezvous at ``init_file``, default a file in a new temporary
    directory, so that concurrent callers never share a port; under nccl
    bound to the rank's card, :func:`rank_device`) and builds a
    :class:`ProcessGrid` on ``device``.  ``fn`` and its results must pickle
    (``fn`` a module-level function).  ``env`` is added to the processes'
    environment (theirs only); under nccl ``NCCL_DEBUG`` defaults to
    ``WARN``, so that NCCL's own errors reach the processes' stderr.  When
    any rank fails, the others get ``grace_s`` seconds to finish or fail
    before they are stopped, and a ``RuntimeError`` carries every rank's
    traceback; so does a rank that dies without a word, or a run past
    ``timeout_s`` (also each collective's time limit: a collective that
    hangs fails the run).

    Nothing it starts outlives the call: the spawn method's first process
    also starts multiprocessing's resource tracker, which would live until
    the caller exits and end just after it, and a tracker that this call
    started is stopped before it returns."""
    n = rows * cols
    env = dict(env or {})
    if backend == "nccl" and "NCCL_DEBUG" not in os.environ:
        env.setdefault("NCCL_DEBUG", "WARN")
    tracker = multiprocessing.resource_tracker._resource_tracker
    tracker_was_running = tracker._fd is not None
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="procgrid-") as tmp:
        init = init_file or os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_worker, args=(fn, rank, rows, cols, backend, device,
                                                   init, row_fold, timeout_s, env, results,
                                                   args))
                 for rank in range(n)]
        for p in procs:
            p.start()
        done: dict[int, object] = {}
        errors: dict[int, str] = {}
        deadline = time.monotonic() + timeout_s
        first_error = None
        try:
            while len(done) + len(errors) < n:
                # a process flushes its result before it exits: one that had
                # exited before an empty read sent none (a result that did
                # not pickle included)
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None]
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                    (done if ok else errors)[rank] = payload
                    if not ok and first_error is None:
                        first_error = time.monotonic()
                    continue
                except queue.Empty:
                    pass
                now = time.monotonic()
                for rank, code in dead:
                    if rank not in done and rank not in errors:
                        errors[rank] = f"process exited with code {code} and no result"
                        first_error = first_error or now
                if now > deadline or (first_error is not None and now - first_error > grace_s):
                    why = ("timed out" if now > deadline
                           else f"stopped {grace_s:.0f} s after another rank failed")
                    for rank in range(n):
                        if rank not in done and rank not in errors:
                            errors[rank] = why
                    break
        finally:
            for p in procs:
                if p.is_alive() and (errors or len(done) < n):
                    p.terminate()
            for p in procs:
                p.join()
            results.close()
            del results  # its semaphores unregister from the tracker
            if not tracker_was_running:
                tracker._stop()
    if errors:
        raise RuntimeError(f"{len(errors)} of {n} ranks failed:\n" + "\n".join(
            f"--- rank {rank}:\n{msg}" for rank, msg in sorted(errors.items())))
    return [done[rank] for rank in range(n)]


def require_no_children() -> None:
    """Raise if any process this one started is still alive (a child not
    yet reaped included)."""
    alive = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) == os.getpid():
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    alive.append((int(d), f.read().replace(b"\0", b" ").decode()[:120]))
        except (FileNotFoundError, ProcessLookupError):  # ended meanwhile
            continue
    if alive:
        raise AssertionError(f"processes started here still alive: {alive}")
