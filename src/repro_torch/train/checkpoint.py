"""Checkpoints with atomic manifests and elastic restore.

The port's counterpart of ``repro/train/checkpoint.py``, with its layout
per step::

    <dir>/step_000123/
        host_0000.npz     # the state's leaves, arr_0 .. arr_{n-1}
        MANIFEST.json     # step, tree structure, leaf shapes/dtypes, status

The leaves are in :mod:`repro_torch.tree` order, which is ``jax.tree``
order, so a checkpoint the reference wrote restores here and one written
here restores in the reference.  The manifest's ``treedef`` is a string
for the reader (:func:`repro_torch.tree.structure`); :func:`restore`
checks the number of leaves and their shapes, as the reference does.

* **atomic**: data is written into ``step_N.tmp/`` and renamed at the end;
  a crash mid-write never corrupts the latest-complete pointer.
* **async**: :class:`AsyncCheckpointer` copies the state to host memory
  synchronously and writes it in a background thread, so the training loop
  does not wait on the disk.
* **elastic**: :func:`restore` returns host (CPU) tensors;
  :func:`restore_sharded` places them on a device, or on every rank of a
  grid, whatever rank count saved them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array of its own (a copy of a tensor's data)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def save(state: Any, step: int, ckpt_dir: str) -> str:
    """Synchronous atomic save. Returns the final directory path."""
    host_leaves = [_host(x) for x in tree.leaves(state)]
    final = os.path.join(ckpt_dir, f"step_{step:06d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "host_0000.npz"), *host_leaves)
    manifest = {
        "step": step,
        "treedef": tree.structure(state),
        "n_leaves": len(host_leaves),
        "shapes": [list(x.shape) for x in host_leaves],
        "dtypes": [str(x.dtype) for x in host_leaves],
        "status": "complete",
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a complete manifest (ignores torn .tmp dirs)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            with open(os.path.join(ckpt_dir, name, "MANIFEST.json")) as f:
                m = json.load(f)
            if m.get("status") == "complete":
                steps.append(m["step"])
        except (OSError, json.JSONDecodeError):
            continue
    return max(steps) if steps else None


def restore(like: Any, step: int, ckpt_dir: str) -> Any:
    """Restore into the structure of ``like``: a tree of CPU tensors, each
    with the dtype it was saved with."""
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    with np.load(os.path.join(path, "host_0000.npz")) as z:
        host_leaves = [z[f"arr_{k}"] for k in range(len(z.files))]
    flat, unflatten = tree.flatten(like)
    if len(flat) != len(host_leaves):
        raise ValueError(f"checkpoint/state structure mismatch: {len(host_leaves)} leaves "
                         f"saved, {len(flat)} in the state")
    for k, (l, h) in enumerate(zip(flat, host_leaves)):
        if tuple(l.shape) != tuple(h.shape):
            raise ValueError(f"leaf {k}: shape {tuple(h.shape)} saved, {tuple(l.shape)} in "
                             f"the state")
    return unflatten([torch.from_numpy(h) for h in host_leaves])


def restore_sharded(like: Any, step: int, ckpt_dir: str, shardings: Any) -> Any:
    """Elastic restore: the host state placed on ``shardings``, in place of
    the reference's ``jax.sharding``s: a device (the whole tree there), or
    a grid's per-rank list of devices (one copy of the tree on each; a
    ``None`` entry, a rank another process holds, stays ``None``).  The
    list's length need not be the saver's rank count."""
    host_state = restore(like, step, ckpt_dir)
    if isinstance(shardings, (list, tuple)):
        return [None if dev is None else  # each rank its own copy, as on a SimGrid
                tree.tree_map(lambda h, dev=dev: h.to(dev, copy=True), host_state)
                for dev in shardings]
    return tree.tree_map(lambda h: h.to(shardings), host_state)


class AsyncCheckpointer:
    """Snapshot synchronously, write in the background; at most one pending
    write (a newer snapshot supersedes a queued one).  The writer thread
    clears itself under the lock once nothing is pending, so a snapshot
    submitted as it ends starts a new one."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._lock = threading.Lock()
        self._pending: tuple[Any, int] | None = None
        self._thread: threading.Thread | None = None
        self.written: list[int] = []

    def submit(self, state: Any, step: int) -> None:
        """Copy ``state`` to host memory now (after the work of each card that
        holds a part of it is done) and queue it for writing as ``step``."""
        for dev in {x.device for x in tree.leaves(state)
                    if isinstance(x, torch.Tensor) and x.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        snapshot = tree.tree_map(_host, state)
        with self._lock:
            self._pending = (snapshot, step)
            if self._thread is None:
                self._thread = threading.Thread(target=self._drain, daemon=True)
                self._thread.start()

    def _drain(self) -> None:
        try:
            while True:
                with self._lock:
                    if self._pending is None:
                        self._thread = None
                        return
                    snapshot, step = self._pending
                    self._pending = None
                save(snapshot, step, self.ckpt_dir)
                self.written.append(step)
        except BaseException:
            with self._lock:
                self._thread = None
            raise

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
