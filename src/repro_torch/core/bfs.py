"""Single-device level-synchronous BFS (paper Algorithm 2, one processor).

The port's counterpart of ``repro/core/bfs.py:46-300``.  One level is a
masked min of candidate parents over the local-expansion backend
(:mod:`repro_torch.core.expand`); the direction of each level comes from a
traversal policy (:mod:`repro_torch.core.traversal`).  ``root`` may be a
scalar or a ``(B,)`` batch of distinct sources; batched runs widen every
plane to ``(B, n)`` and return, per plane, what B single-source runs give.

The frontier algebra (:mod:`repro_torch.core.algebra`) is an argument of
:func:`bfs`: ``sssp``, ``cc`` and ``pagerank`` run the same level loop, with
the ``parent`` field of the result carrying the finalized values.

JAX's ``while_loop`` / ``scan`` become a Python loop: each level takes one
device->host copy, of the (B,) frontier counts, direction flags and the
algebra's ``alive``, which decides whether the loop goes on and which
``direction_opt`` pass runs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import algebra as algebra_mod
from repro_torch.core import expand as expand_mod
from repro_torch.core import traversal

INF = algebra_mod.INF


class BFSResult(NamedTuple):
    parent: torch.Tensor  # (n,) | (B, n) int32, -1 = unreached, parent[root] = root
    #                      (value algebras: finalized values, float32 for pagerank)
    level: torch.Tensor  # (n,) | (B, n) int32, -1 = unreached (last improvement)
    n_levels: int  # levels run (batched: depth of the longest plane)


def validate_roots(roots, n: int):
    """Check root vertices (dtype, range, duplicates) -> int32 array
    (0-d for a scalar root, (B,) for a batch).  A ``meta`` tensor has no
    values: its shape and dtype are checked, as a traced root is in the
    reference, and it comes back as an int32 ``meta`` tensor."""
    if isinstance(roots, torch.Tensor) and roots.device.type == "meta":
        if roots.dim() > 1:
            raise ValueError(f"roots must be a scalar or (B,) vector, got "
                             f"shape {tuple(roots.shape)}")
        if roots.dtype.is_floating_point or roots.dtype.is_complex or roots.dtype == torch.bool:
            raise TypeError(f"roots must be integers, got {roots.dtype}")
        if roots.dim() == 1 and roots.shape[0] == 0:
            raise ValueError("roots must name at least one source vertex")
        return roots.to(torch.int32)
    if isinstance(roots, torch.Tensor):
        roots = roots.cpu().numpy()
    arr = np.asarray(roots)
    if arr.ndim > 1:
        raise ValueError(f"roots must be a scalar or (B,) vector, got "
                         f"shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"roots must be integers, got {arr.dtype}")
    if arr.size == 0:
        raise ValueError("roots must name at least one source vertex")
    if arr.min(initial=0) < 0 or arr.max(initial=0) >= n:
        bad = arr[(arr < 0) | (arr >= n)]
        raise ValueError(
            f"roots out of range [0, {n}): {np.atleast_1d(bad)[:8].tolist()}"
        )
    if arr.ndim == 1 and np.unique(arr).size != arr.size:
        vals, counts = np.unique(arr, return_counts=True)
        raise ValueError(
            f"duplicate roots in batch: {vals[counts > 1][:8].tolist()} "
            "(each source plane must have a distinct root)"
        )
    return arr.astype(np.int32)


def hub_roots(degrees, n_roots: int) -> np.ndarray:
    """The ``n_roots`` highest-degree vertices (stable order, argmax first)."""
    order = np.argsort(-np.asarray(degrees), kind="stable")
    return order[:n_roots].astype(np.int64)


def _init_state(roots: torch.Tensor, n: int, policy, alg) -> traversal.LevelState:
    b = roots.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=roots.device)
    hit = idx[None, :] == roots[:, None]
    value, frontier = alg.init(hit, idx, roots, n)
    return traversal.LevelState(
        value=value,
        level=torch.where(hit, 0, -1).to(torch.int32),
        frontier=frontier,
        depth=0,
        active=True,
        use_bu=torch.full((b,), policy.starts_bottom_up, dtype=torch.bool,
                          device=roots.device),
        counts=torch.ones(b, dtype=torch.int32, device=roots.device),
        host_counts=np.ones(b, np.int32),
        host_use_bu=np.full(b, policy.starts_bottom_up),
        aux=alg.init_aux(frontier),
    )


def _setup(src, dst, root, n, policy, expand, device, block, alg):
    """Shared argument handling of :func:`bfs` and :func:`bfs_levels`."""
    dev = resolve_device(device)
    roots = validate_roots(root, n)
    pol = traversal.resolve(policy)
    backend = expand_mod.resolve(expand)
    if block is None:
        src_h, dst_h = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a) for a in (src, dst))
        block = backend.local_block(src_h, dst_h, backend.graph_arrays(src_h, dst_h, n),
                                    n, n, dev)
    # the degree vector, once before the level loop, where something reads
    # it: the anticipatory direction oracle or PageRank's x = v/deg
    deg = None
    if (pol.uses_top_down and pol.uses_bottom_up) or alg.needs_deg:
        deg = traversal.degree_vector(torch.as_tensor(src, device=dev),
                                      torch.as_tensor(dst, device=dev), n, n)
    roots_t = torch.as_tensor(np.atleast_1d(roots), device=dev)
    state = _init_state(roots_t, n, pol, alg)
    return roots.ndim == 0, pol, backend, block, deg, state


def _result(state, squeeze: bool, alg) -> BFSResult:
    value = alg.finalize(state.value)
    if squeeze:
        return BFSResult(value[0], state.level[0], state.depth)
    return BFSResult(value, state.level, state.depth)


def bfs(
    src,
    dst,
    root,
    n: int,
    policy: str = "top_down",
    max_levels: int = 64,
    expand: str = "coo",
    device=None,
    block: expand_mod.LocalBlock | None = None,
    algebra="bfs",
) -> BFSResult:
    """BFS over a symmetric COO edge list (padding edges may use src=dst=n).

    Args:
      src/dst: (m,) int32 edge endpoints (numpy arrays or tensors; tensors
        already on ``device`` are used in place).
      root: scalar source vertex, or a ``(B,)`` batch of distinct sources
        — batched runs return ``(B, n)`` parent/level planes.
      n: vertex count.
      policy: ``top_down`` | ``bottom_up`` | ``direction_opt``.
      max_levels: depth cap; vertices beyond it stay unreached and a
        truncated run shows as ``n_levels == max_levels``.
      expand: ``coo`` | ``ell`` | ``hybrid`` | ``auto``.  All give
        bit-identical results; ``direction_opt`` + ``hybrid`` is the
        configuration that runs the CUDA kernels on every level.
      device: ``None`` means ``cuda`` (raises if no card is present).
      block: the expansion backend's :class:`~repro_torch.core.expand.LocalBlock`
        for this graph, from :func:`repro_torch.core.expand.block_from_arrays`,
        so that a loop over many roots builds the containers once; built
        from ``src``/``dst`` when omitted.
      algebra: frontier algebra name or instance (``bfs`` | ``sssp`` |
        ``cc`` | ``pagerank``, :mod:`repro_torch.core.algebra`).  For a
        value algebra ``parent`` carries the finalized value plane (SSSP
        distances with ``INF`` unreached, CC labels, float32 PageRank
        scores) and ``level`` the level each vertex last improved in.
    """
    alg = algebra_mod.resolve(algebra)
    squeeze, pol, backend, block, deg, state = _setup(
        src, dst, root, n, policy, expand, device, block, alg)
    oracle = traversal.DensityOracle(n)
    while state.active and state.depth < max_levels:
        state = traversal.level_once(pol, oracle, alg, state, backend, block, deg)
    return _result(state, squeeze, alg)


def bfs_levels(
    src,
    dst,
    root,
    n: int,
    max_levels: int = 64,
    policy: str = "top_down",
    expand: str = "coo",
    device=None,
    block: expand_mod.LocalBlock | None = None,
) -> tuple[BFSResult, torch.Tensor]:
    """BFS + per-level frontier sizes.

    ``sizes[l, k]`` (int32, on the host) is plane ``k``'s frontier size
    after level ``l+1``, for ``max_levels`` rows (zeros once every plane
    is done); a scalar root gives a ``(max_levels,)`` column.
    """
    alg = algebra_mod.resolve("bfs")
    squeeze, pol, backend, block, deg, state = _setup(
        src, dst, root, n, policy, expand, device, block, alg)
    oracle = traversal.DensityOracle(n)
    sizes = np.zeros((max_levels, state.counts.shape[0]), np.int32)
    for lvl in range(max_levels):
        if not state.active:
            break
        state = traversal.level_once(pol, oracle, alg, state, backend, block, deg)
        sizes[lvl] = state.host_counts
    sizes_t = torch.from_numpy(sizes)
    return _result(state, squeeze, alg), (sizes_t[:, 0] if squeeze else sizes_t)
