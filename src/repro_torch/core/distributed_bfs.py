"""2D-partitioned distributed BFS with adaptive compressed collectives
(paper Alg. 4) on an R x C grid: simulated in one process
(:class:`repro_torch.comm.SimGrid`) or one process per rank
(:class:`repro_torch.comm.procgrid.ProcessGrid`).

The port's counterpart of ``repro/core/distributed_bfs.py``.  One level on
the grid (rank (i, j) holds block A_ij and owns vertex chunk q = i*C + j of
width s):

  1. **TransposeVector**: a ``ppermute`` moves owned frontier chunk q to
     rank (q % R, q // R), which needs it in the column phase.
  2. **column phase**: all-gather of the frontier membership over the grid
     column assembles the column slice f_j, in the wire format the bucket
     ladder picks per group (packed id stream when sparse, bitmap when
     dense).
  3. **local expansion**: the traversal policy's direction — push or pull
     (gated on an unreached-bitmap all-gather over the grid row) — through
     the expansion backend (``coo`` / ``ell`` / ``hybrid``); the CUDA ELL
     kernels run on every rank's slab.
  4. **row phase**: push exchanges per-destination candidate streams
     (ids delta-packed, parents bit-packed); pull swaps them for found
     bitmaps + packed parents.  The receiver min-reduces into its chunk.
  5. update, then the termination psum of the per-plane popcounts; for
     ``direction_opt`` the same counts and the Beamer edge signals decide
     each plane's next direction.

The frontier algebra is ``DistBFSConfig.algebra`` (``bfs`` | ``sssp`` |
``cc`` | ``pagerank``, :mod:`repro_torch.core.algebra`).  A value algebra
adds a value column phase: the owned (B, s) value plane takes the same
transpose ``ppermute`` (``fmt="values"``), then a dense all-gather over the
grid column assembles the (B, n_c) source values beside the membership
bits (``{alg}/values``); its termination consensus is its own
(``post_update``: SSSP's window ``pmin``, PageRank's residual ``psum``), and
PageRank's x = v/deg reads the owned degree slice.  Phases are named
``{alg}/...``.

JAX's ``while_loop`` becomes a host loop: per level the host reads the
counts, directions and the algebra's ``alive`` once (one copy, from a
local rank: they are global after their all-reduces), and each adaptive
exchange reads its groups' buckets once.  Every collective reports its
bytes to a :class:`repro_torch.comm.CommStats` — here, what each level
actually sent, by the grid's local ranks.  The loop runs over the grid's
local ranks only; ``DistBFSConfig.row_axes`` names the grid's row axes
(``("pod", "data")`` on a grid with that row fold), as the JAX config does.

On a ``meta`` grid (the dry-run's count: nothing has a value to read) one
level runs, with every pass the policy uses and every rung of each
adaptive exchange -- the while body the reference's program holds once --
and the depth is 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comm import AdaptiveExchange, CommStats
from repro_torch.comm import collectives as comm_cc
from repro_torch.comm import registry as wire_registry
from repro_torch.comm.grid import COL_AXIS, ROW_AXIS, Grid, axis_names
from repro_torch.core import algebra as algebra_mod
from repro_torch.core.algebra import per_rank
from repro_torch.core import bfs, traversal
from repro_torch.core import expand as expand_mod
from repro_torch.core.csr import BlockedGraph, Partition2D


#: bottom-up exit density (hysteresis); the entry density comes from the
#: row ladder (:func:`repro_torch.core.traversal.ladder_alpha`)
BETA = 0.05


@dataclasses.dataclass(frozen=True)
class DistBFSConfig:
    row_axes: tuple[str, ...] = (ROW_AXIS,)  # the grid's row axes (a fold: several)
    mode: str = "auto"  # wire plan: 'raw' | 'bitmap' | 'auto' | 'btfly'
    policy: str = "top_down"  # 'top_down' | 'bottom_up' | 'direction_opt'
    expand: str = "coo"  # 'coo' | 'ell' | 'hybrid' | 'auto'
    max_levels: int = 64
    algebra: str = "bfs"  # 'bfs' | 'sssp' | 'cc' | 'pagerank' (or an instance)


def parent_width_class(n_c: int) -> int:
    """Smallest packing class covering column-local parent offsets."""
    return algebra_mod.width_class(n_c)


def _check(grid: Grid, part: Partition2D, cfg: DistBFSConfig | None = None) -> None:
    if (part.rows, part.cols) != (grid.rows, grid.cols):
        raise ValueError(f"partition is {part.rows}x{part.cols}, grid is "
                         f"{grid.rows}x{grid.cols}")
    if cfg is not None and axis_names(cfg.row_axes) != grid.row_axes:
        raise ValueError(f"config row axes {cfg.row_axes} are not the grid's "
                         f"{grid.row_axes}")


def _level_loop(grid: Grid, part: Partition2D, cfg: DistBFSConfig, blocks,
                roots: torch.Tensor, stats: CommStats | None):
    """Run the algebra on every root plane; per-rank (B, s) finalized values
    and levels (for the local ranks) and the number of levels run."""
    src_l, dst_l, *extra = blocks
    b = roots.shape[0]
    c, s = part.cols, part.chunk
    n_r, n_c = part.n_r, part.n_c
    ranks = grid.local_ranks
    row_axes, all_axes = grid.row_axes, grid.all_axes
    col = grid.axis_index(COL_AXIS)
    alg = algebra_mod.resolve(cfg.algebra)
    p = alg.name  # CommStats phase prefix
    # the row wire's payload: column-local parents for the id algebra, the
    # algebra's value class otherwise
    p_width = alg.row_payload_width(n_c, part.n)

    policy = traversal.resolve(cfg.policy)
    adaptive = policy.uses_top_down and policy.uses_bottom_up
    oracle = traversal.DensityOracle(part.n, alpha=traversal.ladder_alpha(s, p_width),
                                     beta=BETA)

    plan = wire_registry.wire_plan(cfg.mode)
    column_gather = plan.build_column(s, grid, row_axes, b=b, stats=stats,
                                      phase=f"{p}/column")
    row_exchange = row_exchange_bu = unreached_gather = None
    if policy.uses_top_down:
        row_exchange = plan.build_row(s, grid, COL_AXIS, n_c, p_width, b=b,
                                      stats=stats, phase=f"{p}/row", alg=alg)
    if policy.uses_bottom_up:
        row_exchange_bu = plan.build_row_bu(s, grid, COL_AXIS, n_c, p_width, b=b,
                                            stats=stats, phase=f"{p}/row-pull", alg=alg)
        unreached_gather = plan.build_unreached(s, grid, COL_AXIS, b=b, stats=stats,
                                                phase=f"{p}/unreached")
    ex_transpose = AdaptiveExchange(f"{p}/transpose", grid, all_axes, None, stats,
                                    planes=b)
    ex_term = AdaptiveExchange(f"{p}/termination", grid, all_axes, None, stats,
                               planes=b)
    ex_values = None
    if alg.needs_values:
        ex_values = AdaptiveExchange(f"{p}/values", grid, row_axes, None, stats, planes=b)
    perm = part.transpose_perm()

    deg_own = [None] * grid.size
    if (adaptive and alg.payload_is_id) or alg.needs_deg:
        # the owned-degree vector of the anticipatory oracle (id payloads)
        # and of PageRank's x = v/deg: one grid-row all-reduce before the
        # level loop, shared by every plane
        ex_degree = AdaptiveExchange(f"{p}/degree", grid, COL_AXIS, None, stats)
        deg_row = ex_degree.psum(
            grid.local(lambda q: traversal.degree_vector(src_l[q], dst_l[q], n_c, n_r)),
            fmt="degree")
        deg_own = grid.local(lambda q: deg_row[q][col[q] * s:(col[q] + 1) * s])

    backend = expand_mod.resolve(cfg.expand)
    ctx = traversal.DistLevelCtx(
        expand=backend,
        blocks=grid.local(lambda q: backend.local_block(
            src_l[q], dst_l[q], tuple(e[q] for e in extra), n_r, n_c, grid.device)),
        n_r=n_r, n_c=n_c, s=s, c=c, col_index=col,
        row_exchange=row_exchange, row_exchange_bu=row_exchange_bu,
        unreached_gather=unreached_gather,
        algebra=alg, row_base=[(q // c) * n_r for q in range(grid.size)],
    )

    value, level, frontier, aux = ([None] * grid.size for _ in range(4))
    for q in ranks:
        idx = q * s + torch.arange(s, dtype=torch.int32, device=grid.device)
        hit = idx[None, :] == roots[:, None]
        value[q], frontier[q] = alg.init(hit, idx, roots, part.n)
        aux[q] = alg.init_aux(frontier[q])
        level[q] = torch.where(hit, 0, -1).to(torch.int32)
    counts = grid.local(lambda q: torch.ones(b, dtype=torch.int32, device=grid.device))
    use_bu = grid.local(lambda q: torch.full((b,), policy.starts_bottom_up,
                                             dtype=torch.bool, device=grid.device))
    host_counts = np.ones(b, np.int32)
    host_bu = np.full(b, policy.starts_bottom_up)
    # on meta nothing has a value: one level runs with every pass the
    # policy uses, the while body the reference's program holds once
    symbolic = grid.device.type == "meta"
    depth, alive = 0, True
    while alive and depth < cfg.max_levels:
        bits_t = ex_transpose.ppermute(frontier, perm, fmt="membership")
        f_col = column_gather(bits_t)
        x_col = None
        if alg.needs_values:
            x_t = ex_transpose.ppermute(
                grid.local(lambda q: alg.source_values(value[q], deg_own[q])), perm,
                fmt="values")
            x_col = comm_cc.gather_values_planes(ex_values, x_t)
        if symbolic:
            passes = (policy.uses_top_down, policy.uses_bottom_up)
        else:
            act = host_counts > 0
            passes = (bool((act & ~host_bu).any()), bool((act & host_bu).any()))
        active = per_rank(lambda cn: cn > 0, counts)
        reduced = policy.expand_dist(ctx, value, f_col, use_bu, active, passes, x_col=x_col)
        old = value
        updated = per_rank(lambda v, r: alg.update(v, r, depth, part.n), old, reduced)
        value = per_rank(lambda u: u[0], updated)
        new = per_rank(lambda u: u[1], updated)
        m_f = m_u = None
        if adaptive and alg.payload_is_id:
            lm = grid.local(lambda q: torch.stack(
                traversal.edge_signals(deg_own[q], new[q], old[q]), dim=1))
            edges = ex_term.psum(lm, fmt="termination", part="edges")
            m_f = per_rank(lambda e: e[:, 0], edges)
            m_u = per_rank(lambda e: e[:, 1], edges)
        aux, frontier_next, new_counts, alive_t = alg.post_update(
            ex_term, aux, old, value, new, frontier, oracle.plane_counts)
        frontier = frontier_next
        use_bu = grid.local(lambda q: policy.next_direction(
            oracle, new_counts[q], use_bu[q],
            m_f=None if m_f is None else m_f[q], m_u=None if m_u is None else m_u[q],
            growing=new_counts[q] > counts[q]))
        counts = new_counts
        level = per_rank(lambda nw, lv: torch.where(nw, depth + 1, lv), new, level)
        depth += 1
        if symbolic:
            break
        q = ranks[0]  # counts, flags and alive are global: any local rank's copy
        host = torch.cat([counts[q], use_bu[q].to(torch.int32),
                          alive_t[q].reshape(1).to(torch.int32)]).cpu().numpy()
        host_counts, host_bu, alive = host[:b], host[b:2 * b].astype(bool), bool(host[-1])
    return per_rank(alg.finalize, value), level, depth


def build_bfs(
    grid: Grid,
    bg: BlockedGraph | Partition2D,
    cfg: DistBFSConfig | None = None,
    *,
    stats: CommStats | None = None,
):
    """The distributed BFS on ``grid``.  Returns ``fn(*blocks, root) ->
    (parent, level, n_levels)``, ``blocks`` being what :func:`shard_blocked`
    returns for ``cfg.expand``.

    ``root`` may be a scalar (``(n,)`` outputs) or a ``(B,)`` batch of
    distinct sources (``(B, n)`` planes over the padded vertex space, one
    consensus round and one wire header per exchange serving all B
    planes).  Roots are validated (dtype, range, duplicates; a ``meta``
    root: shape and dtype) first.  For a
    value algebra (``cfg.algebra``) ``parent`` carries its finalized values
    (float32 for ``pagerank``).
    ``stats``, if given, gets every collective call's bytes (of the local
    ranks; :meth:`repro_torch.comm.CommStats.gather` merges the processes'
    ledgers).  The bucket ladders use the reference's modelled
    :class:`repro_torch.comm.ThresholdPolicy`.  Every process of a
    :class:`~repro_torch.comm.procgrid.ProcessGrid` gets the full planes: they
    are gathered once at the end, outside the ledger, as JAX's global output
    is not a collective of the program.
    """
    cfg = cfg or DistBFSConfig()
    wire_registry.wire_plan(cfg.mode)  # fail on unknown names at build time
    algebra_mod.resolve(cfg.algebra)
    policy = traversal.resolve(cfg.policy)
    backend = expand_mod.resolve(cfg.expand)
    part = bg if isinstance(bg, Partition2D) else bg.part
    _check(grid, part, cfg)
    if (cfg.mode in ("bitmap", "auto", "btfly") or policy.uses_bottom_up) and part.chunk % 1024:
        raise ValueError(
            f"compressed modes and pull traversal need 1024-multiple chunks "
            f"(got s={part.chunk}); partition with chunk_multiple=1024")
    n_blocks = 2 + len(backend.extra_ndims)

    def run(*args):
        if len(args) != n_blocks + 1:
            raise TypeError(
                f"expansion backend {backend.name!r} expects fn(*{n_blocks} block "
                f"arrays, root), got {len(args)} args — pass everything "
                "shard_blocked returned")
        *blocks, root = args
        roots = bfs.validate_roots(root, part.n_orig)
        if isinstance(roots, torch.Tensor):  # a meta root: shapes only
            roots_t = roots.reshape(-1).to(grid.device)
        else:
            roots_t = torch.as_tensor(np.atleast_1d(roots), device=grid.device)
        value, level, depth = _level_loop(grid, part, cfg, blocks, roots_t, stats)
        parent, level = grid.assemble(value), grid.assemble(level)
        if roots.ndim == 0:
            return parent[0], level[0], depth
        return parent, level, depth

    return run


def shard_blocked(grid: Grid, bg: BlockedGraph, cfg: DistBFSConfig | None = None):
    """Place each local rank's blocked edge arrays — and the expansion
    backend's block containers (ELL slab / hybrid residue) — on the grid's
    device.  Returns per-rank lists ``(src, dst, *backend arrays)``, rank
    ``p = i*C + j`` holding block A_ij (``None`` for a rank this process
    does not hold)."""
    cfg = cfg or DistBFSConfig()
    _check(grid, bg.part)
    backend = expand_mod.resolve(cfg.expand)
    arrays = (bg.src_local, bg.dst_local, *backend.block_arrays(bg))
    c = grid.cols
    return tuple(
        grid.local(lambda q: torch.as_tensor(a[q // c, q % c], device=grid.device)
                   .contiguous())
        for a in arrays
    )
