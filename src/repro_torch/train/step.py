"""Train-step factories.

The port's counterpart of ``repro/train/step.py``:

* :func:`make_train_step` — one device: autograd, then AdamW
  (:func:`repro_torch.optim.adamw.apply`).
* :func:`make_dp_train_step` — explicit data parallelism over one axis of
  a grid (:class:`~repro_torch.comm.SimGrid` or
  :class:`~repro_torch.comm.procgrid.ProcessGrid`), in place of the
  reference's ``shard_map`` over a mesh axis: each rank computes its own
  gradients on its own batch, the gradient mean crosses the wire as int8
  with error feedback (:func:`repro_torch.optim.grad_compress.dp_allreduce_int8`,
  the residual kept per rank) or as a plain ``pmean``, and each rank
  applies AdamW to its replicated parameters.
* :func:`make_sharded_train_step` — the LM train step FSDP x TP over a
  grid, placed as the cell catalogue places the reference's GSPMD step
  (``param_specs``; the batch over the grid rows): one per-rank body whose
  backward runs through the transposed collectives, and AdamW on each
  rank's own slices of params, ``m`` and ``v``.  :func:`shard_state` and
  :func:`gather_state` carry a :class:`TrainState` to the ranks' slices and
  back.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.comm.grid import ROW_AXIS, Grid, pmean_trees
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh
from repro_torch.optim import adamw, grad_compress


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    ef: grad_compress.EFState | None = None


def init_state(params: Any, with_ef: bool = False) -> TrainState:
    return TrainState(params=params, opt=adamw.init(params),
                      ef=grad_compress.init(params) if with_ef else None)


def value_and_grad(loss_fn: Callable[[Any, Any], torch.Tensor], params: Any,
                   batch) -> tuple[torch.Tensor, Any]:
    """``loss_fn(params, batch)`` and its gradient tree, both detached; a
    leaf the loss does not read gets zeros, as under ``jax.grad``."""
    flat, unflatten = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), unflatten(list(grads))


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                    opt_cfg: adamw.AdamWConfig):
    """One device: ``step(state, batch) -> (state, metrics)``, metrics
    ``loss``, ``grad_norm`` and ``step``."""

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = value_and_grad(loss_fn, state.params, batch)
        params, opt = adamw.apply(opt_cfg, state.params, grads, state.opt)
        metrics = {"loss": loss, "grad_norm": adamw.global_norm(grads), "step": opt.step}
        return TrainState(params=params, opt=opt, ef=state.ef), metrics

    return step


def make_dp_train_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                       opt_cfg: adamw.AdamWConfig, grid: Grid, dp_axis=ROW_AXIS,
                       compress: bool = True):
    """Pure data parallelism over the grid axis ``dp_axis`` (the row axis of
    an R x 1 grid is the reference's ``("data",)`` mesh):
    ``step(states, batches) -> (states, metrics)`` over per-rank lists of
    :class:`TrainState` (parameters replicated, the residual per rank when
    ``compress``; :func:`init_state` with ``with_ef=compress``) and of
    batches.  The gradient mean crosses the wire as int8 + error feedback,
    or as a plain ``pmean`` when ``compress=False``; the metrics (``loss``,
    ``pmean``ed, and ``grad_norm``) are the first local rank's."""
    dp = grid.group_size(dp_axis)

    def step(states: list, batches: list) -> tuple[list, dict]:
        ranks = grid.local_ranks
        out = grid.local(lambda p: value_and_grad(loss_fn, states[p].params, batches[p]))
        grads = grid.local(lambda p: out[p][1])
        if compress:
            grads, ef = grad_compress.dp_allreduce_int8(
                grid, grads, grid.local(lambda p: states[p].ef), dp_axis)
        else:
            grads = pmean_trees(grid, grads, dp_axis)
            ef = grid.local(lambda p: states[p].ef)
        loss = grid.psum(grid.local(lambda p: out[p][0]), dp_axis)

        def update(p):
            params, opt = adamw.apply(opt_cfg, states[p].params, grads[p], states[p].opt)
            return TrainState(params=params, opt=opt, ef=ef[p])

        metrics = {"loss": loss[ranks[0]] / dp,
                   "grad_norm": adamw.global_norm(grads[ranks[0]])}
        return grid.local(update), metrics

    return step


def shard_state(cfg: tfm.TransformerConfig, grid: Grid, state: TrainState, specs) -> list:
    """Each local rank's :class:`TrainState`: its slices (views) of the
    params, ``m`` and ``v`` of the global ``state`` under ``specs``
    (:func:`repro_torch.models.transformer_sharded.shard_params`), and its
    step."""
    params, m, v = (tsh.shard_params(cfg, x, grid, specs)
                    for x in (state.params, state.opt.m, state.opt.v))
    return grid.local(lambda p: TrainState(
        params=params[p], opt=adamw.OptState(step=state.opt.step, m=m[p], v=v[p]), ef=None))


def gather_state(grid: Grid, states: list, specs) -> TrainState:
    """The global :class:`TrainState` of every rank's (a ``SimGrid``'s)
    slices under ``specs``, rank 0's step."""
    def whole(trees):
        unflatten = tree.flatten(trees[0])[1]
        per_rank = [tree.leaves(t) for t in trees]
        return unflatten([tsh.unshard_leaf(grid, [r[k] for r in per_rank], sp)
                          for k, sp in enumerate(meshlib.spec_leaves(specs))])

    return TrainState(params=whole([s.params for s in states]),
                      opt=adamw.OptState(step=states[0].opt.step,
                                         m=whole([s.opt.m for s in states]),
                                         v=whole([s.opt.v for s in states])), ef=None)


def sharded_value_and_grad(cfg: tfm.TransformerConfig, grid: Grid, specs, params: list,
                           tokens: list, *, layers: int | None = None) -> tuple:
    """The loss, each local rank's gradient slices and the gradient's global
    norm of the LM over ``grid``: each rank's params (its slices under
    ``specs``) and token rows (b, S+1) -> (loss, per-rank gradient trees,
    per-rank norms), all detached, the loss and norm equal on every rank.

    Each rank differentiates the grid's mean of the ranks' losses
    (:func:`repro_torch.models.transformer_sharded.loss_fn`; seed ``1 /
    R*C`` on its own) with respect to its own leaf copies, through the
    transposed collectives: an FSDP leaf's gathers transpose to
    reduce-scatters that sum the rows' uses; a leaf replicated over an axis
    (the norms, ``router`` over TP, ``wq_b`` / ``wkv_b`` over the rows)
    then has its gradient summed over it
    (:func:`~repro_torch.models.transformer_sharded.sum_replicas`).  So each
    rank's gradient is its slice of the reference's ``jax.grad``."""
    ranks = grid.local_ranks
    flat = {p: tree.flatten(params[p]) for p in ranks}
    mine = {p: [x.detach().requires_grad_() for x in flat[p][0]] for p in ranks}
    with torch.enable_grad():
        ell = tsh.loss_fn(cfg, grid, grid.local(lambda p: flat[p][1](mine[p])), tokens, specs,
                          layers=layers)
        got = torch.autograd.grad([ell[p] / grid.size for p in ranks],
                                  [x for p in ranks for x in mine[p]], materialize_grads=True)
    k = len(flat[ranks[0]][0])
    at = {p: i * k for i, p in enumerate(ranks)}
    grads = tsh.sum_replicas(grid, grid.local(lambda p: flat[p][1](list(got[at[p]:at[p] + k]))),
                             specs)
    del got
    loss = grid.psum(grid.local(lambda p: ell[p].detach()), grid.all_axes)
    return loss[ranks[0]] / grid.size, grads, tsh.grad_norm(grid, grads, specs)


def make_sharded_train_step(cfg: tfm.TransformerConfig, grid: Grid, specs,
                            opt_cfg: adamw.AdamWConfig, *, layers: int | None = None):
    """The LM train step FSDP x TP over ``grid``:
    ``step(states, tokens) -> (states, metrics)`` over per-rank lists of
    :class:`TrainState` (:func:`shard_state`) and of token rows (b, S+1)
    (grid row ``i`` the ``i``-th block of the batch,
    :func:`repro_torch.models.transformer_sharded.shard_rows`): the loss
    and gradient slices of :func:`sharded_value_and_grad`, then the AdamW
    step of each rank on its own slices, clipped by the global norm (fp32
    master update, as ``adamw.apply``; ``adamw.apply_many`` over every
    local rank's slices at once).  ``layers`` runs the first that
    many layers only (the dry-run).  Metrics ``loss``, ``grad_norm`` and
    ``step``, equal on every rank."""

    def step(states: list, tokens: list) -> tuple[list, dict]:
        loss, grads, norm = sharded_value_and_grad(
            cfg, grid, specs, grid.local(lambda p: states[p].params), tokens, layers=layers)
        ranks = grid.local_ranks
        done = adamw.apply_many(opt_cfg, [states[p].params for p in ranks],
                                [grads[p] for p in ranks], [states[p].opt for p in ranks],
                                norm[ranks[0]])
        new = grid._new()
        for p, (params, opt) in zip(ranks, done):
            new[p] = TrainState(params=params, opt=opt, ef=None)
        return new, {"loss": loss, "grad_norm": norm[ranks[0]], "step": new[ranks[0]].opt.step}

    return step
