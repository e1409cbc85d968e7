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
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.comm.grid import ROW_AXIS, Grid, pmean_trees
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
    """``loss_fn(params, batch)`` and its gradient tree, both detached."""
    flat, unflatten = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
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
