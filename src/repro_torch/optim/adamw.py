"""AdamW + WSD (warmup-stable-decay) schedule over nested dict / list params.

The port's counterpart of ``repro/optim/adamw.py``, term for term: clip by
the global norm, then one AdamW step at the WSD learning rate, with the
bias corrections ``1 - b ** step`` in float32.  ``step`` is an int32
tensor.  No ``torch.optim`` class: the update is the reference's formula,
so that parameters after a few steps match JAX's.

WSD (MiniCPM, arXiv:2404.06395): linear warmup -> long constant plateau ->
short (10%) sharp decay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # WSD schedule
    warmup_steps: int = 100
    total_steps: int = 1000
    decay_frac: float = 0.1  # last 10% of steps decay
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: Any
    v: Any


def wsd_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup-Stable-Decay learning rate at ``step`` (float32, 0-d)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
    decay_t = (step - decay_start) / max(cfg.total_steps - decay_start, 1)
    decay = 1.0 - (1.0 - cfg.min_lr_frac) * torch.clamp(decay_t, 0.0, 1.0)
    mult = torch.where(step < cfg.warmup_steps, warm, torch.ones_like(warm))
    return cfg.lr * torch.where(step > decay_start, decay, mult)


def init(params: Any) -> OptState:
    """Zero moments in float32 and step 0, on the parameters' device."""
    zeros = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
    device = tree.leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                    v=tree.tree_map(torch.clone, zeros))


def global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in tree.leaves(grads)))


def _coefficients(cfg: AdamWConfig, step: torch.Tensor, gn: torch.Tensor) -> tuple:
    """The clip scale, learning rate and bias corrections of step ``step``
    for a gradient of global norm ``gn``."""
    # a tensor numerator: ``scalar / tensor`` multiplies by the reciprocal
    clip = torch.full_like(gn, cfg.grad_clip)
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)
    return scale, wsd_schedule(cfg, step), bc1, bc2


def _update(cfg: AdamWConfig, coef: tuple, p, g, m, v):
    """One leaf's AdamW step -> (param, m, v)."""
    scale, lr, bc1, bc2 = coef
    g = g.to(torch.float32) * scale
    m_new = cfg.b1 * m + (1 - cfg.b1) * g
    v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
    p32 = p.to(torch.float32)
    p_new = p32 - lr * (update + cfg.weight_decay * p32)
    return p_new.to(p.dtype), m_new, v_new


def apply(cfg: AdamWConfig, params: Any, grads: Any, state: OptState,
          norm: torch.Tensor | None = None) -> tuple[Any, OptState]:
    """One AdamW step with global-norm clipping and the WSD schedule.
    ``norm``: the gradient's global norm where ``grads`` hold only part of
    it, else :func:`global_norm` of ``grads``."""
    return apply_many(cfg, [params], [grads], [state],
                      global_norm(grads) if norm is None else norm)[0]


def apply_many(cfg: AdamWConfig, params: list, grads: list, states: list,
               norm: torch.Tensor) -> list[tuple[Any, OptState]]:
    """:func:`apply` on several trees of one structure and shapes at once
    (a grid's ranks' slices, one step count), every tree clipped by the one
    global ``norm``: the same arithmetic element for element, a leaf's
    trees stacked into one tensor (one op for them all).  Returns each
    tree's (params, state)."""
    step = states[0].step + 1
    coef = _coefficients(cfg, step, norm)
    n = len(params)

    def stacked(trees):
        return [xs[0] if n == 1 else torch.stack(xs)
                for xs in zip(*(tree.leaves(t) for t in trees))]

    done = [_update(cfg, coef, *leaf)
            for leaf in zip(stacked(params), stacked(grads), stacked([st.m for st in states]),
                            stacked([st.v for st in states]))]
    out = []
    for i, t in enumerate(params):
        unflatten = tree.flatten(t)[1]
        p, m, v = ([x if n == 1 else x[i] for x in part] for part in zip(*done))
        out.append((unflatten(p), OptState(step=step, m=unflatten(m), v=unflatten(v))))
    return out
