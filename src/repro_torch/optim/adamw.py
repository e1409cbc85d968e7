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


def apply(cfg: AdamWConfig, params: Any, grads: Any,
          state: OptState) -> tuple[Any, OptState]:
    """One AdamW step with global-norm clipping and the WSD schedule."""
    step = state.step + 1
    gn = global_norm(grads)
    # a tensor numerator: ``scalar / tensor`` multiplies by the reciprocal
    clip = torch.full_like(gn, cfg.grad_clip)
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = wsd_schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (update + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m_new, v_new

    flat_p, unflatten = tree.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, tree.leaves(grads),
                                                  tree.leaves(state.m), tree.leaves(state.v))]
    return (unflatten([o[0] for o in out]),
            OptState(step=step, m=unflatten([o[1] for o in out]),
                     v=unflatten([o[2] for o in out])))
