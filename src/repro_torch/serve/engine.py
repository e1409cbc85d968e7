"""Slot-based batched decode engine (continuous batching, greedy/temperature).

Port of :mod:`repro.serve.engine`.  A fixed pool of B slots shares one
(L, B, S, w) KV cache.  Requests are assigned to free slots; every engine
tick runs ONE decode step for the whole pool, so throughput is batch-limited,
not request-limited.  The scheduling is the reference's, tick for tick:
prompts are fed one token per tick, every slot is stepped (a free one with
its stale token at position 0), and a request stops at ``max_new`` tokens
or at position ``max_seq - 1``; so greedy outputs and caches equal the
reference's.  The engine holds a compute-dtype copy of the weights
(:func:`repro_torch.models.transformer.cast_params`) instead of casting
them every tick, and reads the sampled tokens to the host once a tick.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (p,) int32
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cursor: int = 0  # the prompt token the slot was last fed


class Engine:
    """``device=None`` means ``cuda`` (raises without a card).  At
    ``temperature > 0`` tokens are drawn by the Gumbel-max trick from the
    engine's own ``torch.Generator`` seeded with ``seed`` (the reference's
    ``jax.random`` draws cannot be reproduced); greedy decoding takes the
    first maximum, as ``jnp.argmax`` does."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        params: Any,
        batch_slots: int = 8,
        max_seq: int = 512,
        temperature: float = 0.0,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tfm.cast_params(cfg, params)
        self.b = batch_slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.cache = tfm.init_cache(cfg, batch_slots, max_seq, device=self.device)
        self.pos = np.zeros(batch_slots, np.int32)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.pending: list[Request] = []
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_tok = np.zeros(batch_slots, np.int32)
        self.logits = None  # the last tick's (B, V_pad) logits

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _assign(self) -> None:
        for i in range(self.b):
            if self.slot_req[i] is None and self.pending:
                req = self.pending.pop(0)
                self.slot_req[i] = req
                # prefill by stepping through the prompt tokens (cache fill)
                self.pos[i] = 0
                self._next_tok[i] = req.prompt[0]
                req.cursor = 0

    def tick(self) -> int:
        """One engine iteration; returns number of active slots."""
        self._assign()
        active = [i for i in range(self.b) if self.slot_req[i] is not None]
        if not active:
            return 0
        toks = torch.from_numpy(self._next_tok).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = tfm.decode_step(self.cfg, self.params, self.cache, toks, pos)
        self.logits = logits
        if self.temperature > 0:
            u = torch.rand(logits.shape, generator=self.gen, device=self.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            sampled = torch.argmax(logits.float() / self.temperature + gumbel, -1)
        else:
            sampled = torch.argmax(logits, -1)
        sampled = sampled.cpu().numpy().astype(np.int32)  # the tick's one host read

        for i in active:
            req = self.slot_req[i]
            cur = req.cursor
            self.pos[i] += 1
            if cur + 1 < len(req.prompt):  # still consuming the prompt
                req.cursor = cur + 1
                self._next_tok[i] = req.prompt[cur + 1]
                continue
            tok = int(sampled[i])
            req.out.append(tok)
            self._next_tok[i] = tok
            if len(req.out) >= req.max_new or self.pos[i] >= self.max_seq - 1:
                req.done = True
                self.slot_req[i] = None
                self.pos[i] = 0
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.pending:
                return
        raise RuntimeError("engine did not drain")
