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
:class:`GridEngine` runs the same scheduler over an R x C grid, the model
sharded as the cell catalogue places it
(:mod:`repro_torch.models.transformer_sharded`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models import transformer_sharded as tsh


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (p,) int32
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cursor: int = 0  # the prompt token the slot was last fed


def sample(logits, temperature: float, u=None):
    """The next tokens of (B, V_pad) ``logits``: the first maximum
    (greedy), or at ``temperature > 0`` the Gumbel-max trick over the
    uniforms ``u`` (the logits' shape)."""
    if temperature <= 0:
        return torch.argmax(logits, -1)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() / temperature + gumbel, -1)


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
        self.cache = tfm.init_cache(cfg, batch_slots, max_seq, device=self.device)
        self._schedule(batch_slots, max_seq, temperature, seed)

    def _schedule(self, batch_slots: int, max_seq: int, temperature: float, seed: int) -> None:
        """The host-side state of the slots, and the sampling generator."""
        self.b = batch_slots
        self.max_seq = max_seq
        self.temperature = temperature
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
        sampled = self._decode()
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

    def _decode(self) -> np.ndarray:
        """The tick's device work: one decode step over every slot, the
        next tokens sampled -> (B,) on the host (the tick's one host read)."""
        toks = torch.from_numpy(self._next_tok).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = tfm.decode_step(self.cfg, self.params, self.cache, toks, pos)
        self.logits = logits
        return sample(logits, self.temperature, self._uniform(logits.shape)).cpu().numpy().astype(
            np.int32)

    def _uniform(self, shape):
        """The tick's uniforms from the engine's generator (none when greedy)."""
        if self.temperature <= 0:
            return None
        return torch.rand(shape, generator=self.gen, device=self.device)

    def run_until_drained(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if self.tick() == 0 and not self.pending:
                return
        raise RuntimeError("engine did not drain")


class GridEngine(Engine):
    """The engine over an R x C grid (:mod:`repro_torch.models.transformer_sharded`):
    the same scheduler, tick for tick, in every process; the weights placed
    by ``specs`` (default ``serving_specs``: FSDP x TP), the cache's slots
    over the rows (``batch_slots`` a multiple of R) and its sequence over
    the columns (``max_seq`` a multiple of C).  ``params``: each rank's
    slices (``shard_params``, ``init_sharded``).  A tick's logits are
    all-gathered over TP, every rank samples its own slots from uniforms
    drawn by a generator seeded alike in every process (the one-device
    engine's draw, rows for its slots), and the picks are all-gathered over
    the rows: every process reads every slot's token, the one-device
    engine's."""

    def __init__(self, cfg: tfm.TransformerConfig, params, grid, specs=None,
                 batch_slots: int = 8, max_seq: int = 512, temperature: float = 0.0,
                 seed: int = 0):
        self.grid = grid
        self.device = grid.device
        self.cfg = cfg
        self.specs = tsh.serving_specs(cfg, grid) if specs is None else specs
        self.params = tsh.cast_params(cfg, params)
        self.cache = tsh.init_caches(cfg, grid, batch_slots, max_seq)
        self._schedule(batch_slots, max_seq, temperature, seed)

    def _decode(self) -> np.ndarray:
        g, dev = self.grid, self.device
        rows = g.row_axes
        toks = tsh.shard_rows(g, torch.from_numpy(self._next_tok).to(dev))
        pos = tsh.shard_rows(g, torch.from_numpy(self.pos).to(dev))
        logits = tsh.decode_step(self.cfg, g, self.params, self.cache, toks, pos, self.specs)
        self.logits = tsh.gather_logits(g, logits)  # each rank's slots, (b, V_pad)
        u = self._uniform((self.b, self.cfg.padded_vocab))
        b = self.b // g.rows

        def pick(p):
            mine = None if u is None else u.narrow(0, (p // g.cols) * b, b)
            return sample(self.logits[p], self.temperature, mine)

        picked = g.local(pick)
        if g.group_size(rows) > 1:
            picked = g.all_gather(picked, rows)
        return picked[g.local_ranks[0]].cpu().numpy().astype(np.int32)
