"""Continuous-batching serving runtime, a port of
``repro.serving.batching``, run eagerly.

A fixed pool of ``slots`` sequence slots shares one cache per layer;
prefill fills a free slot (one sequence at a time), and every decode
step advances all slots together. The admission and preemption policy
(who gets a slot first, who is evicted when an interactive request
arrives) is the one the simulator picked (``bridge.evaluate_policies``).
Admission, preemption, requeueing and the greedy argmax are the JAX
package's, step for step. That includes its decode position: every
step decodes all slots at ``max(pos)``, so on an attention arch a slot
with a shorter sequence writes its K/V past its own end and attends to
the zero gap between (ROADMAP queue 3); the port keeps it so that the
two packages give the same tokens.

The caches live on the parameters' device and are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import lm
from ..models.common import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # prompt
    max_new: int
    interactive: bool = True
    out: Optional[list] = None


class ContinuousBatcher:
    """Fixed-slot continuous batcher over the LM entry points."""

    def __init__(self, cfg: ModelConfig, params: lm.LM, *, slots: int, max_len: int,
                 policy: str = "priority"):
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.slots = slots
        self.max_len = max_len
        self.policy = policy
        self.caches = lm.init_caches(cfg, slots, max_len, self.device)
        self.live: list[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int32)       # per-slot next position
        self.last_tok = np.zeros(slots, np.int32)
        self.queue: list[Request] = []
        self.done: list[Request] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)
        if self.policy.startswith("priority"):
            self.queue.sort(key=lambda r: (not r.interactive,))

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.live):
            if r is None:
                return i
        return None

    def _admit(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None and self.policy.startswith("priority"):
                # an interactive head may preempt a batch job (Eudoxia's
                # priority semantics, applied to slots)
                head = self.queue[0]
                if head.interactive:
                    victims = [
                        i for i, r in enumerate(self.live)
                        if r is not None and not r.interactive
                    ]
                    if victims:
                        v = victims[-1]
                        evicted = self.live[v]
                        self.live[v] = None
                        # re-queue with progress kept in its token list
                        evicted.tokens = np.concatenate(
                            [evicted.tokens, np.asarray(evicted.out, np.int32)]
                        )
                        evicted.max_new -= len(evicted.out)
                        evicted.out = []
                        self.queue.append(evicted)
                        slot = v
            if slot is None:
                return
            req = self.queue.pop(0)
            self._prefill_into(slot, req)

    def _prefill_into(self, slot: int, req: Request):
        # single-sequence prefill, spliced into slot `slot` of the shared caches
        toks = torch.as_tensor(np.asarray(req.tokens, np.int32), device=self.device)[None, :]
        logits, cache1 = lm.lm_prefill(self.cfg, self.params, {"tokens": toks},
                                       max_len=self.max_len)
        for shared, single in zip(self.caches, cache1):
            for dst, src in zip(shared, single):
                dst[slot:slot + 1] = src.to(dst.dtype)
        self.live[slot] = req
        self.pos[slot] = len(req.tokens)
        self.last_tok[slot] = int(torch.argmax(logits[0]))
        req.out.append(int(self.last_tok[slot]))

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One decode step for all live slots."""
        self._admit()
        if not any(r is not None for r in self.live):
            return False
        pos = int(self.pos.max())  # uniform position (the JAX package's fixed-shape decode)
        toks = torch.as_tensor(self.last_tok, device=self.device)
        logits, self.caches = lm.lm_decode_step(self.cfg, self.params, self.caches, toks, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for i, req in enumerate(self.live):
            if req is None:
                continue
            req.out.append(int(nxt[i]))
            self.last_tok[i] = nxt[i]
            self.pos[i] += 1
            if len(req.out) >= req.max_new or self.pos[i] >= self.max_len - 1:
                self.done.append(req)
                self.live[i] = None
        return True

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or any(self.live)) and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.done


__all__ = ["Request", "ContinuousBatcher"]
