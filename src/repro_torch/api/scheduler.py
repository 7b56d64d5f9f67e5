"""The continuous-batching scheduler behind the facade (port of the dense
half of repro/api/scheduler.py).

Dense layout: one fixed `cache_len` stripe per slot; a request is
admitted whenever a slot is free (FIFO), prefilled alone (right-padded
to a power-of-two bucket), copied into its slot, and then decoded with
every other active slot, one token per step.  A batch whose requests
are all greedy takes the fused greedy decode; any sampled request
switches the step to the sampled decode.

Divergence from the reference: when no slot is active after admission,
`_step` returns whether requests are still queued.  The reference
returns False there (repro/api/scheduler.py:1114-1118), which stops
`run()` and `LLM.generate` while requests wait — e.g. 4 requests of
max_new=1 on 3 slots: all three admitted requests finish at admission
and the fourth stays queued.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.sampling import SamplingParams
from repro_torch.runtime import sampling as RS

__all__ = ["CacheConfig", "Request", "Scheduler", "InvalidRequestError",
           "DenseKVCacheManager"]

_GREEDY = SamplingParams()


class InvalidRequestError(ValueError):
    """Request rejected at admission."""


@dataclass(frozen=True)
class CacheConfig:
    """Dense KV-cache geometry (the paged fields come with paged
    serving)."""

    cache_len: int
    max_batch: int = 4

    def __post_init__(self):
        if self.cache_len <= 0 or self.max_batch <= 0:
            raise ValueError(f"bad cache geometry: {self}")


@dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int
    max_new: int = 16
    eos: int = -1                   # -1 => never
    out: List[int] = field(default_factory=list)
    done: bool = False
    sampling: Optional[SamplingParams] = None
    finish_reason: Optional[str] = None


class DenseKVCacheManager:
    """One fixed `cache_len` stripe per slot (a freed slot is simply
    overwritten by the next admission's insert)."""

    def __init__(self, engine, cc: CacheConfig):
        self.engine = engine
        self.cc = cc
        self.caches = engine.blank_caches(cc.max_batch, cc.cache_len)

    def capacity_error(self, prompt_len: int, max_new: int) -> Optional[str]:
        # a slot holds the prompt plus one KV write per decode step except
        # the last (the final token's KV is never stored)
        need = prompt_len + max_new - 1
        if need > self.cc.cache_len:
            return (f"request needs {need} cache positions, exceeding "
                    f"per-slot cache_len={self.cc.cache_len}")
        return None

    def insert(self, caches1, slot: int):
        self.caches = self.engine.insert_slot(self.caches, caches1, slot)

    def decode(self, params, cur, pos):
        nxt, self.caches = self.engine.decode(params, cur, pos, self.caches)
        return nxt

    def decode_sampled(self, params, cur, pos, t, k, p, gens):
        nxt, self.caches = self.engine.decode_sampled(
            params, cur, pos, self.caches, t, k, p, gens)
        return nxt


class Scheduler:
    """Continuous batching over dense per-slot caches (see module doc)."""

    def __init__(self, engine, params, cache: CacheConfig):
        self.engine = engine
        self.params = params
        self.cache = cache
        self.kv = DenseKVCacheManager(engine, cache)
        self.max_batch = cache.max_batch
        self.cache_len = cache.cache_len
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * cache.max_batch
        self.pos = np.zeros(cache.max_batch, np.int64)
        self.cur = np.zeros((cache.max_batch, 1), np.int64)
        self.completed: Dict[int, Request] = {}

    # ---------------- request lifecycle ----------------

    def submit(self, req: Request):
        """Validate and enqueue."""
        self.validate(req)
        self.queue.append(req)

    def validate(self, req: Request):
        """Admission checks only; raises InvalidRequestError."""
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1 or prompt.size == 0:
            raise InvalidRequestError(
                f"request {req.uid}: prompt must be a non-empty 1-D token "
                f"array (got shape {prompt.shape})")
        if req.max_new <= 0:
            raise InvalidRequestError(
                f"request {req.uid}: max_new must be positive "
                f"(got {req.max_new})")
        if len(prompt) > self.cache_len:
            raise InvalidRequestError(
                f"request {req.uid}: prompt length {len(prompt)} exceeds "
                f"cache_len={self.cache_len}")
        msg = self.kv.capacity_error(len(prompt), self._max_new(req))
        if msg is not None:
            raise InvalidRequestError(f"request {req.uid}: {msg}")

    @staticmethod
    def _resume_tokens(req: Request) -> np.ndarray:
        if not req.out:
            return np.asarray(req.prompt, np.int64)
        return np.concatenate([np.asarray(req.prompt, np.int64),
                               np.asarray(req.out, np.int64)])

    def _prefill(self, toks: np.ndarray, s: int):
        from repro_torch.runtime.forward import bucketed_prefill
        return bucketed_prefill(self.engine, self.params, toks, s,
                                self.cache_len)

    def _first_token(self, req: Request, logits) -> int:
        """The admission token from the prefill logits (1, V)."""
        sp = req.sampling or _GREEDY
        if sp.greedy:
            return int(RS.greedy_tokens(logits)[0])
        gens = RS.make_generators([sp.seed], [len(req.out)], logits.device)
        return int(RS.sample_core(logits, [sp.temperature], [sp.top_k],
                                  [sp.top_p], gens)[0])

    def _admit(self):
        for b in range(self.max_batch):
            if not self.queue:
                break
            if self.slots[b] is not None:
                continue
            req = self.queue.popleft()
            toks = self._resume_tokens(req)
            s = len(toks)
            try:
                logits, caches1 = self._prefill(toks, s)
                first = self._first_token(req, logits)
            except BaseException:
                self.queue.appendleft(req)
                raise
            req.out.append(first)
            self.slots[b] = req
            self.pos[b] = s
            self.cur[b, 0] = first
            self.kv.insert(caches1, b)
            if self._stopping(req, first):
                self._finish(b)

    @staticmethod
    def _max_new(req: Request) -> int:
        if req.sampling is None:
            return req.max_new
        return min(req.max_new, req.sampling.max_new)

    def _stopping(self, req: Request, tok: int) -> bool:
        sp = req.sampling
        if tok == req.eos or (sp is not None and tok in sp.stop_token_ids):
            req.finish_reason = "stop"
            return True
        if len(req.out) >= self._max_new(req):
            req.finish_reason = "length"
            return True
        return False

    def _finish(self, b: int):
        req = self.slots[b]
        req.done = True
        self.completed[req.uid] = req
        self.slots[b] = None
        self.pos[b] = 0

    def cancel(self, reqs):
        """Withdraw requests (queued, active, or completed)."""
        targets = {id(r) for r in reqs}
        if not targets:
            return
        self.queue = deque(r for r in self.queue if id(r) not in targets)
        for b in range(self.max_batch):
            r = self.slots[b]
            if r is not None and id(r) in targets:
                self.slots[b] = None
                self.pos[b] = 0
        for r in reqs:
            if self.completed.get(r.uid) is r:
                del self.completed[r.uid]

    # ---------------- main loop ----------------

    def _active(self) -> List[int]:
        return [b for b in range(self.max_batch)
                if self.slots[b] is not None]

    def _decode_active(self, active: List[int]):
        if all((self.slots[b].sampling or _GREEDY).greedy for b in active):
            return self.kv.decode(self.params, self.cur, self.pos)
        n = self.max_batch
        t = np.zeros(n, np.float32)
        k = np.zeros(n, np.int64)
        p = np.ones(n, np.float32)
        seeds = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int64)
        for b in active:
            sp = self.slots[b].sampling or _GREEDY
            t[b], k[b], p[b] = sp.temperature, sp.top_k, sp.top_p
            seeds[b] = sp.seed
            counts[b] = len(self.slots[b].out)
        gens = RS.make_generators(seeds, counts, self.engine.device)
        return self.kv.decode_sampled(self.params, self.cur, self.pos, t, k,
                                      p, gens)

    def step(self) -> bool:
        """Admit, then one decode step for all active slots.  Returns
        False when there is nothing left to do."""
        self._admit()
        active = self._active()
        if not active:
            return bool(self.queue)
        nxt = self._decode_active(active).cpu().numpy()
        for b in active:
            req = self.slots[b]
            tok = int(nxt[b, 0])
            req.out.append(tok)
            self.pos[b] += 1
            self.cur[b, 0] = tok
            if self._stopping(req, tok):
                self._finish(b)
        return True

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        steps = 0
        while self.has_work() and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.completed
