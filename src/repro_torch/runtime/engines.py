"""The serving engine (port of the dense half of
repro/runtime/engines.py): one `Engine` over a `ParallelBackend`.
Steps are built lazily through `backend.wrap`; caches stay in the
backend's layout between calls and are updated in place."""
from __future__ import annotations

from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import model as M
from repro_torch.parallel.backend import ParallelBackend
from repro_torch.runtime import forward as F


class Engine:
    def __init__(self, cfg: ModelConfig, plan: SPDPlanConfig,
                 backend: ParallelBackend, q_chunk: int = 1024):
        self.cfg, self.plan, self.backend = cfg, plan, backend
        self.q_chunk = q_chunk
        self.tp = backend.tp
        self.device = backend.device
        self._steps = {}

    def _step(self, key, make):
        if key not in self._steps:
            self._steps[key] = self.backend.wrap(*make())
        return self._steps[key]

    def blank_caches(self, batch: int, cache_len: int):
        return self.backend.blank_caches(
            M.cache_struct(self.cfg, self.plan, batch, cache_len, self.tp))

    def insert_slot(self, caches, caches1, b: int):
        return F.insert_slot(caches, caches1, b,
                             batch_axis=self.backend.cache_batch_axis)

    def prefill(self, params, tokens, *, cache_len: int, lengths=None):
        step = self._step(("prefill", cache_len), lambda: F.prefill_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk,
            cache_len=cache_len))
        return step(params, tokens, lengths)

    def _decode(self, with_logits: bool):
        return self._step(("decode", with_logits), lambda: F.decode_step(
            self.cfg, self.plan, tp=self.tp, with_logits=with_logits))

    def decode(self, params, tokens, pos, caches):
        return self._decode(False)(params, tokens, pos, caches)

    def decode_with_logits(self, params, tokens, pos, caches):
        return self._decode(True)(params, tokens, pos, caches)

    def decode_sampled(self, params, tokens, pos, caches, temperature,
                       top_k, top_p, generators):
        """Decode with per-request temperature / top-k / top-p and one
        generator per row (temp <= 0 rows are greedy)."""
        step = self._step(("decode_sampled",), lambda: F.decode_step(
            self.cfg, self.plan, tp=self.tp, sampled=True))
        return step(params, tokens, pos, caches, temperature, top_k, top_p,
                    generators)
