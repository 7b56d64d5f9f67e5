"""The forward step table (port of the dense half of
repro/runtime/forward.py).

Each step maker here returns ``(local_fn, StepSpec)``; a `ParallelBackend`
wraps it into the runnable step.  Local functions take shard-stacked
parameters and caches and per-request host arrays, and return global
values: full-vocab logits and token ids are assembled across shards
here (one device holds every shard, so the gather is a reshape).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import model as M
from repro_torch.parallel.backend import StepSpec
from repro_torch.runtime import sampling as RS


def full_logits(cfg, logits):
    """Vocab-parallel shard logits (tp, B, Vl) -> full (B, V)."""
    tp, b, vl = logits.shape
    return logits.permute(1, 0, 2).reshape(b, tp * vl)[:, : cfg.vocab_size]


def greedy_token(cfg, logits):
    """Greedy next token from shard logits (tp, B, Vl): the argmax of the
    full logits, first maximal index on ties (as the reference's
    gather-free pmax/pmin pair gives)."""
    return RS.greedy_tokens(full_logits(cfg, logits))


def prefill_step(cfg, plan, *, tp, q_chunk, cache_len):
    """Whole-batch prefill -> (full logits (B, V), caches)."""
    def local(p, toks, ln):
        lg, caches = M.prefill(cfg, p, plan, toks, tp=tp, q_chunk=q_chunk,
                               cache_len=cache_len, lengths=ln)
        return full_logits(cfg, lg), caches

    return local, StepSpec(("params", "batch", "batch"), ("batch", "cache"))


def decode_step(cfg, plan, *, tp, with_logits=False, sampled=False):
    """Dense decode -> (next ids (B, 1)[, full logits], caches)."""
    if sampled:
        def local(p, toks, pos, cs, t, k, pp, gens):
            lg, ncs = M.decode_step(cfg, p, plan, toks, pos, cs, tp=tp)
            nxt = RS.sample_core(full_logits(cfg, lg), t, k, pp, gens)
            return nxt[:, None], ncs

        return local, StepSpec(
            ("params", "batch", "batch", "cache", "batch", "batch", "batch",
             "rep"), ("batch", "cache"))

    def local(p, toks, pos, cs):
        lg, ncs = M.decode_step(cfg, p, plan, toks, pos, cs, tp=tp)
        nxt = greedy_token(cfg, lg)[:, None]
        if with_logits:
            return nxt, full_logits(cfg, lg), ncs
        return nxt, ncs

    out = (("batch", "batch", "cache") if with_logits else ("batch", "cache"))
    return local, StepSpec(("params", "batch", "batch", "cache"), out)


def insert_slot(caches, caches1, b: int, *, batch_axis: int):
    """Copy a prefilled batch-1 cache tree into slot `b` of the serving
    caches, in place (`batch_axis` is the backend's cache batch axis)."""
    pre = (slice(None),) * batch_axis
    for seg, seg1 in zip(caches, caches1):
        for k in seg:
            seg[k][pre + (b,)] = seg1[k][pre + (0,)]
    return caches


def bucketed_prefill(engine, params, toks, s: int, cache_len: int,
                     chunk=None):
    """One request's prefill, right-padded to the next power-of-two
    bucket (at least 16) capped at the slot capacity; the pad slots are
    overwritten by decode before they become causally visible."""
    if chunk:
        raise NotImplementedError("chunked prefill is not ported yet")
    toks = np.asarray(toks, np.int64)
    sb = min(max(16, 1 << math.ceil(math.log2(max(s, 1)))), cache_len)
    padded = np.zeros((1, sb), np.int64)
    padded[0, :s] = toks
    return engine.prefill(params, padded, cache_len=cache_len,
                          lengths=np.asarray([s], np.int64))
