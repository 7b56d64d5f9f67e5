"""The forward step table (port of repro/runtime/forward.py: the dense
steps and the fused paged ones).

Each step maker here returns ``(local_fn, StepSpec)``; a `ParallelBackend`
wraps it into the runnable step.  Local functions take shard-stacked
parameters and caches and per-request host arrays, and return global
values: full-vocab logits and token ids are assembled across shards
here (one device holds every shard, so the gather is a reshape).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.parallel.backend import StepSpec
from repro_torch.runtime import sampling as RS
from repro_torch.tree import tree_map


def full_logits(cfg, logits):
    """Vocab-parallel shard logits (tp, B, Vl) -> full (B, V)."""
    tp, b, vl = logits.shape
    return logits.permute(1, 0, 2).reshape(b, tp * vl)[:, : cfg.vocab_size]


def full_logits_seq(cfg, logits):
    """Vocab-parallel shard logits (tp, B, C, Vl) -> full (B, C, V)."""
    tp, b, c, vl = logits.shape
    return logits.permute(1, 2, 0, 3).reshape(b, c, tp * vl)[
        ..., : cfg.vocab_size]


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


def paged_decode_step(cfg, plan, *, tp, with_logits=False, sampled=False):
    """Paged decode, fused: K/V scatter straight into their pages and
    attention reads through the page table (M.paged_step), so no cache
    tree is gathered.  Returns (next ids (B, 1)[, full logits], pools)."""
    M.require_paged_attention(cfg)

    def math(p, toks, pos, pt, pc):
        lg, pc2 = M.paged_step(cfg, p, plan, toks, pos, pc, pt, tp=tp)
        return lg[:, :, 0], pc2

    if sampled:
        def local(p, toks, pos, pt, pc, t, k, pp, gens):
            lg, pc2 = math(p, toks, pos, pt, pc)
            nxt = RS.sample_core(full_logits(cfg, lg), t, k, pp, gens)
            return nxt[:, None], pc2

        return local, StepSpec(
            ("params", "rep", "rep", "rep", "cache", "rep", "rep", "rep",
             "rep"), ("rep", "cache"))

    def local(p, toks, pos, pt, pc):
        lg, pc2 = math(p, toks, pos, pt, pc)
        nxt = greedy_token(cfg, lg)[:, None]
        if with_logits:
            return nxt, full_logits(cfg, lg), pc2
        return nxt, pc2

    out = ("rep", "rep", "cache") if with_logits else ("rep", "cache")
    return local, StepSpec(("params", "rep", "rep", "rep", "cache"), out)


def paged_verify_step(cfg, plan, *, tp, tree=None):
    """Paged multi-token forward: the SUFFIX PREFILL of a warm admission
    (the uncached prompt tail, with other rows' tables masked to -1) and,
    with speculative decoding (ROADMAP A10), the verify chunk.  Returns
    (full logits (B, C, V), pools)."""
    M.require_paged_attention(cfg)
    if tree is not None:
        raise NotImplementedError("tree verify is not ported yet "
                                  "(ROADMAP A10)")

    def local(p, toks, pos, pt, pc):
        lg, pc2 = M.paged_step(cfg, p, plan, toks, pos, pc, pt, tp=tp)
        return full_logits_seq(cfg, lg), pc2

    return local, StepSpec(("params", "rep", "rep", "rep", "cache"),
                           ("rep", "cache"))


def copy_pages_step(cfg, plan):
    """Device-side copy-on-write page duplication: physical page src[i]
    -> dst[i] on every pageable leaf, in place (the PagePool rewires the
    slot's table host-side)."""
    M.require_paged_attention(cfg)

    def local(pc, src, dst):
        for seg in pc:
            for leaf in seg.values():
                leaf[:, :, dst.long()] = leaf[:, :, src.long()]
        return (pc,)

    return local, StepSpec(("cache", "rep", "rep"), ("cache",))


def insert_paged_step(cfg, plan):
    """Scatter one prefilled request (batch-1 dense caches1) into its
    pages (`page_row`) of the paged pools, in place."""
    M.require_paged_attention(cfg)
    from repro_torch.kernels import ops as KOPS

    def local(pc, c1, row):
        for seg, seg1 in zip(pc, c1):
            for name in seg:
                KOPS.scatter_prefill_pages(seg[name], seg1[name], row)
        return (pc,)

    return local, StepSpec(("cache", "cache", "rep"), ("cache",))


def insert_slot(caches, caches1, b: int, *, batch_axis: int):
    """Copy a prefilled batch-1 cache tree into slot `b` of the serving
    caches, in place (`batch_axis` is the backend's cache batch axis; the
    leaves may nest, as an SSM layer's conv tails do)."""
    pre = (slice(None),) * batch_axis
    tree_map(lambda dst, src: dst[pre + (b,)].copy_(src[pre + (0,)]),
             caches, caches1)
    return caches


def drive_pipelined_decode(step, params, groups, *, depth: int = 2):
    """Issue one decode step across independent micro-batches.

    `groups` is a list of per-group step arguments (``(tokens, pos,
    caches)``); returns the step results in order.  CUDA launches are
    asynchronous, so issuing group t+1's step before waiting on group t's
    outputs overlaps t+1's host work with t's device work.  A CUDA event
    recorded after each step is synchronized when the group leaves the
    window, so at most `depth` groups are in flight; on the CPU there is
    nothing to wait for.  Token-identical to the serial loop: the groups
    are independent and have their own caches."""
    def ready(item):
        res, event = item
        if event is not None:
            event.synchronize()
        return res

    inflight, out = [], []
    for g in groups:
        res = step(params, *g)
        event = None
        if res[0].is_cuda:            # res = (ids, caches)
            event = torch.cuda.Event()
            event.record()
        inflight.append((res, event))
        if len(inflight) >= max(int(depth), 1):
            out.append(ready(inflight.pop(0)))
    out.extend(ready(item) for item in inflight)
    return out


def bucketed_prefill(engine, params, toks, s: int, cache_len: int,
                     chunk=None):
    """One request's prefill.  Attention-only models are right-padded to
    the next power-of-two bucket (at least 16) capped at the slot
    capacity; the pad slots are overwritten by decode before they become
    causally visible.  A model with recurrent state is prefilled at the
    prompt's own length: a pad token would be scanned into its state and
    conv tails, which decode never overwrites (ROADMAP C3; the reference
    pads them too)."""
    if chunk:
        raise NotImplementedError("chunked prefill is not ported yet")
    toks = np.asarray(toks, np.int64)
    if M.has_recurrent_state(engine.cfg):
        sb = s
    else:
        sb = min(max(16, 1 << math.ceil(math.log2(max(s, 1)))), cache_len)
    padded = np.zeros((1, sb), np.int64)
    padded[0, :s] = toks
    return engine.prefill(params, padded, cache_len=cache_len,
                          lengths=np.asarray([s], np.int64))
