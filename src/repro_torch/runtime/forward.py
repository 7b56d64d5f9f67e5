"""The forward step table (port of repro/runtime/forward.py: the dense
steps, the fused paged ones and the gather -> dense -> scatter fallback,
chunked prefill and the speculative verify, draft and copy steps).

Each step maker here returns ``(local_fn, StepSpec)``; a `ParallelBackend`
wraps it into the runnable step.  Local functions take shard-stacked
parameters and caches and per-request host arrays, and return global
values: full-vocab logits and token ids are assembled across shards
here (on `sim` one device holds every shard, so the gather is a
reshape; on `shard` an all-gather over the model group, and greedy
tokens come from a gather-free masked argmax with a max / min pair).
Steps whose batch runs replicated over the data ranks (the paged, chunk,
insert and copy steps) declare `shard_batch=False`, as the reference's.

Paged layout: pageable cache leaves swap their (batch, seq) axes for
(num_pages + 1, page_size) -- page `num_pages` is the trash page -- and
the other leaves (rolling-window K/V, SSM state and conv tails) stay
dense per slot; `_map_paged` dispatches on the pageable-flag tree
(`model.cache_pageable_tree`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.kernels import ops as KOPS
from repro_torch.parallel import collectives as COL
from repro_torch.parallel.backend import StepSpec
from repro_torch.runtime import sampling as RS
from repro_torch.tree import tree_map


def _map_paged(flags, fn_paged, fn_dense, *trees):
    """tree_map over cache trees, dispatching on the pageable-flag tree."""
    return tree_map(lambda f, *ls: fn_paged(*ls) if f else fn_dense(*ls),
                    flags, *trees)


def _gathered(flags, pc, pt):
    """The dense view of paged caches: pageable leaves gathered through
    the table (copies), dense ones as they are (updated in place)."""
    return _map_paged(flags, lambda c: KOPS.gather_pages(c, pt),
                      lambda c: c, pc)


def full_logits(cfg, logits):
    """Vocab-parallel shard logits (tp, B, Vl) -> full (B, V)."""
    logits = COL.gather_shards(logits)
    tp, b, vl = logits.shape
    return logits.permute(1, 0, 2).reshape(b, tp * vl)[:, : cfg.vocab_size]


def full_logits_seq(cfg, logits):
    """Vocab-parallel shard logits (tp, B, C, Vl) -> full (B, C, V)."""
    logits = COL.gather_shards(logits)
    tp, b, c, vl = logits.shape
    return logits.permute(1, 2, 0, 3).reshape(b, c, tp * vl)[
        ..., : cfg.vocab_size]


def greedy_token(cfg, logits):
    """Greedy next token from shard logits (tp, B, Vl): the argmax of the
    full logits, first maximal index on ties.  Across ranks without
    gathering the vocab (the reference's form): each rank's masked local
    argmax, a max all-reduce of the row maxima, then a min all-reduce of
    the candidates that reach it picks the first maximal global column."""
    ctx = COL.current_group()
    if ctx is None or ctx.size == 1:
        return RS.greedy_tokens(full_logits(cfg, logits))
    vl = logits.shape[-1]
    gcol = COL.shard_ids(logits)[:, None] * vl + torch.arange(
        vl, device=logits.device)
    masked = torch.where((gcol < cfg.vocab_size)[:, None], logits,
                         torch.full_like(logits, float("-inf")))[0]
    mx = masked.amax(-1)
    lidx = torch.argmax(masked, -1) + gcol[0, 0]
    gmx = COL.group_reduce(mx.clone(), "max")
    cand = torch.where(mx >= gmx, lidx, torch.full_like(lidx,
                                                        cfg.vocab_size + 1))
    return COL.group_reduce(cand, "min")


def prefill_step(cfg, plan, *, tp, q_chunk, cache_len, gather_logits=True):
    """Whole-batch prefill -> (full logits (B, V), caches); `emb` the
    frontend's embeds (B, Flen, frontend_dim) or None, a "batch"
    argument like the tokens (reference forward.py:86-101).
    `gather_logits=False` leaves the logits vocab-sharded, (tp, B, Vl)
    (the "logits_shard" kind; on `shard` each rank keeps its own slice):
    the dry run uses it, so that its ledger holds the model's own syncs
    and not the serving gather."""
    def local(p, toks, ln, emb=None):
        lg, caches = M.prefill(cfg, p, plan, toks, tp=tp, q_chunk=q_chunk,
                               cache_len=cache_len, lengths=ln, embeds=emb)
        return (full_logits(cfg, lg) if gather_logits else lg), caches

    return local, StepSpec(("params", "batch", "batch", "batch"),
                           ("batch" if gather_logits else "logits_shard",
                            "cache"))


def decode_step(cfg, plan, *, tp, with_logits=False, sampled=False):
    """Dense decode -> (next ids (B, 1)[, full logits], caches)."""
    if sampled:
        def local(p, toks, pos, cs, t, k, pp, gens):
            lg, ncs = M.decode_step(cfg, p, plan, toks, pos, cs, tp=tp)
            nxt = RS.sample_core(full_logits(cfg, lg), t, k, pp, gens)
            return nxt[:, None], ncs

        return local, StepSpec(
            ("params", "batch", "batch", "cache", "batch", "batch", "batch",
             "batch"), ("batch", "cache"))

    def local(p, toks, pos, cs):
        lg, ncs = M.decode_step(cfg, p, plan, toks, pos, cs, tp=tp)
        nxt = greedy_token(cfg, lg)[:, None]
        if with_logits:
            return nxt, full_logits(cfg, lg), ncs
        return nxt, ncs

    out = (("batch", "batch", "cache") if with_logits else ("batch", "cache"))
    return local, StepSpec(("params", "batch", "batch", "cache"), out)


def paged_decode_step(cfg, plan, *, tp, with_logits=False, sampled=False):
    """Paged decode.  Where M.supports_paged_attention holds, fused: K/V
    scatter straight into their pages and attention reads through the
    page table (M.paged_step), so no cache tree is gathered.  Elsewhere
    (int8 KV, MLA, windowed, hybrid, SSM) the fallback: every pageable
    leaf gathered into a per-slot view, the dense decode on it, and the
    token it wrote scattered back to its page.  Returns (next ids (B,
    1)[, full logits], pools)."""
    if M.supports_paged_attention(cfg):
        def math(p, toks, pos, pt, pc):
            lg, pc2 = M.paged_step(cfg, p, plan, toks, pos, pc, pt, tp=tp)
            return lg[:, :, 0], pc2
    else:
        flags = M.cache_pageable_tree(cfg, plan)

        def math(p, toks, pos, pt, pc):
            lg, dense = M.decode_step(cfg, p, plan, toks, pos,
                                      _gathered(flags, pc, pt), tp=tp)
            _map_paged(flags, lambda c, nd: KOPS.scatter_token_page(
                c, nd, pt, pos), lambda c, nd: None, pc, dense)
            return lg, pc

    if sampled:
        def local(p, toks, pos, pt, pc, t, k, pp, gens):
            lg, pc2 = math(p, toks, pos, pt, pc)
            nxt = RS.sample_core(full_logits(cfg, lg), t, k, pp, gens)
            return nxt[:, None], pc2

        return local, StepSpec(
            ("params", "rep", "rep", "rep", "cache", "rep", "rep", "rep",
             "rep"), ("rep", "cache"), shard_batch=False)

    def local(p, toks, pos, pt, pc):
        lg, pc2 = math(p, toks, pos, pt, pc)
        nxt = greedy_token(cfg, lg)[:, None]
        if with_logits:
            return nxt, full_logits(cfg, lg), pc2
        return nxt, pc2

    out = ("rep", "rep", "cache") if with_logits else ("rep", "cache")
    return local, StepSpec(("params", "rep", "rep", "rep", "cache"), out,
                           shard_batch=False)


def prefill_chunk_step(cfg, plan, *, tp, q_chunk):
    """One chunked-prefill step (M.prefill_chunk), batch replicated;
    `drive_chunked_prefill` feeds it.  Returns (full logits (B, V),
    caches)."""
    def local(p, toks, start, ln, cs):
        lg, cs = M.prefill_chunk(cfg, p, plan, toks, start, cs, tp=tp,
                                 lengths=ln, q_chunk=q_chunk)
        return full_logits(cfg, lg), cs

    return local, StepSpec(("params", "rep", "rep", "rep", "cache"),
                           ("rep", "cache"), shard_batch=False)


def verify_step(cfg, plan, *, tp, q_chunk, tree=None):
    """Speculative verify on dense caches: tokens (B, C) -- the last
    accepted token and C-1 drafts -- scored in one forward; the full
    logits of every chunk position come out (acceptance reads them).
    `tree=(depths, anc)` (spec.verify.tree_layout) verifies a draft tree
    chunk instead of a chain."""
    def local(p, toks, pos, cs):
        lg, cs = M.verify_step(cfg, p, plan, toks, pos, cs, tp=tp,
                               q_chunk=q_chunk, tree=tree)
        return full_logits_seq(cfg, lg), cs

    return local, StepSpec(("params", "batch", "batch", "cache"),
                           ("batch", "cache"))


def paged_verify_step(cfg, plan, *, tp, q_chunk=1024, tree=None):
    """Paged multi-token forward: the speculative verify chunk, and the
    SUFFIX PREFILL of a warm admission (the uncached prompt tail, with
    other rows' tables masked to -1).  Fused where
    M.supports_paged_attention holds; elsewhere (an int8 KV cache: the
    other fallback stacks have no multi-token forward) the pages are
    gathered, M.verify_step runs on the view and the C tokens it wrote
    are scattered back.  `tree` as in `verify_step`; the chunk scatters
    contiguously at pos..pos+C-1 either way.  Returns (full logits (B, C,
    V), pools)."""
    if M.supports_paged_attention(cfg):
        def local(p, toks, pos, pt, pc):
            lg, pc2 = M.paged_step(cfg, p, plan, toks, pos, pc, pt, tp=tp,
                                   tree=tree)
            return full_logits_seq(cfg, lg), pc2
    else:
        flags = M.cache_pageable_tree(cfg, plan)

        def local(p, toks, pos, pt, pc):
            lg, dense = M.verify_step(cfg, p, plan, toks, pos,
                                      _gathered(flags, pc, pt), tp=tp,
                                      q_chunk=q_chunk, tree=tree)
            n = toks.shape[1]
            _map_paged(flags, lambda c, nd: KOPS.scatter_chunk_pages(
                c, nd, pt, pos, n), lambda c, nd: None, pc, dense)
            return full_logits_seq(cfg, lg), pc

    return local, StepSpec(("params", "rep", "rep", "rep", "cache"),
                           ("rep", "cache"), shard_batch=False)


def draft_step(cfg, plan, *, tp, q_chunk, k, sampled=False, tree_width=1):
    """The k-token self-draft.  The reference fuses it into one jitted
    dispatch (a catch-up verify, then a `lax.scan` of k-1 decodes); here
    it is a Python loop over the port's own steps: the catch-up context
    ctx (B, C) through M.verify_step (K/V at start..start+C-1), then k-1
    one-token M.verify_step calls.  A one-token extension step is the
    dense decode's arithmetic (same mask, RoPE and positions); it is used
    instead of M.decode_step because its cache write drops slots past the
    buffer, which a row near the end of its slot drafts into.

    Greedy returns (toks (B, k), caches); tree_width > 1 also returns the
    first position's top-2..top-w candidates (toks, alts (B, w-1),
    caches).  Sampled takes `gens` a row (gens[b][i]: row b's generator
    of draw i, a "batch" argument that splits over the data ranks with
    the rows), draws draft i with each row's i-th, and returns (toks,
    full logits (B, k, V), caches): the scheduler rebuilds each draw's
    distribution from them."""
    def chain(p, ctx, start, cs, first, draw):
        lg, cs = M.verify_step(cfg, p, plan, ctx, start, cs, tp=tp,
                               q_chunk=q_chunk)
        base = start.long() + ctx.shape[1] - 1   # each row's position
        tok, *rec = first(full_logits(cfg, lg[:, :, -1]))
        toks, recs = [tok], [rec]
        for i in range(1, k):
            lg, cs = M.verify_step(cfg, p, plan, tok[:, None], base + i,
                                   cs, tp=tp, q_chunk=q_chunk)
            tok, *rec = draw(full_logits(cfg, lg[:, :, 0]), i)
            toks.append(tok)
            recs.append(rec)
        return torch.stack(toks, 1), recs, cs

    if sampled:
        def local(p, ctx, start, cs, t, kk, pp, gens):
            def draw(full, i):
                return RS.sample_core(full, t, kk, pp,
                                      [g[i] for g in gens]), full

            toks, recs, cs = chain(p, ctx, start, cs,
                                   lambda full: draw(full, 0), draw)
            return toks, torch.stack([r[0] for r in recs], 1), cs

        return local, StepSpec(
            ("params", "batch", "batch", "cache", "batch", "batch", "batch",
             "batch"), ("batch", "batch", "cache"))

    def greedy(full, i=0):
        return (RS.greedy_tokens(full),)

    if tree_width > 1:
        def local(p, ctx, start, cs):
            def first(full):
                # top-w at the FIRST draft position: the chain continues
                # from top-1, the runners-up become depth-1 alternatives
                # (verified, never drafted past, never in the draft cache)
                top = torch.topk(full, tree_width, dim=-1).indices
                return top[:, 0], top[:, 1:]

            toks, recs, cs = chain(p, ctx, start, cs, first, greedy)
            return toks, recs[0][0], cs

        return local, StepSpec(("params", "batch", "batch", "cache"),
                               ("batch", "batch", "cache"))

    def local(p, ctx, start, cs):
        toks, _, cs = chain(p, ctx, start, cs, greedy, greedy)
        return toks, cs

    return local, StepSpec(("params", "batch", "batch", "cache"),
                           ("batch", "cache"))


def copy_pos_step(cfg, plan):
    """Per-row single-position copy on dense caches, in place: slot
    src[b] -> dst[b] on every leaf.  Tree speculation moves a committed
    alternative's K/V from its chunk slot to its stream position before
    the rollback; src == dst rows (padding 0 -> 0) are no-ops."""
    def local(cs, src, dst):
        for seg in cs:
            for leaf in seg.values():          # (tp, layers, B, S, ...)
                bi = torch.arange(leaf.shape[2], device=leaf.device)
                leaf[:, :, bi, dst.long()] = leaf[:, :, bi, src.long()]
        return (cs,)

    return local, StepSpec(("cache", "batch", "batch"), ("cache",))


def copy_pos_paged_step(cfg, plan, *, page_size):
    """copy_pos_step through the page table: each row's src / dst slot
    resolves to (page, offset); an unallocated page (or one past the
    table) resolves to the trash page, so padded rows copy trash ->
    trash.  Pageable leaves only: the others have no sequence axis to
    copy along."""
    flags = M.cache_pageable_tree(cfg, plan)

    def local(pc, pt, src, dst):
        bi = torch.arange(pt.shape[0], device=pt.device)
        table = pt.long()

        def phys(slot):
            pidx = torch.div(slot.long(), page_size, rounding_mode="floor")
            pg = table[bi, pidx.clamp(max=table.shape[1] - 1)]
            return pg, pidx >= table.shape[1]

        (sp, s_out), (dp, d_out) = phys(src), phys(dst)

        def one(leaf):                         # (tp, layers, P+1, ps, ...)
            trash = leaf.shape[2] - 1
            s_pg = torch.where((sp < 0) | s_out, trash, sp)
            d_pg = torch.where((dp < 0) | d_out, trash, dp)
            leaf[:, :, d_pg, dst.long() % page_size] = leaf[
                :, :, s_pg, src.long() % page_size]

        _map_paged(flags, one, lambda c: None, pc)
        return (pc,)

    return local, StepSpec(("cache", "rep", "rep", "rep"), ("cache",),
                           shard_batch=False)


def copy_pages_step(cfg, plan):
    """Device-side copy-on-write page duplication: physical page src[i]
    -> dst[i] on every pageable leaf, in place (the PagePool rewires the
    slot's table host-side); dense leaves are per slot, so nothing is
    shared there."""
    flags = M.cache_pageable_tree(cfg, plan)

    def local(pc, src, dst):
        def one(leaf):
            leaf[:, :, dst.long()] = leaf[:, :, src.long()]

        _map_paged(flags, one, lambda c: None, pc)
        return (pc,)

    return local, StepSpec(("cache", "rep", "rep"), ("cache",),
                           shard_batch=False)


def insert_paged_step(cfg, plan):
    """Scatter one prefilled request (batch-1 dense caches1) into slot `b`
    of the paged pools, in place: pageable leaves into its pages
    (`page_row`), dense leaves (rolling-window K/V, SSM state and conv
    tails) into the slot's stripe."""
    flags = M.cache_pageable_tree(cfg, plan)

    def local(pc, c1, b, row):
        def dense(p, c):
            p[:, :, int(b)].copy_(c[:, :, 0])

        _map_paged(flags, lambda p, c: KOPS.scatter_prefill_pages(
            p, c, row, tail=p.dim() - 4), dense, pc, c1)
        return (pc,)

    return local, StepSpec(("cache", "cache", "rep", "rep"), ("cache",),
                           shard_batch=False)


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


def drive_chunked_prefill(step, caches, tokens, lengths, chunk):
    """Host loop of chunked prefill: right-pad the batch to a chunk
    multiple, feed the chunks through `step(toks, start, lengths,
    caches)`, and keep each row's last-token logits from the chunk that
    holds its lengths-1 (ragged rows finish in different chunks)."""
    lengths = np.asarray(lengths, np.int64)
    tokens = np.asarray(tokens, np.int64)
    n = max(1, -(-int(lengths.max()) // chunk))
    toks = np.zeros((tokens.shape[0], n * chunk), np.int64)
    m = min(tokens.shape[1], n * chunk)
    toks[:, :m] = tokens[:, :m]
    final_chunk = (lengths - 1) // chunk
    logits = None
    for i in range(n):
        lg, caches = step(toks[:, i * chunk:(i + 1) * chunk], i * chunk,
                          lengths, caches)
        if logits is None:
            logits = lg.clone()
        else:
            sel = torch.from_numpy(final_chunk == i).to(lg.device)
            logits[sel] = lg[sel]
    return logits, caches


def bucketed_prefill(engine, params, toks, s: int, cache_len: int,
                     chunk=None):
    """One request's prefill, shared by the scheduler's admission and the
    speculative Drafter.  With `chunk`, chunked (`Engine.prefill_chunked`,
    which prefills whole on archs the extension forward does not cover).
    Otherwise attention-only models are right-padded to the next
    power-of-two bucket (at least 16) capped at the slot capacity; the pad
    slots are overwritten by decode before they become causally visible.
    A model with recurrent state is prefilled at the prompt's own length:
    a pad token would be scanned into its state and conv tails, which
    decode never overwrites (ROADMAP C3; the reference pads them too)."""
    toks = np.asarray(toks, np.int64)
    if chunk:
        return engine.prefill_chunked(params, toks[None], cache_len=cache_len,
                                      lengths=np.asarray([s], np.int64),
                                      chunk=chunk)
    if M.has_recurrent_state(engine.cfg):
        sb = s
    else:
        sb = min(max(16, 1 << math.ceil(math.log2(max(s, 1)))), cache_len)
    padded = np.zeros((1, sb), np.int64)
    padded[0, :s] = toks
    return engine.prefill(params, padded, cache_len=cache_len,
                          lengths=np.asarray([s], np.int64))
