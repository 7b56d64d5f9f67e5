"""The serving engine (port of repro/runtime/engines.py: dense, paged,
chunked prefill and the speculative steps): one `Engine` over a
`ParallelBackend`.  Steps are built lazily
through `backend.wrap`; caches and page pools stay in the backend's
layout between calls and are updated in place."""
from __future__ import annotations

import numpy as np

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
        """Dense caches of `batch` slots (on `shard`, this data rank's
        share of them)."""
        return self.backend.blank_caches(
            M.cache_struct(self.cfg, self.plan, batch, cache_len, self.tp))

    def blank_paged_caches(self, max_slots: int, cache_len: int, *,
                           page_size: int, num_pages: int):
        """Page pools, whole on every data rank (paged steps run the batch
        replicated)."""
        return self.backend.blank_caches(M.paged_cache_struct(
            self.cfg, self.plan, max_slots, cache_len, self.tp,
            page_size=page_size, num_pages=num_pages), shard_batch=False)

    def insert_paged(self, pcaches, caches1, b: int, page_row):
        """Scatter slot `b`'s prefilled caches1 into its pages
        (`page_row`, the slot's table row) and its dense leaves into slot
        `b`'s stripe."""
        step = self._step(("insert_paged",),
                          lambda: F.insert_paged_step(self.cfg, self.plan))
        return step(pcaches, caches1, b, page_row)[0]

    def copy_paged_pages(self, pcaches, src, dst):
        """COW page duplication: physical page src[i] -> dst[i] on every
        pageable leaf (PagePool.ensure_writable decides the pairs)."""
        step = self._step(("copy_pages",),
                          lambda: F.copy_pages_step(self.cfg, self.plan))
        return step(pcaches, np.asarray(src, np.int64),
                    np.asarray(dst, np.int64))[0]

    def insert_slot(self, caches, caches1, b: int):
        return self.backend.insert_slot(caches, caches1, b)

    def prefill(self, params, tokens, *, cache_len: int, lengths=None,
                embeds=None):
        """Whole-batch prefill -> (full logits (B, V), caches).  `embeds`
        (B, Flen, frontend_dim), a frontend config's prefix: the caches
        then hold Flen + S positions, the logits are the last real
        token's and decode goes on at Flen + lengths.  On a backend with
        data ranks the batch (tokens, lengths and embeds) pads to a
        multiple of them and the result is cut back, as the reference's
        engine does (engines.py:96-123)."""
        step = self._step(("prefill", cache_len), lambda: F.prefill_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk,
            cache_len=cache_len))
        dpn = self.backend.dp_total
        if dpn == 1:
            return step(params, tokens, lengths, embeds)
        tokens = np.asarray(tokens)
        b0 = tokens.shape[0]
        pad = (-b0) % dpn
        if pad:
            tokens = np.concatenate(
                [tokens, np.zeros((pad,) + tokens.shape[1:], tokens.dtype)])
            if lengths is not None:
                lengths = np.asarray(lengths)
                lengths = np.concatenate(
                    [lengths, np.ones((pad,), lengths.dtype)])
            if embeds is not None:
                embeds = np.asarray(embeds)
                embeds = np.concatenate(
                    [embeds, np.zeros((pad,) + embeds.shape[1:],
                                      embeds.dtype)])
        lg, caches = step(params, tokens, lengths, embeds)
        return lg[:b0], self.backend.cache_rows(caches, b0)

    def prefill_chunked(self, params, tokens, *, cache_len: int, lengths,
                        chunk: int):
        """Incremental prefill in fixed-size chunks: tokens (B, S)
        right-padded, lengths (B,) the real lengths.  Archs the extension
        forward does not cover prefill whole, at the tokens' own length.
        The chunk step runs the batch replicated over the data ranks, so
        its caches hold every row on each of them (`shard_batch=False`),
        as a whole prefill's do after `backend.cache_rows`."""
        if not M.supports_chunked_prefill(self.cfg):
            return self.prefill(params, tokens, cache_len=cache_len,
                                lengths=np.asarray(lengths, np.int64))
        step = self._step(("prefill_chunk", cache_len),
                          lambda: F.prefill_chunk_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk))
        caches = self.backend.blank_caches(M.cache_struct(
            self.cfg, self.plan, tokens.shape[0], cache_len, self.tp),
            shard_batch=False)
        return F.drive_chunked_prefill(
            lambda t, st, ln, cs: step(params, t, st, ln, cs), caches,
            tokens, lengths, int(chunk))

    def _decode(self, with_logits: bool):
        return self._step(("decode", with_logits), lambda: F.decode_step(
            self.cfg, self.plan, tp=self.tp, with_logits=with_logits))

    def decode(self, params, tokens, pos, caches):
        return self._decode(False)(params, tokens, pos, caches)

    def decode_pipelined(self, params, groups, *, depth: int = 2):
        """Greedy decode over independent micro-batches, each issued
        before waiting on the one before (F.drive_pipelined_decode), the
        host-level overlap seam of the "overlap" backend.  `groups` is a
        list of ``(tokens, pos, caches)``; returns ``[(ids, caches),
        ...]`` token-identical to calling `decode` per group.  On the
        shard backend's ranks each group's rows split over the data ranks
        and its ids come back through the data group, as `decode`'s (the
        step is the backend's wrapped decode)."""
        return F.drive_pipelined_decode(self._decode(False), params,
                                        groups, depth=depth)

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

    def verify(self, params, tokens, pos, caches, tree=None):
        """Speculative verify on dense caches: tokens (B, C) -- the last
        accepted token and C-1 drafts -- in one forward; returns (full
        logits (B, C, V), caches).  `tree=(depths, anc)` (static tuples
        from spec.verify.tree_layout) verifies a tree chunk."""
        step = self._step(("verify", tree), lambda: F.verify_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk,
            tree=tree))
        return step(params, tokens, pos, caches)

    def verify_paged(self, params, tokens, pos, page_table, pcaches,
                     tree=None):
        """Paged multi-token forward (speculative verify, warm-admission
        suffix prefill): full-vocab logits of every chunk position,
        (B, C, V).  `tree` as in `verify`."""
        step = self._step(("verify_paged", tree), lambda: F.paged_verify_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk,
            tree=tree))
        return step(params, tokens, pos, page_table, pcaches)

    # ---- the self-draft steps (spec.draft.Drafter) ----

    def draft(self, params, ctx, start, caches, *, k: int):
        """Greedy k-token self-draft (F.draft_step): the catch-up verify
        and k-1 one-token steps.  Returns (toks (B, k), caches)."""
        step = self._step(("draft", int(k)), lambda: F.draft_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk, k=k))
        return step(params, ctx, start, caches)

    def draft_tree(self, params, ctx, start, caches, *, k: int,
                   width: int):
        """Greedy draft that also returns the first position's top-2..
        top-`width` candidates: (toks (B, k), alts (B, width-1),
        caches)."""
        step = self._step(("draft_tree", int(k), int(width)),
                          lambda: F.draft_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk, k=k,
            tree_width=width))
        return step(params, ctx, start, caches)

    def draft_sampled(self, params, ctx, start, caches, temperature, top_k,
                      top_p, generators, *, k: int):
        """Sampled draft: per-request temperature / top-k / top-p, and
        `generators[i]` (one per row) for draft draw i.  Returns (toks
        (B, k), full logits (B, k, V), caches).  The step takes the
        generators a row (row b's k draws), so that a backend with data
        ranks splits them with the other rows."""
        step = self._step(("draft_sampled", int(k)), lambda: F.draft_step(
            self.cfg, self.plan, tp=self.tp, q_chunk=self.q_chunk, k=k,
            sampled=True))
        rows = [list(g) for g in zip(*generators)]
        return step(params, ctx, start, caches, temperature, top_k, top_p,
                    rows)

    def copy_pos(self, caches, src, dst):
        """Per-row cache position copy src[b] -> dst[b] on dense caches
        (src == dst rows are no-ops)."""
        step = self._step(("copy_pos",),
                          lambda: F.copy_pos_step(self.cfg, self.plan))
        return step(caches, np.asarray(src, np.int64),
                    np.asarray(dst, np.int64))[0]

    def copy_pos_paged(self, pcaches, page_table, src, dst, *,
                       page_size: int):
        """copy_pos through the page table (unallocated pages resolve to
        the trash page)."""
        step = self._step(("copy_pos_paged", int(page_size)),
                          lambda: F.copy_pos_paged_step(
            self.cfg, self.plan, page_size=page_size))
        return step(pcaches, page_table, np.asarray(src, np.int64),
                    np.asarray(dst, np.int64))[0]

    def _decode_paged(self, with_logits: bool):
        return self._step(("decode_paged", with_logits),
                          lambda: F.paged_decode_step(
            self.cfg, self.plan, tp=self.tp, with_logits=with_logits))

    def decode_paged(self, params, tokens, pos, page_table, pcaches):
        return self._decode_paged(False)(params, tokens, pos, page_table,
                                         pcaches)

    def decode_paged_with_logits(self, params, tokens, pos, page_table,
                                 pcaches):
        return self._decode_paged(True)(params, tokens, pos, page_table,
                                        pcaches)

    def decode_paged_sampled(self, params, tokens, pos, page_table, pcaches,
                             temperature, top_k, top_p, generators):
        """Paged decode with per-request sampling (temp <= 0 rows are
        greedy)."""
        step = self._step(("decode_paged_sampled",), lambda:
                          F.paged_decode_step(self.cfg, self.plan, tp=self.tp,
                                              sampled=True))
        return step(params, tokens, pos, page_table, pcaches, temperature,
                    top_k, top_p, generators)
