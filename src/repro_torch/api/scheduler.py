"""The continuous-batching scheduler behind the facade (port of
repro/api/scheduler.py: dense and paged, chunked prefill, speculative
decoding and the observability hooks).

One `Scheduler` over a `CacheConfig`: dense when page_size / num_pages
are None, paged otherwise, through a pluggable KV-cache manager.

  * dense: one fixed `cache_len` stripe per slot; a request is admitted
    whenever a slot is free (FIFO), prefilled alone (right-padded to a
    power-of-two bucket) and copied into its slot;
  * paged: head-of-line FIFO admission against free PAGES
    (runtime/paging.py).  Admission matches the prompt's full pages
    against the prefix cache, shares the hit read-only and prefills only
    the uncached suffix in place (warm), or prefills the whole prompt and
    scatters it into fresh pages (cold).  Before each decode step every
    active slot must own the page it is about to write; pool exhaustion
    preempts the latest-admitted slot (pages freed, request requeued at
    the front keeping its generated tokens; on re-admission it prefills
    over prompt + output).

Active slots then decode together, one token per step.  A batch whose
requests are all greedy takes the fused greedy decode; any sampled
request switches the step to the sampled decode.  `CacheConfig.
prefill_chunk` prefills prompts in fixed-size chunks on either layout.

Speculative decoding: built with a `repro_torch.spec.SpecState`, every
decode step becomes a draft-k / verify-once round -- the Drafter
proposes k tokens with the target's own weights under a cheap comm
plan, one multi-token verify forward scores them, and acceptance
(greedy or rejection-sampled, spec/verify.py) commits 1..k+1 tokens.
The rejected suffix rolls back: dense caches rewind the position,
paged slots return their suffix pages (`PagePool.shrink`).  Greedy
streams equal plain decoding's token for token.

Observability: built with a `repro_torch.obs.Recorder` (or given one
through `set_obs`), the scheduler, its page pool and its drafter feed
the reference's metrics (TTFT, TPOT and queue-wait histograms, request,
token, preemption, prefix and speculation counters, slot and queue
gauges) and trace (per-slot `queue` / `prefill` / `serve` slices and
`preempt` instants, the `scheduler` track's `step` spans and
`active_slots` counter, the `spec` track's `draft` / `verify` spans),
at the reference's places and in its order of clock reads.  The
default `NULL_RECORDER` makes every hook a no-op: no clock is read and
no request metadata kept.  No hook touches a tensor: the times are the
host's, and TTFT and TPOT end where the scheduler reads a step's tokens
back, which it does either way.

On the `shard` engine every rank runs this same host program: its
decisions (admission, preemption, prefix hits, sampled tokens) depend
only on the tokens, which the logits all-gather makes equal on every
rank.  `backend.agree` checks that at each admission and decode step
when the backend's `check_agreement` is set (off by default).

Divergence from the reference: when no slot is active after admission
(or after paged growth), `step` returns whether requests are still
queued.  The reference returns False after admission
(repro/api/scheduler.py:1114-1118), which stops `run()` and
`LLM.generate` while requests wait -- e.g. 4 requests of max_new=1 on 3
slots: all three admitted requests finish at admission and the fourth
stays queued.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.sampling import SamplingParams
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.runtime import sampling as RS
from repro_torch.runtime.paging import PagePool, page_hashes
from repro_torch.spec.verify import (accept_greedy_tree,
                                     accept_speculative_tree, filtered_probs,
                                     spec_rng, tree_layout)

__all__ = ["CacheConfig", "Request", "Scheduler", "InvalidRequestError",
           "DenseKVCacheManager", "PagedKVCacheManager"]

_GREEDY = SamplingParams()

# spec acceptance-rate histogram layout (a 0..1 ratio, not seconds)
_ACCEPT_BUCKETS = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class InvalidRequestError(ValueError):
    """Request rejected at admission."""


@dataclass(frozen=True)
class CacheConfig:
    """KV-cache geometry for a `Scheduler`.

    Dense layout when `page_size` / `num_pages` are None; paged
    otherwise (both must be set together, and `cache_len` must be a
    multiple of `page_size`).  `prefill_chunk` switches prompt prefill
    from power-of-two buckets to fixed-size chunks on either layout.
    `prefix_cache`
    (paged only): None = on when the arch has the fused paged forward,
    True forces it on, False off.
    """

    cache_len: int
    max_batch: int = 4
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    prefill_chunk: Optional[int] = None
    prefix_cache: Optional[bool] = None

    def __post_init__(self):
        if self.cache_len <= 0 or self.max_batch <= 0:
            raise ValueError(f"bad cache geometry: {self}")
        if (self.page_size is None) != (self.num_pages is None):
            raise ValueError(
                "page_size and num_pages must be set together "
                f"(got page_size={self.page_size}, "
                f"num_pages={self.num_pages})")
        if self.paged:
            if self.page_size <= 0 or self.num_pages <= 0:
                raise ValueError(f"bad paged geometry: {self}")
            if self.cache_len % self.page_size:
                raise ValueError(
                    f"cache_len={self.cache_len} not a multiple of "
                    f"page_size={self.page_size}")
        if self.prefill_chunk is not None and self.prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive: {self}")

    @property
    def paged(self) -> bool:
        return self.page_size is not None


@dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int
    max_new: int = 16
    eos: int = -1                   # -1 => never
    out: List[int] = field(default_factory=list)
    done: bool = False
    n_preempted: int = 0
    sampling: Optional[SamplingParams] = None
    finish_reason: Optional[str] = None
    # speculative decoding: tokens drafted for this request and how many
    # the verify forward accepted
    n_drafted: int = 0
    n_draft_accepted: int = 0


# ---------------------------------------------------------------------------
# KV-cache managers: the layout-specific half of the scheduler
# ---------------------------------------------------------------------------

class DenseKVCacheManager:
    """One fixed `cache_len` stripe per slot (a freed slot is simply
    overwritten by the next admission's insert)."""

    paged = False

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

    def admit_begin(self, slot: int, toks, total: int) -> Optional[int]:
        """Dense slots never share and never wait: 0 resident tokens."""
        return 0

    def register_prefix(self, slot: int, toks):
        pass

    # prefix-cache stats (always zero on dense, for uniform reporting)
    prefix_queries = 0
    prefix_hits = 0
    prefix_tokens_reused = 0

    def insert(self, caches1, slot: int):
        self.caches = self.engine.insert_slot(self.caches, caches1, slot)

    def release(self, slot: int):
        pass

    def decode(self, params, cur, pos):
        nxt, self.caches = self.engine.decode(params, cur, pos, self.caches)
        return nxt

    def decode_sampled(self, params, cur, pos, t, k, p, gens):
        nxt, self.caches = self.engine.decode_sampled(
            params, cur, pos, self.caches, t, k, p, gens)
        return nxt

    def ensure(self, slot: int, upto: int) -> bool:
        return upto <= self.cc.cache_len

    def verify(self, params, toks, pos, tree=None):
        """Multi-token speculative verify -> full logits (B, C, V) on the
        device (all-greedy rounds bring only the argmax ids to the
        host).  Chunk slots past a row's buffer are dropped."""
        lg, self.caches = self.engine.verify(params, toks, pos, self.caches,
                                             tree=tree)
        return lg

    def copy_pos(self, src, dst):
        """Per-row position copy src[b] -> dst[b]: a tree round moves a
        committed alternative's K/V from its chunk slot to the stream."""
        self.caches = self.engine.copy_pos(self.caches, src, dst)

    def truncate(self, slot: int, n_tokens: int):
        # dense rollback is free: the K/V past the committed position is
        # causally masked and overwritten as the position passes it again
        pass


class PagedKVCacheManager:
    """Page-pool allocator + page tables (runtime/paging.py), plus the
    prefix cache: admission matches a new prompt's full pages against
    resident registered pages, shares the hit read-only (refcounts), and
    prefills only the uncached suffix through `verify_paged` with every
    other batch row masked to the trash page."""

    paged = True

    def __init__(self, engine, cc: CacheConfig):
        self.engine = engine
        self.cc = cc
        self.pool = PagePool(num_pages=cc.num_pages, page_size=cc.page_size,
                             max_slots=cc.max_batch,
                             pages_per_slot=cc.cache_len // cc.page_size)
        self.pcaches = engine.blank_paged_caches(
            cc.max_batch, cc.cache_len, page_size=cc.page_size,
            num_pages=cc.num_pages)
        self.prefix_cache = cc.prefix_cache
        if self.prefix_cache is None:
            from repro_torch.core.model import supports_paged_attention
            self.prefix_cache = supports_paged_attention(engine.cfg)
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        # per-slot digests computed at admission, reused by register_prefix
        self._admit_hashes: Dict[int, list] = {}

    def _table(self, rows=None) -> np.ndarray:
        """Host page table (int64), width-bucketed to the next power of
        two of the largest row: fewer K/V positions to attend over, and
        at most log2(pages_per_slot) + 1 widths."""
        t = self.pool.table if rows is None else rows
        w = max(1, int(self.pool.owned.max()))
        b = 1
        while b < w:
            b <<= 1
        return t[:, :min(b, self.pool.pages_per_slot)].astype(np.int64)

    def _cow(self, pos, n_tokens: int):
        """Copy-on-write barrier before writing n_tokens at pos[b]: every
        page about to be written must be privately owned (in the steady
        state writes sit above any shared prefix and nothing copies)."""
        pairs = []
        ps = self.cc.page_size
        for b in range(self.cc.max_batch):
            own = int(self.pool.owned[b])
            if own == 0:
                continue
            lo = int(pos[b]) // ps
            hi = min((int(pos[b]) + n_tokens - 1) // ps, own - 1)
            for pg in range(lo, hi + 1):
                pr = self.pool.ensure_writable(b, pg)
                if pr is not None:
                    pairs.append(pr)
        if pairs:
            src, dst = zip(*pairs)
            self.pcaches = self.engine.copy_paged_pages(
                self.pcaches, list(src), list(dst))

    def capacity_error(self, prompt_len: int, max_new: int) -> Optional[str]:
        # admission grows to resume_len + 1, and a preemption after
        # max_new - 1 tokens resumes with prompt + max_new - 1 tokens, so
        # the worst case is prompt + max_new positions
        need = prompt_len + max_new
        if need > self.cc.cache_len or not self.pool.fits_alone(need):
            return (f"request needs {need} cache positions, exceeding "
                    f"pool capacity ({self.pool.num_pages} pages x "
                    f"{self.pool.page_size} tokens, "
                    f"cache_len={self.cc.cache_len})")
        return None

    def admit_begin(self, slot: int, toks, total: int) -> Optional[int]:
        """Match the prompt against the prefix cache, share the hit, and
        reserve pages through `total` positions.  Returns the number of
        resident prefix tokens (0 = cold admission), or None when the pool
        cannot supply the pages (head-of-line wait).  The match is capped
        page-aligned BELOW len(toks), so at least one position is always
        prefilled for the first token's logits."""
        matched = []
        self._admit_hashes.pop(slot, None)
        if self.prefix_cache and len(toks) > 1:
            ps = self.cc.page_size
            self.prefix_queries += 1
            hashes = page_hashes(np.asarray(toks), ps)
            self._admit_hashes[slot] = hashes
            cap_pages = (len(toks) - 1) // ps
            if cap_pages > 0:
                matched = self.pool.match_prefix(
                    None, hashes=hashes[:cap_pages])
        if matched:
            self.pool.share_prefix(slot, matched)
        if not self.pool.grow(slot, total):
            self.pool.release(slot)
            return None
        if matched:
            self.prefix_hits += 1
            self.prefix_tokens_reused += len(matched) * self.cc.page_size
        return len(matched) * self.cc.page_size

    def register_prefix(self, slot: int, toks):
        """Index the slot's full prompt pages for future sharing."""
        if self.prefix_cache:
            self.pool.register_prefix(slot, np.asarray(toks),
                                      hashes=self._admit_hashes.pop(
                                          slot, None))

    def prefill_suffix(self, params, toks, m: int, slot: int):
        """Prefill toks[m:] into `slot`'s own pages (positions m..s-1)
        through the paged multi-token step, every OTHER row's table masked
        to -1 (their reads are masked and their writes land in the trash
        page).  The suffix is right-padded to a power-of-two bucket (at
        least 8); pad positions' K/V land above s in the slot's reserved
        pages (or the trash page) and are overwritten by decode before they
        become causally visible.  Returns full-vocab logits (1, V) for
        position s-1."""
        toks = np.asarray(toks, np.int64)
        s = toks.shape[0]
        ln = s - m
        assert ln >= 1, (s, m)
        sb = max(8, 1 << (ln - 1).bit_length())
        n = self.cc.max_batch
        tok_arr = np.zeros((n, sb), np.int64)
        tok_arr[slot, :ln] = toks[m:]
        pos = np.zeros(n, np.int64)
        pos[slot] = m
        rows = np.full_like(self.pool.table, -1)
        rows[slot] = self.pool.table[slot]
        lg, self.pcaches = self.engine.verify_paged(
            params, tok_arr, pos, self._table(rows), self.pcaches)
        return lg[slot:slot + 1, ln - 1]

    def ensure(self, slot: int, upto: int) -> bool:
        return self.pool.grow(slot, upto)

    def insert(self, caches1, slot: int):
        self.pcaches = self.engine.insert_paged(
            self.pcaches, caches1, slot, self.pool.table[slot])

    def release(self, slot: int):
        self.pool.release(slot)

    def decode(self, params, cur, pos):
        self._cow(pos, 1)
        nxt, self.pcaches = self.engine.decode_paged(
            params, cur, pos, self._table(), self.pcaches)
        return nxt

    def decode_sampled(self, params, cur, pos, t, k, p, gens):
        self._cow(pos, 1)
        nxt, self.pcaches = self.engine.decode_paged_sampled(
            params, cur, pos, self._table(), self.pcaches, t, k, p, gens)
        return nxt

    def verify(self, params, toks, pos, tree=None):
        self._cow(pos, int(toks.shape[1]))
        lg, self.pcaches = self.engine.verify_paged(
            params, toks, pos, self._table(), self.pcaches, tree=tree)
        return lg

    def copy_pos(self, src, dst):
        """A tree alternative's K/V relocation through the page table; it
        must run before `truncate` frees the pages of the chunk slots.
        The destination page lies in the verify chunk's write region, so
        this round's COW barrier already made it private."""
        self.pcaches = self.engine.copy_pos_paged(
            self.pcaches, self._table(), src, dst,
            page_size=self.cc.page_size)

    def truncate(self, slot: int, n_tokens: int):
        # paged rollback: pages past the committed length drop their
        # reference (the table keeps its valid-prefix / -1-suffix form)
        self.pool.shrink(slot, n_tokens)


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

class Scheduler:
    """Continuous batching over either cache layout (see module doc)."""

    def __init__(self, engine, params, cache: CacheConfig, spec=None,
                 obs=None):
        self.engine = engine
        self.params = params
        self.cache = cache
        self.kv = (PagedKVCacheManager(engine, cache) if cache.paged
                   else DenseKVCacheManager(engine, cache))
        self.max_batch = cache.max_batch
        self.cache_len = cache.cache_len
        self.prefill_chunk = cache.prefill_chunk
        # speculative decoding (a spec.SpecState, or None)
        self.spec = spec
        self.reset()
        # observability: the null recorder makes every hook a no-op
        self.obs = NULL_RECORDER
        if obs is not None:
            self.set_obs(obs)

    def reset(self):
        """Restore the state of a freshly built scheduler on the same
        caches: no queue, slots, completions or request metadata, every
        position, token and counter at zero, the page pool at its
        canonical fresh state (the same free-list order) with an empty
        prefix cache, the drafter's positions and counters at zero.  The
        caches' contents are left: a fresh slot is written before it is
        read, and masked positions are never read.  A cluster replica
        calls it after its warm-up request (cluster/replica.py)."""
        n = self.max_batch
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * n
        self.pos = np.zeros(n, np.int64)
        self.cur = np.zeros((n, 1), np.int64)
        self.admit_seq = np.zeros(n, np.int64)
        self._seq = 0
        self.completed: Dict[int, Request] = {}
        self.n_preemptions = 0
        self.spec_rounds = 0          # verify forwards
        self.spec_row_rounds = 0      # active rows summed over rounds
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_committed = 0       # tokens committed by rounds
        self.spec_alt_commits = 0     # tree rounds committed via an alt
        # per-slot adaptive budget and zero-acceptance streak
        self._spec_kb = np.zeros(n, np.int64)
        self._spec_rej = np.zeros(n, np.int64)
        self._req_meta: Dict[int, dict] = {}   # id(Request) -> times
        kv = self.kv
        if kv.paged:
            kv.pool.reset()
            kv._admit_hashes.clear()
            kv.prefix_queries = kv.prefix_hits = kv.prefix_tokens_reused = 0
        if self.spec is not None:
            dr = self.spec.drafter
            dr.pos[:] = 0
            dr.adoptions = dr.prefills = dr.rounds = 0

    def set_obs(self, obs):
        """Attach (or, with None, detach) a recorder on the scheduler and
        what it drives (page pool, drafter).  Returns the previous one: a
        replica swaps in NULL_RECORDER around its warm-up request."""
        prev = self.obs
        self.obs = obs if obs is not None else NULL_RECORDER
        if self.kv.paged:
            self.kv.pool.obs = self.obs
        if self.spec is not None:
            self.spec.drafter.obs = self.obs
        return prev

    def metrics(self) -> dict:
        """Scheduler stats (always) plus, with a live recorder, the flat
        registry snapshot under "registry"."""
        out = {
            "queue_depth": len(self.queue),
            "active_slots": len(self._active()),
            "completed": len(self.completed),
            "n_preemptions": self.n_preemptions,
            "prefix_queries": self.kv.prefix_queries,
            "prefix_hits": self.kv.prefix_hits,
            "prefix_tokens_reused": self.kv.prefix_tokens_reused,
        }
        if self.kv.paged:
            pool = self.kv.pool
            out["pool_pages_used"] = (pool.num_pages - len(pool.free)
                                      - len(pool.cached))
            out["pool_high_water"] = pool.high_water
        if self.spec is not None:
            out["spec_rounds"] = self.spec_rounds
            out["spec_acceptance"] = self.spec_acceptance
            out["spec_tokens_per_step"] = self.spec_tokens_per_step
            out["spec_alt_commits"] = self.spec_alt_commits
        if self.obs.enabled:
            out["registry"] = self.obs.snapshot()
        return out

    @property
    def pcaches(self):
        return self.kv.pcaches

    @property
    def pool(self) -> PagePool:
        return self.kv.pool

    # ---------------- request lifecycle ----------------

    def submit(self, req: Request):
        """Validate and enqueue."""
        self.validate(req)
        self.note_submit(req)
        self.queue.append(req)

    def note_submit(self, req: Request):
        """Stamp a request's submission time (the queue-wait and TTFT
        base).  `submit` calls it; a caller that enqueues directly (the
        facade validates a batch first) calls it itself.  A request never
        stamped is back-filled at admission with no queue wait."""
        if self.obs.enabled:
            t = self.obs.now()
            meta = self._req_meta.setdefault(
                id(req), {"submit0": t, "first": None})
            meta["submit"] = t
            self.obs.inc("requests_submitted_total")

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
        """Prompt plus already-generated tokens (recompute after preempt)."""
        if not req.out:
            return np.asarray(req.prompt, np.int64)
        return np.concatenate([np.asarray(req.prompt, np.int64),
                               np.asarray(req.out, np.int64)])

    def _prefill(self, toks: np.ndarray, s: int):
        from repro_torch.runtime.forward import bucketed_prefill
        return bucketed_prefill(self.engine, self.params, toks, s,
                                self.cache_len, self.prefill_chunk)

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
            req = self.queue[0]
            toks = self._resume_tokens(req)
            s = len(toks)
            # prefix-cache match + capacity for the prompt and the first
            # decode write at pos s; m = resident prefix tokens (0 = cold)
            m = self.kv.admit_begin(b, toks, s + 1)
            if m is None:
                break          # head-of-line: wait for pages, stay FIFO
            self.queue.popleft()
            if self.obs.enabled:
                t_admit = self.obs.now()
                meta = self._req_meta.setdefault(
                    id(req),
                    {"submit0": t_admit, "submit": t_admit, "first": None})
                wait = t_admit - meta["submit"]
                self.obs.observe("queue_wait_seconds", wait)
                self.obs.complete(f"slot{b}", "queue", meta["submit"],
                                  wait, uid=req.uid)
            try:
                if m:
                    # warm: prefill only the uncached suffix, in place
                    logits = self.kv.prefill_suffix(self.params, toks, m, b)
                else:
                    logits, caches1 = self._prefill(toks, s)
                first = self._first_token(req, logits)
                self.engine.backend.agree([first])
            except BaseException:
                # free the pages admit_begin reserved and requeue
                self.kv.release(b)
                self.queue.appendleft(req)
                raise
            req.out.append(first)
            self.slots[b] = req
            self.pos[b] = s
            self.cur[b, 0] = first
            self.admit_seq[b] = self._seq
            self._seq += 1
            if self.obs.enabled:
                t_first = self.obs.now()
                meta["serve_start"] = t_admit
                self.obs.complete(f"slot{b}", "prefill", t_admit,
                                  t_first - t_admit, uid=req.uid,
                                  tokens=s - m, cached=m)
                if meta["first"] is None:
                    # TTFT once, from the ORIGINAL submit (a re-admission
                    # after preemption does not count again)
                    meta["first"] = t_first
                    self.obs.observe("ttft_seconds",
                                     t_first - meta["submit0"])
                if m:
                    self.obs.inc("prefix_cache_hits_total")
                    self.obs.inc("prefix_tokens_reused_total", m)
            if not m:
                self.kv.insert(caches1, b)
            self.kv.register_prefix(b, toks)
            if self.spec is not None:
                # a cold admission just prefilled this prompt: the
                # drafter restacks that KV onto its own plan instead of
                # prefilling again (a warm one has no dense caches1)
                self._spec_kb[b] = self.spec.k
                self._spec_rej[b] = 0
                self.spec.drafter.insert(b, toks,
                                         caches1=None if m else caches1)
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
        if self.obs.enabled:
            self._observe_finish(b, req)
        self.completed[req.uid] = req
        self.slots[b] = None
        self.pos[b] = 0
        self.kv.release(b)

    def _observe_finish(self, b: int, req: Request):
        """A finished request's counters, acceptance, TPOT and its final
        `serve` slice."""
        t = self.obs.now()
        meta = self._req_meta.pop(id(req), None)
        reason = req.finish_reason or "stop"
        self.obs.inc("requests_finished_total", reason=reason)
        self.obs.inc("tokens_generated_total", len(req.out))
        if req.n_drafted:
            self.obs.metrics.observe(
                "spec_request_acceptance",
                req.n_draft_accepted / req.n_drafted,
                buckets=_ACCEPT_BUCKETS)
        if meta is None:
            return
        if meta.get("first") is not None and len(req.out) > 1:
            # time per output token over the decode tail (the first
            # token is TTFT's)
            self.obs.observe("tpot_seconds",
                             (t - meta["first"]) / (len(req.out) - 1))
        t0 = meta.get("serve_start", t)
        self.obs.complete(f"slot{b}", "serve", t0, t - t0, uid=req.uid,
                          tokens=len(req.out), reason=reason)

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
                self.kv.release(b)
        for r in reqs:
            if self.completed.get(r.uid) is r:
                del self.completed[r.uid]
            self._req_meta.pop(id(r), None)

    def _grow_active(self, active: List[int], upto_fn) -> List[int]:
        """Paged growth with preemption-by-eviction: oldest-admitted
        slots grow first (never starved), `upto_fn(b)` gives each slot's
        target cache position, and a slot may evict itself as the last
        resort.  Returns the surviving active list."""
        for b in sorted(active, key=lambda b: self.admit_seq[b]):
            if self.slots[b] is None:   # preempted by an earlier slot
                continue
            while not self.kv.ensure(b, upto_fn(b)):
                v = self._preempt_one(keep=b)
                if v is None or v == b:
                    break
        return self._active()

    def _preempt_one(self, keep: int) -> Optional[int]:
        """Evict the latest-admitted active slot (other than `keep` when
        possible); its request requeues at the front with output kept."""
        cands = [b for b in range(self.max_batch)
                 if self.slots[b] is not None and b != keep]
        if not cands:
            cands = [keep] if self.slots[keep] is not None else []
        if not cands:
            return None
        v = max(cands, key=lambda b: self.admit_seq[b])
        req = self.slots[v]
        req.n_preempted += 1
        self.kv.release(v)
        self.slots[v] = None
        self.pos[v] = 0
        self.queue.appendleft(req)
        self.n_preemptions += 1
        self.obs.inc("preemptions_total")
        if self.obs.enabled:
            t = self.obs.now()
            self.obs.instant(f"slot{v}", "preempt", uid=req.uid,
                             n_preempted=req.n_preempted)
            meta = self._req_meta.get(id(req))
            if meta is not None:
                t0 = meta.get("serve_start", t)
                self.obs.complete(f"slot{v}", "serve", t0, t - t0,
                                  uid=req.uid, preempted=True)
                meta["submit"] = t       # queue wait restarts at requeue
        return v

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

    # ---------------- speculative decoding ----------------

    @property
    def spec_acceptance(self) -> float:
        """Fraction of drafted tokens the exact model accepted."""
        return self.spec_accepted / max(self.spec_drafted, 1)

    @property
    def spec_tokens_per_step(self) -> float:
        """Committed tokens per request per verify round."""
        return self.spec_committed / max(self.spec_row_rounds, 1)

    def _spec_cap(self, b: int) -> int:
        """Cache positions request b may ever need: the bound its
        admission was validated against."""
        req = self.slots[b]
        return len(np.asarray(req.prompt)) + self._max_new(req)

    def _spec_round_k(self, active: List[int]) -> Dict[int, int]:
        """Each row's draft budget this round: spec.k, or the slot's
        walked budget when adaptive."""
        if self.spec.adaptive:
            return {b: int(self._spec_kb[b]) for b in active}
        return {b: self.spec.k for b in active}

    def _spec_adapt(self, b: int, k_b: int, n_acc: int, used_alt: int):
        """Walk slot b's budget from this round's outcome."""
        if n_acc >= k_b:
            self._spec_kb[b] = min(k_b + 1, self.spec.k_cap)
            self._spec_rej[b] = 0
        elif n_acc == 0 and not used_alt:
            self._spec_rej[b] += 1
            if self._spec_rej[b] >= 2:
                self._spec_kb[b] = max(self.spec.k_min, k_b - 1)
                self._spec_rej[b] = 0
        else:
            self._spec_rej[b] = 0

    def _spec_inputs(self, active: List[int], k: int, chunk: int):
        """The draft's catch-up context, starts, per-row acceptance RNGs,
        tree-alternative eligibility and (any sampled row) the sampled
        draft's arguments."""
        dr = self.spec.drafter
        n = self.max_batch
        width = 1
        for b in active:
            width = max(width, int(self.pos[b]) - int(dr.pos[b]) + 1)
        ctx = np.zeros((n, width), np.int64)
        start = np.zeros(n, np.int64)
        rngs, alt_ok = {}, {}
        w = self.spec.tree_width
        for b in active:
            req = self.slots[b]
            stream = self._resume_tokens(req)
            p = int(self.pos[b])
            start[b] = p - width + 1
            ctx[b] = stream[start[b]: p + 1]
            rngs[b] = spec_rng((req.sampling or _GREEDY).seed, len(req.out))
            # an alternative is usable only when its chunk slot
            # (pos+k+1..pos+C-1) really holds its K/V -- inside the dense
            # slot or the grown pages -- and the row may still commit two
            # tokens; otherwise the row takes chain acceptance (fewer
            # commits never change the greedy stream)
            cap = (self._spec_cap(b) - 1 if self.kv.paged
                   else self.cache_len)
            alt_ok[b] = (w > 1 and p + chunk <= cap
                         and self._max_new(req) - len(req.out) >= 2)
        if all((self.slots[b].sampling or _GREEDY).greedy for b in active):
            return ctx, start, rngs, alt_ok, None
        t = np.zeros(n, np.float32)
        tk = np.zeros(n, np.int64)
        tp_ = np.ones(n, np.float32)
        seeds = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int64)
        for b in active:
            sp = self.slots[b].sampling or _GREEDY
            t[b], tk[b], tp_[b] = sp.temperature, sp.top_k, sp.top_p
            seeds[b] = sp.seed
            counts[b] = len(self.slots[b].out)
        gens = RS.draft_generators(seeds, counts, k, self.engine.device)
        return ctx, start, rngs, alt_ok, (t, tk, tp_, gens)

    def _spec_step(self, active: List[int]) -> bool:
        """One draft / verify-once round for every active slot.

        The round's k is the largest row budget, so the verify width is
        k + tree_width; a row with a smaller budget k_b clamps acceptance
        to its own first k_b drafts.  Its surplus verify positions can
        never be committed: dense writes past the slot are dropped
        (`models.attention.write_chunk`), paged ones land in the trash
        page, and their logits are never read.  Rows whose remaining
        budget is tighter than k_b clamp their commits the same way.

        With tree_width w > 1 the chunk is [cur, d_1..d_k, a_1..a_{w-1}]:
        the draft's first-position runners-up verify as depth-1 branches
        in the same forward, and a row whose first draft is rejected
        still commits two tokens when the target's correction is one of
        them -- after moving that alternative's K/V from its chunk slot
        to the stream position (copy_pos, BEFORE the rollback frees the
        chunk's pages).

        Paged slots must own pages through pos + chunk first (the same
        preemption rule as decode growth), capped at the request's
        validated capacity; after acceptance the rejected suffix rolls
        back (position rewind on dense, `PagePool.shrink` on paged)."""
        w = self.spec.tree_width
        kb = self._spec_round_k(active)
        k = max(kb.values())
        chunk = k + w                 # verify width: cur + chain + alts
        if self.kv.paged:
            active = self._grow_active(
                active, lambda b: min(int(self.pos[b]) + chunk,
                                      self._spec_cap(b) - 1))
            if not active:
                return bool(self.queue)
        dr = self.spec.drafter
        n = self.max_batch
        ctx, start, rngs, alt_ok, sampling = self._spec_inputs(active, k,
                                                               chunk)
        with self.obs.span("spec", "draft", k=k, rows=len(active), tree=w):
            draft_toks, draft_logits, alts = dr.draft(
                ctx, start, k, greedy=sampling is None, tree_width=w,
                sampling=sampling)
        ver = np.concatenate([self.cur, draft_toks], axis=1)   # (n, k+1)
        tree = None
        if w > 1:
            ver = np.concatenate([ver, np.asarray(alts, np.int64)], axis=1)
            tree = tree_layout(k, w)
        # the span ends where the verify's result reaches the host (the
        # read the round makes either way)
        with self.obs.span("spec", "verify", rows=len(active), tree=w):
            lg = self.kv.verify(self.params, ver, self.pos, tree=tree)
            if sampling is None:
                # only the (n, C) argmax ids come to the host
                argmax, logits = lg.argmax(dim=-1).cpu().numpy(), None
            else:
                argmax, logits = None, lg.float().cpu().numpy()
        self.spec_rounds += 1
        relocs, post, seen = [], [], []
        for b in active:
            req = self.slots[b]
            sp = req.sampling or _GREEDY
            k_b = kb[b]
            row_alts = alts[b] if alt_ok[b] else None
            if logits is None:
                committed, n_acc, used_alt = accept_greedy_tree(
                    draft_toks[b][:k_b], row_alts, argmax[b][:k_b + 1],
                    argmax[b][k + 1:])
            else:
                # each draft draw's exact distribution, rebuilt from the
                # returned logits (filtered_probs mirrors sample_core)
                dp = None if sp.greedy else np.stack([
                    filtered_probs(draft_logits[b, i], sp.temperature,
                                   sp.top_k, sp.top_p)
                    for i in range(k_b)])
                committed, n_acc, used_alt = accept_speculative_tree(
                    draft_toks[b][:k_b], dp, logits[b][:k_b + 1],
                    row_alts, logits[b][k + 1:],
                    temperature=sp.temperature, top_k=sp.top_k,
                    top_p=sp.top_p, rng=rngs[b])
            old_pos = int(self.pos[b])
            req.n_drafted += k_b
            req.n_draft_accepted += n_acc
            self.spec_drafted += k_b
            self.spec_accepted += n_acc
            self.spec_row_rounds += 1
            if used_alt:
                self.spec_alt_commits += 1
            if self.obs.enabled:
                self.obs.inc("spec_drafted_total", k_b)
                self.obs.inc("spec_accepted_total", n_acc)
                if used_alt:
                    self.obs.inc("spec_tree_alt_commits_total")
                if self.spec.adaptive:
                    self.obs.gauge("spec_k", k_b, slot=str(b))
                self.obs.metrics.observe("spec_acceptance_ratio",
                                         n_acc / k_b,
                                         buckets=_ACCEPT_BUCKETS)
            if self.spec.adaptive:
                self._spec_adapt(b, k_b, n_acc, used_alt)
            budget = self._max_new(req) - len(req.out)
            done_b = False
            for tok in committed[:budget]:
                seen.append(tok)
                req.out.append(tok)
                self.spec_committed += 1
                self.pos[b] += 1
                self.cur[b, 0] = tok
                if self._stopping(req, tok):
                    done_b = True
                    break
            # a finishing row's slot is released whole: nothing to move
            if used_alt and not done_b:
                relocs.append((b, old_pos + k + used_alt, old_pos + 1))
            post.append((b, done_b, used_alt, old_pos))
        self.engine.backend.agree(seen)
        if relocs:
            src = np.zeros(n, np.int64)
            dst = np.zeros(n, np.int64)
            for b, s_, d_ in relocs:
                src[b], dst[b] = s_, d_
            self.kv.copy_pos(src, dst)
        for b, done_b, used_alt, old_pos in post:
            if done_b:
                self._finish(b)
                continue
            self.kv.truncate(b, int(self.pos[b]))
            if used_alt:
                # the draft cache's old_pos+1 holds the chain draft's
                # K/V, not the alternative's: next round's catch-up
                # context rewrites it
                dr.pos[b] = old_pos + 1
            else:
                # the draft wrote old_pos..old_pos+k-1 for [cur, d_1..
                # d_{k-1}]; the accepted prefix keeps it valid up to the
                # committed end or old_pos + k
                dr.pos[b] = min(int(self.pos[b]), old_pos + k)
        return True

    def step(self) -> bool:
        """Admit, (paged) grow, then one decode step (or, with
        speculation, one draft / verify round) for all active slots.
        Returns False when there is nothing left to do."""
        if not self.obs.enabled:
            return self._step()
        with self.obs.span("scheduler", "step") as s:
            out = self._step()
            act = len(self._active())
            s["active"] = act
            s["queued"] = len(self.queue)
            self.obs.gauge("active_slots", act)
            self.obs.gauge("queue_depth", len(self.queue))
            self.obs.counter_event("scheduler", "active_slots", act)
        return out

    def _step(self) -> bool:
        self._admit()
        active = self._active()
        if self.spec is not None and active:
            return self._spec_step(active)
        if self.kv.paged and active:
            # each slot writes position pos[b] this step: make sure its
            # page exists (preemption rules: _grow_active)
            active = self._grow_active(active,
                                       lambda b: int(self.pos[b]) + 1)
        if not active:
            return bool(self.queue)
        nxt = self._decode_active(active).cpu().numpy()
        self.engine.backend.agree(nxt[active, 0])
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

    def outstanding_tokens(self) -> int:
        """Token-work backlog: a queued request counts its full prefill
        (prompt + kept output) plus its remaining decode budget, an
        active slot its remaining decode budget.  The load signal the
        cluster router's least-outstanding policy balances."""
        n = sum(len(r.prompt) + self._max_new(r) for r in self.queue)
        for b in self._active():
            r = self.slots[b]
            n += self._max_new(r) - len(r.out)
        return n

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        steps = 0
        while self.has_work() and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.completed
