"""Paged KV-cache bookkeeping: a block-pool allocator with per-slot page
tables, copy-on-write page sharing, and a hash-keyed prefix cache (port
of repro/runtime/paging.py; host-side numpy, kept operation for
operation so the same sequence of calls gives the same tables).

Layout contract (the shard-stacked `(tp, layer, ...)` cache layout, so
SPD-dropped blocks keep their divergent per-shard caches):

    dense leaf   (tp, layer, batch,     seq,       HkvL, dh)
    paged pool   (tp, layer, pages + 1, page_size, HkvL, dh)

The extra physical page at index `num_pages` is the TRASH page: reads
through unallocated table entries (-1) are masked, and scatters for
inactive slots land in it harmlessly.

Sharing model: every physical page carries a refcount; FULL pages whose
token content is known are registered in a prefix index keyed by a
chain digest over the whole token prefix; released registered pages
move to a cached LRU (evicted only when the free list runs dry);
admission shares a prompt's resident prefix pages read-only and
prefills only the suffix; a write to a shared page copies it first
(`ensure_writable` returns the (src, dst) pair for the device copy).

Observability: the pool carries the recorder the scheduler wires in
(`obs`, the null recorder by default) and counts prefix-cache evictions,
shared pages and copy-on-write copies, and mirrors the referenced pages
as the `pool_pages_used` gauge, at the reference's places.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.recorder import NULL_RECORDER


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens cache entries."""
    return -(-max(n_tokens, 0) // page_size)


# splitmix64 finalizer constants + stream/lane constants for the
# vectorized prefix digests (two 64-bit lanes -> 16-byte digests)
_SM1 = np.uint64(0xBF58476D1CE4E5B9)
_SM2 = np.uint64(0x94D049BB133111EB)
_K1 = np.uint64(0x9E3779B97F4A7C15)
_K2 = np.uint64(0xC2B2AE3D27D4EB4F)
_SEED = np.uint64(0x243F6A8885A308D3)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (wrapping mul), on a
    copy."""
    x = np.array(x, dtype=np.uint64, copy=True)
    tmp = x >> np.uint64(30)
    x ^= tmp
    x *= _SM1
    np.right_shift(x, np.uint64(27), out=tmp)
    x ^= tmp
    x *= _SM2
    np.right_shift(x, np.uint64(31), out=tmp)
    x ^= tmp
    return x


# cached per-position weight lanes for page_hashes, grown geometrically
_WLANES: List[np.ndarray] = [np.empty(0, np.uint64), np.empty(0, np.uint64)]


def _weights(size: int) -> tuple:
    if _WLANES[0].size < size:
        grow = max(size, 2 * _WLANES[0].size, 4096)
        idx = np.arange(1, grow + 1, dtype=np.uint64)
        for lane, k in enumerate((_K1, _K2)):
            w = _mix64(idx * k + _SEED)
            np.bitwise_or(w, np.uint64(1), out=w)   # odd: see page_hashes
            _WLANES[lane] = w
    return _WLANES[0][:size], _WLANES[1][:size]


def page_hashes(tokens, page_size: int) -> List[bytes]:
    """16-byte prefix digests of every FULL page of `tokens`, in one
    vectorized pass: digest j covers tokens[: (j+1)*page_size].

    Each absolute position carries two pseudorandom ODD uint64 weights;
    per-page lane sums of token*weight are cumulated and re-finalized
    with the prefix length.  Odd weights make any single-token change
    move the covering digest; an accidental multi-token cancellation
    must zero two independent lanes (~2^-128).  Partial trailing pages
    are never hashed."""
    toks = np.asarray(tokens).astype(np.uint64, copy=False)
    n = toks.shape[0] // page_size
    if n <= 0:
        return []
    t = toks[: n * page_size]
    w1, w2 = _weights(t.size)
    ends = np.arange(1, n + 1, dtype=np.uint64) * np.uint64(page_size)
    s1 = np.cumsum((t * w1).reshape(n, page_size).sum(1, dtype=np.uint64),
                   dtype=np.uint64)
    s2 = np.cumsum((t * w2).reshape(n, page_size).sum(1, dtype=np.uint64),
                   dtype=np.uint64)
    d1 = _mix64(s1 ^ (ends * _K1))
    d2 = _mix64(s2 ^ (ends * _K2))
    raw = np.ascontiguousarray(
        np.stack([d1, d2], axis=1).astype("<u8")).tobytes()
    return [raw[16 * j: 16 * (j + 1)] for j in range(n)]


def page_hashes_chain(tokens, page_size: int) -> List[bytes]:
    """blake2b-128 chain digests (link j hashes link j-1's digest plus
    page j's token bytes): the equality-semantics oracle of
    `page_hashes`."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int64))
    n = toks.shape[0] // page_size
    if n <= 0:
        return []
    stride = page_size * toks.itemsize
    buf = memoryview(toks.tobytes())
    out: List[bytes] = []
    h = b""
    for j in range(n):
        d = hashlib.blake2b(h, digest_size=16)
        d.update(buf[j * stride:(j + 1) * stride])
        h = d.digest()
        out.append(h)
    return out


@dataclass
class PagePool:
    """Fixed-size page allocator: per-slot page tables, per-page
    refcounts, and a prefix cache over released pages.

    Invariants (asserted by `check`):
      * every physical page is in exactly ONE of: the free list, the
        cached LRU, or referenced by table rows (refs >= 1);
      * `refs[p]` equals the number of table entries mapping to p;
      * a slot's table row is a prefix of valid pages followed by -1s;
      * `page_hash` and `prefix_index` are inverse bijections; every
        cached page is registered.
    """
    num_pages: int
    page_size: int
    max_slots: int
    pages_per_slot: int

    # plain class attributes (not dataclass fields): the recorder the
    # scheduler wires in (the null recorder makes every hook a no-op) and
    # the pages referenced at peak
    obs = NULL_RECORDER
    high_water = 0

    def __post_init__(self):
        assert self.num_pages > 0 and self.page_size > 0
        self.reset()

    # ---------------- queries ----------------

    @property
    def num_free(self) -> int:
        """Pages allocatable right now: truly free + evictable cached."""
        return len(self.free) + len(self.cached)

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def fits_alone(self, n_tokens: int) -> bool:
        """Whether a request of n_tokens could ever run (even with the
        whole pool to itself)."""
        need = self.pages_for(n_tokens)
        return need <= min(self.num_pages, self.pages_per_slot)

    # ---------------- internal page lifecycle ----------------

    def _alloc_page(self) -> int:
        """Take one page: prefer the free list, evict the least-recently
        released cached page (deregistering its digest) when empty."""
        if self.free:
            return self.free.pop()
        p, _ = self.cached.popitem(last=False)
        self._deregister(p)
        self.obs.inc("prefix_cache_evictions_total")
        return p

    def _unref(self, p: int):
        self.refs[p] -= 1
        assert self.refs[p] >= 0, (p, self.refs[p])
        if self.refs[p] == 0:
            if p in self.page_hash:
                self.cached[p] = None          # retained for prefix hits
                self.cached.move_to_end(p)
            else:
                self.free.append(p)

    def _deregister(self, p: int):
        h = self.page_hash.pop(p, None)
        if h is not None:
            del self.prefix_index[h]

    # ---------------- mutation ----------------

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Grow `slot`'s allocation to cover n_tokens cache positions.
        All-or-nothing: returns False (allocating nothing) when free +
        evictable-cached pages cannot supply every page needed."""
        target = self.pages_for(n_tokens)
        if target > self.pages_per_slot:
            return False
        have = int(self.owned[slot])
        need = target - have
        if need <= 0:
            return True
        if need > self.num_free:
            return False
        for i in range(have, target):
            p = self._alloc_page()
            self.table[slot, i] = p
            self.refs[p] += 1
        self.owned[slot] = target
        self._note_occupancy()
        return True

    def shrink(self, slot: int, n_tokens: int) -> int:
        """Truncate `slot`'s allocation to cover only n_tokens cache
        positions, dropping one reference per suffix page (back to free,
        or to the cached LRU when registered).  Returns the number of
        table entries cleared."""
        target = self.pages_for(n_tokens)
        have = int(self.owned[slot])
        if target >= have:
            return 0
        for i in range(have - 1, target - 1, -1):
            self._unref(int(self.table[slot, i]))
            self.table[slot, i] = -1
        self.owned[slot] = target
        return have - target

    def release(self, slot: int) -> int:
        """Drop every reference `slot` holds; returns the count dropped."""
        n = int(self.owned[slot])
        for i in range(n):
            self._unref(int(self.table[slot, i]))
        self.table[slot, :] = -1
        self.owned[slot] = 0
        return n

    def reset(self):
        """Restore the canonical fresh-pool state (identical to a newly
        constructed pool, whatever release order preceded it)."""
        self.table = np.full((self.max_slots, self.pages_per_slot), -1,
                             np.int32)
        self.owned = np.zeros(self.max_slots, np.int64)   # row lengths
        self.refs = np.zeros(self.num_pages, np.int64)
        # LIFO free list: page 0 is popped first
        self.free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self.cached: "OrderedDict[int, None]" = OrderedDict()
        self.page_hash: Dict[int, bytes] = {}
        self.prefix_index: Dict[bytes, int] = {}
        self.high_water = 0

    def _note_occupancy(self):
        """Track peak referenced pages; mirror the live value as a gauge
        (a no-op under the null recorder)."""
        used = self.num_pages - len(self.free) - len(self.cached)
        if used > self.high_water:
            self.high_water = used
        self.obs.gauge("pool_pages_used", used)

    # ---------------- prefix cache ----------------

    def match_prefix(self, tokens, hashes: Optional[List[bytes]] = None
                     ) -> List[int]:
        """Longest run of resident physical pages whose chain digests
        match `tokens`' full pages (the caller caps the token count so at
        least one position is left to prefill).  `hashes` short-circuits
        the digest computation with a precomputed `page_hashes`."""
        if hashes is None:
            hashes = page_hashes(tokens, self.page_size)
        out: List[int] = []
        for h in hashes:
            p = self.prefix_index.get(h)
            if p is None:
                break
            out.append(p)
        return out

    def share_prefix(self, slot: int, pages: List[int]):
        """Map `pages` (a match_prefix result) read-only into the empty
        `slot`'s table prefix, taking one reference each."""
        assert int(self.owned[slot]) == 0, (slot, self.owned[slot])
        assert len(pages) <= self.pages_per_slot
        for i, p in enumerate(pages):
            assert p in self.page_hash, p   # only registered pages shared
            self.cached.pop(p, None)        # resident again, not evictable
            self.table[slot, i] = p
            self.refs[p] += 1
        self.owned[slot] = len(pages)
        if pages:
            self.obs.inc("pages_shared_total", len(pages))
            self._note_occupancy()

    def register_prefix(self, slot: int, tokens,
                        hashes: Optional[List[bytes]] = None):
        """Register `slot`'s full pages (content = `tokens`) in the
        prefix index.  Pages whose digest is already indexed (including
        this slot's own shared pages) are skipped, keeping page_hash and
        prefix_index bijective."""
        if hashes is None:
            hashes = page_hashes(tokens, self.page_size)
        n = min(len(hashes), int(self.owned[slot]))
        for j in range(n):
            p = int(self.table[slot, j])
            h = hashes[j]
            if self.page_hash.get(p) == h or h in self.prefix_index:
                continue
            self._deregister(p)             # stale digest, if any
            self.page_hash[p] = h
            self.prefix_index[h] = p

    def ensure_writable(self, slot: int,
                        page_idx: int) -> Optional[Tuple[int, int]]:
        """Prepare logical page `page_idx` of `slot` for a write.

        Shared page (refs > 1): allocate a private copy, rewire the
        slot's table, and return (src, dst); the caller copies the page
        content on the device before writing.  Privately owned but
        registered page: deregister it (its content is about to change)
        and return None.  Already private: None."""
        p = int(self.table[slot, page_idx])
        assert p >= 0, (slot, page_idx)
        if self.refs[p] > 1:
            if self.num_free == 0:
                raise RuntimeError("COW copy needs a page but pool is full")
            dst = self._alloc_page()
            self.refs[p] -= 1
            self.table[slot, page_idx] = dst
            self.refs[dst] += 1
            self.obs.inc("cow_copies_total")
            return p, dst
        self._deregister(p)
        return None

    # ---------------- invariants ----------------

    def check(self):
        free_set = set(self.free)
        assert len(free_set) == len(self.free), "free list has duplicates"
        cached_set = set(self.cached)
        assert not (free_set & cached_set), "page both free and cached"
        ref_count = np.zeros(self.num_pages, np.int64)
        for s in range(self.max_slots):
            n = int(self.owned[s])
            row = self.table[s]
            assert (row[:n] >= 0).all() and (row[n:] == -1).all(), \
                (s, row, n)
            for p in row[:n]:
                p = int(p)
                assert 0 <= p < self.num_pages, (s, p)
                ref_count[p] += 1
        assert (ref_count == self.refs).all(), "refcount drift"
        for p in range(self.num_pages):
            states = (p in free_set) + (p in cached_set) + (ref_count[p] > 0)
            assert states == 1, f"page {p} in {states} states"
        assert len(free_set) + len(cached_set) + int((ref_count > 0).sum()) \
            == self.num_pages
        assert set(self.cached) <= set(self.page_hash), \
            "cached page not registered"
        assert len(self.page_hash) == len(self.prefix_index)
        for p, h in self.page_hash.items():
            assert self.prefix_index.get(h) == p, (p, h)
            assert 0 <= p < self.num_pages
