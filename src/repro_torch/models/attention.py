"""Attention math on the heads one shard owns (port of
repro/models/attention.py).  Plain torch, as the reference's is plain
XLA: `attend` is the dense oracle, `attention_any` the prefill path of
attn_backend="xla" and of every sliding-window or hybrid layer,
`decode_attend` the dense decode path over a full buffer or a rolling
window (the reference has no kernel for dense decode, so neither does
the port), and
`paged_attend` the paged path of attn_backend="xla" and of every tree
chunk, `tree_mask` the visibility of a speculative tree chunk, and
`write_chunk` the dense cache write of a chunk (positions past the
buffer dropped, as JAX's scatter drops them), and `kv_quantize` /
`kv_dequantize` the int8 KV cache's per-(position, head) absmax codes.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q (...,Sq,Hq,Dh), k (...,Sk,Hkv,Dh) with Hq % Hkv == 0 ->
    scores (...,Hq,Sq,Sk) in fp32."""
    *lead, sq, hq, dh = q.shape
    hkv = k.shape[-2]
    q = q.reshape(*lead, sq, hkv, hq // hkv, dh)
    s = torch.einsum("...qhgd,...khd->...hgqk", q.float(), k.float())
    return s.reshape(*lead, hq, sq, k.shape[-3])


def _gqa_combine(p, v):
    """p (...,Hq,Sq,Sk) fp32, v (...,Sk,Hkv,Dh) -> (...,Sq,Hq,Dh)."""
    *lead, hq, sq, sk = p.shape
    hkv = v.shape[-2]
    p = p.reshape(*lead, hkv, hq // hkv, sq, sk)
    o = torch.einsum("...hgqk,...khd->...qhgd", p, v.float())
    return o.reshape(*lead, sq, hq, v.shape[-1])


def causal_mask(q_pos, kv_pos, window: int = 0):
    """(..., Sq) x (..., Sk) -> bool (..., Sq, Sk); True = attend.  A
    `window` > 0 keeps the last `window` positions (sliding window)."""
    m = kv_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= kv_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def tree_mask(pos, anc, kv_pos):
    """Visibility of a speculative TREE chunk.  Its C tokens sit in the
    distinct cache slots pos..pos+C-1 but attend by the tree: kv slot m
    is visible to chunk token i iff it holds committed history (m < pos)
    or an in-chunk ancestor of i (anc[i, m - pos], diagonal True).
    pos (B,) chunk starts; anc (C, C) bool; kv_pos (B, Sk) slot indices.
    Returns bool (B, C, Sk); True = attend."""
    c = anc.shape[0]
    rel = kv_pos - pos.long()[:, None]                       # (B, Sk)
    in_chunk = (rel >= 0) & (rel < c)
    within = anc[:, rel.clamp(0, c - 1)].permute(1, 0, 2)    # (B, C, Sk)
    return (rel < 0)[:, None, :] | (in_chunk[:, None, :] & within)


def attend(q, k, v, mask, scale: float | None = None):
    """Dense softmax attention.  q (...,Sq,Hq,Dh), k/v (...,Sk,Hkv,Dh),
    mask bool (...,Sq,Sk) broadcasting against the leading dims (it gets
    the head axis here).  A fully masked row gives 0."""
    dh = q.shape[-1]
    scale = scale if scale is not None else dh ** -0.5
    s = _gqa_scores(q * scale, k)
    mask = mask.unsqueeze(-3)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2).detach())
    p = torch.where(mask, p, torch.zeros_like(p))
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp(denom, min=1e-20)
    return _gqa_combine(p, v).to(q.dtype)


def attend_chunked(q, k, v, q_pos, kv_pos, *, window: int = 0,
                   q_chunk: int = 1024, scale: float | None = None):
    """Query-chunked causal (+ sliding window) attention: O(q_chunk * Sk)
    score memory."""
    outs = []
    for i in range(0, q.shape[-3], q_chunk):
        mask = causal_mask(q_pos[..., i:i + q_chunk], kv_pos, window)
        outs.append(attend(q[..., i:i + q_chunk, :, :], k, v, mask, scale))
    return torch.cat(outs, dim=-3)


def attention_any(q, k, v, q_pos, kv_pos, *, window: int = 0,
                  q_chunk: int = 1024, scale: float | None = None):
    """Dense for short q, query-chunked for long.  q (...,Sq,Hq,Dh),
    positions (B,Sq)/(B,Sk) broadcasting against q's leading dims."""
    if q.shape[-3] > q_chunk:
        return attend_chunked(q, k, v, q_pos, kv_pos, window=window,
                              q_chunk=q_chunk, scale=scale)
    return attend(q, k, v, causal_mask(q_pos, kv_pos, window), scale)


def paged_attend(q, k_pool, v_pool, page_table, pos, *,
                 scale: float | None = None, anc=None):
    """Paged-KV attention, plain path: gather ONLY the table's pages.

    q (..., B, C, Hq, Dh) at absolute positions pos[b]..pos[b]+C-1;
    k_pool / v_pool (..., P+1, ps, Hkv, Dh) are the shared page pools
    (page P the trash page); page_table (B, n) int, -1 = unallocated
    (masked).  Reuses `attend`, so masked lanes contribute exactly 0.
    `anc` (C, C) bool switches the chunk to tree visibility
    (`tree_mask`): speculative tree verification."""
    b, c = q.shape[-4:-2]
    pn1, ps, hkv, dh = k_pool.shape[-4:]
    n = page_table.shape[1]
    table = page_table.long()
    pt = torch.where(table < 0, torch.full_like(table, pn1 - 1), table)
    lead = tuple(k_pool.shape[:-4])
    kg = k_pool[..., pt.reshape(-1), :, :, :].reshape(
        lead + (b, n * ps, hkv, dh))
    vg = v_pool[..., pt.reshape(-1), :, :, :].reshape(
        lead + (b, n * ps, hkv, dh))
    kv_pos = torch.arange(n * ps, device=q.device)[None].expand(b, n * ps)
    if anc is None:
        q_pos = pos.long()[:, None] + torch.arange(c, device=q.device)[None]
        mask = causal_mask(q_pos, kv_pos)
    else:
        mask = tree_mask(pos, anc, kv_pos)
    mask = mask & (table.repeat_interleave(ps, dim=1) >= 0)[:, None, :]
    return attend(q, kg, vg, mask, scale)


def decode_attend(q, k_cache, v_cache, pos, *, window: int = 0,
                  scale: float | None = None):
    """Single-token decode: q (...,B,1,Hq,Dh); caches (...,B,S,Hkv,Dh);
    pos (B,) current absolute position.  A windowed layer's cache is a
    rolling buffer (slot = p % S, S = min(window, buffer)): RoPE was
    applied before the write, so only the filled slots are masked."""
    s = k_cache.shape[-3]
    slots = torch.arange(s, device=q.device)[None, :]
    if window > 0:
        valid = slots < torch.clamp(pos[:, None] + 1, max=s)
    else:
        valid = slots <= pos[:, None]
    return attend(q, k_cache, v_cache, valid[:, None, :], scale)


def cache_update(k_cache, v_cache, k_new, v_new, pos, *, window: int = 0):
    """Write one token's k/v at pos (slot pos % window on a windowed
    layer's rolling buffer): caches (...,B,S,Hkv,Dh), new (...,B,1,Hkv,Dh),
    pos (B,).

    Unlike the reference's functional `.at[].set`, this writes the
    caches IN PLACE (they are the serving buffers) and returns them."""
    slot = pos % window if window > 0 else pos
    bi = torch.arange(pos.shape[0], device=k_cache.device)
    k_cache[..., bi, slot, :, :] = k_new.select(-3, 0)
    v_cache[..., bi, slot, :, :] = v_new.select(-3, 0)
    return k_cache, v_cache


def write_chunk(cache, vals, wpos):
    """Write a chunk of C tokens per row into a dense cache, in place.

    cache (..., B, S, H, D); vals (..., B, C, H, D) for slots wpos (B, C),
    contiguous in each row (wpos[b, j] = wpos[b, 0] + j).  The reference
    writes with `.at[].set`, whose scatter DROPS slots past S (a
    speculative row near the end of its slot verifies positions it can
    never commit); an index past S is an error here, so those writes
    are masked without a host sync: each row's out-of-range entries
    repeat its last in-range entry (same slot, same value, so the
    duplicate writes agree), and a row wholly past S rewrites slot S-1
    with what it holds."""
    s = cache.shape[-3]
    b, c = vals.shape[-4:-2]
    start = wpos[:, 0].long()
    lim = s - 1 - start                          # last in-range chunk index
    j = torch.arange(c, device=cache.device)
    j_eff = torch.minimum(j[None], lim.clamp(min=0)[:, None])     # (B, C)
    tgt = (start[:, None] + j_eff).clamp(max=s - 1)
    bi = torch.arange(b, device=cache.device)[:, None].expand(b, c)
    src = vals[..., bi, j_eff, :, :].to(cache.dtype)
    gone = (lim < 0)[:, None, None, None]
    src = torch.where(gone, cache[..., bi, tgt, :, :], src)
    cache[..., bi, tgt, :, :] = src
    return cache


# ---------------------------------------------------------------------------
# Int8 KV cache: per-(position, head) absmax scales halve the cache bytes
# ---------------------------------------------------------------------------

def kv_quantize(x):
    """x (..., Dh) -> (int8 codes (..., Dh), scale (...,) bf16): the codes
    round x / s with the fp32 scale, half to even, then clip; the bf16
    scale is what dequantization reads.  127 divides as a tensor: on the
    card, PyTorch divides by a Python scalar through its reciprocal,
    which is not the reference's true division (ROADMAP P1)."""
    x32 = x.float()
    lv = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    s = torch.clamp(x32.abs().amax(-1), min=1e-12) / lv
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def kv_dequantize(q, scale, dtype):
    """int8 codes (..., Dh) and scales (...,) -> (..., Dh) in `dtype`,
    through fp32."""
    return (q.float() * scale.float()[..., None]).to(dtype)
