"""Attention math on the heads one shard owns (port of
repro/models/attention.py).  Plain torch, as the reference's is plain
XLA: `attend` is the dense oracle, `attention_any` the prefill path of
attn_backend="xla", `decode_attend` the dense decode path (the reference
has no kernel for dense decode, so neither does the port), and
`paged_attend` the paged path of attn_backend="xla".
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


def causal_mask(q_pos, kv_pos):
    """(..., Sq) x (..., Sk) -> bool (..., Sq, Sk); True = attend.  (The
    reference's sliding-window option waits for a windowed config.)"""
    return kv_pos[..., None, :] <= q_pos[..., :, None]


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


def attend_chunked(q, k, v, q_pos, kv_pos, *, q_chunk: int = 1024,
                   scale: float | None = None):
    """Query-chunked causal attention: O(q_chunk * Sk) score memory."""
    outs = []
    for i in range(0, q.shape[-3], q_chunk):
        mask = causal_mask(q_pos[..., i:i + q_chunk], kv_pos)
        outs.append(attend(q[..., i:i + q_chunk, :, :], k, v, mask, scale))
    return torch.cat(outs, dim=-3)


def attention_any(q, k, v, q_pos, kv_pos, *, q_chunk: int = 1024,
                  scale: float | None = None):
    """Dense for short q, query-chunked for long.  q (...,Sq,Hq,Dh),
    positions (B,Sq)/(B,Sk) broadcasting against q's leading dims."""
    if q.shape[-3] > q_chunk:
        return attend_chunked(q, k, v, q_pos, kv_pos, q_chunk=q_chunk,
                              scale=scale)
    return attend(q, k, v, causal_mask(q_pos, kv_pos), scale)


def paged_attend(q, k_pool, v_pool, page_table, pos, *,
                 scale: float | None = None, anc=None):
    """Paged-KV attention, plain path: gather ONLY the table's pages.

    q (..., B, C, Hq, Dh) at absolute positions pos[b]..pos[b]+C-1;
    k_pool / v_pool (..., P+1, ps, Hkv, Dh) are the shared page pools
    (page P the trash page); page_table (B, n) int, -1 = unallocated
    (masked).  Reuses `attend`, so masked lanes contribute exactly 0.
    Tree visibility (`anc`) comes with speculative verify, ROADMAP A10."""
    if anc is not None:
        raise NotImplementedError("tree verify (anc) is not ported yet "
                                  "(ROADMAP A10)")
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
    q_pos = pos.long()[:, None] + torch.arange(c, device=q.device)[None]
    mask = causal_mask(q_pos, kv_pos)
    mask = mask & (table.repeat_interleave(ps, dim=1) >= 0)[:, None, :]
    return attend(q, kg, vg, mask, scale)


def decode_attend(q, k_cache, v_cache, pos, *, scale: float | None = None):
    """Single-token decode: q (...,B,1,Hq,Dh); caches (...,B,S,Hkv,Dh);
    pos (B,) current absolute position."""
    slots = torch.arange(k_cache.shape[-3], device=q.device)[None, :]
    valid = slots <= pos[:, None]
    return attend(q, k_cache, v_cache, valid[:, None, :], scale)


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Write one token's k/v at pos: caches (...,B,S,Hkv,Dh), new
    (...,B,1,Hkv,Dh), pos (B,).

    Unlike the reference's functional `.at[].set`, this writes the
    caches IN PLACE (they are the serving buffers) and returns them."""
    bi = torch.arange(pos.shape[0], device=k_cache.device)
    k_cache[..., bi, pos, :, :] = k_new.select(-3, 0)
    v_cache[..., bi, pos, :, :] = v_new.select(-3, 0)
    return k_cache, v_cache
