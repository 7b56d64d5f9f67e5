"""Layout plumbing around the kernels (port of repro/kernels/ops.py)."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_norm as FN
from repro_torch.kernels import ssd_scan as SSD


def flash_attention(q, k, v, *, sm_scale=None):
    """q (B,S,Hq,D); k/v (B,S,Hkv,D) -> (B,S,Hq,D), causal.

    Packs to heads-major (B*H, S, D) so the kernel's GQA map (kv row =
    q row // group) holds: q row b*Hq + h reads kv row (b*Hq + h) // g =
    b*Hkv + h // g only because Hq = g * Hkv.  Under the shard-stacked
    layout the shard axis is folded into B, so the same holds per shard
    with the shard-local head counts.  No padding: the kernel masks the
    ragged S edge itself."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}: "
                         "the row // group mapping would cross sequences")
    qp = q.transpose(1, 2).reshape(b * hq, s, d).contiguous()
    kp = k.transpose(1, 2).reshape(b * hkv, k.shape[1], d).contiguous()
    vp = v.transpose(1, 2).reshape(b * hkv, v.shape[1], d).contiguous()
    out = FA.flash_attention_bhsd(qp, kp, vp, sm_scale=sm_scale)
    return out.reshape(b, hq, s, d).transpose(1, 2)


def fused_residual_rmsnorm(x, r, w, *, eps: float = 1e-5):
    """x, r (..., d) -> (rmsnorm(x+r)*w, x+r).  The kernel takes any row
    count, so unlike the reference no padding to `block_rows` is needed."""
    shape, d = x.shape, x.shape[-1]
    y, s = FN.fused_residual_rmsnorm(x.reshape(-1, d).contiguous(),
                                     r.reshape(-1, d).contiguous(),
                                     w.contiguous(), eps=eps)
    return y.reshape(shape), s.reshape(shape)


def ssd_scan(x, dt, a, bm, cm, dd, *, chunk: int):
    """Batched heads: x (B,S,H,P), dt (B,S,H), a and dd (H,) or (B,H),
    bm/cm (B,S,G,N) with H % G == 0 -> (y (B,S,H,P) in x's dtype, final
    state (B,H,P,N) fp32).

    The kernel reads the streams in this layout and B/C by group, so
    unlike the reference nothing is transposed, broadcast or padded: the
    ragged S edge is masked in the kernel.  Only the per-head vectors
    become per-stream fp32 (B, H)."""
    b, s, h, _ = x.shape

    def per_stream(v):
        return v.float().expand(b, h).contiguous()

    return SSD.ssd_scan(x.contiguous(), dt.float().contiguous(),
                        per_stream(a), bm, cm, per_stream(dd), chunk=chunk)


# ---------------------------------------------------------------------------
# Paged KV cache (runtime/paging.py holds the allocator).  Every paged leaf
# is a pool (..., P+1, ps, Hkv, D) where page P is the TRASH page absorbing
# writes for unallocated (-1) table entries; the leading axes (the shard
# axis, and the layer axis of a segment leaf) ride along.  The scatters
# write IN PLACE into the pool they are given -- a view of the serving
# leaf -- as `models.attention.cache_update` does, and return it.
# ---------------------------------------------------------------------------

def paged_attention(q, k_pool, v_pool, page_table, pos, *, sm_scale=None):
    """Paged flash attention (the hand-written kernel on the card; see
    kernels/flash_attention.paged_flash_attention for the layout).
    q ([tp,] B, C, Hq, D); pools ([tp,] P+1, ps, Hkv, D); page_table
    (B, n) int, -1 = unallocated; pos (B,) chunk starts."""
    return FA.paged_flash_attention(q.contiguous(), k_pool, v_pool,
                                    page_table, pos, sm_scale=sm_scale)


def scatter_tokens_pages(pool, vals, page_table, pos):
    """Write a chunk of C tokens per slot straight into its pages.

    pool (..., P+1, ps, Hkv, D) is one layer's page pool; vals (..., B,
    C, Hkv, D) are the new entries for logical positions pos[b]..pos[b]+
    C-1 of slot b.  Positions whose table entry is -1, that fall past the
    table width, or before position 0, land in the trash page (distinct
    live positions never collide; only trash writes overlap)."""
    pn = pool.shape[-4] - 1
    ps = pool.shape[-3]
    b, c = vals.shape[-4:-2]
    n = page_table.shape[1]
    pos2 = pos.long()[:, None] + torch.arange(c, device=pos.device)[None]
    pidx = torch.div(pos2, ps, rounding_mode="floor")
    table = page_table.long()
    phys = torch.gather(table, 1, pidx.clamp(0, n - 1))
    phys = torch.where((phys < 0) | (pidx >= n) | (pidx < 0),
                       torch.full_like(phys, pn), phys)
    off = pos2 - pidx * ps
    lead = tuple(vals.shape[:-4])
    pool[..., phys.reshape(-1), off.reshape(-1), :, :] = vals.reshape(
        lead + (b * c,) + tuple(vals.shape[-2:])).to(pool.dtype)
    return pool


def scatter_prefill_pages(pool, dense1, page_row):
    """Insert one request's prefill cache into its allocated pages.

    pool (..., P+1, ps, Hkv, D); dense1 (..., 1, S, Hkv, D) with S a
    multiple of ps (the per-slot maximum); page_row (pages_per_slot,)
    int.  Pages the slot did not allocate (-1) scatter into the trash
    page, so the right-padded tail never touches live pages."""
    pn = pool.shape[-4] - 1
    ps = pool.shape[-3]
    d = dense1.select(-4, 0)                             # (..., S, Hkv, D)
    n = d.shape[-3] // ps
    d = d.reshape(tuple(d.shape[:-3]) + (n, ps) + tuple(d.shape[-2:]))
    row = page_row[:n].long()
    phys = torch.where(row < 0, torch.full_like(row, pn), row)
    pool[..., phys, :, :, :] = d.to(pool.dtype)
    return pool
