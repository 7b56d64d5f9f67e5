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


def scatter_prefill_pages(pool, dense1, page_row, *, tail: int = 2):
    """Insert one request's prefill cache into its allocated pages.

    pool (..., P+1, ps, *t); dense1 (..., 1, S, *t) with S a multiple of
    ps (the per-slot maximum); `tail` the number of feature axes *t (2
    for K/V's (Hkv, D), 1 for an int8 scale's or an MLA latent's);
    page_row (pages_per_slot,) int.  Pages the slot did not allocate
    (-1) scatter into the trash page, so the right-padded tail never
    touches live pages."""
    pa = pool.dim() - tail - 2                           # the page axis
    pn = pool.shape[pa] - 1
    ps = pool.shape[pa + 1]
    d = dense1.select(pa, 0)                             # (..., S, *t)
    n = d.shape[pa] // ps
    d = d.reshape(tuple(d.shape[:pa]) + (n, ps) + tuple(d.shape[pa + 1:]))
    row = page_row[:n].long()
    phys = torch.where(row < 0, torch.full_like(row, pn), row)
    pool[(slice(None),) * pa + (phys,)] = d.to(pool.dtype)
    return pool


# ---------------------------------------------------------------------------
# The gather -> dense -> scatter fallback (runtime/forward.py): stacks the
# fused paged forward does not cover (int8 KV, MLA, windowed, hybrid, SSM)
# gather each slot's pages into a contiguous view, run the dense step on
# it, and write back the positions the step wrote.  Plain torch, as the
# reference's are XLA code (no TPU kernel).  Pools are whole segment
# leaves (tp, layers, P+1, ps, *t), views (tp, layers, B, n*ps, *t); the
# pools are written in place.
# ---------------------------------------------------------------------------

def _phys(page_table, pidx, trash: int):
    """Physical pages of logical pages pidx (B, m) through the table: -1
    entries, and pages before 0 or past the table width, map to the
    trash page."""
    n = page_table.shape[1]
    phys = torch.gather(page_table.long(), 1, pidx.clamp(0, n - 1))
    return torch.where((phys < 0) | (pidx >= n) | (pidx < 0),
                       torch.full_like(phys, trash), phys)


def gather_pages(pool, page_table):
    """pool (tp, L, P+1, ps, *t); page_table (B, n) int, -1 =
    unallocated.  Returns the contiguous per-slot view (tp, L, B, n*ps,
    *t), a copy.  Entries read through -1 come from the trash page; the
    dense step's position masking hides them."""
    pn = pool.shape[2] - 1
    ps = pool.shape[3]
    b, n = page_table.shape
    table = page_table.long()
    pt = torch.where(table < 0, torch.full_like(table, pn), table)
    g = pool[:, :, pt.reshape(-1)]                 # (tp, L, B*n, ps, *t)
    return g.reshape(tuple(pool.shape[:2]) + (b, n * ps)
                     + tuple(pool.shape[4:]))


def scatter_chunk_pages(pool, dense, page_table, pos, n: int):
    """Write back the `n` tokens a dense step just wrote per slot: the
    entries of the view dense (tp, L, B, S, *t) at sequence indices
    pos[b]..pos[b]+n-1 land in their pages of pool (tp, L, P+1, ps,
    *t), in place.  Positions whose page is unallocated (-1) or past the
    table land in the trash page (only trash writes can collide)."""
    pn = pool.shape[2] - 1
    ps = pool.shape[3]
    b, s = dense.shape[2:4]
    pos2 = pos.long()[:, None] + torch.arange(n, device=pos.device)[None]
    pidx = torch.div(pos2, ps, rounding_mode="floor")
    phys = _phys(page_table, pidx, pn)
    bi = torch.arange(b, device=pos.device)[:, None].expand(b, n)
    toks = dense[:, :, bi, pos2.clamp(0, s - 1)]      # (tp, L, B, n, *t)
    pool[:, :, phys.reshape(-1), (pos2 - pidx * ps).reshape(-1)] = \
        toks.reshape(tuple(dense.shape[:2]) + (b * n,)
                     + tuple(dense.shape[4:])).to(pool.dtype)
    return pool


def scatter_token_page(pool, dense, page_table, pos):
    """Write back the ONE token a decode step just wrote per slot: the
    view's entry at sequence index pos[b] lands in physical page
    page_table[b, pos[b] // ps] at offset pos[b] % ps (the trash page
    when unallocated)."""
    return scatter_chunk_pages(pool, dense, page_table, pos, 1)
