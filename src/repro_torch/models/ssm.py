"""Mamba2 SSD (state-space duality): shard-local math (port of
repro/models/ssm.py).

Chunked quadratic-dual form (arXiv:2405.21060): within a chunk the
output is an attention-like masked contraction; across chunks a small
recurrent state (H, P, N) is carried.  These are the plain versions;
kernels/ssd_scan.py holds the hand-written CUDA kernel of the chunked
scan, which the model's prefill launches on the card.

Shapes (shard-local):
  x  (B, S, H, P)   per-head inputs          H = local heads, P = head_dim
  dt (B, S, H)      softplus-activated step sizes
  A  (H,) or (B, H) negative decay rates (per batch row when the shard
                    axis is folded into B: each shard has its own heads)
  Bm (B, S, G, N)   input projections        G = groups (shared across heads)
  Cm (B, S, G, N)   output projections
  D  (H,) or (B, H) skip connection

Computation is fp32 inside; outputs come back in x's dtype, states in
fp32, as in the reference.
"""
from __future__ import annotations

import torch


def segsum(a):
    """log-decay segment sums: a (..., Q) -> L (..., Q, Q) with
    L[i,j] = sum_{k=j+1..i} a[k] for i>=j, -inf otherwise."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def _group_expand(m, h):
    """(B,S,G,N) -> (B,S,H,N) by repeating each group over its heads."""
    return m.repeat_interleave(h // m.shape[2], dim=2)


def _per_head(v):
    """(H,) or (B, H) -> fp32 (1 or B, H)."""
    v = v.float()
    return v[None] if v.dim() == 1 else v


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int, initial_state=None):
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).
    S must be a multiple of `chunk`."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    f32 = torch.float32
    xd = x.to(f32)
    dt = dt.to(f32)
    Bh = _group_expand(Bm.to(f32), h)            # (B,S,H,N)
    Ch = _group_expand(Cm.to(f32), h)
    dA = dt * _per_head(A)[:, None, :]           # (B,S,H) log-decay per step

    def chunks(t):                               # (nc, B, Q, ...)
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:])).transpose(0, 1)

    xc, dtc, Bc, Cc, dAc = map(chunks, (xd, dt, Bh, Ch, dA))
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    ys = []
    for xq, dtq, bq, cq, daq in zip(xc, dtc, Bc, Cc, dAc):
        csum = torch.cumsum(daq, dim=1)                          # (B,Q,H)
        # intra-chunk (quadratic dual form)
        L = torch.exp(segsum(daq.transpose(1, 2)))               # (B,H,Q,Q)
        scores = torch.einsum("bqhn,bkhn->bhqk", cq, bq) * L
        y_intra = torch.einsum("bhqk,bkh,bkhp->bqhp", scores, dtq, xq)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", cq, state,
                               torch.exp(csum))
        # state update
        total = csum[:, -1]                                      # (B,H)
        decay_out = torch.exp(total[:, None] - csum)             # (B,Q,H)
        upd = torch.einsum("bqh,bqh,bqhp,bqhn->bhpn", decay_out, dtq, xq, bq)
        state = torch.exp(total)[..., None, None] * state + upd
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    y = y + xd * _per_head(D)[:, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A, Bm, Cm, D, state):
    """One-token recurrence. x (B,1,H,P), state (B,H,P,N) ->
    (y (B,1,H,P) in x's dtype, new_state fp32)."""
    h = x.shape[2]
    f32 = torch.float32
    xd = x[:, 0].to(f32)                          # (B,H,P)
    dt0 = dt[:, 0].to(f32)                        # (B,H)
    Bh = _group_expand(Bm.to(f32), h)[:, 0]       # (B,H,N)
    Ch = _group_expand(Cm.to(f32), h)[:, 0]
    decay = torch.exp(dt0 * _per_head(A))         # (B,H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt0, xd, Bh)
    state = decay[..., None, None] * state.to(f32) + upd
    y = (torch.einsum("bhpn,bhn->bhp", state, Ch)
         + xd * _per_head(D)[:, :, None])
    return y[:, None].to(x.dtype), state


def ssd_reference(x, dt, A, Bm, Cm, D, initial_state=None):
    """O(S) sequential oracle (tests only: it validates the chunked form
    and the kernel's plain version)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(x[:, t:t + 1], dt[:, t:t + 1], A,
                                   Bm[:, t:t + 1], Cm[:, t:t + 1], D, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def causal_conv(x, w, state=None):
    """Depthwise causal conv.  x (..., S, C), w (..., K, C), broadcast
    over the leading axes.  Whole-sequence mode zero-pads the left edge;
    with `state` (..., K-1, C) it streams.  Returns (y in x's dtype, the
    last K-1 inputs: the next call's state)."""
    k, s = w.shape[-2], x.shape[-2]
    pad = x.new_zeros(tuple(x.shape[:-2]) + (k - 1, x.shape[-1])) \
        if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)                  # (..., S+K-1, C)
    xf, wf = xp.float(), w.float()
    y = xf[..., 0:s, :] * wf[..., 0:1, :]
    for j in range(1, k):
        y = y + xf[..., j:j + s, :] * wf[..., j:j + 1, :]
    return y.to(x.dtype), xp[..., xp.shape[-2] - (k - 1):, :]
