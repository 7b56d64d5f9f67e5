"""Mixture-of-experts FFN, shard-local math with the experts split over
the TP shards (port of repro/models/moe.py).

Activations entering the block are replicated over the shards, so there
is no all-to-all: every shard routes all tokens, runs its LOCAL experts
on the tokens routed to them (capacity-bounded gather dispatch), and the
weighted combine rides the block's single output sync, which is the
sync SPD's deferred attention residual is added to.

Every function takes any leading axes (the port's shard axis among
them): h (..., T, d), router (..., d, E_pad), expert weights wg/wu
(..., E_l, d, ff) and wd (..., E_l, ff, d), E_l = E_pad / tp.  The
padding experts' router columns are masked to -inf, so they route
nothing.  Plain PyTorch, as the reference's is plain XLA: the expert
products are batched matmuls outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn


def route(h, w_router, top_k: int, n_routed: int):
    """Top-k routing in fp32: h (..., T, d), w_router (..., d, E_pad) ->
    gates (..., T, k) fp32, expert ids (..., T, k) in the padded global
    numbering, and the switch-style load-balance loss aux (...,)."""
    logits = torch.matmul(h.float(), w_router.float())        # (..., T, E)
    e_pad = logits.shape[-1]
    if e_pad > n_routed:
        pad = torch.arange(e_pad, device=h.device) >= n_routed
        logits = logits.masked_fill(pad, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # aux = E * sum_e f_e * P_e over the real experts
    t = h.shape[-2]
    f_e = F.one_hot(idx, e_pad).float().sum((-3, -2)) / (t * top_k)
    aux = n_routed * (f_e * probs.mean(-2)).sum(-1)
    return gates, idx, aux


def dispatch_local(idx, e_lo, e_l: int, capacity: int):
    """Gather and scatter plans for one shard's experts [e_lo, e_lo+e_l).

    idx (..., T, k); `e_lo` an int or a tensor over the leading
    axes (each shard's offset).  Assignments queue at their expert in
    row-major (token, k) order; past `capacity` they are dropped.
    Returns slot_token (..., E_l, C): the token feeding each expert slot
    (T = none, a zero row), and tok_slot (..., T, k): each assignment's
    flat slot e_l * C + c, or -1 (not local, or over capacity)."""
    t, k = idx.shape[-2:]
    lead = tuple(idx.shape[:-2])
    e_lo = torch.as_tensor(e_lo, device=idx.device)
    e_lo = e_lo.reshape(tuple(e_lo.shape) + (1, 1))       # over (T, k)
    local = (idx >= e_lo) & (idx < e_lo + e_l)
    lid = torch.where(local, idx - e_lo, torch.zeros_like(idx))
    flat = (F.one_hot(lid, e_l) * local[..., None]).reshape(
        lead + (t * k, e_l))
    # queue positions: an exclusive running count down the assignments,
    # scanned along the last axis (a scan down an outer axis of few
    # columns is a slow kernel on the card)
    before = flat.transpose(-1, -2).cumsum(-1).transpose(-1, -2) - flat
    pos = (before * flat).sum(-1).reshape(lead + (t, k))
    ok = local & (pos < capacity)
    slot = torch.where(ok, lid * capacity + pos,
                       torch.full_like(lid, e_l * capacity))  # overflow bin
    slot_token = torch.full(lead + (e_l * capacity + 1,), t,
                            dtype=torch.long, device=idx.device)
    tokens = torch.arange(t, device=idx.device).repeat_interleave(k)
    # distinct slots but for the overflow bin, which is cut off below
    slot_token.scatter_(-1, slot.reshape(lead + (t * k,)),
                        tokens.expand(lead + (t * k,)))
    slot_token = slot_token[..., :-1].reshape(lead + (e_l, capacity))
    tok_slot = torch.where(ok, lid * capacity + pos, torch.full_like(lid, -1))
    return slot_token, tok_slot


def _bmm(x, w):
    """x (..., E, C, a) @ w (..., E, a, b): one batched product per
    leading index.  A layer's expert weights are a strided view of their
    segment's (tp, layers, E, a, b) leaf, whose (tp, E) axes do not fold
    into one batch axis: `torch.matmul` would copy every expert's weights
    to fold them."""
    if w.dim() == 3:
        return torch.bmm(x, w)
    return torch.stack([_bmm(xi, wi) for xi, wi in zip(x, w)])


def expert_ffn(xe, wg, wu, wd, act: str, gated: bool):
    """xe (..., E_l, C, d) -> (..., E_l, C, d): every local expert's MLP
    on its slots, one batched product per weight (and leading index)."""
    a = act_fn(act)
    up = _bmm(xe, wu)
    hidden = a(_bmm(xe, wg)) * up if gated else a(up)
    return _bmm(hidden, wd)


def _rows(x, index):
    """x (..., R, d) gathered at index (..., n) -> (..., n, d)."""
    return torch.gather(x, -2, index[..., None].expand(
        tuple(index.shape) + (x.shape[-1],)))


def moe_local(h, gates, tok_slot, slot_token, wg, wu, wd, act: str,
              gated: bool):
    """Run the local experts and combine back to token order: h (..., T,
    d) -> the partial (..., T, d) = sum over local assignments of gate *
    expert output."""
    t, d = h.shape[-2:]
    e_l, cap = slot_token.shape[-2:]
    lead = tuple(h.shape[:-2])
    k = tok_slot.shape[-1]
    hp = torch.cat([h, h.new_zeros(lead + (1, d))], -2)      # padding row
    xe = _rows(hp, slot_token.reshape(lead + (e_l * cap,)))
    ye = expert_ffn(xe.reshape(lead + (e_l, cap, d)), wg, wu, wd, act, gated)
    ye = torch.cat([ye.reshape(lead + (e_l * cap, d)),
                    ye.new_zeros(lead + (1, d))], -2)
    taken = tok_slot >= 0
    flat = torch.where(taken, tok_slot, torch.full_like(tok_slot, e_l * cap))
    picked = _rows(ye, flat.reshape(lead + (t * k,))).reshape(
        lead + (t, k, d))
    picked = torch.where(taken[..., None], picked, torch.zeros_like(picked))
    return torch.einsum("...tk,...tkd->...td", gates.to(picked.dtype), picked)
