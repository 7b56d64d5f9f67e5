"""Tensor-parallel weight layout (port of repro/parallel/layout.py).

Canonical parameters are padded so every split axis divides by `tp`;
`split_leaf` then moves the split axis to a leading shard axis of size
`tp` (the reference's sim layout, which is how one GPU holds every
shard).  Spec trees mirror the parameter tree with the split axis of
each leaf, or REPLICATED (-1).

GQA head padding: with KV >= tp, KV pads up to a multiple of tp and Q to
match; with KV < tp, KV pads to a divisor of tp and each KV head is
replicated over tp/KV_pad consecutive shards.  Zero-padded query heads
have zero W_Q columns and zero W_O rows, so they add nothing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tree import tree_map

REPLICATED = -1


@dataclass(frozen=True)
class GQALayout:
    n_heads: int
    n_kv_heads: int
    tp: int
    h_pad: int            # padded query heads (multiple of tp)
    kv_pad: int           # padded distinct kv heads
    kv_layout: int        # kv heads in TP layout (= replication * kv_pad)
    q_local: int          # query heads per shard
    kv_local: int         # kv heads per shard
    replication: int      # how many shards share one kv head

    @property
    def q_per_kv_pad(self) -> int:
        return self.h_pad // self.kv_pad


def make_gqa_layout(n_heads: int, n_kv_heads: int, tp: int) -> GQALayout:
    if n_heads < 1 or n_kv_heads < 1 or tp < 1:
        raise ValueError(f"bad GQA layout request {n_heads}/{n_kv_heads}/{tp}")
    q_per_kv = -(-n_heads // n_kv_heads)
    if n_kv_heads >= tp:
        kv_pad = -(-n_kv_heads // tp) * tp
        h_pad = kv_pad * q_per_kv
        replication = 1
    else:
        kv_pad = next(d for d in range(n_kv_heads, tp + 1) if tp % d == 0)
        replication = tp // kv_pad
        h_pad = kv_pad * (-(-q_per_kv // replication) * replication)
    kv_layout = kv_pad * replication
    return GQALayout(n_heads=n_heads, n_kv_heads=n_kv_heads, tp=tp,
                     h_pad=h_pad, kv_pad=kv_pad, kv_layout=kv_layout,
                     q_local=h_pad // tp, kv_local=kv_layout // tp,
                     replication=replication)


def q_head_orig(layout: GQALayout) -> np.ndarray:
    """Padded query-head index -> original head index, or -1 (padding).
    Original head h (kv group g, slot r) sits at g * q_per_kv_pad + r."""
    q_per_kv = -(-layout.n_heads // layout.n_kv_heads)
    out = np.full(layout.h_pad, -1, dtype=np.int64)
    for h in range(layout.n_heads):
        g, r = divmod(h, q_per_kv)
        out[g * layout.q_per_kv_pad + r] = h
    return out


def kv_head_orig(layout: GQALayout) -> np.ndarray:
    """Layout kv index -> original kv head, or -1 (padding); consecutive
    shards share a replicated kv head."""
    d = np.arange(layout.kv_layout) // layout.replication
    return np.where(d < layout.n_kv_heads, d, -1)


def pad_heads(w, axis: int, src_map, head_dim: int, n_src: int):
    """Expand `w` along `axis` from n_src packed heads to len(src_map)
    heads; src_map[i] is the source head of slot i, or -1 for zeros."""
    if w.shape[axis] != n_src * head_dim:
        raise ValueError(f"{tuple(w.shape)} axis {axis} is not "
                         f"{n_src} x {head_dim}")
    if np.array_equal(src_map, np.arange(n_src)):
        return w                  # nothing to pad: no copy
    w = w.movedim(axis, 0)
    rest = w.shape[1:]
    w = w.reshape((n_src, head_dim) + tuple(rest))
    zero = torch.zeros_like(w[0])
    out = torch.stack([w[s] if s >= 0 else zero for s in src_map], 0)
    out = out.reshape((len(src_map) * head_dim,) + tuple(rest))
    return out.movedim(0, axis)


def split_leaf(w, axis: int, tp: int):
    """TP-layout full weight -> (tp, ...) per-shard weights, contiguous."""
    if axis == REPLICATED:
        return w[None].expand((tp,) + tuple(w.shape)).contiguous()
    if w.shape[axis] % tp:
        raise ValueError(f"axis {axis} of {tuple(w.shape)} does not split "
                         f"{tp} ways")
    local = w.shape[axis] // tp
    w = w.reshape(tuple(w.shape[:axis]) + (tp, local)
                  + tuple(w.shape[axis + 1:]))
    return w.movedim(axis, 0).contiguous()


def shard_leaf(w, axis: int, tp: int, rank: int):
    """Shard `rank` of split_leaf(w, axis, tp), as (1, ...): a new
    contiguous tensor (never a view of w, which may then be freed)."""
    if axis == REPLICATED:
        return w[None].clone(memory_format=torch.contiguous_format)
    if w.shape[axis] % tp:
        raise ValueError(f"axis {axis} of {tuple(w.shape)} does not split "
                         f"{tp} ways")
    local = w.shape[axis] // tp
    return w.narrow(axis, rank * local, local)[None].clone(
        memory_format=torch.contiguous_format)


def merge_leaf(w, axis: int, tp: int):
    """Inverse of split_leaf (replicated leaves: shard 0)."""
    if axis == REPLICATED:
        return w[0]
    w = w.movedim(0, axis)
    return w.reshape(tuple(w.shape[:axis])
                     + (w.shape[axis] * w.shape[axis + 1],)
                     + tuple(w.shape[axis + 2:]))


def split_tree(params, specs, tp: int):
    return tree_map(lambda w, a: split_leaf(w, a, tp), params, specs)
