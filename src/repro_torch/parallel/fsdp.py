"""FSDP / ZeRO-3 over the simulated data axis (port of
repro/parallel/fsdp.py).

The reference stores each parameter leaf split over "data" too, on its
largest dp-divisible axis that is neither the TP split axis nor the
layer-stack axis; its forward all-gathers one layer's weights at a time
and the gathers' transpose hands back reduce-scattered gradients.  On
one card every weight is whole, so the port keeps the layout as
`FSDPSpecs` and:

  * logs each all-gather where the reference runs it (the embedding,
    one layer's weights scaled over its segment, the final norm, the
    head), with one device's bytes: 1/dp of a model shard's leaf;
  * keeps fp32 m / v / master in the parameters' shard-stacked layout
    (checkpointed merged, as the reference's global arrays);
  * clips on the same norm groups (model-sharded leaves over data and
    model, replicated ones over data only) from per-slot partials over
    each leaf's data-split axis.

On the `shard` backend's ranks (a data group bound,
collectives.data_group) the layout is real: a rank stores its model
shard's slice of each data-split leaf (`FSDPSpecs.scatter`), the
forward all-gathers each weight over the data group where the ledger
logs it (collectives.gather_data), the gather's backward hands back the
reduce-scattered gradient, a leaf with no data-split axis has its
gradient all-reduced over the data group, every gradient is then
all-reduced over the pod group (collectives.pod_all_reduce; the state
is data-sharded within a pod and replicated across pods), and AdamW
runs on the slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import model as M
from repro_torch.parallel.collectives import (current_data_group,
                                              gather_data, group_reduce_data,
                                              ledger_unshared,
                                              log_collective, pod_all_reduce,
                                              psum_plain, shard_nbytes)
from repro_torch.parallel.layout import REPLICATED
from repro_torch.parallel.zero1 import adam_consts, clip_scale
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Spec derivation
# ---------------------------------------------------------------------------

def _leaf_fsdp_axis(shape, tp_axis: int, dp: int, *, offset: int) -> int:
    """Largest-size axis (excluding the TP split axis and the layer-stack
    axis) divisible by dp; -1 if none.  `offset`=1 for stacked leaves."""
    best, best_size = -1, 0
    for ax in range(offset, len(shape)):
        if ax == tp_axis:
            continue
        if shape[ax] % dp == 0 and shape[ax] > best_size:
            best, best_size = ax, shape[ax]
    return best


def fsdp_specs(cfg, plan, dp: int, split_params: dict,
               tp: Optional[int] = None) -> dict:
    """Int tree parallel to the stacked params: each leaf's data-split
    axis in its GLOBAL stacked shape (the reference's stack_segments
    output: the shard axis dropped, the TP split axis whole), or -1.
    `tp` is the TP degree when the params hold fewer shards than that
    (a rank's model shard); by default their shard axis's length."""
    specs = M.stacked_specs(cfg, plan)

    def one(w, tp_a, off):
        shape = list(w.shape[1:])
        tp_axis = -999
        if tp_a != REPLICATED:
            tp_axis = tp_a + off
            shape[tp_axis] *= tp or w.shape[0]
        return _leaf_fsdp_axis(shape, tp_axis, dp, offset=off)

    out = {k: tree_map(lambda w, a: one(w, a, 0), v, specs[k])
           for k, v in split_params.items() if k != "segs"}
    out["segs"] = [tree_map(lambda w, a: one(w, a, 1), sv, ss)
                   for sv, ss in zip(split_params["segs"], specs["segs"])]
    return out


# ---------------------------------------------------------------------------
# Gathers (forward): logged, nothing to move on one card
# ---------------------------------------------------------------------------

def local_nbytes(x, axis: int, dp: int) -> int:
    """One device's bytes of a shard-stacked leaf split over data on
    `axis` (-1: not split): 1/dp of one model shard's leaf (on a rank, x
    is that slice already)."""
    if axis < 0 or current_data_group() is not None:
        return shard_nbytes(x)
    return shard_nbytes(x) // dp


def gather_leaf(x, axis: int, dp: int, shift: int = 0):
    """The all-gather of a shard-stacked leaf's data slices (axis < 0: not
    data-split, no gather): logged with one device's slice bytes.  On
    sim x is whole already and is returned; on a rank its slice is
    gathered on dim axis + 1 + shift (`shift` -1: the layer axis is
    gone)."""
    if axis < 0:
        return x
    with ledger_unshared():
        log_collective("all-gather", "data", local_nbytes(x, axis, dp))
    return gather_data(x, axis + 1 + shift)


def gather_tree(tree, spec_tree, dp: int, shift: int = 0):
    return tree_map(lambda x, a: gather_leaf(x, a, dp, shift), tree,
                    spec_tree)


class FSDPSpecs(NamedTuple):
    """The data-split axes (fsdp_specs) and the data degree: what
    `model.forward_seq` / `loss_fn` take as `fsdp=`."""

    tree: dict
    dp: int

    def gather_top(self, stacked: dict, keys) -> dict:
        """`stacked` with the top-level leaves `keys` that the model has
        gathered."""
        out = dict(stacked)
        for k in keys:
            if k in stacked:
                out[k] = gather_tree(stacked[k], self.tree[k], self.dp)
        return out

    def gather_layer(self, layer_p: dict, seg_i: int) -> dict:
        """One layer's weights of segment seg_i (layer axis removed)."""
        return gather_tree(layer_p, self.tree["segs"][seg_i], self.dp,
                           shift=-1)

    def scatter(self, stacked: dict, index: int) -> dict:
        """Data rank `index`'s slice of every data-split leaf of a
        shard-stacked tree (a rank's stored layout); the other leaves as
        they are."""
        def cut(x, a):
            if a < 0:
                return x
            k = x.shape[a + 1] // self.dp
            return x.narrow(a + 1, index * k, k).clone()

        out = {k: tree_map(cut, v, self.tree[k])
               for k, v in stacked.items() if k != "segs"}
        out["segs"] = [tree_map(cut, sv, ss)
                       for sv, ss in zip(stacked["segs"], self.tree["segs"])]
        return out


def make_specs(split_params: dict, cfg, plan, dp: int,
               tp: Optional[int] = None) -> FSDPSpecs:
    return FSDPSpecs(fsdp_specs(cfg, plan, dp, split_params, tp), dp)


# ---------------------------------------------------------------------------
# AdamW on the (scattered) layout
# ---------------------------------------------------------------------------

def fsdp_opt_init(params):
    f32 = lambda p: p.detach().float().clone()           # noqa: E731
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "master": tree_map(f32, params)}


def _slot_sq(g, axis: int, dp: int):
    """Sum of squares of a shard-stacked gradient per (data, model) slot,
    (dp, tp): slot d holds slice d of the leaf's data-split axis (in the
    global stacked shape; dim axis + 1 here).  A leaf with no split axis
    counts once, on slot 0.  On a rank, its own slot, (1, 1)."""
    sq = g * g
    d = current_data_group()
    if d is not None:
        s = sq.sum().reshape(1, 1)
        return s if axis >= 0 or d.index == 0 else torch.zeros_like(s)
    if axis < 0:
        out = torch.zeros((dp, g.shape[0]), device=g.device)
        out[0] = sq.reshape(g.shape[0], -1).sum(-1)
        return out
    sq = sq.unflatten(axis + 1, (dp, -1)).movedim(axis + 1, 1)
    return sq.reshape(g.shape[0], dp, -1).sum(-1).t()


@torch.no_grad()
def fsdp_update(grads, state, params, *, cfg, plan, specs: FSDPSpecs, lr,
                b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                clip_norm: float = 0.0, pod_axis: Optional[str] = None):
    """grads: shard-stacked, summed over the data axes (on a rank: the
    data-split leaves' reduce-scattered slices, the others this rank's
    partials, all-reduced here).  Returns (params, state, grad_norm),
    params and state updated in place."""
    step = state["step"] + 1
    c1, c2 = adam_consts(step, b1, b2)
    dp = specs.dp
    grads = tree_map(lambda g: g.float(), grads)
    if current_data_group() is not None:
        for g, f in zip(tree_leaves(grads), tree_leaves(specs.tree)):
            if f < 0:
                group_reduce_data(g)
    if pod_axis is not None:
        for g, f in zip(tree_leaves(grads), tree_leaves(specs.tree)):
            pod_all_reduce(g, pod_axis, local_nbytes(g, f, dp))

    tp_specs = M.stacked_specs(cfg, plan)
    flat_g = tree_leaves(grads)
    dev = flat_g[0].device
    slots = ((1, 1) if current_data_group() is not None
             else (dp, flat_g[0].shape[0]))
    sh = torch.zeros(slots, device=dev)
    rp = torch.zeros(slots[:1], device=dev)
    for g, a, f in zip(flat_g, tree_leaves(tp_specs),
                       tree_leaves(specs.tree)):
        sq = _slot_sq(g, f, dp)
        if a == REPLICATED:
            rp = rp + sq[:, 0]
        else:
            sh = sh + sq
    tot = psum_plain(sh, ("data", "model")) + psum_plain(rp, "data")
    gnorm = torch.sqrt(tot)
    scale = clip_scale(gnorm, clip_norm)

    for g, m0, v0, w0, p in zip(flat_g, *(tree_leaves(state[k]) for k in
                                          ("m", "v", "master")),
                                tree_leaves(params)):
        g = g * scale
        m = b1 * m0 + (1 - b1) * g
        v = b2 * v0 + (1 - b2) * g * g
        w = w0 - lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                       + weight_decay * w0)
        p.copy_(w)
        m0.copy_(m)
        v0.copy_(v)
        w0.copy_(w)
    state["step"] = step
    return params, state, gnorm
