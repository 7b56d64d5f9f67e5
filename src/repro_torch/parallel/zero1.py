"""ZeRO-1 optimizer-state sharding over the simulated data axis (port
of repro/parallel/zero1.py).

Gradients arrive shard-stacked (dim 0 the TP shard) and already summed
over the data axes: the port differentiates the whole global batch at
once (parallel/tp.py).  The update keeps the reference's steps and
their ledger entries:

  1. (multi-pod) all-reduce over "pod": the optimizer state is
     data-sharded within a pod and replicated across pods; on sim
     logged only, the gradient already holds the sum;
  2. reduce-scatter each flattened leaf over "data": slot i owns slice i
     of every TP shard's fp32 leaf, padded to a multiple of dp;
  3. the global-grad-norm clip on the slices (spec-aware: TP-sharded
     leaves summed over data and model, replicated ones over data only,
     since every model shard holds the same replicated slices);
  4. AdamW on every slice (fp32 m / v / master) in the reference's
     operation order;
  5. all-gather over "data" rebuilds each updated parameter.

State leaves have the reference's GLOBAL shape (dp, tp, n), so a
checkpoint holds the same arrays in both packages.  Parameters and
state are updated in place (the reference donates them).

On the `shard` backend's ranks (a data group bound,
collectives.data_group) a rank's gradients are the partials of its own
rows, its parameters its model shard (1, ...), and its state ONE (data,
model) slot of its pod, (1, 1, n): step 1 all-reduces the gradient over
the pod group (collectives.pod_all_reduce), step 2 is a reduce-scatter
over the data group, the norm's partials are all-reduced over the
rank's groups (within its pod: every pod holds the same sums) and step
5 all-gathers the updated slice, with the same code and ledger.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel.collectives import (all_gather,
                                              current_data_group,
                                              pod_all_reduce, psum_plain,
                                              psum_scatter, shard_nbytes)
from repro_torch.parallel.layout import REPLICATED
from repro_torch.tree import tree_leaves, tree_map


def _pad_to(x, mult: int):
    """Shard-stacked x (tp, ...) -> (tp, L): each shard flattened and
    zero-padded to a multiple of `mult`."""
    flat = x.reshape(x.shape[0], -1)
    pad = (-flat.shape[1]) % mult
    return F.pad(flat, (0, pad)) if pad else flat


def _leaf_states(state_leaves, params) -> list:
    """The {"m","v","w"} dict of each parameter leaf, in leaf order."""
    out = []
    tree_map(lambda _, st: out.append(st), params, state_leaves)
    return out


def zero1_init_structured(params, dp: int):
    """{"leaves": per leaf {"m","v","w"} (dp, tp, n) fp32, "step" 0-d
    int32}: w holds the parameter's slices, m and v zeros.  Under a data
    group (a rank) only the rank's slot, (1, 1, n)."""
    d = current_data_group()

    def one(p):
        flat = _pad_to(p.detach().float(), dp)
        sl = flat.reshape(flat.shape[0], dp, -1).transpose(0, 1)
        if d is not None:
            sl = sl[d.index:d.index + 1]
        sl = sl.contiguous()
        return {"m": torch.zeros_like(sl), "v": torch.zeros_like(sl),
                "w": sl}
    dev = tree_leaves(params)[0].device
    return {"leaves": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adam_consts(step, b1: float, b2: float):
    """The bias corrections 1 - b^t, formed in fp32 as the reference's."""
    t = step.float()
    f32 = dict(dtype=torch.float32, device=step.device)
    return (1.0 - torch.tensor(b1, **f32) ** t,
            1.0 - torch.tensor(b2, **f32) ** t)


def clip_scale(gnorm, clip_norm: float):
    if clip_norm <= 0:
        return torch.ones((), dtype=torch.float32, device=gnorm.device)
    return torch.clamp(clip_norm / gnorm.clamp_min(1e-9), max=1.0)


@torch.no_grad()
def zero1_update_clipped(grads, state, params, *, specs, dp: int, lr,
                         b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                         clip_norm: float = 0.0,
                         pod_axis: Optional[str] = None):
    """Returns (params, state, grad_norm), params and state updated in
    place."""
    step = state["step"] + 1
    c1, c2 = adam_consts(step, b1, b2)
    flat_p = tree_leaves(params)
    flat_s = _leaf_states(state["leaves"], params)
    flat_a = tree_leaves(specs)

    # ---- 1-2: reduce ----
    slices = []
    for g in tree_leaves(grads):
        g32 = g.float()
        if pod_axis is not None:
            g32 = pod_all_reduce(g32, pod_axis, shard_nbytes(g32))
        slices.append(psum_scatter(_pad_to(g32, dp), "data", dp))

    # ---- 3: spec-aware global norm on the slices, per (data, model) slot
    # (dp, tp) on sim, (1, 1) on a rank
    dev = flat_p[0].device
    sq_sh = torch.zeros(slices[0].shape[:2], device=dev)
    sq_rp = torch.zeros(slices[0].shape[:1], device=dev)
    for s, a in zip(slices, flat_a):
        sq = torch.sum(s * s, dim=-1)                     # (dp, tp)
        if a == REPLICATED:
            sq_rp = sq_rp + sq[:, 0]
        else:
            sq_sh = sq_sh + sq
    tot = psum_plain(sq_sh, ("data", "model")) + psum_plain(sq_rp, "data")
    gnorm = torch.sqrt(tot)
    scale = clip_scale(gnorm, clip_norm)

    # ---- 4-5: sliced AdamW + gather ----
    for gsl, st, p in zip(slices, flat_s, flat_p):
        gsl = gsl * scale
        m0, v0, w0 = st["m"], st["v"], st["w"]
        m = b1 * m0 + (1 - b1) * gsl
        v = b2 * v0 + (1 - b2) * gsl * gsl
        w = w0 - lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                       + weight_decay * w0)
        full = all_gather(w, "data")[:, : p[0].numel()]
        p.copy_(full.reshape(p.shape))
        m0.copy_(m)
        v0.copy_(v)
        w0.copy_(w)
    state["step"] = step
    return params, state, gnorm


def zero1_reshard(state_tree, dp_new: int):
    """Re-shard a (dp_old, tp, n_old) ZeRO-1 state tree to a new data
    degree (elastic re-mesh).  Content-preserving: for each model shard
    the concatenated slices ARE the flat padded parameter, so resharding
    is a transpose and a reshape.  Where dp_old * n_old does not divide
    by dp_new (the reference asserts it does) the flat leaf is padded
    with zeros first: its tail past the parameter is padding."""
    def one(x):
        if x.dim() != 3:
            return x
        dp_old, tp, n_old = x.shape
        flat = _pad_to(x.transpose(0, 1).reshape(tp, dp_old * n_old),
                       dp_new)
        return flat.reshape(tp, dp_new, -1).transpose(0, 1).contiguous()

    return {"leaves": tree_map(one, state_tree["leaves"]),
            "step": state_tree["step"]}
