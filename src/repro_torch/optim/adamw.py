"""AdamW on parameter trees (port of repro/optim/adamw.py): fp32
moments and optional fp32 master copies of low-precision params, the
update computed on the master and cast back to each param's dtype.

Plain functions on the port's nested dict/list trees; nothing is
updated in place.  `torch.optim.AdamW` is not a stand-in: it keeps no
fp32 master of a bf16 param, its default b2 is 0.999, and it applies
the weight decay in another rounding order.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def adamw_init(params, *, master: bool = True):
    state = {"step": 0,
             "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
             "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)}
    if master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """Returns (new_params, new_state).  `lr` is a float or a 0-d
    tensor; the bias corrections are formed in fp32 as the reference's
    are."""
    step = state["step"] + 1
    t = torch.tensor(float(step), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
    masters = state.get("master") or tree_map(lambda p: p.detach().float(),
                                              params)

    def upd(g, m, v, w):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        new = w - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * w)
        return new, m, v

    out = [upd(*leaves) for leaves in zip(*map(tree_leaves, (
        grads, state["m"], state["v"], masters)))]
    new_master, new_m, new_v = (tree_unflatten(grads, [o[i] for o in out])
                                for i in range(3))
    new_state = {"step": step, "m": new_m, "v": new_v}
    if "master" in state:
        new_state["master"] = new_master
    new_params = tree_map(lambda w, p: w.to(p.dtype), new_master, params)
    return new_params, new_state


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm, *, precomputed_norm=None):
    n = precomputed_norm if precomputed_norm is not None else global_norm(
        grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), n
