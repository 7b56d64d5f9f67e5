"""Simulated tensor parallelism on one device (port of
repro/core/simtp.py: parameter splitting, the engine functions the
sensitivity sweep, the quality evals and Algorithm 1's recovery run
on, and the gradient function).

The reference vmaps each function over the shard axis and jits it; the
port's functions are already written over shard-stacked tensors (dim 0
the TP shard) and run eagerly: the evals under `torch.inference_mode()`,
the block-input capture and the block function under `torch.no_grad()`
(their outputs feed a backward, which an inference tensor may not).

Gradients: `make_grad_fn` differentiates the SUM over the shard axis of
each shard's own loss through the collectives' f/g rules
(parallel/collectives.py), the reference's grad-inside-vmap.  Every
copy of a replicated leaf receives the full shard-summed gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import blocks as B
from repro_torch.core import model as M
from repro_torch.core.layer_kinds import plan_segments
from repro_torch.parallel.collectives import local_shards
from repro_torch.parallel.layout import (REPLICATED, merge_leaf, shard_leaf,
                                         split_leaf)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _split_with_offset(tree, specs, tp, offset):
    return tree_map(lambda w, a: split_leaf(
        w, a if a == REPLICATED else a + offset, tp), tree, specs)


def split_padded(padded: dict, cfg: ModelConfig, plan: SPDPlanConfig,
                 tp: int, *, rank=None, device=None) -> dict:
    """Padded per-layer list -> every leaf with a leading (tp, ...) axis
    (segment leaves carry their layer axis at dim 1): the reference's
    `split_stacked(stack_segments(padded))` in one pass.  Each segment
    leaf is stacked and split on its own, so at most one stacked leaf
    lives beside the result (a 7B model is not held three times over).

    With `rank` (the shard backend's per-rank placement) only shard
    `rank` of each leaf is made, (1, ...), and moved to `device`: each
    layer's slice is cut before the layers stack, so a rank never holds
    more than its own shard beside the padded tree."""
    specs = M.stacked_specs(cfg, plan)
    if rank is not None:
        def cut(w, a):
            return shard_leaf(w, a, tp, rank).to(device)

        out = {k: tree_map(cut, v, specs[k])
               for k, v in padded.items() if k != "layers"}
        out["segs"] = []
        for (start, length, _, _), ss in zip(
                plan_segments(cfg, plan.drop_mask, plan.qmodes),
                specs["segs"]):
            layers = padded["layers"][start:start + length]
            out["segs"].append(tree_map(
                lambda a, *ws: torch.cat([cut(w, a) for w in ws])[None],
                ss, *layers))
        return out
    out = {k: _split_with_offset(v, specs[k], tp, offset=0)
           for k, v in padded.items() if k != "layers"}
    out["segs"] = []
    for (start, length, _, _), ss in zip(
            plan_segments(cfg, plan.drop_mask, plan.qmodes), specs["segs"]):
        layers = padded["layers"][start:start + length]
        out["segs"].append(tree_map(
            lambda a, *ws: split_leaf(torch.stack(ws, 0),
                                      a if a == REPLICATED else a + 1, tp),
            ss, *layers))
    return out


def prepare_params(canonical: dict, cfg: ModelConfig, plan: SPDPlanConfig,
                   tp: int) -> dict:
    """canonical -> padded -> stacked -> split."""
    return split_padded(M.pad_model(canonical, cfg, tp), cfg, plan, tp)


def merge_stacked(split: dict, cfg: ModelConfig, plan: SPDPlanConfig,
                  tp: int) -> dict:
    """Inverse of split_padded up to the per-layer list: per-segment
    stacked trees (layer axis 0); replicated leaves take shard 0."""
    specs = M.stacked_specs(cfg, plan)
    out = {k: tree_map(lambda w, a: merge_leaf(w, a, tp), v, specs[k])
           for k, v in split.items() if k != "segs"}
    out["segs"] = [tree_map(lambda w, a: merge_leaf(
        w, a if a == REPLICATED else a + 1, tp), sv, ss)
        for sv, ss in zip(split["segs"], specs["segs"])]
    return out


def split_layer(layer_params: dict, cfg, kind, tp: int, rank=None) -> dict:
    """Canonical layer params -> padded, every leaf (tp, ...); with
    `rank`, only that shard, (1, ...)."""
    padded = B.pad_layer(layer_params, cfg, kind, tp)
    if rank is not None:
        return tree_map(lambda w, a: shard_leaf(w, a, tp, rank), padded,
                        B.layer_specs(cfg, kind))
    return _split_with_offset(padded, B.layer_specs(cfg, kind), tp,
                              offset=0)


def merge_layer(split: dict, cfg, kind, tp: int) -> dict:
    """Inverse of split_layer up to head padding (padded canonical)."""
    return tree_map(lambda w, a: merge_leaf(w, a, tp), split,
                    B.layer_specs(cfg, kind))


# ---------------------------------------------------------------------------
# Engine functions (forward only)
# ---------------------------------------------------------------------------

def _device(split_params):
    return split_params["emb"].device


def _batch(batch, dev):
    return {k: torch.as_tensor(np.asarray(v)).to(dev)
            for k, v in batch.items() if not k.startswith("_")}


def _positions(b: int, s: int, dev):
    return torch.arange(s, device=dev).expand(b, s)


def grad_leaves(tree):
    """Fresh leaves that require grad, sharing the tree's storage: the
    tree rebuilt on them, and the list autograd differentiates."""
    leaves = [w.detach().requires_grad_() for w in tree_leaves(tree)]
    return tree_unflatten(tree, leaves), leaves


def grads_of(total, tree, leaves):
    """d total / d leaves, as a tree like `tree` (zeros where unused)."""
    gs = torch.autograd.grad(total, leaves, allow_unused=True)
    return tree_unflatten(tree, [torch.zeros_like(w) if g is None else g
                          for g, w in zip(gs, leaves)])


def make_loss_fn(cfg, plan, tp, *, q_chunk=1024, dual=False):
    """fn(split_params, batch[, drop_flags]) -> (loss, metrics).

    `dual=True` takes per-layer drop flags (L,) at each call, the
    reference's dual mode: one placement under `plan` (the no-SPD plan)
    serves every evaluation of the sweep."""

    @torch.inference_mode()
    def fn(split_params, batch, drop_flags=None):
        if (drop_flags is not None) != dual:
            raise TypeError("drop_flags are given exactly when dual=True")
        b = _batch(batch, _device(split_params))
        flags = (None if drop_flags is None
                 else [bool(f > 0.5) for f in np.asarray(drop_flags)])
        return M.loss_fn(cfg, split_params, plan, b, tp=tp, q_chunk=q_chunk,
                         drop_flags=flags)

    return fn


def make_grad_fn(cfg, plan, tp, *, q_chunk=1024, remat=False):
    """fn(split_params, batch) -> (loss, grads): shard 0's loss (a 0-d
    tensor) and the gradient tree of the shard-summed loss, shaped like
    `split_params`.  `remat=True` recomputes each block in the backward;
    the values do not change."""

    def fn(split_params, batch):
        p, leaves = grad_leaves(split_params)
        b = _batch(batch, _device(split_params))
        with torch.enable_grad():
            loss, met = M.loss_fn(cfg, p, plan, b, tp=tp, q_chunk=q_chunk,
                                  remat=remat)
            grads = grads_of(met["shard_loss"].sum(), split_params, leaves)
        return loss.detach(), grads

    return fn


def make_logits_fn(cfg, plan, tp, *, q_chunk=1024):
    """fn(split_params, tokens, embeds=None) -> full logits (B,S,V) fp32
    of the token positions (a frontend's prefix cut, as the reference's
    simtp.py:132-146), the shards' vocab slices concatenated and the
    padded columns cut."""

    @torch.inference_mode()
    def fn(split_params, tokens, embeds=None):
        dev = _device(split_params)
        tokens = torch.as_tensor(np.asarray(tokens)).to(dev)
        if embeds is not None:
            embeds = torch.as_tensor(np.asarray(embeds)).to(dev)
        x, _, _, prefix = M.forward_seq(cfg, split_params, plan, tokens,
                                        tp=tp, q_chunk=q_chunk,
                                        embeds=embeds)
        lg = M.lm_logits(split_params, cfg, x[:, :, prefix:])  # (tp,B,S,Vl)
        tp_, b, s, vl = lg.shape
        full = lg.permute(1, 2, 0, 3).reshape(b, s, tp_ * vl)
        return full[..., : cfg.vocab_size]

    return fn


def make_collect_fn(cfg, plan, tp, *, q_chunk=1024):
    """fn(split_params, tokens) -> every block's INPUT (L+1, B, S, d):
    entry L is the last block's output (before the final norm).  The
    stream is replicated, so shard 0's copy is returned.

    Unlike the reference's, the stream includes OPT's learned positions
    (added after the embedding, as every forward adds them): the
    reference's collect function leaves them out."""
    segs = plan_segments(cfg, plan.drop_mask, plan.qmodes)
    lay = M._gqa_layout(cfg, tp)

    @torch.no_grad()
    def fn(split_params, tokens):
        tokens = torch.as_tensor(np.asarray(tokens)).to(
            _device(split_params))
        b, s = tokens.shape
        pos = _positions(b, s, tokens.device)
        x = M._add_positions(split_params, cfg,
                             M.embed_tokens(split_params["emb"], tokens),
                             pos)
        outs = [x[0]]
        for seg_i, (start, length, kind, dropped) in enumerate(segs):
            sp = split_params["segs"][seg_i]
            for j in range(length):
                x, _, _ = B.block_seq(cfg, kind, lay, M._layer(sp, j), x, pos,
                                      drop=dropped, q_chunk=q_chunk,
                                      comm=plan.block_mode(start))
                outs.append(x[0])
        return torch.stack(outs)

    return fn


# ---------------------------------------------------------------------------
# Single-block apply (distillation, grouping checks)
# ---------------------------------------------------------------------------

def make_block_fn(cfg, kind, tp, *, drop: bool, q_chunk=1024):
    """fn(split_layer_params, x (B,S,d), pos (B,S)) -> block output
    (B,S,d), shard 0's copy (a rank's own under a model group)."""
    lay = M._gqa_layout(cfg, tp)

    @torch.no_grad()
    def fn(split_p, x, pos):
        xs = x[None].expand((local_shards(tp),) + tuple(x.shape))
        out, _, _ = B.block_seq(cfg, kind, lay, split_p, xs, pos, drop=drop,
                                q_chunk=q_chunk)
        return out[0]

    return fn


# ---------------------------------------------------------------------------
# Quality evaluation
# ---------------------------------------------------------------------------

def eval_ppl(loss_fn, split_params, batches, dual_flags=None) -> float:
    tot_ce, tot_n = 0.0, 0.0
    for b in batches:
        if dual_flags is not None:
            _, met = loss_fn(split_params, b, dual_flags)
        else:
            _, met = loss_fn(split_params, b)
        tot_ce += float(met["sum_ce"])
        tot_n += float(met["n_tok"])
    return float(np.exp(tot_ce / max(tot_n, 1.0)))


def eval_cloze(logits_fn, split_params, suite) -> float:
    lg = logits_fn(split_params, suite["tokens"])
    qp = suite["query_pos"]
    pred = lg[np.arange(len(qp)), qp].argmax(-1).cpu().numpy()
    return float((pred == suite["answer"]).mean())
