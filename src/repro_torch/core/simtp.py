"""Simulated tensor parallelism on one device (port of
repro/core/simtp.py: parameter splitting and the forward-only engine
functions the sensitivity sweep and the quality evals run on).

The reference vmaps each function over the shard axis and jits it; the
port's functions are already written over shard-stacked tensors (dim 0
the TP shard) and run eagerly under `torch.inference_mode()`.  The
gradient functions (`make_grad_fn`) come with the training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import model as M
from repro_torch.core.layer_kinds import plan_segments
from repro_torch.parallel.layout import REPLICATED, split_leaf
from repro_torch.tree import tree_map


def _split_with_offset(tree, specs, tp, offset):
    return tree_map(lambda w, a: split_leaf(
        w, a if a == REPLICATED else a + offset, tp), tree, specs)


def split_padded(padded: dict, cfg: ModelConfig, plan: SPDPlanConfig,
                 tp: int) -> dict:
    """Padded per-layer list -> every leaf with a leading (tp, ...) axis
    (segment leaves carry their layer axis at dim 1): the reference's
    `split_stacked(stack_segments(padded))` in one pass.  Each segment
    leaf is stacked and split on its own, so at most one stacked leaf
    lives beside the result (a 7B model is not held three times over)."""
    specs = M.stacked_specs(cfg, plan)
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


# ---------------------------------------------------------------------------
# Engine functions (forward only)
# ---------------------------------------------------------------------------

def _device(split_params):
    return split_params["emb"].device


def make_loss_fn(cfg, plan, tp, *, q_chunk=1024, dual=False):
    """fn(split_params, batch[, drop_flags]) -> (loss, metrics).

    `dual=True` takes per-layer drop flags (L,) at each call, the
    reference's dual mode: one placement under `plan` (the no-SPD plan)
    serves every evaluation of the sweep."""

    @torch.inference_mode()
    def fn(split_params, batch, drop_flags=None):
        if (drop_flags is not None) != dual:
            raise TypeError("drop_flags are given exactly when dual=True")
        dev = _device(split_params)
        b = {k: torch.as_tensor(np.asarray(v)).to(dev)
             for k, v in batch.items() if not k.startswith("_")}
        flags = (None if drop_flags is None
                 else [bool(f > 0.5) for f in np.asarray(drop_flags)])
        return M.loss_fn(cfg, split_params, plan, b, tp=tp, q_chunk=q_chunk,
                         drop_flags=flags)

    return fn


def make_logits_fn(cfg, plan, tp, *, q_chunk=1024):
    """fn(split_params, tokens) -> full logits (B,S,V) fp32, the shards'
    vocab slices concatenated and the padded columns cut."""

    @torch.inference_mode()
    def fn(split_params, tokens):
        tokens = torch.as_tensor(np.asarray(tokens)).to(
            _device(split_params))
        x, _ = M.forward_seq(cfg, split_params, plan, tokens, tp=tp,
                             q_chunk=q_chunk)
        lg = M.lm_logits(split_params, cfg, x)          # (tp,B,S,Vl)
        tp_, b, s, vl = lg.shape
        full = lg.permute(1, 2, 0, 3).reshape(b, s, tp_ * vl)
        return full[..., : cfg.vocab_size]

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
