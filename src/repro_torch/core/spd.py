"""Algorithm 1: sensitivity-ranked, multi-tier SPD application (port of
repro/core/spd.py).

Given canonical params, a calibration set, a TP degree and a budget
N_spd, `apply_spd`:

  1. measures block-wise sync sensitivity (core/sensitivity.py),
  2. ranks blocks ascending, takes the first N_spd,
  3. classifies each into ISB / SB / ESB via (τ1, τ2),
  4. ISB  -> zero-shot drop,
     SB   -> SPD-aware block-to-block distillation (core/distill.py),
     ESB  -> head-grouping init (core/grouping.py) + distillation,
  5. returns deployment-ready PADDED per-layer params (distilled SPD
     weights are TP-degree-specific, hence padded space) + the plan.

The sensitivity-tiered comm policy (drop / quant8 / exact per block)
reuses steps 1-3 zero-shot.

On the `shard` backend's ranks (`groups`, this rank's
launch.dist.TPGroups) every step runs each rank's own model shard with
the model group bound, as the serving forward does: the canonical tree
stays where it lies (the host), the rank places its shard under the
no-SPD plan, the sweep, the capture and the distillation sync over the
group, and head grouping is computed from the canonical layer, the same
way on every rank.  A distilled block's shards are gathered back over
the group, so every rank returns the same padded tree.  Each data rank
runs the same work on the same calibration batches.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.config.base import CommPolicy, ModelConfig, SPDPlanConfig
from repro_torch.core import distill as D
from repro_torch.core import grouping as G
from repro_torch.core import model as M
from repro_torch.core import sensitivity as S
from repro_torch.core import simtp
from repro_torch.core.layer_kinds import layer_kinds
from repro_torch.parallel.collectives import gather_shards, rank_bound
from repro_torch.tree import tree_map


@dataclass
class SPDReport:
    sensitivity: np.ndarray
    ppl_suffix: np.ndarray
    ranking: np.ndarray
    categories: List[str]              # per chosen block (ranking order)
    chosen: List[int]
    distill_losses: Dict[int, List[float]] = field(default_factory=dict)
    grouping: Dict[int, "G.GroupingResult"] = field(default_factory=dict)
    # wall seconds of each part of apply_spd that ran: "sweep",
    # "capture", "grouping", "distill" (the device drained at each end)
    seconds: Dict[str, float] = field(default_factory=dict)


def place_no_spd(cfg, padded, tp, groups=None):
    """`padded` placed under the no-SPD plan: every shard (sim), or this
    rank's, (1, ...), on its device."""
    plan = SPDPlanConfig.none(cfg.n_layers)
    if groups is None:
        return simtp.split_padded(padded, cfg, plan, tp)
    return simtp.split_padded(padded, cfg, plan, tp, rank=groups.model_rank,
                              device=groups.device)


def capture_block_inputs(cfg, padded, tp, calib_batches, *, q_chunk=1024,
                         split0=None, groups=None):
    """Hidden states at every block's input, all-TP mode, per calib
    batch: a list over batches of (L+1,B,S,d) tensors on the params'
    device.  `split0` is the no-SPD placement of `padded` when the
    caller holds one (the sweep's); else it is placed here and freed.
    On a rank (`groups`), its shard runs with the model group bound."""
    plan = SPDPlanConfig.none(cfg.n_layers)
    if split0 is None:
        split0 = place_no_spd(cfg, padded, tp, groups)
    collect = simtp.make_collect_fn(cfg, plan, tp, q_chunk=q_chunk)
    with rank_bound(groups):
        return [collect(split0, b["tokens"]) for b in calib_batches]


def sweep_sensitivity(cfg: ModelConfig, canonical: dict, calib_batches,
                      tp: int, *, q_chunk: int = 1024, keep_split=False,
                      groups=None):
    """Place the canonical params once under the no-SPD plan and run
    Algorithm 1's block sweep.  Returns (SensitivityResult, padded
    params), and the placement too when `keep_split`; else it is freed
    on return.  On a rank (`groups`) the padded tree stays where the
    canonical one lies and the rank's shard is placed on its device."""
    padded = M.pad_model(canonical, cfg, tp)
    split0 = place_no_spd(cfg, padded, tp, groups)
    with rank_bound(groups):
        res = S.measure_sensitivity(cfg, split0, calib_batches, tp,
                                    q_chunk=q_chunk)
    return (res, padded, split0) if keep_split else (res, padded)


def _clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def apply_spd(cfg: ModelConfig, canonical: dict, calib_batches, tp: int, *,
              n_spd: int, tau1: float, tau2: float, lr: float = 5e-5,
              epochs: int = 10, strategies=("ZS", "B2B", "HG"),
              q_chunk: int = 1024, groups=None):
    """Returns (padded_params_final, plan, report).  `groups`: this
    rank's launch.dist.TPGroups on the shard backend (module doc)."""
    if not cfg.spd_applicable:
        padded = M.pad_model(canonical, cfg, tp)
        plan = SPDPlanConfig.none(cfg.n_layers)
        rep = SPDReport(np.zeros(cfg.n_layers), np.zeros(cfg.n_layers + 1),
                        np.arange(cfg.n_layers), [], [])
        return padded, plan, rep

    # ---- 1-2: sensitivity + ranking ----
    dev = canonical["emb"].device if groups is None else groups.device
    t0 = _clock(dev)
    res, padded, split0 = sweep_sensitivity(cfg, canonical, calib_batches,
                                            tp, q_chunk=q_chunk,
                                            keep_split=True, groups=groups)
    chosen = [int(i) for i in res.ranking[:n_spd]]
    cats = S.classify(res.sensitivity[chosen], tau1, tau2)
    plan = SPDPlanConfig.from_ranking(res.ranking, n_spd, cfg.n_layers)
    report = SPDReport(res.sensitivity, res.ppl_suffix, res.ranking,
                       cats, chosen)
    t1 = _clock(dev)
    report.seconds["sweep"] = t1 - t0

    need_recovery = [i for i, c in zip(chosen, cats) if c != S.ISB]
    if not need_recovery or "B2B" not in strategies:
        return padded, plan, report

    # ---- hidden states at block inputs (TP mode, App C.1) ----
    hiddens = capture_block_inputs(cfg, padded, tp, calib_batches,
                                   q_chunk=q_chunk, split0=split0,
                                   groups=groups)
    del split0
    t2 = _clock(dev)
    report.seconds["capture"] = t2 - t1
    report.seconds["grouping"] = report.seconds["distill"] = 0.0

    kinds = layer_kinds(cfg)
    new_layers = list(padded["layers"])
    for bi, cat in zip(chosen, cats):
        if cat == S.ISB:
            continue
        kind = kinds[bi]
        layer_canonical = tree_map(lambda w: w.to(dev),
                                   canonical["layers"][bi])
        if cat == S.ESB and "HG" in strategies:
            t = _clock(dev)
            gres = G.group_heads(cfg, kind, layer_canonical, hiddens[0][bi],
                                 tp)
            report.grouping[bi] = gres
            layer_canonical = G.apply_grouping(layer_canonical, cfg, gres, tp)
            report.seconds["grouping"] += _clock(dev) - t
        t = _clock(dev)
        # teacher = the (possibly permuted) TP weights
        teacher_split = simtp.split_layer(
            layer_canonical, cfg, kind, tp,
            rank=None if groups is None else groups.model_rank)
        with rank_bound(groups):
            student_split, losses = D.b2b_distill(
                cfg, kind, tp, teacher_split, [h[bi] for h in hiddens],
                lr=lr, epochs=epochs, q_chunk=q_chunk)
            # a rank's distilled shard, gathered back over the group
            student_split = tree_map(gather_shards, student_split)
        report.distill_losses[bi] = losses
        new_layers[bi] = simtp.merge_layer(student_split, cfg, kind, tp)
        report.seconds["distill"] += _clock(dev) - t

    out = dict(padded)
    out["layers"] = new_layers
    return out, plan, report


def prepare_deployment(cfg, padded, plan, tp):
    """Padded per-layer params + plan -> the sim engine's split tree."""
    return simtp.split_padded(padded, cfg, plan, tp)


# ---------------------------------------------------------------------------
# Sensitivity-aware comm-policy assignment (Algorithm-1 tiering reused for
# the drop | quant8 | quant4 | exact decision per block)
# ---------------------------------------------------------------------------

def comm_policy_from_sensitivity(sens, ranking, n_layers: int, *,
                                 n_spd: int, tau1: float, tau2: float,
                                 sb_level: str = "quant8",
                                 esb_level: str = "exact",
                                 logits: str = "exact"):
    """Map Algorithm 1's sensitivity tiers onto a per-block comm policy.

    ISB blocks (sens <= tau1, cheapest n_spd by ranking) drop their sync
    outright; SB blocks (tau1 < sens <= tau2) keep it at `sb_level`; ESB
    blocks (sens > tau2) keep `esb_level` (exact by default).  Returns
    an SPDPlanConfig with the CommPolicy attached."""
    cats = S.classify(np.asarray(sens), tau1, tau2)
    budget = set(int(i) for i in list(ranking)[:n_spd])
    drop, levels = [], []
    for i, cat in enumerate(cats):
        if cat == S.ISB and i in budget:
            drop.append(True)
            levels.append("exact")
        else:
            drop.append(False)
            levels.append(sb_level if cat in (S.ISB, S.SB) else esb_level)
    return SPDPlanConfig(tuple(drop),
                         CommPolicy(tuple(levels), logits_mode=logits))


def assign_comm_policy(cfg: ModelConfig, canonical: dict, calib_batches,
                       tp: int, *, n_spd: int, tau1: float, tau2: float,
                       sb_level: str = "quant8", esb_level: str = "exact",
                       logits: str = "exact", q_chunk: int = 1024,
                       groups=None):
    """Measure block sensitivity and give each block the cheapest sync it
    can afford: drop / quant8 / quant4 / exact.  Zero-shot.  `groups`:
    this rank's launch.dist.TPGroups on the shard backend.

    Returns (plan_with_comm, SensitivityResult)."""
    if not cfg.spd_applicable:
        plan = SPDPlanConfig.none(cfg.n_layers).with_comm(
            CommPolicy.uniform(cfg.n_layers, sb_level, logits=logits))
        return plan, S.SensitivityResult(
            np.zeros(cfg.n_layers + 1), np.zeros(cfg.n_layers),
            np.arange(cfg.n_layers))
    res, _ = sweep_sensitivity(cfg, canonical, calib_batches, tp,
                               q_chunk=q_chunk, groups=groups)
    plan = comm_policy_from_sensitivity(
        res.sensitivity, res.ranking, cfg.n_layers, n_spd=n_spd,
        tau1=tau1, tau2=tau2, sb_level=sb_level, esb_level=esb_level,
        logits=logits)
    return plan, res
