"""Algorithm 1: sensitivity-ranked, multi-tier SPD application (port of
repro/core/spd.py, its zero-shot half).

Given canonical params, a calibration set, a TP degree and a budget
N_spd, the reference:

  1. measures block-wise sync sensitivity (core/sensitivity.py),
  2. ranks blocks ascending, takes the first N_spd,
  3. classifies each into ISB / SB / ESB via (τ1, τ2),
  4. ISB  -> zero-shot drop,
     SB   -> SPD-aware block-to-block distillation (core/distill.py),
     ESB  -> head-grouping init (core/grouping.py) + distillation,
  5. returns deployment-ready PADDED per-layer params + the plan.

Steps 1-3, the zero-shot drop and the sensitivity-tiered comm policy
(drop / quant8 / exact per block) run here, forward only.  Distillation
and head grouping need gradients and come with the training slice
(ROADMAP A2): `apply_spd` raises NotImplementedError exactly where the
reference would start them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.config.base import CommPolicy, ModelConfig, SPDPlanConfig
from repro_torch.core import model as M
from repro_torch.core import sensitivity as S
from repro_torch.core import simtp


@dataclass
class SPDReport:
    sensitivity: np.ndarray
    ppl_suffix: np.ndarray
    ranking: np.ndarray
    categories: List[str]              # per chosen block (ranking order)
    chosen: List[int]
    distill_losses: Dict[int, List[float]] = field(default_factory=dict)
    grouping: Dict[int, object] = field(default_factory=dict)


def sweep_sensitivity(cfg: ModelConfig, canonical: dict, calib_batches,
                      tp: int, *, q_chunk: int = 1024):
    """Place the canonical params once under the no-SPD plan and run
    Algorithm 1's block sweep.  Returns (SensitivityResult, padded
    params); the placement is freed on return."""
    plan0 = SPDPlanConfig.none(cfg.n_layers)
    padded = M.pad_model(canonical, cfg, tp)
    split0 = simtp.split_padded(padded, cfg, plan0, tp)
    res = S.measure_sensitivity(cfg, split0, calib_batches, tp,
                                q_chunk=q_chunk)
    return res, padded


def apply_spd(cfg: ModelConfig, canonical: dict, calib_batches, tp: int, *,
              n_spd: int, tau1: float, tau2: float, lr: float = 5e-5,
              epochs: int = 10, strategies=("ZS", "B2B", "HG"),
              q_chunk: int = 1024):
    """Returns (padded_params, plan, report) wherever the reference
    returns without training: every chosen block is ISB, or "B2B" is not
    among `strategies`.  Elsewhere it raises NotImplementedError (B2B
    distillation and head grouping come with the training slice).  `lr`
    and `epochs` are the distillation's, kept for the signature."""
    if not cfg.spd_applicable:
        padded = M.pad_model(canonical, cfg, tp)
        plan = SPDPlanConfig.none(cfg.n_layers)
        rep = SPDReport(np.zeros(cfg.n_layers), np.zeros(cfg.n_layers + 1),
                        np.arange(cfg.n_layers), [], [])
        return padded, plan, rep

    res, padded = sweep_sensitivity(cfg, canonical, calib_batches, tp,
                                    q_chunk=q_chunk)
    chosen = [int(i) for i in res.ranking[:n_spd]]
    cats = S.classify(res.sensitivity[chosen], tau1, tau2)
    plan = SPDPlanConfig.from_ranking(res.ranking, n_spd, cfg.n_layers)
    report = SPDReport(res.sensitivity, res.ppl_suffix, res.ranking,
                       cats, chosen)
    need_recovery = [i for i, c in zip(chosen, cats) if c != S.ISB]
    if not need_recovery or "B2B" not in strategies:
        return padded, plan, report
    raise NotImplementedError(
        f"blocks {need_recovery} are SB/ESB and strategies {strategies} "
        "ask for block-to-block distillation (and head grouping for ESB): "
        "training is not ported yet (ROADMAP A2, the training slice); "
        "pass strategies=('ZS',) for the zero-shot plan")


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
                       logits: str = "exact", q_chunk: int = 1024):
    """Measure block sensitivity and give each block the cheapest sync it
    can afford: drop / quant8 / quant4 / exact.  Zero-shot.

    Returns (plan_with_comm, SensitivityResult)."""
    if not cfg.spd_applicable:
        plan = SPDPlanConfig.none(cfg.n_layers).with_comm(
            CommPolicy.uniform(cfg.n_layers, sb_level, logits=logits))
        return plan, S.SensitivityResult(
            np.zeros(cfg.n_layers + 1), np.zeros(cfg.n_layers),
            np.arange(cfg.n_layers))
    res, _ = sweep_sensitivity(cfg, canonical, calib_batches, tp,
                               q_chunk=q_chunk)
    plan = comm_policy_from_sensitivity(
        res.sensitivity, res.ranking, cfg.n_layers, n_spd=n_spd,
        tau1=tau1, tau2=tau2, sb_level=sb_level, esb_level=esb_level,
        logits=logits)
    return plan, res
