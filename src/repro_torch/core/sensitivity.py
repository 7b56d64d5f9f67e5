"""Block-wise sync-sensitivity identification — the paper's §4.2.1 / Fig 4.

Sensitivity of block i = ppl(SPD on blocks i..L-1) − ppl(SPD on i+1..L-1)
on calibration data (suffix plans isolate block i's effect while keeping
its input numerically identical to TP — App. C.1).

Port of repro/core/sensitivity.py.  The sweep runs on one placement
under the no-SPD plan with the per-layer drop flags given to each
evaluation (the reference's DUAL mode), so the L+1 evaluations share the
placed parameters: nothing is re-stacked or re-split per evaluation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import simtp

ISB, SB, ESB = "ISB", "SB", "ESB"


@dataclass
class SensitivityResult:
    ppl_suffix: np.ndarray    # (L+1,) ppl with SPD on blocks i..L-1
    sensitivity: np.ndarray   # (L,)   relative ppl increase caused by block i
    ranking: np.ndarray       # (L,)   block indices, ascending sensitivity


def suffix_flags(n_layers: int, i: int) -> np.ndarray:
    """SPD applied to blocks i..L-1 (i == L => no SPD)."""
    f = np.zeros(n_layers, np.float32)
    f[i:] = 1.0
    return f


def measure_sensitivity(cfg: ModelConfig, split_params, calib_batches,
                        tp: int, *, q_chunk: int = 1024) -> SensitivityResult:
    n = cfg.n_layers
    if not cfg.spd_applicable:
        z = np.zeros(n)
        return SensitivityResult(np.zeros(n + 1), z, np.arange(n))
    plan = SPDPlanConfig.none(n)
    loss_fn = simtp.make_loss_fn(cfg, plan, tp, q_chunk=q_chunk, dual=True)
    ppls = np.empty(n + 1)
    for i in range(n + 1):
        flags = suffix_flags(n, i)
        ppls[i] = simtp.eval_ppl(loss_fn, split_params, calib_batches,
                                 dual_flags=flags)
    # sens[i] = ppl(SPD i..L-1) - ppl(SPD i+1..L-1)
    sens = ppls[:-1] - ppls[1:]
    ranking = np.argsort(sens, kind="stable")
    return SensitivityResult(ppls, sens, ranking)


def classify(sens: np.ndarray, tau1: float, tau2: float) -> List[str]:
    """Algorithm 1's categories per block."""
    out = []
    for s in sens:
        if s <= tau1:
            out.append(ISB)
        elif s <= tau2:
            out.append(SB)
        else:
            out.append(ESB)
    return out


def plan_from_ranking(res: SensitivityResult, n_spd: int,
                      n_layers: int) -> SPDPlanConfig:
    return SPDPlanConfig.from_ranking(res.ranking, n_spd, n_layers)


def tier_modes(sens: np.ndarray, tau1: float, tau2: float, *,
               isb: str, sb: str, esb: str) -> tuple:
    """Per-layer block comm modes from Algorithm-1 tiers: ISB blocks get
    the `isb` level, SB `sb`, ESB `esb` (levels are SPDPlanConfig.
    from_modes block strings: "exact" | "quant8" | "quant4" | "drop" |
    "drop+quant4" ...).  The reference's draft-policy calibration
    search (spec/calibrate.py) uses this to turn one measured
    sensitivity profile into a family of candidate draft CommPolicies."""
    table = {ISB: isb, SB: sb, ESB: esb}
    return tuple(table[c] for c in classify(sens, tau1, tau2))
