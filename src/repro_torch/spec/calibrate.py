"""Draft-policy calibration for self-speculative decoding (port of
repro/spec/calibrate.py).

A fixed draft preset guesses a CommPolicy; what matters is the measured
acceptance per unit of wire.  Candidates come from the SPD knob itself:
uniform drop/quant levels, plus Algorithm 1's sensitivity tiers mapped
to level mixes (core.sensitivity.tier_modes), every one cheaper than
exact syncs.  Acceptance is measured by greedy-serving a few held-out
prompts through a throwaway speculative Scheduler per candidate and
reading its `spec_acceptance`.

`calibrate_draft` walks the candidates cheapest wire first and stops at
the first whose acceptance clears `target`, else takes the best one.
Results are cached per (arch, engine kind, tp) for the process; pass
`force=True` after the weights change.  Each candidate's draft placement
is freed before the next is placed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.base import SPDPlanConfig
from repro_torch.spec.draft import SpecError

__all__ = ["CalibrationResult", "candidate_policies", "calibrate_draft",
           "clear_cache"]

# heuristic per-block wire cost of each from_modes level, relative to
# exact's two full syncs (attn + MLP) — ORDERING only; the bench prices
# candidates with the real comm ledger (benchmarks/bench_spec.py)
_MODE_COST = {
    "drop": 0.50,          # attn sync gone, MLP sync exact
    "drop+quant4": 0.13,
    "drop+quant8": 0.25,
    "quant4": 0.25,
    "quant8": 0.50,
    "exact": 1.00,
}
_LOGITS_COST = {"quant4": 0.25, "quant8": 0.50, "exact": 1.00}


def _policy_cost(name: str, plan: SPDPlanConfig) -> float:
    modes = plan.qmodes or ("exact",) * len(plan.drop_mask)
    c = 0.0
    for dropped, lvl in zip(plan.drop_mask, modes):
        m = (f"drop+{lvl}" if dropped and lvl != "exact"
             else "drop" if dropped else lvl)
        c += _MODE_COST.get(m, 1.0)
    c /= max(len(plan.drop_mask), 1)
    logits = getattr(plan.comm, "logits_mode", "exact") if plan.comm \
        else "exact"
    return c + 0.5 * _LOGITS_COST.get(logits, 1.0)


def candidate_policies(cfg, *, sensitivity=None, tau1: float = 0.05,
                       tau2: float = 0.5
                       ) -> List[Tuple[str, SPDPlanConfig]]:
    """The calibration search space, ordered cheapest wire first.

    Uniform drop/quant ladders always; with a measured `sensitivity`
    profile, Algorithm-1 tier mixes too (insensitive blocks drop,
    sensitive ones keep a quantized sync — the paper's §4.2 idea turned
    into a draft policy).  Every candidate is strictly cheaper than
    exact syncs, so whatever wins, drafting saves wire."""
    n = cfg.n_layers
    cands: List[Tuple[str, SPDPlanConfig]] = [
        ("all-drop", SPDPlanConfig.full(n)),
        ("drop+quant4",
         SPDPlanConfig.from_modes(("drop+quant4",) * n, logits="quant4")),
        ("quant4",
         SPDPlanConfig.from_modes(("quant4",) * n, logits="quant4")),
        ("quant4+logits8",
         SPDPlanConfig.from_modes(("quant4",) * n, logits="quant8")),
        ("quant8",
         SPDPlanConfig.from_modes(("quant8",) * n, logits="quant8")),
    ]
    if sensitivity is not None:
        from repro_torch.core.sensitivity import tier_modes
        sens = np.asarray(sensitivity)
        tiers = [
            ("tiered-drop/q4/q8",
             tier_modes(sens, tau1, tau2, isb="drop", sb="quant4",
                        esb="quant8"), "quant8"),
            ("tiered-drop/q8/exact",
             tier_modes(sens, tau1, tau2, isb="drop", sb="quant8",
                        esb="exact"), "quant8"),
            ("tiered-q4/q8/exact",
             tier_modes(sens, tau1, tau2, isb="quant4", sb="quant8",
                        esb="exact"), "quant8"),
        ]
        cands += [(nm, SPDPlanConfig.from_modes(modes, logits=lg))
                  for nm, modes, lg in tiers]
    cands.sort(key=lambda it: _policy_cost(*it))
    return cands


@dataclass(frozen=True)
class CalibrationResult:
    """Outcome of one draft-policy search."""

    policy: SPDPlanConfig          # the winning draft plan
    name: str                      # its candidate name
    acceptance: float              # measured greedy acceptance
    tokens_per_step: float         # measured committed tokens / round
    trials: Tuple[Tuple[str, float, float], ...]   # every measured
    #                                (name, acceptance, tokens_per_step)


# process-local result cache: calibration is a function of the weights,
# which live as long as the process for every current entry point
_CACHE: Dict[tuple, CalibrationResult] = {}


def clear_cache():
    _CACHE.clear()


def _measure(llm, plan: SPDPlanConfig, prompts, *, k: int,
             max_new: int) -> Tuple[float, float]:
    """Greedy-serve `prompts` through a throwaway speculative scheduler
    whose drafter runs under `plan`; returns (acceptance, tokens/step).
    The target engine and params are reused; the draft engine and its
    placement are fresh, and freed on return."""
    from repro_torch.api.scheduler import CacheConfig, Request, Scheduler
    from repro_torch.spec.draft import Drafter, SpecState

    engine = llm._make_engine(plan)
    # a slot a prompt, rounded up to whole data ranks (on `shard`)
    dpn = llm.engine.backend.dp_total
    slots = -(-min(llm.cache.max_batch, max(len(prompts), 1)) // dpn) * dpn
    cc = CacheConfig(cache_len=llm.cache.cache_len, max_batch=slots)
    drafter = Drafter(engine, llm._place(engine), cc.max_batch,
                      cc.cache_len)
    sched = Scheduler(llm.engine, llm.params, cc,
                      spec=SpecState(k=k, drafter=drafter))
    for i, p in enumerate(prompts):
        sched.submit(Request(uid=i, prompt=np.asarray(p, np.int64),
                             max_new=max_new))
    sched.run()
    return float(sched.spec_acceptance), float(sched.spec_tokens_per_step)


def calibrate_draft(llm, prompts: Sequence, *, k: int = 3,
                    target: float = 0.45, max_new: int = 16,
                    sensitivity=None, tau1: float = 0.05,
                    tau2: float = 0.5,
                    candidates: Optional[List[Tuple[str, SPDPlanConfig]]]
                    = None, force: bool = False) -> CalibrationResult:
    """Search draft CommPolicies for `llm`'s weights (module docstring).

    prompts   held-out token sequences (a few short ones suffice: each
              candidate greedy-serves them once and the acceptance
              counter aggregates every verify round)
    target    acceptance bar: the CHEAPEST candidate measuring at or
              above it wins (candidates walk cheapest-wire-first); if
              none reaches it the best-measuring one wins
    candidates  override the search space (name, plan) — default
              `candidate_policies` (tier mixes included iff
              `sensitivity` is given)

    Cached per (arch, engine kind, tp) unless `force`."""
    if not len(prompts):
        raise SpecError("calibrate_draft needs at least one held-out "
                        "prompt (got none)")
    key = (llm.cfg.name, llm.engine_kind, llm.tp)
    if not force and key in _CACHE:
        return _CACHE[key]
    if candidates is None:
        candidates = candidate_policies(llm.cfg, sensitivity=sensitivity,
                                        tau1=tau1, tau2=tau2)
    trials: List[Tuple[str, float, float]] = []
    best = None
    for name, plan in candidates:
        acc, tps = _measure(llm, plan, prompts, k=k, max_new=max_new)
        trials.append((name, acc, tps))
        if best is None or acc > best[1]:
            best = (name, acc, tps, plan)
        if acc >= target:
            # cheapest-first ordering: the first qualifying candidate
            # IS the cheapest qualifying candidate — stop searching
            best = (name, acc, tps, plan)
            break
    name, acc, tps, plan = best
    res = CalibrationResult(policy=plan, name=name, acceptance=acc,
                            tokens_per_step=tps, trials=tuple(trials))
    _CACHE[key] = res
    return res
