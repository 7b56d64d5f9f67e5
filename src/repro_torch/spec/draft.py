"""Draft side of self-speculative decoding (port of repro/spec/draft.py):
the target model under a cheaper CommPolicy.

The draft reuses the target's canonical parameters under an aggressive
sync-point policy and runs its own dense per-slot KV cache; no extra
weights.  Presets (`DRAFT_PRESETS`):

  all-drop     every attention-output sync dropped; the MLP syncs stay
               exact.
  drop+quant4  every block dropped, its surviving MLP sync and the
               logits all-gather at int4.
  tiered       Algorithm 1's ISB/SB/ESB tiers as a draft policy
               (core.spd.comm_policy_from_sensitivity): insensitive
               blocks drop, sensitive ones keep an int8 or exact sync.
               Needs a sensitivity profile (LLM.enable_spec runs the
               sweep from calibration batches).
  calibrated   spec/calibrate.py searches drop/quant candidates for the
               cheapest one whose measured acceptance on held-out
               prompts clears a target.

`Drafter` is the runtime half: it owns the draft engine, its placed
params and a dense per-slot cache, follows the committed stream, and
proposes k tokens per round for the target's verify forward
(api/scheduler.py drives it; the acceptance math is spec/verify.py).
Its counters are plain attributes (`adoptions`, `prefills`, `rounds`)
and, with a recorder wired in by `Scheduler.set_obs`, the reference's
`spec_draft_adoptions_total`, `spec_draft_prefills_total` and
`spec_draft_rounds_total`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.obs.recorder import NULL_RECORDER

__all__ = ["SpecConfig", "SpecError", "SpecState", "DRAFT_PRESETS",
           "derive_draft_plan", "Drafter", "spec_supported"]

DRAFT_PRESETS = ("all-drop", "drop+quant4", "tiered", "calibrated")


class SpecError(ValueError):
    """Speculative decoding misconfiguration."""


@dataclass(frozen=True)
class SpecConfig:
    """How to speculate.

    k        drafted tokens per verify round (the verify forward scores
             k+1 positions); with `adaptive=True` the initial per-request
             budget.
    draft    one of DRAFT_PRESETS, or an SPDPlanConfig used as the draft
             plan directly.
    n_spd / tau1 / tau2
             Algorithm 1's tiering knobs for the "tiered" preset (n_spd
             defaults to every layer being drop-eligible).
    adaptive / k_min / k_max
             per-request adaptive budget: k grows by one after a fully
             accepted round (cap k_max, default k) and shrinks after two
             consecutive zero-acceptance rounds (floor k_min).  The
             round's verify width is the largest budget; a row with a
             smaller one clamps acceptance to its own first k_b drafts.
    tree_width
             1 = chain; w > 1 also verifies the draft's top-2..top-w
             candidates at the first position as depth-1 branches in the
             same forward.
    """

    k: int = 4
    draft: object = "all-drop"
    n_spd: Optional[int] = None
    tau1: float = 0.05
    tau2: float = 0.5
    adaptive: bool = False
    k_min: int = 1
    k_max: Optional[int] = None
    tree_width: int = 1

    def __post_init__(self):
        if self.k < 1:
            raise SpecError(f"spec k must be >= 1, got {self.k}")
        if (not isinstance(self.draft, SPDPlanConfig)
                and self.draft not in DRAFT_PRESETS):
            raise SpecError(f"draft must be an SPDPlanConfig or one of "
                            f"{DRAFT_PRESETS}, got {self.draft!r}")
        if self.k_min < 1:
            raise SpecError(f"spec k_min must be >= 1, got {self.k_min}")
        k_max = self.k if self.k_max is None else self.k_max
        if k_max < self.k_min:
            raise SpecError(
                f"spec k_max={k_max} < k_min={self.k_min}: the adaptive "
                "budget window is empty")
        if not (self.k_min <= self.k <= k_max):
            raise SpecError(
                f"spec k={self.k} outside the adaptive window "
                f"[{self.k_min}, {k_max}]")
        if self.tree_width < 1:
            raise SpecError(
                f"spec tree_width must be >= 1, got {self.tree_width}")
        if self.tree_width > self.k_min + 1:
            # a round's chunk is [cur, chain(k_b), alts(w-1)]: once k_b
            # falls to k_min the alternatives must not outnumber the
            # chain positions they rescue
            raise SpecError(
                f"spec tree_width={self.tree_width} exceeds the verify "
                f"chunk capacity k_min+1={self.k_min + 1} (alternatives "
                "may not outnumber chain positions)")

    @property
    def k_cap(self) -> int:
        """Effective upper draft budget (k_max defaulting to k)."""
        return self.k if self.k_max is None else self.k_max


def spec_supported(cfg: ModelConfig) -> bool:
    from repro_torch.core import model as M
    return M.supports_spec_decode(cfg)


def derive_draft_plan(cfg: ModelConfig, spec: SpecConfig, *,
                      sensitivity=None, ranking=None,
                      policy: Optional[SPDPlanConfig] = None
                      ) -> SPDPlanConfig:
    """The draft plan for `spec` on `cfg` (see the module docstring).
    "tiered" needs Algorithm 1's `sensitivity` and `ranking`;
    "calibrated" the measured `policy` from spec/calibrate.py.  Raises
    SpecError where the arch cannot self-draft (no droppable sync, or no
    multi-token verify forward)."""
    if not spec_supported(cfg):
        raise SpecError(
            f"{cfg.name}: self-speculative decoding needs an SPD-droppable "
            "sync point and the cache-extension verify forward "
            "(full-causal GQA stacks)")
    n = cfg.n_layers
    if isinstance(spec.draft, SPDPlanConfig):
        if len(spec.draft.drop_mask) != n:
            raise SpecError(f"draft plan covers {len(spec.draft.drop_mask)} "
                            f"layers, model has {n}")
        return spec.draft
    if spec.draft == "calibrated":
        if policy is None:
            raise SpecError(
                "the 'calibrated' draft preset needs a measured policy: "
                "call LLM.enable_spec(spec, calib_batches=...) (or "
                "calib_prompts=...) so spec/calibrate.py can search one, "
                "or pass an explicit SPDPlanConfig as spec.draft")
        if len(policy.drop_mask) != n:
            raise SpecError(f"calibrated policy covers "
                            f"{len(policy.drop_mask)} layers, model has {n}")
        return policy
    if spec.draft == "all-drop":
        return SPDPlanConfig.full(n)
    if spec.draft == "drop+quant4":
        return SPDPlanConfig.from_modes(("drop+quant4",) * n, logits="quant4")
    if sensitivity is None or ranking is None:
        raise SpecError(
            "the 'tiered' draft preset needs a measured sensitivity "
            "profile: call LLM.enable_spec(spec, calib_batches) or pass "
            "sensitivity/ranking from core.sensitivity.measure_sensitivity")
    from repro_torch.core.spd import comm_policy_from_sensitivity
    n_spd = n if spec.n_spd is None else spec.n_spd
    return comm_policy_from_sensitivity(
        np.asarray(sensitivity), ranking, n, n_spd=n_spd,
        tau1=spec.tau1, tau2=spec.tau2, sb_level="quant8",
        esb_level="exact", logits="exact")


@dataclass
class SpecState:
    """What `api.scheduler.Scheduler(spec=...)` takes: the budget knobs
    and a Drafter.  `k` is the fixed round budget, or each request's
    initial budget when `adaptive`; `tree_width` > 1 makes rounds
    depth-1 tree verifications."""

    k: int
    drafter: object
    adaptive: bool = False
    k_min: int = 1
    k_max: Optional[int] = None
    tree_width: int = 1

    @property
    def k_cap(self) -> int:
        return self.k if self.k_max is None else self.k_max


class Drafter:
    """Per-scheduler draft runtime: draft engine, params and dense cache.

    Invariant the scheduler keeps: for every active slot b, `pos[b]` (the
    next cache position the draft writes) trails the target's position by
    at most one token, so a round's catch-up context is 1 or 2 tokens
    (re-processing a written position is idempotent)."""

    # the recorder Scheduler.set_obs wires in
    obs = NULL_RECORDER

    def __init__(self, engine, params, max_batch: int, cache_len: int,
                 prefill_chunk: Optional[int] = None):
        self.engine = engine
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.prefill_chunk = prefill_chunk
        self.caches = engine.blank_caches(max_batch, cache_len)
        self.pos = np.zeros(max_batch, np.int64)
        self.adoptions = 0          # admissions whose target KV was restacked
        self.prefills = 0           # admissions the draft prefilled itself
        self.rounds = 0             # draft calls

    def insert(self, b: int, toks, caches1=None):
        """Draft-prefill one admitted request into slot b.

        Given the scheduler's own admission prefill (`caches1`, dense,
        under the TARGET plan), the drafter adopts it: the weights are
        shared and the per-layer KV layout is the same under both plans,
        only the stacked segmentation differs, so the target's prompt KV
        restacks onto the draft plan's segments.  A warm paged admission
        has no dense caches1, and the draft prefills the prompt itself.
        (The reference also falls back to its own prefill where the
        layouts cannot restack; every arch that can self-draft here is a
        homogeneous GQA stack, so they always do.)"""
        toks = np.asarray(toks, np.int64)
        s = len(toks)
        if caches1 is not None:
            c1 = self._resegment(caches1)
            self.adoptions += 1
            self.obs.inc("spec_draft_adoptions_total")
        else:
            from repro_torch.runtime.forward import bucketed_prefill
            _, c1 = bucketed_prefill(self.engine, self.params, toks, s,
                                     self.cache_len, self.prefill_chunk)
            self.prefills += 1
            self.obs.inc("spec_draft_prefills_total")
        self.caches = self.engine.insert_slot(self.caches, c1, b)
        self.pos[b] = s

    def _resegment(self, caches1):
        """Restack a target-plan cache tree (a list of per-segment
        {"k", "v"} trees, batch 1) onto the draft plan's segments:
        concatenate every leaf along the layer axis and split it at the
        draft's segment lengths.  The sim layout's leaves are (tp,
        layers, batch, ...), so the layer axis is the backend's cache
        batch axis - 1, as in the reference."""
        from repro_torch.core.layer_kinds import plan_segments
        axis = self.engine.backend.cache_batch_axis - 1
        cat = {name: torch.cat([seg[name] for seg in caches1], dim=axis)
               for name in caches1[0]}
        out, off = [], 0
        for (_, ln, _, _) in plan_segments(self.engine.cfg,
                                           self.engine.plan.drop_mask,
                                           self.engine.plan.qmodes):
            out.append({name: leaf.narrow(axis, off, ln)
                        for name, leaf in cat.items()})
            off += ln
        return out

    def draft(self, ctx, start, k: int, *, greedy: bool = False,
              tree_width: int = 1, sampling=None):
        """Propose k tokens per row (runtime/forward.draft_step: the
        catch-up verify, then k-1 one-token steps).

        ctx (B, C): committed tokens ending at each row's current token;
        start (B,): absolute position of ctx[:, 0].  greedy=True (every
        active request greedy) drafts by argmax, with tree_width > 1 also
        returning the first position's runners-up.  Otherwise `sampling`
        is (temperature, top_k, top_p, generators) with generators[i] the
        rows' generators of draw i (runtime.sampling.draft_generators):
        drafts are drawn on the device and the full per-draft logits come
        back so the scheduler can rebuild each draw's distribution.

        Returns (draft_toks (B, k) int64, draft_logits (B, k, V) fp32 or
        None when greedy, alts (B, tree_width-1) or None when
        tree_width = 1), numpy."""
        self.rounds += 1
        self.obs.inc("spec_draft_rounds_total")
        ctx = np.asarray(ctx, np.int64)
        start = np.asarray(start, np.int64)
        if greedy and tree_width > 1:
            toks, alts, self.caches = self.engine.draft_tree(
                self.params, ctx, start, self.caches, k=k, width=tree_width)
            return toks.cpu().numpy(), None, alts.cpu().numpy()
        if greedy:
            toks, self.caches = self.engine.draft(self.params, ctx, start,
                                                  self.caches, k=k)
            return toks.cpu().numpy(), None, None
        t, top_k, top_p, gens = sampling
        toks, logits, self.caches = self.engine.draft_sampled(
            self.params, ctx, start, self.caches, t, top_k, top_p, gens, k=k)
        toks = toks.cpu().numpy()
        logits = logits.float().cpu().numpy()
        alts = None
        if tree_width > 1:
            # the host-side mirror of the tree draft's top-k: the sampled
            # path already has the full logits
            from repro_torch.spec.verify import alt_candidates
            alts = np.stack([
                np.asarray(alt_candidates(logits[b, 0], toks[b, 0],
                                          tree_width), np.int64)
                for b in range(toks.shape[0])])
        return toks, logits, alts

