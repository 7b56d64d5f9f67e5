"""`repro_torch.spec` -- self-speculative decoding with no extra weights
(port of repro/spec).

The draft is the target's own parameters under an aggressive SPD
`CommPolicy` (every attention sync dropped, or dropped and quantized);
the exact model scores k drafted tokens in one multi-token forward, with
greedy acceptance (the same tokens as plain greedy) or rejection
sampling (the target's distribution under `SamplingParams`).  The
scheduler loop lives in `repro_torch.api.scheduler`.

    from repro_torch.api import LLM, SamplingParams
    from repro_torch.spec import SpecConfig
    llm = LLM.load("llama2-7b", tp=2, spd=0.25, comm="quant8",
                   spec=SpecConfig(k=4, draft="all-drop"))
    outs = llm.generate(prompts, SamplingParams(max_new=16))
"""
from repro_torch.spec.calibrate import (CalibrationResult, calibrate_draft,
                                        candidate_policies)
from repro_torch.spec.draft import (DRAFT_PRESETS, Drafter, SpecConfig,
                                    SpecError, SpecState, derive_draft_plan,
                                    spec_supported)
from repro_torch.spec.verify import (accept_speculative, filtered_probs,
                                     spec_rng, tree_layout)

__all__ = [
    "SpecConfig", "SpecError", "SpecState", "DRAFT_PRESETS", "Drafter",
    "derive_draft_plan", "spec_supported",
    "accept_speculative", "filtered_probs", "spec_rng", "tree_layout",
    "CalibrationResult", "calibrate_draft", "candidate_policies",
]
