"""The port's speculative serving surface on the CPU (reduced SmolLM,
tp=2, fp32): the drafter's adoption of the admission prefill, tree
alternatives, the tiered and calibrated drafts (the calibrated search
against the reference's), sampled speculation, `generate_stream`, and
`stop_token_ids` on plain decoding and inside a speculative round.
Tokens and counters are compared exactly; acceptances to 1e-12."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import LLM as RLLM  # noqa: E402
from repro.spec import calibrate as RCAL  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.data import calibration_batches  # noqa: E402
from repro_torch.spec import (SpecConfig, SpecError,  # noqa: E402
                              calibrate_draft, candidate_policies)
from repro_torch.spec import calibrate as CAL  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


MAXNEW = 10
KW = dict(tp=2, dtype="float32", device="cpu", cache_len=64, max_batch=3,
          q_chunk=64)
ACC_ATOL = 1e-12


@pytest.fixture(scope="module")
def base():
    """A plain port LLM on seed-0 reference parameters, five prompts and
    their plain greedy tokens."""
    ref = RLLM.load("smollm-360m-reduced", engine="sim", tp=2,
                    dtype="float32", cache_len=64, max_batch=3, q_chunk=64)
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    llm = LLM.load(cfg, params=from_reference(
        jax.tree.map(np.asarray, ref.canonical), cfg), **KW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(m))
               for m in rng.integers(3, 12, 5)]
    sp = SamplingParams(max_new=MAXNEW)
    plain = [o.token_ids for o in llm.generate(prompts, sp)]
    return dict(ref=ref, llm=llm, cfg=cfg, prompts=prompts, sp=sp,
                plain=plain)


def _spec(base, spec, **kw):
    return LLM.load(base["cfg"], params=base["llm"].canonical, spec=spec,
                    **dict(KW, **kw))


def test_drafter_adopts_admission_prefill(base):
    """Cold admissions hand the target's prompt KV to the drafter, which
    restacks it onto the draft plan's segments instead of prefilling
    (the same tokens, no draft prefill); a warm paged admission has no
    dense KV, so the drafter prefills itself."""
    llm = _spec(base, SpecConfig(k=3))
    outs = llm.generate(base["prompts"], base["sp"])
    assert [o.token_ids for o in outs] == base["plain"]
    dr = llm.serve().spec.drafter
    assert dr.adoptions == len(base["prompts"]) and dr.prefills == 0
    assert dr.rounds == llm.serve().spec_rounds
    paged = _spec(base, SpecConfig(k=3), page_size=4, num_pages=30)
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, base["cfg"].vocab_size, 12)
    pair = [np.concatenate([prefix, rng.integers(0, 500, n)])
            for n in (3, 5)]
    sp = SamplingParams(max_new=6)
    got = [paged.generate([p], sp)[0].token_ids for p in pair]
    assert got == [o.token_ids for o in base["llm"].generate(pair, sp)]
    sched = paged.serve()
    assert sched.kv.prefix_hits == 1
    assert sched.spec.drafter.prefills == 1
    assert sched.spec.drafter.adoptions == 1


def test_tree_alt_commits_fire_on_all_drop(base):
    """Mirrors tests/test_spec.py::test_tree_alt_commits_fire_on_all_drop:
    some first-position rejections recover through the alternative, and
    the tokens stay the plain ones."""
    llm = _spec(base, SpecConfig(k=3, adaptive=True, k_min=1, k_max=5,
                                 tree_width=2))
    outs = llm.generate(base["prompts"], base["sp"])
    assert [o.token_ids for o in outs] == base["plain"]
    assert llm.serve().spec_alt_commits > 0


def test_tiered_draft_accepts_at_least_all_drop(base):
    """A draft that keeps the sensitive blocks' syncs (Algorithm 1's
    tiers, from the port's own sweep) is accepted at least as often as
    dropping every sync, on the same prompts."""
    prompts = [np.random.default_rng(0).integers(0, 512, 9)
               for _ in range(1)] + base["prompts"]
    sp = SamplingParams(max_new=12)

    def rate(llm):
        outs = llm.generate(prompts, sp)
        assert [o.token_ids for o in outs] == [
            o.token_ids for o in base["llm"].generate(prompts, sp)]
        return llm.serve().spec_acceptance

    r_all = rate(_spec(base, SpecConfig(k=3, draft="all-drop")))
    tiered = _spec(base, None)
    calib = calibration_batches(base["cfg"].vocab_size, 4, 32)
    tiered.enable_spec(SpecConfig(k=3, draft="tiered", n_spd=2, tau1=0.05,
                                  tau2=0.5), calib)
    assert tiered.draft_plan.n_dropped < base["cfg"].n_layers
    r_tiered = rate(tiered)
    assert r_tiered >= r_all, (r_tiered, r_all)


def test_calibrated_draft_search_equals_reference(base):
    """calibrate_draft over the two cheapest candidates picks the
    reference's candidate with the same measured acceptance and tokens
    per step, caches per (arch, engine, tp), and serves as the
    "calibrated" preset; no prompts is a SpecError."""
    llm, ref = base["llm"], base["ref"]
    cands = candidate_policies(llm.cfg)
    rcands = RCAL.candidate_policies(ref.cfg)
    prompts = [np.asarray(p, np.int32) for p in base["prompts"][:2]]
    CAL.clear_cache()
    RCAL.clear_cache()
    try:
        res = calibrate_draft(llm, prompts, k=3, target=0.01,
                              candidates=cands[:2], max_new=8)
        want = RCAL.calibrate_draft(ref, prompts, k=3, target=0.01,
                                    candidates=rcands[:2], max_new=8)
        assert res.name == want.name
        assert [t[0] for t in res.trials] == [t[0] for t in want.trials]
        np.testing.assert_allclose([t[1:] for t in res.trials],
                                   [t[1:] for t in want.trials], rtol=0,
                                   atol=ACC_ATOL)
        assert calibrate_draft(llm, prompts, k=3,
                               candidates=cands[:2]) is res
        cal = _spec(base, None)
        cal.enable_spec(SpecConfig(k=3, draft="calibrated"),
                        calib_prompts=prompts)
        assert cal.spec_calibration is res and cal.draft_plan is res.policy
        assert len(cal.generate(prompts[:1], SamplingParams(
            max_new=4))[0].token_ids) == 4
        with pytest.raises(SpecError):
            calibrate_draft(llm, [], k=3)
    finally:
        CAL.clear_cache()
        RCAL.clear_cache()


def test_calib_prompts_take_calibration_batches(base):
    """The "calibrated" preset's held-out prompts sliced from
    `calibration_batches` (dicts of token arrays): the first row of each
    of the first three batches, trimmed to min(16, cache_len // 4).  The
    reference's `_calib_prompts` takes each batch as an array and raises
    on its own batches (ROADMAP C6)."""
    calib = calibration_batches(base["cfg"].vocab_size, 4, 32, batch=1)
    got = base["llm"]._calib_prompts(calib)
    assert len(got) == 3
    for p, b in zip(got, calib):
        np.testing.assert_array_equal(p, np.asarray(b["tokens"])[0, :16])
    with pytest.raises(TypeError):
        base["ref"]._calib_prompts(calib)


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_spec_respects_budget_and_seed(base, paged):
    """Sampled speculation (rejection scheme, drafts drawn on the
    device): every request gets max_new tokens in the vocabulary, and
    the same seeds give the same tokens on a fresh scheduler."""
    kw = dict(page_size=4, num_pages=14) if paged else {}
    llm = _spec(base, SpecConfig(k=3, tree_width=2), **kw)
    sp = SamplingParams(temperature=0.9, top_k=32, top_p=0.95, seed=7,
                        max_new=MAXNEW)
    a = [o.token_ids for o in llm.generate(base["prompts"], sp)]
    assert all(len(t) == MAXNEW for t in a)
    assert all(0 <= x < base["cfg"].vocab_size for t in a for x in t)
    assert llm.serve().spec_rounds > 0
    llm._sched = None
    assert [o.token_ids for o in llm.generate(base["prompts"], sp)] == a


def test_generate_stream_equals_generate_and_cancel_releases(base):
    """The concatenated events equal generate's tokens, the last event of
    each request carries its finish reason; a stream abandoned after 3
    events leaves no queued request, no active slot and no held page,
    and the scheduler serves the next batch exactly."""
    llm = _spec(base, SpecConfig(k=3), page_size=4, num_pages=14)
    got = [[] for _ in base["prompts"]]
    reasons = {}
    for ev in llm.generate_stream(base["prompts"], base["sp"]):
        got[ev.index].append(ev.token_id)
        if ev.done:
            reasons[ev.index] = ev.finish_reason
    assert got == base["plain"]
    assert reasons == {i: "length" for i in range(len(base["prompts"]))}
    stream = llm.generate_stream(base["prompts"], base["sp"])
    for _ in range(3):
        next(stream)
    stream.close()
    sched = llm.serve()
    assert not sched.queue and all(s is None for s in sched.slots)
    assert sched.pool.num_free == sched.pool.num_pages
    assert [o.token_ids for o in llm.generate(base["prompts"],
                                              base["sp"])] == base["plain"]


def test_stop_token_ids_plain_and_in_a_spec_round(base):
    """A stop token ends a request where it first appears, kept, with
    finish_reason "stop" -- on plain decoding, and inside a speculative
    round that commits several tokens at once (a draft under the
    target's own plan is always accepted, so a round commits k + 1): the
    round commits nothing after it."""
    stream = base["plain"][0]
    # a position inside a round (rounds commit tokens 5r+1..5r+5)
    i = next(j for j in range(2, len(stream))
             if j % 5 and stream[j] not in stream[:j])
    stop = stream[i]
    sp = SamplingParams(max_new=MAXNEW, stop_token_ids=(stop,))
    out = base["llm"].generate(base["prompts"][:1], sp)[0]
    assert out.token_ids == stream[:i + 1] and out.finish_reason == "stop"
    same = _spec(base, SpecConfig(k=4, draft=base["llm"].plan))
    out = same.generate(base["prompts"][:1], sp)[0]
    sched = same.serve()
    assert out.token_ids == stream[:i + 1] and out.finish_reason == "stop"
    assert sched.spec_acceptance == 1.0
    assert sched.spec_tokens_per_step > 1.0
    assert sched.spec_committed == i
