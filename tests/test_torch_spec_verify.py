"""The port's speculative acceptance layer against the JAX package's.

`repro_torch.spec.verify` is a numpy copy of `repro.spec.verify`: every
function gives the reference's result on the same inputs and the same
`spec_rng` (chain and tree, greedy and rejection).  `SpecConfig`
validation, `derive_draft_plan` for every preset and
`candidate_policies` (names, plans, order) equal the reference's.  The
rejection scheme keeps the target distribution on the port's own model
logits, and the port's samplers draw the reference's distributions.

Tolerances: the acceptance functions and plans are compared exactly
(filtered_probs to 1e-12: the same float64 numpy in both).  The
statistical checks are bounded in total variation (TV), each bound
stated at its test."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.runtime import sampling as RSMP  # noqa: E402
from repro.spec import calibrate as RCAL  # noqa: E402
from repro.spec import draft as RDRAFT  # noqa: E402
from repro.spec import verify as RV  # noqa: E402

from repro_torch.api import LLM  # noqa: E402
from repro_torch.api.scheduler import Request  # noqa: E402
from repro_torch.config.base import SPDPlanConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime import sampling as RS  # noqa: E402
from repro_torch.spec import calibrate as CAL  # noqa: E402
from repro_torch.spec import draft as DRAFT  # noqa: E402
from repro_torch.spec import verify as V  # noqa: E402
from repro_torch.spec import SpecConfig, SpecError  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


PROBS_ATOL = 1e-12


def _logits(rng, rows, v, spread=3.0):
    return rng.standard_normal((rows, v)) * spread


# ---------------------------------------------------------------------------
# spec/verify.py, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,p", [(0.0, 0, 1.0), (0.7, 0, 1.0),
                                   (1.0, 5, 1.0), (1.3, 0, 0.8),
                                   (0.9, 10, 0.6), (1e-7, 3, 0.5)])
def test_filtered_probs_equal_reference(t, k, p):
    rng = np.random.default_rng(1)
    for row in _logits(rng, 8, 64):
        np.testing.assert_allclose(V.filtered_probs(row, t, k, p),
                                   RV.filtered_probs(row, t, k, p),
                                   rtol=0, atol=PROBS_ATOL)


def _draft_case(seed, k=4, v=48, sampled=False):
    rng = np.random.default_rng(seed)
    tl = _logits(rng, k + 1, v)
    argmax = np.argmax(tl, -1)
    toks = argmax[:k].copy()
    cut = int(rng.integers(0, k + 1))       # first wrong draft (k = none)
    if cut < k:
        toks[cut] = (toks[cut] + 1 + int(rng.integers(0, v - 1))) % v
    dl = _logits(rng, k, v)
    if sampled:
        toks = np.asarray([rng.integers(0, v) for _ in range(k)])
    return tl, argmax, toks, dl


@pytest.mark.parametrize("seed", range(6))
def test_chain_acceptance_equals_reference(seed):
    """accept_greedy, and accept_speculative greedy and sampled (the same
    spec_rng stream on both sides)."""
    tl, argmax, toks, dl = _draft_case(seed)
    assert V.accept_greedy(toks, argmax) == RV.accept_greedy(toks, argmax)
    assert (V.accept_speculative(toks, None, tl)
            == RV.accept_speculative(toks, None, tl))
    tl, _, toks, dl = _draft_case(seed, sampled=True)
    t, k, p = 0.9, 12, 0.9
    q = np.stack([V.filtered_probs(r, t, k, p) for r in dl])
    got = V.accept_speculative(toks, q, tl, temperature=t, top_k=k,
                               top_p=p, rng=V.spec_rng(seed, 3))
    want = RV.accept_speculative(toks, q, tl, temperature=t, top_k=k,
                                 top_p=p, rng=RV.spec_rng(seed, 3))
    assert got == want


@pytest.mark.parametrize("k,w", [(1, 1), (3, 1), (3, 2), (4, 3), (6, 2)])
def test_tree_layout_equals_reference(k, w):
    assert V.tree_layout(k, w) == RV.tree_layout(k, w)


@pytest.mark.parametrize("seed", range(6))
def test_tree_acceptance_equals_reference(seed):
    """alt_candidates, accept_greedy_tree (a first-draft rejection whose
    correction is an alternative, and one whose is not) and
    accept_speculative_tree."""
    rng = np.random.default_rng(100 + seed)
    k, w, v = 3, 3, 40
    tl = _logits(rng, k + 1, v)
    alt_lg = _logits(rng, w - 1, v)
    argmax, alt_argmax = np.argmax(tl, -1), np.argmax(alt_lg, -1)
    row = _logits(rng, 1, v)[0]
    d1 = int(rng.integers(0, v))
    assert V.alt_candidates(row, d1, w) == RV.alt_candidates(row, d1, w)
    toks = argmax[:k].copy()
    toks[0] = (toks[0] + 1) % v
    alts = np.asarray([(argmax[0] + 7) % v, argmax[0]]) if seed % 2 else \
        np.asarray([(argmax[0] + 7) % v, (argmax[0] + 9) % v])
    got = V.accept_greedy_tree(toks, alts, argmax, alt_argmax)
    assert got == RV.accept_greedy_tree(toks, alts, argmax, alt_argmax)
    assert (got[2] > 0) == bool(seed % 2)
    t, kk, p = 0.8, 0, 0.95
    q = np.stack([V.filtered_probs(r, t, kk, p) for r in _logits(rng, k, v)])
    stoks = np.asarray([rng.integers(0, v) for _ in range(k)])
    salts = np.asarray(V.alt_candidates(tl[0], stoks[0], w))
    got = V.accept_speculative_tree(stoks, q, tl, salts, alt_lg,
                                    temperature=t, top_k=kk, top_p=p,
                                    rng=V.spec_rng(seed, 5))
    want = RV.accept_speculative_tree(stoks, q, tl, salts, alt_lg,
                                      temperature=t, top_k=kk, top_p=p,
                                      rng=RV.spec_rng(seed, 5))
    assert got == want


def test_spec_rng_streams_equal_reference():
    for seed, n in ((0, 0), (-5, 3), (2 ** 31 - 1, 17)):
        assert np.array_equal(V.spec_rng(seed, n).random(8),
                              RV.spec_rng(seed, n).random(8))


# ---------------------------------------------------------------------------
# SpecConfig, draft plans and calibration candidates
# ---------------------------------------------------------------------------

def _load(**kw):
    return LLM.load("smollm-360m-reduced", tp=2, dtype="float32",
                    device="cpu", cache_len=64, q_chunk=64, **kw)


def test_spec_config_validation():
    """Mirrors tests/test_spec.py::test_spec_config_validation."""
    with pytest.raises(SpecError):
        SpecConfig(k=0)
    with pytest.raises(SpecError):
        SpecConfig(draft="nope")
    with pytest.raises(SpecError):
        SpecConfig(k=2, adaptive=True, k_min=3, k_max=2)
    with pytest.raises(SpecError):
        SpecConfig(k=5, adaptive=True, k_min=2, k_max=4)
    with pytest.raises(SpecError):
        SpecConfig(k=3, k_min=0)
    with pytest.raises(SpecError):
        SpecConfig(k=3, tree_width=0)
    with pytest.raises(SpecError):
        SpecConfig(k=3, tree_width=3)          # k_min=1 -> capacity 2
    SpecConfig(k=3, adaptive=True, k_min=2, k_max=5, tree_width=3)
    with pytest.raises(SpecError):
        _load(spec=SpecConfig(draft="calibrated"))
    with pytest.raises(SpecError):
        _load(spec=SpecConfig(draft="tiered"))
    with pytest.raises(SpecError):
        LLM.load("mamba2-370m-reduced", tp=2, device="cpu", cache_len=64,
                 q_chunk=64, spec=SpecConfig(k=2, draft="all-drop"))
    with pytest.raises(TypeError):
        _load(spec=object())
    assert SpecConfig(k=3, k_max=5, adaptive=True).k_cap == 5


def _same_plan(got, want):
    assert tuple(got.drop_mask) == tuple(want.drop_mask)
    assert got.qmodes == want.qmodes
    assert got.logits_mode == want.logits_mode


@pytest.mark.parametrize("draft", ["all-drop", "drop+quant4", "tiered",
                                   "calibrated", "explicit"])
def test_derive_draft_plan_equals_reference(draft):
    cfg, rcfg = get_config("llama2-7b", reduced=True), rget(
        "llama2-7b", reduced=True)
    n = cfg.n_layers
    sens = np.asarray([0.01, 0.2, 0.9, 0.03])
    ranking = np.argsort(sens, kind="stable")
    if draft == "explicit":
        mask = (True, False, True, False)
        got = DRAFT.derive_draft_plan(
            cfg, SpecConfig(draft=SPDPlanConfig(mask)))
        want = RDRAFT.derive_draft_plan(
            rcfg, RDRAFT.SpecConfig(draft=RPlan(mask)))
    elif draft == "calibrated":
        pol = SPDPlanConfig.from_modes(("drop", "quant8", "drop+quant4",
                                        "exact"), logits="quant8")
        rpol = RPlan.from_modes(("drop", "quant8", "drop+quant4", "exact"),
                                logits="quant8")
        got = DRAFT.derive_draft_plan(cfg, SpecConfig(draft=draft),
                                      policy=pol)
        want = RDRAFT.derive_draft_plan(rcfg, RDRAFT.SpecConfig(draft=draft),
                                        policy=rpol)
    else:
        kw = dict(n_spd=3, tau1=0.05, tau2=0.5)
        got = DRAFT.derive_draft_plan(cfg, SpecConfig(draft=draft, **kw),
                                      sensitivity=sens, ranking=ranking)
        want = RDRAFT.derive_draft_plan(
            rcfg, RDRAFT.SpecConfig(draft=draft, **kw), sensitivity=sens,
            ranking=ranking)
    assert len(got.drop_mask) == n
    _same_plan(got, want)


@pytest.mark.parametrize("with_sens", [False, True])
def test_candidate_policies_equal_reference(with_sens):
    cfg, rcfg = get_config("llama2-7b", reduced=True), rget(
        "llama2-7b", reduced=True)
    sens = np.asarray([0.01, 0.2, 0.9, 0.03]) if with_sens else None
    got = CAL.candidate_policies(cfg, sensitivity=sens)
    want = RCAL.candidate_policies(rcfg, sensitivity=sens)
    assert [nm for nm, _ in got] == [nm for nm, _ in want]
    for (_, a), (_, b) in zip(got, want):
        _same_plan(a, b)
    assert len(got) == (8 if with_sens else 5)


# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------

# TV of an N-sample empirical distribution over <= 16 tokens: expected
# ~0.5 * sqrt(16 / N) ~ 0.012 at N = 30000; the bound is ~2.5x that
SPEC_N = 30_000
SPEC_TV = 0.03


@pytest.fixture(scope="module")
def round_logits():
    """One round's real logits on the port's model (reduced SmolLM, fp32,
    all-drop draft): the draft's per-draft logits (at temperature 0 the
    sampled draft argmaxes, and returns them) and the target's verify
    logits for [cur, drafts], then a tree verify with the target's
    filtered mode as the alternative."""
    llm = _load(max_batch=3, spec=SpecConfig(k=3, draft="all-drop"))
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, llm.cfg.vocab_size, 9)
    sched = llm.serve()
    sched.submit(Request(uid=0, prompt=prompt, max_new=4))
    sched._admit()
    dr, n, k, w = sched.spec.drafter, sched.max_batch, 3, 2
    pos = sched.pos.copy()
    ctx = sched.cur.copy()
    gens = RS.draft_generators(np.zeros(n), np.ones(n), k, "cpu")
    draft_toks, draft_logits, _ = dr.draft(
        ctx, pos, k, sampling=(np.zeros(n, np.float32),
                               np.zeros(n, np.int64),
                               np.ones(n, np.float32), gens))
    ver = np.concatenate([sched.cur, draft_toks], 1)
    chain = sched.kv.verify(llm.params, ver, pos)[0].numpy()
    temp, top_k, top_p = 0.8, 16, 0.95
    order = np.argsort(-V.filtered_probs(chain[0], temp, top_k, top_p))
    alt = int(order[0] if order[0] != draft_toks[0, 0] else order[1])
    alts = np.full((n, w - 1), alt, np.int64)
    tree = sched.kv.verify(llm.params, np.concatenate([ver, alts], 1), pos,
                           tree=V.tree_layout(k, w))[0].numpy()
    return dict(dlg=draft_logits[0], chain=chain, tree=tree, alts=alts[0],
                k=k, temp=temp, top_k=top_k, top_p=top_p)


def _tv_first_token(rl, logits, kb, seed0, tree):
    t, tk, tp = rl["temp"], rl["top_k"], rl["top_p"]
    q = np.stack([V.filtered_probs(rl["dlg"][i], t, tk, tp)
                  for i in range(kb)])
    p0 = V.filtered_probs(logits[0], t, tk, tp)
    v = p0.shape[0]
    counts = np.zeros(v)
    fired = 0
    for i in range(SPEC_N):
        rng = np.random.default_rng(seed0 + i)
        drafts = np.asarray([rng.choice(v, p=q[j]) for j in range(kb)])
        if tree:
            committed, _, used = V.accept_speculative_tree(
                drafts, q, logits[:kb + 1], rl["alts"],
                logits[rl["k"] + 1:], temperature=t, top_k=tk, top_p=tp,
                rng=rng)
            fired += bool(used)
        else:
            committed, _ = V.accept_speculative(
                drafts, q, logits, temperature=t, top_k=tk, top_p=tp,
                rng=rng)
        counts[committed[0]] += 1
    return 0.5 * np.abs(counts / SPEC_N - p0).sum(), counts, fired


def test_rejection_scheme_preserves_target_distribution(round_logits):
    """As tests/test_spec.py:140, on the port's logits: the first
    committed token's empirical distribution (N = SPEC_N) is within
    SPEC_TV of the filtered target distribution."""
    tv, counts, _ = _tv_first_token(round_logits, round_logits["chain"],
                                    round_logits["k"], 10_000, tree=False)
    assert tv < SPEC_TV, tv
    assert 0 < (counts > 0).sum() <= 16


def test_tree_rejection_preserves_target_distribution(round_logits):
    """As tests/test_spec.py:201: the tree path with a clamped budget
    (k_b = 2 of k = 3) and a real depth-1 alternative scored by a tree
    verify forward; the alternative really fires."""
    tv, _, fired = _tv_first_token(round_logits, round_logits["tree"], 2,
                                   20_000, tree=True)
    assert tv < SPEC_TV, tv
    assert fired > 0


# The port's plain samplers against the reference's: 20,000 draws each on
# fixed logits over 32 tokens.  Two independent empirical distributions
# of N = 20000 over <= 32 tokens differ by TV ~0.5 * sqrt(2 * 32 / (pi *
# N)) ~ 0.016 at most; a probe found 0.004-0.013.  Bound: 0.03, and the
# same against the exact filtered distribution.
SAMPLE_N = 20_000
SAMPLE_TV = 0.03


@pytest.mark.parametrize("t,k,p", [(0.7, 0, 1.0), (1.0, 5, 1.0),
                                   (1.3, 0, 0.8), (0.9, 10, 0.6)])
def test_plain_sampler_distribution_matches_reference(t, k, p):
    rng = np.random.default_rng(7)
    row = (rng.standard_normal(32) * 1.5).astype(np.float32)
    exact = V.filtered_probs(row, t, k, p)
    seeds = np.arange(SAMPLE_N)
    zeros = np.zeros(SAMPLE_N, np.int64)
    got = RS.sample_core(torch.from_numpy(row)[None].expand(SAMPLE_N, 32),
                         np.full(SAMPLE_N, t), np.full(SAMPLE_N, k),
                         np.full(SAMPLE_N, p),
                         RS.make_generators(seeds, zeros, "cpu")).numpy()
    keys = RSMP.make_keys(jnp.asarray(seeds, jnp.int32),
                          jnp.asarray(zeros, jnp.int32))
    want = np.asarray(RSMP.sample_core(
        jnp.broadcast_to(jnp.asarray(row), (SAMPLE_N, 32)),
        jnp.full(SAMPLE_N, t, jnp.float32), jnp.full(SAMPLE_N, k, jnp.int32),
        jnp.full(SAMPLE_N, p, jnp.float32), keys))
    hg = np.bincount(got, minlength=32) / SAMPLE_N
    hw = np.bincount(want, minlength=32) / SAMPLE_N
    assert 0.5 * np.abs(hg - hw).sum() < SAMPLE_TV
    assert 0.5 * np.abs(hg - exact).sum() < SAMPLE_TV
    assert set(np.flatnonzero(hg)) <= set(np.flatnonzero(exact))
