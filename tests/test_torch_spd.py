"""PyTorch port vs JAX reference: the zero-shot half of Algorithm 1.
The synthetic calibration data bit for bit; the plan constructors; the
vocab-parallel loss, perplexity, logits and cloze evals; the sensitivity
sweep's L+1 perplexities, ranking and tiers; the tiered comm policy and
`apply_spd` with the zero-shot strategy, through the core functions and
the `LLM` facade, and the greedy tokens served under the plans they
produce.  Reduced llama2-7b and opt-6.7b at tp=2, fp32, the reference's
parameters with every bias, norm and position leaf perturbed off its
constant, carried across with `core.convert.from_reference`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import (CommPolicy as RComm,  # noqa: E402
                               SPDPlanConfig as RPlan, replace as rreplace)
from repro.configs import get_config as rget  # noqa: E402
from repro.core import sensitivity as RSe  # noqa: E402
from repro.core import simtp as RS, spd as RSPD  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import (CommPolicy, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import sensitivity as Se, simtp, spd as SPD  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.data import synthetic as D  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TP = 2
# perplexities: fp32 forwards of 4 blocks and a CE over 2 x 32 tokens;
# XLA and torch sum in other orders
PPL_RTOL = 1e-5
LOGIT_ATOL = 1e-4


_SETUPS = {}


def _setup(name, **kw):
    """(reference cfg, port cfg, numpy canonical params, calibration
    batches, reference SensitivityResult), built once per config."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _SETUPS:
        rcfg = rreplace(rget(name, reduced=True), dtype="float32", **kw)
        cfg = replace(get_config(name, reduced=True), dtype="float32", **kw)
        canon = perturbed_canonical(rcfg)
        calib = RD.calibration_batches(rcfg.vocab_size, 4, 32, batch=2)
        res, _ = RSPD.sweep_sensitivity(rcfg, jax.tree.map(jnp.asarray,
                                                           canon),
                                        calib, TP, q_chunk=64)
        _SETUPS[key] = (rcfg, cfg, canon, calib, res)
    return _SETUPS[key]


def _taus(sens):
    """Thresholds halfway between sorted sensitivities, so that ISB, SB
    and ESB all occur and no block sits on a threshold: one ISB, the
    middle two SB, one ESB (4 blocks)."""
    s = np.sort(sens)
    return float((s[0] + s[1]) / 2), float((s[2] + s[3]) / 2)


def _assert_separated(sens, taus, scale):
    """Every gap that decides a tier or a rank exceeds ten times the
    perplexity tolerance: near-ties could go either way."""
    s = np.sort(sens)
    assert np.diff(s).min() > 10 * PPL_RTOL * scale, s
    for t in taus:
        assert np.abs(s - t).min() > 5 * PPL_RTOL * scale, (s, t)


# ---------------------------------------------------------------------------
# Data and plan constructors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,n,seq,batch", [(512, 4, 32, 2),
                                               (32000, 4, 128, 2),
                                               (509, 7, 24, 3)])
def test_calibration_batches_bit_for_bit(vocab, n, seq, batch):
    ref = RD.calibration_batches(vocab, n, seq, batch=batch)
    got = D.calibration_batches(vocab, n, seq, batch=batch)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [777, 5])
def test_cloze_suite_and_stream_bit_for_bit(seed):
    ref = RD.cloze_suite(512, 6, 40, seed=seed)
    got = D.cloze_suite(512, 6, 40, seed=seed)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    rit = RD.make_batch_iterator(512, 2, 16, seed=seed, start_step=3)
    pit = D.make_batch_iterator(512, 2, 16, seed=seed, start_step=3)
    for _ in range(2):
        a, b = next(pit), next(rit)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_plan_constructors_match_reference():
    modes = ("drop", "quant8", "drop+quant4", "exact", "drop+quant8",
             "quant4")
    for logits in ("exact", "quant8"):
        r, p = RPlan.from_modes(modes, logits), SPDPlanConfig.from_modes(
            modes, logits)
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.modes() == r.modes() == list(modes)
        assert (p.fraction, p.n_dropped, p.comm.n_quantized) == (
            r.fraction, r.n_dropped, r.comm.n_quantized)
    for ctor in ("none", "full"):
        assert getattr(SPDPlanConfig, ctor)(5).drop_mask == getattr(
            RPlan, ctor)(5).drop_mask
    ranking = np.asarray([3, 0, 4, 1, 2])
    assert SPDPlanConfig.from_ranking(ranking, 2, 5).drop_mask == \
        RPlan.from_ranking(ranking, 2, 5).drop_mask
    assert CommPolicy.exact(3) == CommPolicy(("exact",) * 3)
    assert dataclasses.asdict(CommPolicy.exact(3)) == dataclasses.asdict(
        RComm.exact(3))
    with pytest.raises(ValueError):
        SPDPlanConfig.from_modes(("drop+exact",))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiers_and_comm_policy_match_reference(seed):
    """classify, tier_modes and comm_policy_from_sensitivity on the same
    sensitivities (ties and values on the thresholds included)."""
    rng = np.random.default_rng(seed)
    sens = np.round(rng.standard_normal(12), 1)
    ranking = np.argsort(sens, kind="stable")
    for tau1, tau2 in ((-0.5, 0.5), (0.0, 0.0), (sens[3], sens[7])):
        assert Se.classify(sens, tau1, tau2) == RSe.classify(sens, tau1,
                                                             tau2)
        kw = dict(isb="drop+quant8", sb="quant8", esb="exact")
        assert Se.tier_modes(sens, tau1, tau2, **kw) == RSe.tier_modes(
            sens, tau1, tau2, **kw)
        for n_spd in (0, 3, 12):
            for levels in ({}, dict(sb_level="quant4", esb_level="quant8",
                                    logits="quant8")):
                p = SPD.comm_policy_from_sensitivity(
                    sens, ranking, 12, n_spd=n_spd, tau1=tau1, tau2=tau2,
                    **levels)
                r = RSPD.comm_policy_from_sensitivity(
                    sens, ranking, 12, n_spd=n_spd, tau1=tau1, tau2=tau2,
                    **levels)
                assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert Se.suffix_flags(5, 2).tolist() == RSe.suffix_flags(5, 2).tolist()


# ---------------------------------------------------------------------------
# Loss, perplexity, logits, cloze
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["llama2-7b", "opt-6.7b"])
def test_loss_and_evals_match_reference(name, tp):
    """make_loss_fn (a vocab of 509: padded columns masked, the row max
    across shards), eval_ppl in plain and dual mode, make_logits_fn and
    eval_cloze, at a plan with two blocks dropped."""
    rcfg, cfg, canon, _, _ = _setup(name, vocab_size=509)
    drop = (True, False, False, True)
    rsplit = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg,
                               RPlan(drop), tp)
    psplit = simtp.prepare_params(from_reference(canon, cfg), cfg,
                                  SPDPlanConfig(drop), tp)
    batches = RD.calibration_batches(509, 4, 32, batch=2)
    rloss = RS.make_loss_fn(rcfg, RPlan(drop), tp, q_chunk=64)
    ploss = simtp.make_loss_fn(cfg, SPDPlanConfig(drop), tp, q_chunk=64)
    for b in batches:
        rl, rm = rloss(rsplit, {k: jnp.asarray(v) for k, v in b.items()})
        pl, pm = ploss(psplit, b)
        np.testing.assert_allclose(float(pl), float(rl), rtol=PPL_RTOL)
        assert float(pm["n_tok"]) == float(rm["n_tok"])
    ppl = simtp.eval_ppl(ploss, psplit, batches)
    np.testing.assert_allclose(ppl, RS.eval_ppl(rloss, rsplit, batches),
                               rtol=PPL_RTOL)
    # dual mode over the no-SPD placement gives the same perplexity
    none = SPDPlanConfig.none(4)
    dual = simtp.make_loss_fn(cfg, none, tp, q_chunk=64, dual=True)
    psplit0 = simtp.prepare_params(from_reference(canon, cfg), cfg, none,
                                   tp)
    np.testing.assert_allclose(
        simtp.eval_ppl(dual, psplit0, batches,
                       dual_flags=np.asarray(drop, np.float32)),
        ppl, rtol=PPL_RTOL)
    with pytest.raises(TypeError):
        dual(psplit0, batches[0])
    suite = RD.cloze_suite(509, 6, 40)
    rlog = RS.make_logits_fn(rcfg, RPlan(drop), tp, q_chunk=64)
    plog = simtp.make_logits_fn(cfg, SPDPlanConfig(drop), tp, q_chunk=64)
    lg = plog(psplit, suite["tokens"])
    assert lg.shape == (6, 40, 509)
    np.testing.assert_allclose(lg.numpy(), np.asarray(
        rlog(rsplit, jnp.asarray(suite["tokens"]))), atol=LOGIT_ATOL,
        rtol=0)
    assert simtp.eval_cloze(plog, psplit, suite) == RS.eval_cloze(
        rlog, rsplit, suite)


# ---------------------------------------------------------------------------
# Sensitivity sweep, comm policy, apply_spd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama2-7b", "opt-6.7b"])
def test_measure_sensitivity_matches_reference(name):
    """The L+1 suffix perplexities within PPL_RTOL; the sensitivities
    and the ranking follow wherever blocks are separated by more than
    ten times that (random weights leave near-ties an argsort may order
    either way)."""
    rcfg, cfg, canon, calib, ref = _setup(name)
    res, padded = SPD.sweep_sensitivity(cfg, from_reference(canon, cfg),
                                        calib, TP, q_chunk=64)
    assert res.ppl_suffix.shape == (cfg.n_layers + 1,)
    assert np.isfinite(res.ppl_suffix).all()
    np.testing.assert_allclose(res.ppl_suffix, ref.ppl_suffix,
                               rtol=PPL_RTOL)
    scale = ref.ppl_suffix.max()
    np.testing.assert_allclose(res.sensitivity, ref.sensitivity, rtol=0,
                               atol=2 * PPL_RTOL * scale)
    assert sorted(res.ranking.tolist()) == list(range(cfg.n_layers))
    pos = {int(b): i for i, b in enumerate(res.ranking)}
    for i, a in enumerate(ref.ranking):
        for b in ref.ranking[i + 1:]:
            if ref.sensitivity[b] - ref.sensitivity[a] > \
                    10 * PPL_RTOL * scale:
                assert pos[int(a)] < pos[int(b)], (a, b)
    # the sweep's placement shares the canonical leaves where nothing pads
    assert padded["layers"][0]["attn"]["wq"].shape == (cfg.d_model,
                                                       cfg.d_model)


@pytest.mark.parametrize("name", ["llama2-7b", "opt-6.7b"])
def test_apply_comm_policy_matches_reference(name):
    """The facade's tiered plan (drop, quant8 and exact syncs together)
    and the greedy tokens served under it."""
    rcfg, cfg, canon, calib, ref_res = _setup(name)
    taus = _taus(ref_res.sensitivity)
    _assert_separated(ref_res.sensitivity, taus, ref_res.ppl_suffix.max())
    kw = dict(tp=TP, cache_len=64, comm_logits="quant8", comm="quant8")
    ref = RLLM.load(rcfg, params=jax.tree.map(jnp.asarray, canon), **kw)
    port = LLM.load(cfg, device="cpu", params=from_reference(canon, cfg),
                    **kw)
    args = dict(n_spd=2, tau1=taus[0], tau2=taus[1], logits="quant8")
    rres = ref.apply_comm_policy(calib, **args)
    res = port.apply_comm_policy(calib, **args)
    assert dataclasses.asdict(port.plan) == dataclasses.asdict(ref.plan)
    modes = port.plan.modes()
    assert {"drop", "quant8", "exact"} <= set(modes), modes
    assert res.ranking.tolist() == rres.ranking.tolist()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (6, 19)]
    want = [o.token_ids for o in ref.generate(prompts, RSP(max_new=6))]
    got = [o.token_ids for o in port.generate(prompts,
                                              SamplingParams(max_new=6))]
    assert got == want


def test_apply_spd_zero_shot_matches_reference():
    """apply_spd with strategies=("ZS",): the plan, the report and the
    padded params equal the reference's; with every chosen block ISB the
    default strategies return the same plan without training."""
    rcfg, cfg, canon, calib, ref_res = _setup("llama2-7b")
    taus = _taus(ref_res.sensitivity)
    rcanon, pcanon = jax.tree.map(jnp.asarray, canon), from_reference(
        canon, cfg)
    for strategies, t1, t2 in ((("ZS",), *taus),
                               (("ZS", "B2B", "HG"), 1e9, 2e9)):
        kw = dict(n_spd=2, tau1=t1, tau2=t2, strategies=strategies,
                  q_chunk=64)
        rpad, rplan, rrep = RSPD.apply_spd(rcfg, rcanon, calib, TP, **kw)
        ppad, pplan, prep = SPD.apply_spd(cfg, pcanon, calib, TP, **kw)
        assert pplan.drop_mask == rplan.drop_mask and pplan.n_dropped == 2
        assert prep.chosen == rrep.chosen
        assert prep.categories == rrep.categories
        assert not prep.distill_losses and not prep.grouping
        np.testing.assert_array_equal(
            ppad["layers"][1]["attn"]["wo"].numpy(),
            np.asarray(rpad["layers"][1]["attn"]["wo"]))
        split = SPD.prepare_deployment(cfg, ppad, pplan, TP)
        want = simtp.prepare_params(pcanon, cfg, pplan, TP)
        for seg, ref_seg in zip(split["segs"], want["segs"]):
            torch.testing.assert_close(seg["mlp"]["wd"],
                                       ref_seg["mlp"]["wd"], rtol=0, atol=0)


def test_facade_apply_spd_matches_reference():
    """LLM.apply_spd (zero-shot) rewires the plan as the reference's
    facade does; the greedy tokens after it are equal."""
    rcfg, cfg, canon, calib, ref_res = _setup("opt-6.7b")
    ref = RLLM.load(rcfg, tp=TP, cache_len=64,
                    params=jax.tree.map(jnp.asarray, canon))
    port = LLM.load(cfg, tp=TP, cache_len=64, device="cpu",
                    params=from_reference(canon, cfg))
    port.serve()
    rrep = ref.apply_spd(calib, n_spd=2, tau1=1e9, tau2=2e9)
    prep = port.apply_spd(calib, n_spd=2, tau1=1e9, tau2=2e9)
    assert port._sched is None
    assert port.plan.drop_mask == ref.plan.drop_mask
    assert prep.chosen == rrep.chosen and port.plan.n_dropped == 2
    prompts = [np.arange(7, dtype=np.int32) * 31 % 512]
    assert [o.token_ids for o in port.generate(
        prompts, SamplingParams(max_new=6))] == [
        o.token_ids for o in ref.generate(prompts, RSP(max_new=6))]
