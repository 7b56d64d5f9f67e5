"""PyTorch port vs JAX reference: Algorithm 1 on the MoE, MLA and hybrid
families (reduced qwen2-moe-a2.7b, deepseek-v2-lite-16b, hymba-1.5b at
tp 2, fp32; the reference's parameters perturbed off their constants,
routers made decisive: tests/torch_families.py says why).

* the sensitivity sweep's L+1 suffix perplexities within PPL_RTOL, the
  sensitivities within 2 PPL_RTOL of the largest perplexity, the
  ranking wherever blocks are more than 10 PPL_RTOL apart (each block
  dropped by its drop flag, the reference's dual mode);
* `assign_comm_policy`'s plan (drop, quant8 and exact blocks) equal to
  the reference's;
* `apply_spd` with the default strategies and thresholds that make one
  block ISB, one SB and one ESB: the plan, the categories, the
  groupings (deepseek's dense MLA layer grouped by head, MoE and hybrid
  layers the identity) and every distillation step's loss within
  LOSS_RTOL (test_torch_distill.py's bound);
* MLA head grouping on a config whose MLA layers have MLP FFNs (reduced
  qwen3-1.7b with an MLA block): the features, the match scores, the
  groups, the assignment and the permuted wq / wuk / wuv / wo leaves."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import MLAConfig as RMLAConfig  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import grouping as RG, spd as RSPD  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402
from repro_torch.config.base import MLAConfig, replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import grouping as G, spd as SPD  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
import torch_families as TF  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TP = 2
FAMILIES = (TF.MOE, TF.MLA, TF.HYBRID)
PPL_RTOL = 1e-5             # test_torch_spd.py's
LOSS_RTOL = 1e-4            # test_torch_distill.py's per-step MSE bound
FEAT_ATOL = 1e-6            # test_torch_grouping.py's
SCORE_RTOL = 1e-5
LR = 1e-3

_SWEEPS = {}


def _sweep(name):
    """(calibration batches, the reference's SensitivityResult)."""
    if name not in _SWEEPS:
        rcfg, _, canon = TF.cfgs(name)
        calib = RD.calibration_batches(rcfg.vocab_size, 4, 32, batch=2)
        res, _ = RSPD.sweep_sensitivity(
            rcfg, jax.tree.map(jnp.asarray, canon), calib, TP, q_chunk=64)
        _SWEEPS[name] = (calib, res)
    return _SWEEPS[name]


def _taus(sens):
    """Halfway between the sorted sensitivities: one ISB block, one ESB,
    the rest SB."""
    s = np.sort(sens)
    return float((s[0] + s[1]) / 2), float((s[-2] + s[-1]) / 2)


def _assert_separated(sens, taus, scale):
    """Every gap that decides a tier or a rank exceeds ten times the
    perplexity tolerance: near-ties could go either way."""
    s = np.sort(sens)
    assert np.diff(s).min() > 10 * PPL_RTOL * scale, s
    for t in taus:
        assert np.abs(s - t).min() > 5 * PPL_RTOL * scale, (s, t)


@pytest.mark.parametrize("name", FAMILIES)
def test_sweep_matches_reference(name):
    _, cfg, canon = TF.cfgs(name)
    calib, ref = _sweep(name)
    res, _ = SPD.sweep_sensitivity(cfg, from_reference(canon, cfg), calib,
                                   TP, q_chunk=64)
    np.testing.assert_allclose(res.ppl_suffix, ref.ppl_suffix,
                               rtol=PPL_RTOL)
    scale = ref.ppl_suffix.max()
    np.testing.assert_allclose(res.sensitivity, ref.sensitivity, rtol=0,
                               atol=2 * PPL_RTOL * scale)
    pos = {int(b): i for i, b in enumerate(res.ranking)}
    for i, a in enumerate(ref.ranking):
        for b in ref.ranking[i + 1:]:
            if ref.sensitivity[b] - ref.sensitivity[a] > \
                    10 * PPL_RTOL * scale:
                assert pos[int(a)] < pos[int(b)], (a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_comm_policy_matches_reference(name):
    """drop / quant8 / exact per block at the separated thresholds."""
    rcfg, cfg, canon = TF.cfgs(name)
    calib, ref = _sweep(name)
    taus = _taus(ref.sensitivity)
    _assert_separated(ref.sensitivity, taus, ref.ppl_suffix.max())
    kw = dict(n_spd=1, tau1=taus[0], tau2=taus[1], logits="quant8",
              q_chunk=64)
    rplan, _ = RSPD.assign_comm_policy(
        rcfg, jax.tree.map(jnp.asarray, canon), calib, TP, **kw)
    plan, res = SPD.assign_comm_policy(cfg, from_reference(canon, cfg),
                                       calib, TP, **kw)
    assert plan.drop_mask == rplan.drop_mask
    assert plan.comm.block_modes == rplan.comm.block_modes
    assert plan.comm.logits_mode == rplan.comm.logits_mode == "quant8"
    assert {"drop", "quant8", "exact"} <= set(plan.modes()), plan.modes()


@pytest.mark.parametrize("name", FAMILIES)
def test_apply_spd_with_recovery_matches_reference(name):
    """Every block chosen, over two calibration batches, two epochs: the
    cheapest ISB (zero-shot), the dearest ESB (grouping, then
    distillation), the others SB (distillation)."""
    rcfg, cfg, canon = TF.cfgs(name)
    calib, ref = _sweep(name)
    n = cfg.n_layers
    rres, _ = RSPD.sweep_sensitivity(rcfg, jax.tree.map(jnp.asarray, canon),
                                     calib[:2], TP, q_chunk=64)
    chosen = np.sort(rres.sensitivity[rres.ranking[:n]])
    t1, t2 = float((chosen[0] + chosen[1]) / 2), float(
        (chosen[-2] + chosen[-1]) / 2)
    _assert_separated(rres.sensitivity, (t1, t2), rres.ppl_suffix.max())
    kw = dict(n_spd=n, tau1=t1, tau2=t2, lr=LR, epochs=2, q_chunk=64)
    rpad, rplan, rrep = RSPD.apply_spd(rcfg, jax.tree.map(jnp.asarray, canon),
                                       calib[:2], TP, **kw)
    ppad, pplan, prep = SPD.apply_spd(cfg, from_reference(canon, cfg),
                                      calib[:2], TP, **kw)
    assert pplan.drop_mask == rplan.drop_mask and pplan.n_dropped == n
    assert prep.chosen == rrep.chosen
    assert prep.categories == rrep.categories
    assert {"ISB", "SB", "ESB"} <= set(prep.categories)
    assert sorted(prep.distill_losses) == sorted(rrep.distill_losses)
    for bi, losses in rrep.distill_losses.items():
        np.testing.assert_allclose(prep.distill_losses[bi], losses,
                                   rtol=LOSS_RTOL, err_msg=str(bi))
    assert sorted(prep.grouping) == sorted(rrep.grouping)
    kinds = layer_kinds(cfg)
    for bi, g in rrep.grouping.items():
        got = prep.grouping[bi]
        assert (got.supported, got.groups, got.assignment) == (
            g.supported, g.groups, g.assignment)
        assert got.supported == (kinds[bi].mixer == "mla"
                                 and kinds[bi].ffn == "mlp")
    assert len(tree_leaves(ppad)) == len(jax.tree.leaves(rpad))


def _mla_setup():
    """qwen3-1.7b reduced with an MLA attention block: MLA layers with
    MLP FFNs (the grouping's supported case)."""
    mk = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16)
    rcfg = rreplace(rget("qwen3-1.7b", reduced=True), dtype="float32",
                    mla=RMLAConfig(**mk))
    cfg = replace(get_config("qwen3-1.7b", reduced=True), dtype="float32",
                  mla=MLAConfig(**mk))
    canon = perturbed_canonical(rcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return (rcfg, cfg, jax.tree.map(jnp.asarray, canon["layers"][1]),
            from_reference(canon["layers"][1], cfg), x)


@pytest.mark.parametrize("tp", [2, 4])
def test_mla_grouping_matches_reference(tp):
    """One head a unit: the features within FEAT_ATOL, the scores within
    SCORE_RTOL, the same groups and assignment, and apply_grouping's
    leaves (wq, wuk, wuv, wo permuted; wdkv, lnorm untouched) bit for
    bit, also for the reversed assignment (one of the two moves
    heads)."""
    rcfg, cfg, rlp, plp, x = _mla_setup()
    kind, rkind = layer_kinds(cfg)[1], rkinds(rcfg)[1]
    assert (kind.mixer, kind.ffn) == ("mla", "mlp")
    rf = RG.head_score_features(rcfg, rkind, rlp, x, max_pos=16)
    pf = G.head_score_features(cfg, kind, plp, torch.from_numpy(x),
                               max_pos=16)
    np.testing.assert_allclose(pf, rf, rtol=0, atol=FEAT_ATOL)
    assert G._units(cfg) == RG._units(rcfg) == [[h] for h in
                                                range(cfg.n_heads)]
    rres = RG.group_heads(rcfg, rkind, rlp, x, tp)
    pres = G.group_heads(cfg, kind, plp, torch.from_numpy(x), tp)
    assert pres.supported and rres.supported
    assert (pres.groups, pres.assignment) == (rres.groups, rres.assignment)
    np.testing.assert_allclose(pres.score, rres.score, rtol=SCORE_RTOL)
    moved = G.GroupingResult(True, pres.groups,
                             list(reversed(pres.assignment)), pres.score)
    rmoved = RG.GroupingResult(True, rres.groups,
                               list(reversed(rres.assignment)), rres.score)
    moves = []
    for pr, rr in ((pres, rres), (moved, rmoved)):
        got = G.apply_grouping(plp, cfg, pr, tp)
        want = RG.apply_grouping(rlp, rcfg, rr, tp)
        assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for k in ("wdkv", "lnorm"):
            assert got["attn"][k] is plp["attn"][k]
        moves.append(not torch.equal(got["attn"]["wuk"], plp["attn"]["wuk"]))
    assert any(moves)


def test_family_layers_group_as_the_reference():
    """deepseek's dense MLA layer is grouped, its MoE layers and every
    hybrid layer keep the identity grouping (supported False), as the
    reference's do."""
    for name in (TF.MLA, TF.HYBRID, TF.MOE):
        rcfg, cfg, canon = TF.cfgs(name)
        x = np.random.default_rng(2).standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32)
        for li, (kind, rkind) in enumerate(zip(layer_kinds(cfg),
                                               rkinds(rcfg))):
            rres = RG.group_heads(rcfg, rkind, jax.tree.map(
                jnp.asarray, canon["layers"][li]), x, TP)
            pres = G.group_heads(cfg, kind, from_reference(
                canon["layers"][li], cfg), torch.from_numpy(x), TP)
            assert (pres.supported, pres.groups, pres.assignment) == (
                rres.supported, rres.groups, rres.assignment), (name, li)
            assert pres.supported == (name == TF.MLA and li == 0)
