"""PyTorch port vs JAX reference: head grouping (the paper's §4.2.4,
Eqs. 2-3).

The per-head attention-score features and the MLP match scores (torch)
within fp32 tolerance of the reference's; the combinatorial parts
(anti-clustering with its swap search, the bitmask DP, the distance sum)
exactly equal on the same numpy input; `group_heads` choosing the same
groups and assignment; `apply_grouping`'s permuted leaves bit for bit;
and the permutation leaving the TP block output invariant while the SPD
output changes.  Reduced configs in fp32 (llama2-7b: 8 MHA heads;
smollm-360m: 2 kv groups of 3; opt-6.7b: q/k/v biases), the reference's
parameters with every bias / norm leaf perturbed off its constant."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import grouping as RG, simtp as RS  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import grouping as G, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

# softmax probabilities and MLP output norms from fp32 forwards
FEAT_ATOL = 1e-6
SCORE_RTOL = 1e-5

_SETUPS = {}


def _setup(name):
    """(reference cfg, port cfg, reference layer 1, port layer 1, x)."""
    if name not in _SETUPS:
        rcfg = rreplace(rget(name, reduced=True), dtype="float32")
        cfg = replace(get_config(name, reduced=True), dtype="float32")
        canon = perturbed_canonical(rcfg)
        x = np.random.default_rng(1).standard_normal(
            (2, 24, cfg.d_model)).astype(np.float32)
        _SETUPS[name] = (rcfg, cfg,
                         jax.tree.map(jnp.asarray, canon["layers"][1]),
                         from_reference(canon["layers"][1], cfg), x)
    return _SETUPS[name]


@pytest.mark.parametrize("name", ["llama2-7b", "smollm-360m", "opt-6.7b"])
def test_features_and_match_scores_match_reference(name):
    """head_score_features within FEAT_ATOL; mlp_match_scores for the
    reference's own groups within SCORE_RTOL, at tp 2 and 4."""
    rcfg, cfg, rlp, plp, x = _setup(name)
    kind, rkind = layer_kinds(cfg)[1], rkinds(rcfg)[1]
    rf = RG.head_score_features(rcfg, rkind, rlp, x, max_pos=16)
    pf = G.head_score_features(cfg, kind, plp, torch.from_numpy(x),
                               max_pos=16)
    assert pf.shape == rf.shape == (cfg.n_heads, 2 * 16 * 16)
    assert pf.dtype == rf.dtype
    np.testing.assert_allclose(pf, rf, rtol=0, atol=FEAT_ATOL)
    units = G._units(cfg)
    assert units == RG._units(rcfg)
    for tp in (2, 4):
        if len(units) % tp:
            continue
        groups = [units_i.tolist() for units_i in
                  np.array_split(np.arange(len(units)), tp)]
        rs = RG.mlp_match_scores(rcfg, rkind, rlp, x, groups, units)
        ps = G.mlp_match_scores(cfg, kind, plp, torch.from_numpy(x), groups,
                                units)
        assert ps.shape == (tp, tp) and ps.dtype == np.float64
        np.testing.assert_allclose(ps, rs, rtol=SCORE_RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combinatorics_equal_reference_exactly(seed):
    """scatter_units, intra_group_distance and max_assignment are the
    reference's numpy: the same input gives the same output, exactly."""
    rng = np.random.default_rng(seed)
    for u, g in ((8, 2), (8, 4), (12, 3), (32, 2)):
        feats = rng.standard_normal((u, 20)).astype(
            np.float32 if seed % 2 else np.float64)
        groups = G.scatter_units(feats, g)
        assert groups == RG.scatter_units(feats, g)
        assert sorted(i for grp in groups for i in grp) == list(range(u))
        assert G.intra_group_distance(feats, groups) == \
            RG.intra_group_distance(feats, groups)
    for n in (1, 2, 3, 5, 8):
        sc = rng.standard_normal((n, n))
        assert G.max_assignment(sc) == RG.max_assignment(sc)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["llama2-7b", "smollm-360m", "opt-6.7b"])
def test_group_heads_and_apply_grouping_match_reference(name, tp):
    """The same groups and assignment (score within SCORE_RTOL), or the
    same identity fallback (smollm at tp 4: 2 kv groups over 4 shards);
    apply_grouping's leaves equal the reference's bit for bit."""
    rcfg, cfg, rlp, plp, x = _setup(name)
    kind, rkind = layer_kinds(cfg)[1], rkinds(rcfg)[1]
    rres = RG.group_heads(rcfg, rkind, rlp, x, tp)
    pres = G.group_heads(cfg, kind, plp, torch.from_numpy(x), tp)
    assert (pres.supported, pres.groups, pres.assignment) == (
        rres.supported, rres.groups, rres.assignment)
    assert pres.supported == (name != "smollm-360m" or tp == 2)
    np.testing.assert_allclose(pres.score, rres.score, rtol=SCORE_RTOL)
    # a grouping that surely moves heads: reversed assignment
    moved = G.GroupingResult(pres.supported, pres.groups,
                             list(reversed(pres.assignment)), pres.score)
    rmoved = RG.GroupingResult(rres.supported, rres.groups,
                               list(reversed(rres.assignment)), rres.score)
    for pr, rr in ((pres, rres), (moved, rmoved)):
        got = G.apply_grouping(plp, cfg, pr, tp)
        want = RG.apply_grouping(rlp, rcfg, rr, tp)
        leaves = tree_leaves(got)
        assert len(leaves) == len(jax.tree.leaves(want))
        for a, b in zip(leaves, jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["llama2-7b", "opt-6.7b"])
def test_grouping_keeps_tp_output_and_moves_spd_output(name):
    """The permutation as weight reordering: the TP block output is
    invariant to a relative norm < 1e-3 (the reference's bound; the head
    sum reassociates), the SPD output changes by far more."""
    _, cfg, _, plp, x = _setup(name)
    kind = layer_kinds(cfg)[1]
    tp = 2
    res = G.group_heads(cfg, kind, plp, torch.from_numpy(x), tp)
    res = G.GroupingResult(True, res.groups, list(reversed(res.assignment)),
                           res.score)
    permuted = G.apply_grouping(plp, cfg, res, tp)
    xt = torch.from_numpy(x)
    pos = torch.arange(x.shape[1]).expand(x.shape[0], x.shape[1])

    def run(layer, drop):
        fn = simtp.make_block_fn(cfg, kind, tp, drop=drop, q_chunk=64)
        return fn(simtp.split_layer(layer, cfg, kind, tp), xt, pos)

    def rel(a, b):
        return float((a - b).norm() / a.norm())

    r_tp = rel(run(plp, False), run(permuted, False))
    r_spd = rel(run(plp, True), run(permuted, True))
    assert r_tp < 1e-3, r_tp
    assert r_spd > 10 * max(r_tp, 1e-6), (r_tp, r_spd)


def test_unported_branches_raise_or_fall_back():
    """MLA moves one head at a time (its latent is shared: the
    reference's units); an SSM layer gets the identity grouping."""
    import dataclasses
    _, cfg, _, plp, x = _setup("llama2-7b")
    mla = dataclasses.replace(cfg, mla=object())
    assert G._units(mla) == [[h] for h in range(cfg.n_heads)]
    mamba = get_config("mamba2-370m", reduced=True)
    res = G.group_heads(mamba, layer_kinds(mamba)[0], {}, None, 2)
    assert (res.supported, res.groups, res.assignment) == (False, [], [0, 1])
    assert G.apply_grouping(plp, cfg, res, 2) is plp
