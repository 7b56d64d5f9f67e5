"""Algorithm 1 on the shard engine's ranks (one process per TP shard over
gloo): `LLM.apply_comm_policy` and `LLM.apply_spd` on a multi-process
LLM against the port's sim engine and the JAX reference.

Reduced LLaMA2-7B and OPT-6.7B, fp32, tp 2 at dp 1 and dp 2, from the
reference's parameters with every bias, norm and position leaf moved
off its constant; 4 calibration samples of 32 tokens in 2 batches.  The
thresholds sit halfway between the sorted sensitivities of sim's own
sweep, so that every tier occurs:

  * `apply_comm_policy(n_spd=2, sb_level="quant8", logits="quant8")`:
    one block dropped, two at quant8, one exact;
  * then `apply_spd(n_spd=3, epochs=2)`: one ISB block dropped zero-
    shot, one SB block distilled, one ESB block head-grouped and
    distilled (each rank distils its own shard, the block's syncs over
    the model group);
  * after each, a greedy generate of 4 prompts on the new plan.
On every rank the plan, its comm policy, the ranking, the categories,
the chosen blocks, the grouping and the greedy tokens equal sim's, the
perplexities and sensitivities within 1e-5 of sim's largest perplexity
and every distillation loss within 1e-5 relative; every rank agrees
(the facade checks the plan and ranking across ranks itself).  The
comm policy of one layout equals the reference's
`core.spd.assign_comm_policy` on the same numbers.
Spawns: one per layout, each running all of its cases beside this
process's sim runs (torch_dist.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import spd as RSPD  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import spd as SPD  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.data import calibration_batches  # noqa: E402
import torch_dist as TD  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ("llama2-7b", "opt-6.7b")
LAYOUTS = ((2, 1), (2, 2))
TP = 2
LENS = (5, 9, 7, 11)
# fp32 perplexities of 4 blocks over 4 x 2 x 32 tokens: the ranks' and
# sim's products sum in other orders
PPL_RTOL = 1e-5
DISTILL_RTOL = 1e-5


def _cfg(arch):
    return replace(get_config(arch, reduced=True), dtype="float32")


def _rcfg(arch):
    return rreplace(rget(arch, reduced=True), dtype="float32")


def _calib(vocab):
    return calibration_batches(vocab, 4, 32, batch=2)


def _kwargs(sens):
    """Algorithm 1's arguments from sim's sensitivities: the comm policy
    drops the cheapest block, keeps the next two at quant8 and the
    dearest exact; apply_spd takes the three cheapest, one a tier."""
    s = np.sort(sens)
    mid = [float((a + b) / 2) for a, b in zip(s[:-1], s[1:])]
    policy = dict(n_spd=2, tau1=mid[0], tau2=mid[2], sb_level="quant8",
                  logits="quant8", q_chunk=64)
    spd = dict(n_spd=3, tau1=mid[0], tau2=mid[1], epochs=2, q_chunk=64)
    return policy, spd


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """{arch: (reference numpy tree, port tree, policy kwargs, spd
    kwargs)} and the ranks' parameter file."""
    out = {}
    for a in ARCHS:
        tree = perturbed_canonical(_rcfg(a))
        port = from_reference(tree, _cfg(a))
        res, _ = SPD.sweep_sensitivity(_cfg(a), port, _calib(
            _cfg(a).vocab_size), TP, q_chunk=64)
        s = np.sort(res.sensitivity)
        assert np.diff(s).min() > 10 * PPL_RTOL * res.ppl_suffix.max(), s
        out[a] = (tree, port) + _kwargs(res.sensitivity)
    path = tmp_path_factory.mktemp("shard_spd") / "canon.pt"
    torch.save({a: v[1] for a, v in out.items()}, path)
    return out, str(path)


@pytest.fixture(scope="module")
def runs(setup):
    """runs(tp, dp) -> (the ranks' results, sim's): one spawn per layout,
    both started at the first use, beside this process's sim runs."""
    trees, path = setup
    jobs = {lay: dict(tp=lay[0], dp=lay[1], params=path, cases=[
        dict(kind="algorithm1", name=a, arch=a, cfg=_cfg(a), lens=LENS,
             policy=trees[a][2], spd=trees[a][3]) for a in ARCHS])
        for lay in LAYOUTS}
    waits = {lay: TD.start(job, deadline_s=600, timeout_s=120)
             for lay, job in jobs.items()}
    sim = {}
    for case in jobs[LAYOUTS[0]]["cases"]:
        llm = TD.load(case["cfg"], trees[case["arch"]][1], "sim", TP)
        sim[case["name"]] = TD.algorithm1(llm, case)
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            done[(tp, dp)] = waits[(tp, dp)](), sim
        return done[(tp, dp)]

    return get


def _grid():
    return [(lay, a) for lay in LAYOUTS for a in ARCHS]


def _ids(case):
    (tp, dp), a = case
    return f"tp{tp}dp{dp}-{a}"


def _same_numbers(got, want, what):
    scale = float(np.max(want["ppl_suffix"]))
    np.testing.assert_allclose(got["ppl_suffix"], want["ppl_suffix"],
                               rtol=PPL_RTOL, err_msg=what)
    np.testing.assert_allclose(got["sensitivity"], want["sensitivity"],
                               rtol=0, atol=PPL_RTOL * scale, err_msg=what)
    assert got["ranking"] == want["ranking"], what


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_comm_policy_equals_sim(runs, case):
    (tp, dp), a = case
    ranks, sim = runs(tp, dp)
    want = sim[a]["policy"]
    assert set(want["modes"]) == {"drop", "quant8", "exact"}
    for r, res in enumerate(ranks):
        got = res[a]["policy"]
        _same_numbers(got, want, f"rank {r}")
        assert got["modes"] == want["modes"], r
        assert got["logits_mode"] == want["logits_mode"] == "quant8"


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_apply_spd_equals_sim(runs, case):
    (tp, dp), a = case
    ranks, sim = runs(tp, dp)
    want = sim[a]["spd"]
    assert want["categories"] == ["ISB", "SB", "ESB"]
    assert sorted(want["distill"]) == sorted(want["chosen"][1:])
    assert all(g[0] for g in want["grouping"].values())
    for r, res in enumerate(ranks):
        got = res[a]["spd"]
        _same_numbers(got, want, f"rank {r}")
        for k in ("modes", "categories", "chosen", "grouping"):
            assert got[k] == want[k], (r, k)
        assert sorted(got["distill"]) == sorted(want["distill"])
        for b, losses in want["distill"].items():
            # 2 epochs over the 2 calibration batches
            assert len(got["distill"][b]) == len(losses) == 4
            np.testing.assert_allclose(got["distill"][b], losses,
                                       rtol=DISTILL_RTOL,
                                       err_msg=f"rank {r} block {b}")


@pytest.mark.parametrize("what", ["policy", "spd"])
@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_greedy_tokens_after_equal_sim(runs, case, what):
    (tp, dp), a = case
    ranks, sim = runs(tp, dp)
    want = sim[a][what]["greedy"]
    assert len(want) == len(LENS) and all(len(t) == 6 for t in want)
    for res in ranks:
        assert res[a][what]["greedy"] == want


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"tp{x[0]}dp{x[1]}")
def test_every_rank_returns_the_same(runs, layout):
    ranks, _ = runs(*layout)
    for a in ARCHS:
        for what in ("policy", "spd"):
            r0 = ranks[0][a][what]
            for res in ranks[1:]:
                got = res[a][what]
                for k in r0:
                    if isinstance(r0[k], np.ndarray):
                        np.testing.assert_array_equal(got[k], r0[k])
                    else:
                        assert got[k] == r0[k], (a, what, k)


def test_comm_policy_equals_reference(runs, setup):
    """The reference's assign_comm_policy on the same parameters and
    calibration batches at tp 2 gives the ranks' plan."""
    trees, _ = setup
    a = "llama2-7b"
    ranks, _ = runs(2, 1)
    tree, _, policy, _ = trees[a]
    rcfg = _rcfg(a)
    plan, res = RSPD.assign_comm_policy(
        rcfg, jax.tree.map(jnp.asarray, tree),
        RD.calibration_batches(rcfg.vocab_size, 4, 32, batch=2), TP,
        **policy)
    for r in ranks:
        got = r[a]["policy"]
        assert got["modes"] == list(plan.modes())
        assert got["ranking"] == [int(i) for i in res.ranking]
        assert got["logits_mode"] == plan.comm.logits_mode
