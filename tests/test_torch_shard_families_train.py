"""Training and Algorithm 1 of the MoE, MLA and hybrid families on the
shard engine's ranks (one process per (data, model) slot over gloo)
against the port's sim engine and the JAX reference.

Reduced qwen2-moe-a2.7b, deepseek-v2-lite-16b and hymba-1.5b in fp32,
the reference's parameters perturbed off their constants and routers
made decisive (tests/torch_families.py):

  * ranks (2, 2): `make_trainer(engine="shard")`, 3 ZeRO-1 steps of
    batch 8 x 32 tokens in 2 microbatches, the first half of the blocks
    dropped, remat on (hymba also under FSDP).  A rank's rows are its
    data slot's, so its MoE layers route the reference's per-slot T.
    Every step's loss (with the MoE aux), grad norm, tokens and lr equal
    sim's within STEP_RTOL and the same on every rank; the global
    params and fp32 masters after 3 steps within the sign-aware bound
    of torch_parity.assert_params_close; step 1's loss equals the
    reference's shard_map train step's on mesh (2, 2) within 2e-5
    (tests/test_engines.py's bound);
  * ranks (2, 1): hymba's `apply_comm_policy` and `apply_spd` (one block
    a tier; the SB and ESB blocks distilled on each rank's shard, the
    SSD scan and the windowed attention under autograd): the plans, the
    ranking, the categories, the groupings (the identity on hybrid
    layers) and the greedy tokens after each equal sim's on every rank,
    the perplexities within 1e-5 of sim's largest and each distillation
    loss within 1e-5 relative (test_torch_shard_spd.py's bounds).
Spawns: one per layout, each running all of its cases beside this
process's sim runs (torch_dist.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import spd as SPD  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.data import calibration_batches  # noqa: E402
import torch_dist as TD  # noqa: E402
import torch_families as TF  # noqa: E402
from torch_parity import (STEP_RTOL, assert_params_close)  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

LR = 1e-3
# (name, arch, FSDP) trained on ranks (2, 2)
TRAIN = (("moe", TF.MOE, False), ("mla", TF.MLA, False),
         ("hybrid", TF.HYBRID, False), ("hybrid fsdp", TF.HYBRID, True))
ALG1 = TF.HYBRID
LENS = (5, 9, 7, 11)
REF_RTOL = 2e-5
PPL_RTOL = DISTILL_RTOL = 1e-5


def _spd(arch):
    """The trainer's drop fraction: the first half of the blocks."""
    n = TF.cfgs(arch)[1].n_layers
    return (n // 2) / n


def _alg1_kwargs(sens):
    """The comm policy drops the cheapest block, keeps the next two at
    quant8 and the dearest exact; apply_spd takes the three cheapest,
    one a tier (test_torch_shard_spd.py's)."""
    s = np.sort(sens)
    mid = [float((a + b) / 2) for a, b in zip(s[:-1], s[1:])]
    policy = dict(n_spd=2, tau1=mid[0], tau2=mid[2], sb_level="quant8",
                  logits="quant8", q_chunk=64)
    spd = dict(n_spd=3, tau1=mid[0], tau2=mid[1], epochs=2, q_chunk=64)
    return policy, spd


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    port = {a: from_reference(TF.cfgs(a)[2], TF.cfgs(a)[1])
            for a in (TF.MOE, TF.MLA, TF.HYBRID)}
    cfg = TF.cfgs(ALG1)[1]
    res, _ = SPD.sweep_sensitivity(cfg, port[ALG1], calibration_batches(
        cfg.vocab_size, 4, 32, batch=2), 2, q_chunk=64)
    s = np.sort(res.sensitivity)
    assert np.diff(s).min() > 10 * PPL_RTOL * res.ppl_suffix.max(), s
    path = tmp_path_factory.mktemp("shard_families_train") / "canon.pt"
    torch.save(port, path)
    return port, str(path), _alg1_kwargs(res.sensitivity)


@pytest.fixture(scope="module")
def runs(setup):
    """runs(tp, dp) -> (the ranks' results, sim's): both spawns started
    at the first use, beside this process's sim runs."""
    port, path, (policy, spd) = setup
    train = dict(tp=2, dp=2, params=path, cases=[
        dict(kind="train", name=name, arch=a, cfg=TF.cfgs(a)[1],
             kw=dict(spd=_spd(a), fsdp=fsdp))
        for name, a, fsdp in TRAIN])
    alg1 = dict(tp=2, dp=1, params=path, cases=[
        dict(kind="algorithm1", name=ALG1, arch=ALG1, cfg=TF.cfgs(ALG1)[1],
             lens=LENS, policy=policy, spd=spd)])
    jobs = {(2, 2): train, (2, 1): alg1}
    waits = {lay: TD.start(job, deadline_s=600, timeout_s=120)
             for lay, job in jobs.items()}
    sim = {}
    for case in train["cases"]:
        tr, st = TD.trainer(case["cfg"], port[case["arch"]], "sim", 2, 2,
                            **case["kw"])
        sim[case["name"]] = TD.trained(tr, st, 3)
    case = alg1["cases"][0]
    sim[ALG1] = TD.algorithm1(TD.load(case["cfg"], port[ALG1], "sim", 2),
                              case)
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            done[(tp, dp)] = waits[(tp, dp)](), sim
        return done[(tp, dp)]

    return get


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_metrics_equal_sim_on_every_rank(runs, name):
    ranks, sim = runs(2, 2)
    want = sim[name]["metrics"]
    for r, res in enumerate(ranks):
        got = res[name]["metrics"]
        assert len(got) == len(want) == 3
        assert got == ranks[0][name]["metrics"], (r, name)
        for i, (g, w) in enumerate(zip(got, want)):
            for k in ("loss", "grad_norm", "tokens", "lr"):
                np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL,
                                           err_msg=f"{name} step {i} {k}")
        assert got[0]["tokens"] == 8 * 32


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_params_equal_sim(runs, name):
    ranks, sim = runs(2, 2)
    got, want = ranks[0][name], sim[name]
    assert all("params" not in r[name] for r in ranks[1:])
    for key in ("params", "master"):
        assert_params_close(want[key], got[key], LR, f"{name} {key}")
    assert got["opt_step"] == want["opt_step"] == 3


@pytest.mark.parametrize("name", [t[0] for t in TRAIN if not t[2]])
def test_first_loss_equals_reference(runs, name):
    """Step 1's loss on every rank against the reference's shard_map
    train step's (the same plan, batch, microbatches; the MoE aux in
    both)."""
    arch = next(a for n, a, _ in TRAIN if n == name)
    n = TF.cfgs(arch)[1].n_layers
    assert _spd(arch) == (n // 2) / n
    ranks, _ = runs(2, 2)
    rm, _ = TF.ref_train(arch, "half", dp=2, tp=2, nmb=2, steps=1, batch=8,
                         seq=32, lr=LR)
    for res in ranks:
        np.testing.assert_allclose(res[name]["metrics"][0]["loss"],
                                   rm[0]["loss"], rtol=REF_RTOL)


def _same_numbers(got, want, what):
    scale = float(np.max(want["ppl_suffix"]))
    np.testing.assert_allclose(got["ppl_suffix"], want["ppl_suffix"],
                               rtol=PPL_RTOL, err_msg=what)
    np.testing.assert_allclose(got["sensitivity"], want["sensitivity"],
                               rtol=0, atol=PPL_RTOL * scale, err_msg=what)
    assert got["ranking"] == want["ranking"], what


def test_comm_policy_equals_sim(runs):
    ranks, sim = runs(2, 1)
    want = sim[ALG1]["policy"]
    assert set(want["modes"]) == {"drop", "quant8", "exact"}
    for r, res in enumerate(ranks):
        got = res[ALG1]["policy"]
        _same_numbers(got, want, f"rank {r}")
        assert got["modes"] == want["modes"], r
        assert got["greedy"] == want["greedy"], r


def test_apply_spd_equals_sim(runs):
    ranks, sim = runs(2, 1)
    want = sim[ALG1]["spd"]
    assert want["categories"] == ["ISB", "SB", "ESB"]
    assert sorted(want["distill"]) == sorted(want["chosen"][1:])
    assert not any(g[0] for g in want["grouping"].values())
    for r, res in enumerate(ranks):
        got = res[ALG1]["spd"]
        _same_numbers(got, want, f"rank {r}")
        for k in ("modes", "categories", "chosen", "grouping", "greedy"):
            assert got[k] == want[k], (r, k)
        for b, losses in want["distill"].items():
            assert len(got["distill"][b]) == len(losses) == 4
            np.testing.assert_allclose(got["distill"][b], losses,
                                       rtol=DISTILL_RTOL,
                                       err_msg=f"rank {r} block {b}")
