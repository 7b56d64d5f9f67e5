"""The `Trainer` and the train CLI on the shard engine's ranks (one
process per (data, model) slot over gloo): checkpoints, fault recovery,
checkpoints moved between sim and the ranks, a re-shard to another data
degree, and `launch.train --engine shard`.

Reduced SmolLM-360M, fp32, plan first_k(4, 2), ZeRO-1, tp 2, batch 8 x
32 tokens in 2 microbatches, a cosine schedule over 4 steps, from the
reference's parameters with every bias, norm and position leaf moved
off its constant.  The sim engine in this process writes a dp-2
checkpoint at step 2 and runs the 4 steps uninterrupted (the reference
trajectory); then:

  * on ranks (2, 2), 4 steps with a checkpoint every 2 and a fault
    before step 4 end bit for bit where the run without the fault does
    (the replayed step's loss too), and both follow sim's trajectory
    within STEP_RTOL; rank 0 writes the manifest sim writes (the same
    leaf keys, shapes and dtypes);
  * sim's step-2 checkpoint resumes on ranks (2, 2) and on ranks (2, 1)
    (re-sharded from dp 2 to dp 1), and a ranks' (2, 2) checkpoint
    resumes on sim at dp 2 and dp 1: the 2 steps after each resume
    follow sim's trajectory within STEP_RTOL and end at its params
    within the sign-aware bound of torch_parity.assert_params_close;
  * `launch.train.main([..., "--engine", "shard"])` on ranks (2, 2):
    rank 0 prints the JSON line the sim run prints (the final loss
    within STEP_RTOL), the other ranks nothing;
  * `launch.serve.main([..., "--engine", "shard", "--replicas", "2",
    "--router", "prefix-affinity", "--metrics-json", ...])` on ranks (2,
    1) (paged, a pool that preempts): rank 0 prints sim's `outputs`,
    `paged` and `cluster` blocks, token for token, and writes the
    metrics with sim's request, token, preemption and routing counters;
    the other rank prints nothing.
Spawns: (2, 2) and (2, 1), each running all of its cases beside this
process's sim runs (torch_dist.py).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402

from repro_torch.checkpoint.ckpt import load_checkpoint  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
import torch_dist as TD  # noqa: E402
from torch_parity import (STEP_RTOL, assert_params_close,  # noqa: E402
                          perturbed_canonical)
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "smollm-360m"
LR = 1e-3
KW = dict(steps=4, spd=0.5, fsdp=False)
CLI = ["--arch", "smollm-360m-reduced", "--tp", "2", "--dp", "2",
       "--steps", "3", "--batch", "8", "--seq", "32", "--device", "cpu",
       "--ckpt-every", "2"]
SERVE_CLI = ["--arch", "smollm-360m-reduced", "--tp", "2", "--device", "cpu",
             "--requests", "6", "--max-new", "6", "--cache-len", "64",
             "--page-size", "8", "--num-pages", "10", "--spd", "0.25",
             "--replicas", "2", "--router", "prefix-affinity"]


def _cfg():
    return replace(get_config(ARCH, reduced=True), dtype="float32")


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    tree = perturbed_canonical(rreplace(rget(ARCH, reduced=True),
                                        dtype="float32"))
    port = {ARCH: from_reference(tree, _cfg())}
    root = tmp_path_factory.mktemp("shard_trainer")
    torch.save(port, root / "canon.pt")
    return port[ARCH], root


def _case(kind, name, dirname=None, **kw):
    return dict(kind=kind, name=name, arch=ARCH, cfg=_cfg(),
                dir=dirname, **kw)


@pytest.fixture(scope="module")
def runs(canon):
    """(ranks (2, 2), ranks (2, 1), sim's results): sim writes its step-2
    checkpoint first, then both spawns start and run beside sim's
    uninterrupted run, its CLI run and its resumes of the ranks'
    checkpoint."""
    port, root = canon
    d = {k: str(root / k) for k in ("sim2", "r_plain", "r_fault", "r2",
                                    "cli", "scli", "serve_m.json",
                                    "sserve_m.json")}
    tr, st = TD.trainer(_cfg(), port, "sim", 2, 2, ckpt_dir=d["sim2"],
                        **dict(KW, ckpt_every=2))
    TD.trained(tr, st, 2, leaves=False)
    every2 = dict(KW, ckpt_every=2)
    wide = [_case("train_ckpt", "plain", d["r_plain"], steps=4, kw=every2),
            _case("train_ckpt", "fault", d["r_fault"], steps=4, kw=every2,
                  fault=3),
            _case("train_ckpt", "from sim", d["sim2"], steps=2, kw=KW),
            _case("train_ckpt", "to sim", d["r2"], steps=2, kw=every2),
            _case("train_cli", "cli",
                  argv=CLI + ["--engine", "shard", "--ckpt-dir", d["cli"]])]
    narrow = [_case("train_ckpt", "dp1", d["sim2"], steps=2, kw=KW),
              _case("serve_cli", "serve",
                    argv=SERVE_CLI + ["--engine", "shard", "--metrics-json",
                                      d["serve_m.json"]])]
    params = str(root / "canon.pt")
    wait22 = TD.start(dict(tp=2, dp=2, params=params, cases=wide),
                      deadline_s=600, timeout_s=120)
    wait21 = TD.start(dict(tp=2, dp=1, params=params, cases=narrow),
                      deadline_s=600, timeout_s=120)
    sim = {}
    tr, st = TD.trainer(_cfg(), port, "sim", 2, 2, **KW)
    sim["ref"] = TD.trained(tr, st, 4)
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(CLI + ["--ckpt-dir", d["scli"]])
    sim["cli"] = {"rc": rc, "stdout": buf.getvalue()}
    from repro_torch.launch import serve
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(SERVE_CLI + ["--engine", "sim", "--metrics-json",
                                     d["sserve_m.json"]])
    sim["serve"] = {"rc": rc, "stdout": buf.getvalue()}
    ranks22 = wait22()
    for dp in (2, 1):
        tr, st = TD.trainer(_cfg(), port, "sim", 2, dp, ckpt_dir=d["r2"],
                            **KW)
        sim[f"to sim dp{dp}"] = dict(TD.trained(tr, st, 2),
                                     resumed=st["step"])
    return ranks22, wait21(), sim, d


def test_fault_resumes_bit_for_bit(runs):
    ranks, _, _, _ = runs
    for r, res in enumerate(ranks):
        plain, fault = res["plain"], res["fault"]
        assert plain["restores"] == 0 and fault["restores"] == 1, r
        assert plain["step"] == fault["step"] == 4
        # steps 1-3, the replayed step 3, step 4
        assert [m["loss"] for m in fault["metrics"]] == [
            m["loss"] for m in plain["metrics"][:3]
            + plain["metrics"][2:]], r
    p0, f0 = ranks[0]["plain"], ranks[0]["fault"]
    for key in ("params", "master", "moments"):
        for a, b in zip(p0[key], f0[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_ranks_follow_sim_and_write_its_manifest(runs):
    ranks, _, sim, d = runs
    ref = sim["ref"]
    for res in ranks:
        for g, w in zip(res["plain"]["metrics"], ref["metrics"]):
            for k in ("loss", "grad_norm", "tokens", "lr"):
                np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL)
    assert ranks[0]["plain"]["saves"] == [2, 4]
    assert_params_close(ref["params"], ranks[0]["plain"]["params"], LR)
    _, mine, meta = load_checkpoint(d["r_plain"])
    _, theirs, _ = load_checkpoint(d["sim2"])
    assert meta["data_step"] == 4
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
        assert mine[k].dtype == theirs[k].dtype, k


def _follows_ref(res, ref, what):
    assert res["resumed"] == 2, what
    assert len(res["metrics"]) == 2, what
    for g, w in zip(res["metrics"], ref["metrics"][2:]):
        for k in ("loss", "grad_norm", "tokens", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=STEP_RTOL,
                                       err_msg=f"{what} {k}")
    if "params" in res:
        assert_params_close(ref["params"], res["params"], LR, what)


@pytest.mark.parametrize("where", ["ranks dp2", "ranks dp1"])
def test_sim_checkpoint_resumes_on_ranks(runs, where):
    """Sim's dp-2 checkpoint on ranks (2, 2), and re-sharded onto ranks
    (2, 1)."""
    ranks22, ranks21, sim, _ = runs
    ranks = ranks22 if where == "ranks dp2" else ranks21
    name = "from sim" if where == "ranks dp2" else "dp1"
    for r, res in enumerate(ranks):
        _follows_ref(res[name], sim["ref"], f"{where} rank {r}")
        assert res[name]["restores"] == 1


@pytest.mark.parametrize("dp", [2, 1])
def test_rank_checkpoint_resumes_on_sim(runs, dp):
    """The ranks' (2, 2) step-2 checkpoint on sim at dp 2, and re-sharded
    to dp 1."""
    ranks, _, sim, _ = runs
    assert ranks[0]["to sim"]["saves"] == [2]
    _follows_ref(sim[f"to sim dp{dp}"], sim["ref"], f"sim dp{dp}")


def test_cli_engine_shard_prints_sims_line(runs):
    ranks, _, sim, _ = runs
    want = sim["cli"]["stdout"].strip().splitlines()
    got = ranks[0]["cli"]["stdout"].strip().splitlines()
    assert sim["cli"]["rc"] == 0 and all(r["cli"]["rc"] == 0 for r in ranks)
    assert all(r["cli"]["stdout"] == "" for r in ranks[1:])
    assert got[0].startswith("checkpoints in ")
    w, g = json.loads(want[-1]), json.loads(got[-1])
    assert sorted(g) == sorted(w) == ["final_loss", "final_step",
                                      "stragglers"]
    assert g["final_step"] == w["final_step"] == 3
    assert g["stragglers"] == w["stragglers"]
    np.testing.assert_allclose(g["final_loss"], w["final_loss"],
                               rtol=STEP_RTOL)
    assert os.path.isdir(os.path.join(got[0].split()[-1]))


def test_serve_cli_engine_shard_prints_sims_outputs(runs):
    _, ranks, sim, d = runs
    assert sim["serve"]["rc"] == 0
    assert all(r["serve"]["rc"] == 0 for r in ranks)
    assert ranks[1]["serve"]["stdout"] == ""
    w = json.loads(sim["serve"]["stdout"])
    g = json.loads(ranks[0]["serve"]["stdout"])
    assert g["completed"] == w["completed"] == 6
    for k in ("outputs", "paged", "cluster"):
        assert g[k] == w[k], k
    assert g["paged"]["preemptions"] > 0
    with open(d["serve_m.json"]) as f:
        m = json.load(f)["metrics"]
    with open(d["sserve_m.json"]) as f:
        sm = json.load(f)["metrics"]
    for k in ("requests_submitted_total", "tokens_generated_total",
              "preemptions_total", "ttft_seconds_count",
              'cluster_routed_total{policy="prefix-affinity",replica="1"}'):
        assert m[k] == sm[k], k
