"""The train step on a (pod, data, model) world of ranks (one process
per slot over gloo) against the port's sim step on the same mesh and the
JAX reference's three-axis shard_map loss.

  * `launch.dist.init_tp(tp, dp, pod=)` puts world rank (p * dp + d) *
    tp + m at pod p, data d, model m, the reference's
    `make_test_mesh(dp, tp, pod)` device order, and builds its model,
    data, pod, (pod, data) and replica groups from that order;
  * `launch.train.make_trainer(pod=)`, the Trainer on mesh
    `make_test_mesh(dp, tp, pod)` (reduced SmolLM-360M, fp32, plan
    first_k(4, 2), 2 steps of batch 8 x 32 tokens in 2 microbatches,
    remat), runs ZeRO-1, FSDP and quant8 kept
    syncs on every rank of (pod 2, data 2, model 2) and of (pod 2, data
    1, model 2), the card's layout: every step's loss, grad norm,
    tokens and lr equal the sim step's within STEP_RTOL (QUANT_RTOL
    through quant8) and the same on every rank; the global params and
    fp32 masters within the sign-aware bound of
    torch_parity.assert_params_close, the moments as
    test_torch_shard_train.py holds them; rank 0's first-step ledger
    equals sim's entry for entry, the pod all-reduce entries included;
  * step 1's loss on (2, 2, 2) equals the reference's shard_map loss on
    its mesh (2, 2, 2) of the same batch at rtol 2e-5
    (tests/test_engines.py::test_multipod_mesh_axes's bound).
Spawns: one per layout, each running all of its cases beside this
process's sim runs (torch_dist.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM  # noqa: E402
from repro.launch.mesh import make_test_mesh as ref_mesh  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.data.synthetic import make_batch_iterator  # noqa: E402
import torch_dist as TD  # noqa: E402
from test_torch_shard_train import (MOMENT_CAP, REF_RTOL,  # noqa: E402
                                    _ref_loss)
from test_torch_train_step import QUANT_RTOL  # noqa: E402
from torch_parity import (PARAM_FLIP_FRAC, PARAM_REL,  # noqa: E402
                          STEP_RTOL, assert_params_close,
                          perturbed_canonical)
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "smollm-360m"
# (pod, dp, tp): eight ranks, and the card's four
LAYOUTS = ((2, 2, 2), (2, 1, 2))
STEPS, DROP = 2, 2
LR = 1e-3                         # torch_dist.trainer's
RUNS = {"zero1": dict(), "fsdp": dict(fsdp=True),
        "quant8": dict(comm="quant8")}


def _cfg():
    return replace(get_config(ARCH, reduced=True), dtype="float32")


def _rcfg():
    return rreplace(rget(ARCH, reduced=True), dtype="float32")


def _kw(name, pod):
    return dict(RUNS[name], spd=DROP / _cfg().n_layers, steps=STEPS,
                pod=pod)


def _rtol(name):
    return QUANT_RTOL if name == "quant8" else STEP_RTOL


def _lid(lay):
    return "pod{}dp{}tp{}".format(*lay)


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    tree = perturbed_canonical(_rcfg())
    port = from_reference(tree, _cfg())
    path = tmp_path_factory.mktemp("shard_pod") / "canon.pt"
    torch.save({ARCH: port}, path)
    return tree, port, str(path)


@pytest.fixture(scope="module")
def runs(canon):
    """runs(layout) -> (the ranks' results, sim's): both spawns start at
    the first use, beside this process's sim runs."""
    _, port, path = canon
    jobs = {lay: dict(pod=lay[0], dp=lay[1], tp=lay[2], params=path,
                      cases=[dict(kind="layout", name="layout")] + [
                          dict(kind="train", name=n, arch=ARCH,
                               cfg=_cfg(), kw=_kw(n, lay[0])) for n in RUNS])
            for lay in LAYOUTS}
    waits = {lay: TD.start(job, deadline_s=300, timeout_s=120)
             for lay, job in jobs.items()}
    done = {}

    def get(lay):
        if lay not in done:
            pod, dp, tp = lay
            sim = {}
            for n in RUNS:
                tr, st = TD.trainer(_cfg(), port, "sim", tp, dp,
                                    **_kw(n, pod))
                sim[n] = TD.trained(tr, st, STEPS)
            done[lay] = waits[lay](), sim
        return done[lay]

    return get


@pytest.mark.parametrize("lay", LAYOUTS, ids=_lid)
def test_rank_layout_and_groups_follow_the_reference_mesh(runs, lay):
    """Each rank sits where the reference's make_test_mesh(dp, tp, pod)
    puts the device of its index, and each group holds the devices that
    share the other axes' coordinates."""
    pod, dp, tp = lay
    ranks, _ = runs(lay)
    ids = np.vectorize(lambda d: d.id)(ref_mesh(dp, tp, pod=pod).devices)
    assert ids.shape == (pod, dp, tp)
    assert len(ranks) == ids.size
    for r, res in enumerate(ranks):
        got = res["layout"]
        (p,), (d,), (m,) = np.nonzero(ids == r)
        assert got["rank"] == r and got["pod"] == pod
        assert (got["pod_rank"], got["data_rank"], got["model_rank"]) == \
            (p, d, m)
        assert got["model"] == sorted(ids[p, d, :].tolist())
        assert got["data"] == sorted(ids[p, :, m].tolist())
        assert got["pod_group"] == sorted(ids[:, d, m].tolist())
        assert got["pod_data"] == sorted(ids[:, :, m].ravel().tolist())
        assert got["replica"] == sorted(ids[p].ravel().tolist())


def _grid():
    return [(lay, n) for lay in LAYOUTS for n in RUNS]


def _ids(case):
    return f"{_lid(case[0])}-{case[1]}"


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_metrics_equal_sim_on_every_rank(runs, case):
    lay, name = case
    ranks, sim = runs(lay)
    want = sim[name]["metrics"]
    for r, res in enumerate(ranks):
        got = res[name]["metrics"]
        assert len(got) == len(want) == STEPS
        assert got == ranks[0][name]["metrics"], (r, name)
        for i, (g, w) in enumerate(zip(got, want)):
            for k in ("loss", "grad_norm", "tokens", "lr"):
                np.testing.assert_allclose(g[k], w[k], rtol=_rtol(name),
                                           err_msg=f"{name} step {i} {k}")
        assert got[0]["tokens"] == 8 * 32


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_params_and_state_equal_sim(runs, case):
    """The global params and fp32 masters after the steps within the
    sign-aware bound (its relative part QUANT_RTOL through quant8); the
    moments within the step's rtol of their largest value but for
    PARAM_FLIP_FRAC of the elements, every one within MOMENT_CAP
    (test_torch_shard_train.py says why)."""
    lay, name = case
    ranks, sim = runs(lay)
    got, want = ranks[0][name], sim[name]
    assert all("params" not in r[name] for r in ranks[1:])
    rel = PARAM_REL if name != "quant8" else QUANT_RTOL
    for key in ("params", "master"):
        assert_params_close(want[key], got[key], LR, f"{name} {key}",
                            rel=rel)
    assert got["opt_step"] == want["opt_step"] == STEPS
    rtol = STEP_RTOL if name != "quant8" else MOMENT_CAP
    far = total = 0
    for i, (a, b) in enumerate(zip(want["moments"], got["moments"])):
        top = max(float(np.abs(a).max()), 1e-30)
        d = np.abs(a - b)
        assert d.max() <= MOMENT_CAP * top, (name, i, d.max() / top)
        far += int((d > rtol * top).sum())
        total += a.size
    assert far <= PARAM_FLIP_FRAC * total, (name, far, total)


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_rank0_ledger_equals_sim_with_the_pod_all_reduce(runs, case):
    lay, name = case
    ranks, sim = runs(lay)
    got, want = ranks[0][name]["ledger"], sim[name]["ledger"]
    assert got == want and got
    axes = {e[1] for e in got}
    assert {"pod", "pod+data", "data", "data+model"} <= axes
    pods = [e for e in got if e[1] == "pod"]
    assert pods and all(e[0] == "all-reduce" for e in pods)


def test_first_loss_equals_reference_three_axis_shard_map(runs, canon):
    """Step 1's loss (before any update) on every rank of (2, 2, 2)
    against the reference's shard_map loss on mesh (pod 2, data 2,
    model 2) of the same batch."""
    tree = canon[0]
    ranks, _ = runs(LAYOUTS[0])
    rcfg = _rcfg()
    plan = RPlan.first_k(rcfg.n_layers, DROP)
    batch = {k: v for k, v in next(make_batch_iterator(
        rcfg.vocab_size, 8, 32, seed=0)).items() if not k.startswith("_")}
    stacked = jax.tree.map(jnp.asarray, RM.stack_segments(
        RM.pad_model(jax.tree.map(jnp.asarray, tree), rcfg, 2), rcfg, plan))
    ref = _ref_loss(rcfg, plan, ref_mesh(2, 2, pod=2), stacked, batch)
    for res in ranks:
        np.testing.assert_allclose(res["zero1"]["metrics"][0]["loss"], ref,
                                   rtol=REF_RTOL, atol=REF_RTOL)
