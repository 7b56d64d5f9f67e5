"""The train step on the shard engine's ranks (one process per (data,
model) slot over gloo) against the port's sim step and the JAX
reference's shard_map loss.

`launch.train.make_trainer(engine="shard")` on every rank of a layout
(tp, dp) in {(2, 1), (1, 2), (2, 2)}, 3 steps of batch 8 x 32 tokens
in 2 microbatches, fp32, from the reference's parameters with every
bias, norm and position leaf moved off its constant:

  * ZeRO-1 and FSDP at every layout on reduced SmolLM-360M (plan
    first_k(4, 4)); at (2, 2) also SmolLM spd 0, OPT-6.7B spd 2 and
    Mamba2-370M spd 0 (the families `test_engines.py::
    test_sim_vs_shard_loss` trains, minus those ROADMAP A3 refuses);
    quant8 kept syncs at tp 2;
  * every step's loss, grad norm, tokens and lr equal the sim step's
    within STEP_RTOL (QUANT_RTOL through quant8), and the same on every
    rank; the global params and fp32 masters after 3 steps within the
    sign-aware bound of torch_parity.assert_params_close (its relative
    part QUANT_RTOL through quant8: at dp 2 a data rank's partial sums
    part from sim's batched ones by ulps and a quant8 code can flip), the
    moments within STEP_RTOL of their largest value but for the
    elements of flipped parameters (MOMENT_CAP through quant8); rank 0's
    comm ledger of the first step equals sim's entry for entry;
  * the first step's loss on (2, 2) equals the reference's shard_map
    loss of the same batch (the tests/test_engines.py pattern, 8 virtual
    CPU devices) at its rtol 2e-5;
  * a rank's gradient (remat on) is the same when its backward runs on
    another thread than its forward, as a CUDA backward does: the syncs
    of the backward and of the recomputation run over the forward's
    group.
Spawns: one per layout, each running all of its cases beside this
process's sim runs (torch_dist.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM  # noqa: E402
from repro.launch.mesh import make_test_mesh as ref_mesh  # noqa: E402
from repro.parallel import tp as RTP  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.data.synthetic import make_batch_iterator  # noqa: E402
import torch_dist as TD  # noqa: E402
from test_torch_train_step import QUANT_RTOL  # noqa: E402
from torch_parity import (PARAM_FLIP_FRAC, PARAM_REL,  # noqa: E402
                          STEP_RTOL, assert_params_close,
                          perturbed_canonical)
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ("smollm-360m", "opt-6.7b", "mamba2-370m")
LAYOUTS = ((2, 1), (1, 2), (2, 2))
LR = 1e-3
# (name, arch, blocks dropped, FSDP, kept-sync level) of each layout
BASE = [("zero1", "smollm-360m", 4, False, "exact"),
        ("fsdp", "smollm-360m", 4, True, "exact")]
QUANT = [("quant8", "smollm-360m", 2, False, "quant8"),
         ("fsdp quant8", "smollm-360m", 2, True, "quant8")]
WIDE = [("smollm spd0", "smollm-360m", 0, False, "exact"),
        ("opt spd2", "opt-6.7b", 2, False, "exact"),
        ("opt spd2 fsdp", "opt-6.7b", 2, True, "exact"),
        ("mamba spd0", "mamba2-370m", 0, False, "exact"),
        ("mamba spd0 fsdp", "mamba2-370m", 0, True, "exact")]
RUNS = {(2, 1): BASE + QUANT, (1, 2): BASE, (2, 2): BASE + QUANT + WIDE}
# the layouts whose ranks also run a backward on another thread than its
# forward (the autograd engine's thread on a CUDA device)
OFF_THREAD = ((2, 1), (2, 2))
# the reference's sim-vs-shard loss bound (tests/test_engines.py)
REF_RTOL = 2e-5
# the optimizer moments after 3 steps: within the step's rtol of each
# leaf's largest value, except the elements of parameters whose step-1
# sign flipped (assert_params_close's allowance: at most PARAM_FLIP_FRAC
# of them), whose later gradients follow another parameter value; those
# within MOMENT_CAP.  Through quant8 kept syncs at dp 2 a data rank's
# partial sums part from sim's batched ones by ulps and an int8 code can
# flip: a sync output then moves by one code step, 1/127 of its chunk's
# absmax, and the gradients after it by about as much relative to their
# largest (m) or twice that (v, quadratic in them).  There every element
# is held to MOMENT_CAP, 2.5 code steps: measured on the CPU, 0.79% for
# m and 0.84% for v of the leaf's largest value
MOMENT_CAP = 2e-2


def _cfg(arch):
    return replace(get_config(arch, reduced=True), dtype="float32")


def _rcfg(arch):
    return rreplace(rget(arch, reduced=True), dtype="float32")


def _kw(arch, drop, fsdp, comm):
    return dict(spd=drop / _cfg(arch).n_layers, fsdp=fsdp, comm=comm)


def _rtol(comm):
    return QUANT_RTOL if comm != "exact" else STEP_RTOL


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    trees = {a: perturbed_canonical(_rcfg(a)) for a in ARCHS}
    port = {a: from_reference(t, _cfg(a)) for a, t in trees.items()}
    path = tmp_path_factory.mktemp("shard_train") / "canon.pt"
    torch.save(port, path)
    return trees, port, str(path)


@pytest.fixture(scope="module")
def runs(canon):
    """runs(tp, dp) -> (the ranks' results, sim's): one spawn per layout,
    all started at the first use, beside this process's sim runs."""
    _, port, path = canon
    jobs = {lay: dict(tp=lay[0], dp=lay[1], params=path, cases=[
        dict(kind="train", name=name, arch=a, cfg=_cfg(a),
             kw=_kw(a, drop, fsdp, comm))
        for name, a, drop, fsdp, comm in RUNS[lay]]) for lay in LAYOUTS}
    for lay in OFF_THREAD:
        jobs[lay]["cases"].append(dict(
            kind="grads_off_thread", name="off thread", arch=ARCHS[0],
            cfg=_cfg(ARCHS[0])))
    waits = {lay: TD.start(job, deadline_s=600, timeout_s=120)
             for lay, job in jobs.items()}
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            sim = {}
            for case in jobs[(tp, dp)]["cases"]:
                if case["kind"] != "train":
                    continue
                tr, st = TD.trainer(case["cfg"], port[case["arch"]], "sim",
                                    tp, dp, **case["kw"])
                sim[case["name"]] = TD.trained(tr, st, 3)
            done[(tp, dp)] = waits[(tp, dp)](), sim
        return done[(tp, dp)]

    return get


def _grid():
    return [(lay, run) for lay in LAYOUTS for run in RUNS[lay]]


def _ids(case):
    (tp, dp), run = case
    return f"tp{tp}dp{dp}-{run[0].replace(' ', '_')}"


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_metrics_equal_sim_on_every_rank(runs, case):
    (tp, dp), (name, _, _, _, comm) = case
    ranks, sim = runs(tp, dp)
    want = sim[name]["metrics"]
    for r, res in enumerate(ranks):
        got = res[name]["metrics"]
        assert len(got) == len(want) == 3
        assert got == ranks[0][name]["metrics"], (r, name)
        for i, (g, w) in enumerate(zip(got, want)):
            for k in ("loss", "grad_norm", "tokens", "lr"):
                np.testing.assert_allclose(g[k], w[k], rtol=_rtol(comm),
                                           err_msg=f"{name} step {i} {k}")
        assert got[0]["tokens"] == 8 * 32


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_params_and_state_equal_sim(runs, case):
    """The global params and fp32 masters after 3 steps within the
    sign-aware bound (its relative part QUANT_RTOL through quant8); the
    moments as MOMENT_CAP says."""
    (tp, dp), (name, _, _, _, comm) = case
    ranks, sim = runs(tp, dp)
    got, want = ranks[0][name], sim[name]
    assert all("params" not in r[name] for r in ranks[1:])
    rel = PARAM_REL if comm == "exact" else QUANT_RTOL
    for key in ("params", "master"):
        assert_params_close(want[key], got[key], LR, f"{name} {key}",
                            rel=rel)
    assert got["opt_step"] == want["opt_step"] == 3
    assert len(got["moments"]) == len(want["moments"])
    rtol = STEP_RTOL if comm == "exact" else MOMENT_CAP
    far = total = 0
    for i, (a, b) in enumerate(zip(want["moments"], got["moments"])):
        top = max(float(np.abs(a).max()), 1e-30)
        d = np.abs(a - b)
        assert d.max() <= MOMENT_CAP * top, (name, i, d.max() / top)
        far += int((d > rtol * top).sum())
        total += a.size
    assert far <= PARAM_FLIP_FRAC * total, (name, far, total)


@pytest.mark.parametrize("case", _grid(), ids=_ids)
def test_rank0_ledger_equals_sim(runs, case):
    (tp, dp), (name, *_) = case
    ranks, sim = runs(tp, dp)
    got, want = ranks[0][name]["ledger"], sim[name]["ledger"]
    assert got == want and got
    axes = {e[1] for e in got}
    assert "data" in axes and "data+model" in axes


def _ref_loss(rcfg, plan, mesh, stacked, batch):
    """The reference's loss under shard_map: each device's CE sum and
    token count psum'd over the data axes (tests/test_engines.py)."""
    tp = mesh.shape["model"]
    dpx = RTP.dp_axes(mesh)
    p_specs = RTP.param_pspecs(rcfg, plan)
    b_specs = RTP.batch_pspecs(mesh, with_embeds=False)

    def local(p, b):
        _, met = RM.loss_fn(rcfg, p, plan, b, tp=tp, q_chunk=64)
        return (jax.lax.psum(met["sum_ce"], dpx)
                / jax.lax.psum(met["n_tok"], dpx))

    f = jax.jit(RTP.shard_map(local, mesh, in_specs=(p_specs, b_specs),
                              out_specs=P()))
    return float(f(jax.device_put(stacked, RTP.named(mesh, p_specs)),
                   jax.device_put(batch, RTP.named(mesh, b_specs))))


@pytest.mark.parametrize("name", ["zero1", "opt spd2"])
def test_first_loss_equals_reference_shard_map(runs, canon, name):
    """Step 1's loss (before any update) on ranks (2, 2) against the
    reference's shard_map loss on mesh (2, 2) of the same batch."""
    trees = canon[0]
    ranks, _ = runs(2, 2)
    _, arch, drop, _, _ = next(r for r in RUNS[(2, 2)] if r[0] == name)
    rcfg = _rcfg(arch)
    plan = RPlan.first_k(rcfg.n_layers, drop)
    batch = {k: v for k, v in next(make_batch_iterator(
        rcfg.vocab_size, 8, 32, seed=0)).items() if not k.startswith("_")}
    canon_j = jax.tree.map(jnp.asarray, trees[arch])
    stacked = jax.tree.map(jnp.asarray, RM.stack_segments(
        RM.pad_model(canon_j, rcfg, 2), rcfg, plan))
    ref = _ref_loss(rcfg, plan, ref_mesh(2, 2), stacked, batch)
    for res in ranks:
        np.testing.assert_allclose(res[name]["metrics"][0]["loss"], ref,
                                   rtol=REF_RTOL, atol=REF_RTOL)


@pytest.mark.parametrize("layout", OFF_THREAD,
                         ids=lambda x: f"tp{x[0]}dp{x[1]}")
def test_backward_off_thread_equals_on_thread(runs, layout):
    """A CUDA backward and a checkpoint's recomputation run on the
    autograd engine's own thread, where the model group's (thread-local)
    context is not bound: the gradient there must be the one computed on
    the forward's thread, the syncs over the group in both."""
    ranks, _ = runs(*layout)
    for r, res in enumerate(ranks):
        assert res["off thread"]["same"], r
        assert res["off thread"]["norm"] > 0, r
