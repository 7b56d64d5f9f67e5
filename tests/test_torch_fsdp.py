"""The port's FSDP train step (parallel/fsdp.py) against its ZeRO-1 step
and the reference's FSDP step on the CPU: fp32, reduced SmolLM-360M,
plan first_k(4, 2), the same canonical parameters and batches.  Mirrors
tests/test_extended_coverage.py::test_fsdp_matches_zero1_trajectory and
::test_multipod_fsdp_train_step."""
import functools

import jax
import numpy as np
import pytest

from conftest import make_cfg
from repro.config.base import SPDPlanConfig as RPlan
from repro.core import model as RM
from repro.parallel import fsdp as RF
from repro_torch.config.base import SPDPlanConfig, replace
from repro_torch.configs import get_config
from repro_torch.core import simtp
from repro_torch.core.convert import from_reference
from repro_torch.parallel import fsdp as F
from test_torch_train_step import (LR, N_DROP, TPD, _canonical, port_train,
                                   ref_train)
from torch_parity import (STEP_RTOL, TRAJ_RTOL, assert_params_close,
                          one_torch_thread)  # noqa: F401

STEPS = 4


@functools.lru_cache(maxsize=None)
def trajectories():
    """4 steps at dp 4, tp 2, 2 microbatches: the reference's FSDP, the
    port's FSDP and the port's ZeRO-1."""
    return {"ref_fsdp": ref_train(2, False, 0, True, STEPS, dp=4),
            "fsdp": port_train(2, False, 0, True, STEPS, dp=4),
            "zero1": port_train(2, False, 0, False, STEPS, dp=4)}


def _losses(run):
    return [m["loss"] for m in run[0]]


def test_fsdp_trajectory_matches_zero1():
    t = trajectories()
    np.testing.assert_allclose(_losses(t["fsdp"]), _losses(t["zero1"]),
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose([m["grad_norm"] for m in t["fsdp"][0]],
                               [m["grad_norm"] for m in t["zero1"][0]],
                               rtol=TRAJ_RTOL)


def test_fsdp_trajectory_matches_reference():
    t = trajectories()
    np.testing.assert_allclose(_losses(t["fsdp"]), _losses(t["ref_fsdp"]),
                               rtol=TRAJ_RTOL)
    assert _losses(t["fsdp"])[-1] < _losses(t["fsdp"])[0]


def test_fsdp_state_matches_reference():
    """After 4 steps: the params and the fp32 master within the
    sign-aware bound over every step's lr, m and v within the moments'
    drift of 4 steps."""
    (_, rp, ro, _), (_, pp, po, _) = (trajectories()["ref_fsdp"],
                                      trajectories()["fsdp"])
    assert_params_close(rp, pp, STEPS * LR, "params")
    # the reference's opt tree flattens as m, master, step, v (sorted keys)
    n = len(rp)
    r_m, r_master, r_step, r_v = (ro[:n], ro[n:2 * n], ro[2 * n],
                                  ro[2 * n + 1:])
    p_step, p_master, p_m, p_v = po[0], po[1:n + 1], po[n + 1:2 * n + 1], \
        po[2 * n + 1:]
    assert int(r_step) == int(p_step) == STEPS
    assert_params_close(r_master, p_master, STEPS * LR, "master")
    for a, b in zip(r_m + r_v, p_m + p_v):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=TRAJ_RTOL * float(np.abs(a).max()))


@pytest.mark.parametrize("pod", [0, 2], ids=["mesh2x2", "pod2x2x2"])
def test_fsdp_step_matches_reference(pod):
    """One FSDP step: metrics, params and the ledger entry for entry
    (each weight gather with one device's data slice, the pod
    all-reduce of each scattered gradient)."""
    (rm, rp, _, rl) = ref_train(1, False, pod, True, 1)
    (pm, pp, _, pl) = port_train(1, False, pod, True, 1)
    for k in ("loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(pm[0][k], rm[0][k], rtol=STEP_RTOL,
                                   err_msg=k)
    assert_params_close(rp, pp, LR, "params")
    assert pl == rl
    assert sum(op == "all-gather" for op, _, _ in pl) > 0


def test_fsdp_specs_match_reference():
    """The data-split axis of every leaf, from the port's shard-stacked
    params, equals the reference's from its stacked shapes (dp 2, 4)."""
    rcfg = make_cfg("smollm-360m")
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    rplan = RPlan.first_k(rcfg.n_layers, N_DROP)
    plan = SPDPlanConfig.first_k(cfg.n_layers, N_DROP)
    canon = jax.tree.map(np.asarray, _canonical())
    shapes = jax.eval_shape(lambda: RM.stack_segments(
        RM.pad_model(canon, rcfg, TPD), rcfg, rplan))
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, TPD)
    for dp in (2, 4):
        ref = RF.fsdp_specs(rcfg, rplan, dp, shapes)
        port = F.fsdp_specs(cfg, plan, dp, split)
        assert jax.tree.leaves(ref) == jax.tree.leaves(port)
        assert max(jax.tree.leaves(port)) >= 0
