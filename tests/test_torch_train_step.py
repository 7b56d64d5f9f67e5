"""The port's train step (parallel/tp.py, parallel/zero1.py) against the
reference's shard_map train step on the CPU: fp32, reduced SmolLM-360M,
plan first_k(4, 2), both from the same canonical parameters and batches.

The port computes the whole global batch's gradient on one device; the
reference sums per-data-shard partials.  Loss, grad norm and tokens
agree to STEP_RTOL, parameters to the sign-aware bound of
torch_parity.assert_params_close, and one step's comm ledger entry for
entry (the data-axis collectives logged with one device's bytes)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import make_cfg
from repro.config.base import CommPolicy as RComm
from repro.config.base import SPDPlanConfig as RPlan
from repro.core import model as RM
from repro.launch.mesh import make_test_mesh as ref_mesh
from repro.parallel import tp as RTP
from repro.parallel import zero1 as RZ
from repro.parallel.collectives import collective_ledger as ref_ledger
from repro.parallel.layout import REPLICATED as R_REP
from repro_torch.config.base import CommPolicy, SPDPlanConfig, replace
from repro_torch.configs import get_config
from repro_torch.core import simtp
from repro_torch.core.convert import from_reference
from repro_torch.data.synthetic import make_batch_iterator
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import tp as TP
from repro_torch.parallel import zero1 as Z
from repro_torch.parallel.collectives import collective_ledger
from repro_torch.parallel.layout import REPLICATED, merge_leaf, split_leaf
from repro_torch.tree import tree_leaves
from torch_parity import (STEP_RTOL, assert_params_close, ledger_tuples,
                          one_torch_thread, perturbed_canonical)  # noqa: F401

TPD, LR, BATCH, SEQ, N_DROP = 2, 1e-3, 8, 32, 2
# (microbatches, remat, pod degree); dp 2 on every mesh
CASES = {"mb1": (1, False, 0), "mb2": (2, False, 0), "remat": (2, True, 0),
         "pod": (1, False, 2)}
# the ZeRO-1 update alone on the same numbers: the same fp32 operations
UPDATE_RTOL = 1e-6
# loss and grad norm through quant8 kept syncs at tp 1: XLA's and torch's
# partials differ by ulps and a value at a rounding boundary takes the
# next code (tests/test_torch_grads_quant.py); the exact plan's grad
# norm differs from quant8's by ~1%, 10x this
QUANT_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def _canonical():
    return perturbed_canonical(make_cfg("smollm-360m"))


def batches(n, vocab=512, batch=BATCH, seq=SEQ):
    it = make_batch_iterator(vocab, batch, seq, seed=0)
    return [{k: v for k, v in next(it).items() if not k.startswith("_")}
            for _ in range(n)]


def ref_train(nmb, remat, pod, fsdp, steps, dp=2):
    """The reference's train step: per-step metrics, the global params and
    optimizer state leaves after `steps`, and the first step's ledger."""
    rcfg = make_cfg("smollm-360m")
    plan = RPlan.first_k(rcfg.n_layers, N_DROP)
    mesh = ref_mesh(dp, TPD, pod=pod)
    ts = RTP.TrainStepConfig(microbatches=nmb, remat=remat, q_chunk=32,
                             lr=LR, fsdp=fsdp)
    canon = jax.tree.map(jnp.asarray, _canonical())
    stacked = jax.tree.map(jnp.asarray, RM.stack_segments(
        RM.pad_model(canon, rcfg, TPD), rcfg, plan))
    shapes = jax.eval_shape(lambda: stacked) if fsdp else None
    step, init, specs = RTP.build_train_step(rcfg, plan, mesh, ts,
                                             stacked_shapes=shapes)
    gp = jax.device_put(stacked, RTP.named(mesh, specs["params"]))
    opt = init(gp)
    mets, led = [], None
    for i, b in enumerate(batches(steps)):
        gb = jax.device_put(b, RTP.named(mesh, specs["batch"]))
        if i == 0:
            with ref_ledger() as led:
                gp, opt, met = step(gp, opt, gb)
        else:
            gp, opt, met = step(gp, opt, gb)
        mets.append({k: float(v) for k, v in met.items()})
    return (mets, [np.asarray(x) for x in jax.tree.leaves(gp)],
            [np.asarray(x) for x in jax.tree.leaves(opt)],
            ledger_tuples(led))


def port_train(nmb, remat, pod, fsdp, steps, dp=2):
    """The port's, on the same numbers; params merged to the global
    stacked tree, FSDP's state too."""
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    plan = SPDPlanConfig.first_k(cfg.n_layers, N_DROP)
    mesh = make_test_mesh(dp, TPD, pod=pod)
    ts = TP.TrainStepConfig(microbatches=nmb, remat=remat, q_chunk=32,
                            lr=LR, fsdp=fsdp)
    step, init, _ = TP.build_train_step(cfg, plan, mesh, ts, device="cpu")
    params = simtp.prepare_params(from_reference(_canonical(), cfg), cfg,
                                  plan, TPD)
    opt = init(params)
    mets, led = [], None
    for i, b in enumerate(batches(steps)):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        if i == 0:
            with collective_ledger() as led:
                params, opt, met = step(params, opt, tb)
        else:
            params, opt, met = step(params, opt, tb)
        mets.append({k: float(v) for k, v in met.items()})

    def merged(tree):
        return tree_leaves(simtp.merge_stacked(tree, cfg, plan, TPD))

    if fsdp:
        opt_leaves = [opt["step"]] + merged(opt["master"]) + merged(
            opt["m"]) + merged(opt["v"])
    else:
        opt_leaves = tree_leaves(opt)
    return (mets, [t.numpy() for t in merged(params)],
            [t.numpy() for t in opt_leaves], ledger_tuples(led))


@functools.lru_cache(maxsize=None)
def pair(case):
    nmb, remat, pod = CASES[case]
    return (ref_train(nmb, remat, pod, False, 1),
            port_train(nmb, remat, pod, False, 1))


@pytest.mark.parametrize("case", list(CASES))
def test_step_metrics_match_reference(case):
    (rm, _, _, _), (pm, _, _, _) = pair(case)
    for k in ("loss", "grad_norm", "tokens", "lr"):
        np.testing.assert_allclose(pm[0][k], rm[0][k], rtol=STEP_RTOL,
                                   err_msg=k)
    assert pm[0]["tokens"] == BATCH * SEQ


@pytest.mark.parametrize("case", list(CASES))
def test_step_params_and_state_match_reference(case):
    (_, rp, ro, _), (_, pp, po, _) = pair(case)
    assert_params_close(rp, pp, LR, "params")
    # ZeRO-1 state: {"m","v","w"} per leaf (dp, tp, n), then the step
    assert len(ro) == len(po)
    assert int(po[-1]) == int(ro[-1]) == 1
    ws = [(a, b) for i, (a, b) in enumerate(zip(ro[:-1], po[:-1]))
          if i % 3 == 2]
    assert_params_close(*zip(*ws), LR, "master slices")
    for i, (a, b) in enumerate(zip(ro[:-1], po[:-1])):
        if i % 3 != 2:                  # m, v: no sign flips
            np.testing.assert_allclose(
                b, a, rtol=0, atol=STEP_RTOL * float(np.abs(a).max()),
                err_msg=f"moment {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_step_ledger_matches_reference(case):
    """(op, axis, bytes) of one step, in order: the reference's as traced
    by its first call, the port's as logged by its run."""
    (_, _, _, rl), (_, _, _, pl) = pair(case)
    assert pl == rl
    axes = {a for _, a, _ in pl}
    assert {"data", "model", "data+model"} <= axes
    if CASES[case][2]:
        assert {"pod", "pod+data"} <= axes


def _update_inputs(rng):
    """One tree: a model-sharded leaf, a replicated one, and a sharded
    leaf whose per-shard size (9) is not a multiple of dp."""
    params = {"a": rng.standard_normal((6, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "c": rng.standard_normal((3, 6)).astype(np.float32)}
    specs = {"a": 0, "b": REPLICATED, "c": 1}
    grads = [{k: 3 * rng.standard_normal((2,) + v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    return params, specs, grads


def test_zero1_update_clipped_matches_reference():
    """Two clipped updates from zero1_init_structured: the reference under
    shard_map on mesh (2, 2), fed per-data-shard gradient partials; the
    port fed their sums.  Params, state and gnorm within UPDATE_RTOL."""
    params, specs, grads = _update_inputs(np.random.default_rng(3))
    kw = dict(dp=2, lr=LR, weight_decay=0.1, clip_norm=1.0)
    mesh = ref_mesh(2, 2)
    pspec = {"a": P("model"), "b": P(), "c": P(None, "model")}
    gspec = {"a": P("data", "model"), "b": P("data"),
             "c": P("data", None, "model")}
    sspec = {"leaves": {k: {"m": P("data", "model"), "v": P("data", "model"),
                            "w": P("data", "model")} for k in params},
             "step": P()}
    rspecs = {"a": 0, "b": R_REP, "c": 1}

    def local(p, g1, g2):
        st = RZ.zero1_init_structured(p, 2, jax.lax.axis_index("data"))
        norms = []
        for g in (g1, g2):
            g = jax.tree.map(lambda x: x[0], g)
            p, st, gn = RZ.zero1_update_clipped(g, st, p, specs=rspecs, **kw)
            norms.append(gn)
        return p, st, jnp.stack(norms)

    f = jax.jit(RTP.shard_map(local, mesh, in_specs=(pspec, gspec, gspec),
                              out_specs=(pspec, sspec, P())))
    rp, rs, rn = f(*jax.tree.map(jnp.asarray, (params, *grads)))
    assert float(rn[0]) > 1.0           # the clip is active

    def split(tree):
        return {k: split_leaf(torch.from_numpy(np.asarray(v)), specs[k], 2)
                for k, v in tree.items()}

    pp = split(params)
    st = Z.zero1_init_structured(pp, 2)
    pn = []
    for g in grads:
        gsum = split({k: v.sum(0) for k, v in g.items()})
        pp, st, gn = Z.zero1_update_clipped(gsum, st, pp, specs=specs, **kw)
        pn.append(float(gn))
    np.testing.assert_allclose(pn, np.asarray(rn), rtol=UPDATE_RTOL)
    for k in params:
        np.testing.assert_allclose(
            merge_leaf(pp[k], specs[k], 2).numpy(), np.asarray(rp[k]),
            rtol=UPDATE_RTOL, atol=1e-7, err_msg=k)
        for s in ("m", "v", "w"):
            np.testing.assert_allclose(
                st["leaves"][k][s].numpy(), np.asarray(rs["leaves"][k][s]),
                rtol=UPDATE_RTOL, atol=1e-9, err_msg=f"{k}.{s}")
    assert int(st["step"]) == int(rs["step"]) == 2


def test_zero1_reshard_preserves_content():
    """dp 2 -> 1 -> 4: per model shard the concatenated slices are the
    same flat parameter; equal to the reference's reshard of the same
    arrays where it applies (the padded length divides by 4; the port
    pads the others with zeros)."""
    params, specs, _ = _update_inputs(np.random.default_rng(4))
    pp = {k: split_leaf(torch.from_numpy(v), specs[k], 2)
          for k, v in params.items()}
    st2 = Z.zero1_init_structured(pp, 2)
    st1 = Z.zero1_reshard(st2, 1)
    st4 = Z.zero1_reshard(st1, 4)
    for k, p in pp.items():
        n = p[0].numel()
        for st in (st2, st1, st4):
            w = st["leaves"][k]["w"]
            flat = w.transpose(0, 1).reshape(w.shape[1], -1)[:, :n]
            torch.testing.assert_close(flat, p.reshape(2, -1), rtol=0,
                                       atol=0)
        if st2["leaves"][k]["w"][:, 0].numel() % 4:
            continue
        ref = RZ.zero1_reshard(RZ.zero1_reshard(
            {"leaves": {k: {"w": jnp.asarray(st2["leaves"][k]["w"].numpy())}},
             "step": 0}, 1), 4)
        np.testing.assert_array_equal(np.asarray(ref["leaves"][k]["w"]),
                                      st4["leaves"][k]["w"].numpy())


def test_grad_sq_groups_count_replicated_once():
    """The spec-aware squares: a replicated leaf once, a sharded leaf over
    every shard; sh + rp is the squared norm of the merged gradient."""
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    plan = SPDPlanConfig.first_k(cfg.n_layers, N_DROP)
    g = simtp.prepare_params(from_reference(_canonical(), cfg), cfg, plan,
                             TPD)
    sh, rp = TP._grad_sq_groups(g, cfg, plan)
    merged = tree_leaves(simtp.merge_stacked(g, cfg, plan, TPD))
    total = sum(float((w.double() ** 2).sum()) for w in merged)
    np.testing.assert_allclose(float(sh + rp), total, rtol=1e-6)
    assert float(rp) > 0


def test_step_quant8_tp1_matches_reference():
    """Three steps with every kept sync at quant8 on mesh (2, 1): the
    gradient goes through the quantized sync's identity backward in both
    packages (the reference's is right at tp 1; ROADMAP C5 is tp > 1).
    Losses and grad norms within QUANT_RTOL, the ledgers equal."""
    rcfg = make_cfg("smollm-360m")
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    n = cfg.n_layers
    rplan = RPlan(RPlan.first_k(n, N_DROP).drop_mask,
                  RComm.uniform(n, "quant8"))
    plan = SPDPlanConfig.first_k(n, N_DROP).with_comm(
        CommPolicy.uniform(n, "quant8"))
    mesh = ref_mesh(2, 1)
    ts = dict(microbatches=2, remat=False, q_chunk=32, lr=LR)
    step, init, specs = RTP.build_train_step(rcfg, rplan, mesh,
                                             RTP.TrainStepConfig(**ts))
    canon = jax.tree.map(jnp.asarray, _canonical())
    gp = jax.device_put(jax.tree.map(jnp.asarray, RM.stack_segments(
        RM.pad_model(canon, rcfg, 1), rcfg, rplan)),
        RTP.named(mesh, specs["params"]))
    opt = init(gp)
    pstep, pinit, _ = TP.build_train_step(cfg, plan, make_test_mesh(2, 1),
                                          TP.TrainStepConfig(**ts),
                                          device="cpu")
    params = simtp.prepare_params(from_reference(_canonical(), cfg), cfg,
                                  plan, 1)
    popt = pinit(params)
    exact = port_train(2, False, 0, False, 1)[0][0]["grad_norm"]
    for i, b in enumerate(batches(3)):
        with ref_ledger() as rl:
            gp, opt, rm = step(gp, opt, jax.device_put(
                b, RTP.named(mesh, specs["batch"])))
        with collective_ledger() as pl:
            params, popt, pm = pstep(params, popt, {
                k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=QUANT_RTOL, err_msg=f"{k} {i}")
        if i == 0:
            assert ledger_tuples(pl) == ledger_tuples(rl)
            assert ("reduce-scatter", "model") in {
                (e.op, e.axis) for e in pl}
            assert abs(float(pm["grad_norm"]) - exact) > 10 * QUANT_RTOL * exact
