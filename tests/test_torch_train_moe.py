"""PyTorch port vs JAX reference: training the MoE family (reduced
qwen2-moe-a2.7b, fp32, the reference's parameters perturbed off their
constants and routers made decisive: tests/torch_families.py says why).

* `make_grad_fn`'s loss (the load-balance aux at aux_coef 0.01 in it)
  and gradient tree against the reference's at tp 1, 2 and 4, all
  blocks kept and all dropped: LOSS_RTOL, GRAD_RTOL + GRAD_ATOL_FRAC;
* the loss's parts (CE sum, tokens, aux) against the reference's
  loss_fn metrics;
* tp 2 gradients, merged, equal tp 1's: the reference's
  test_tp_grads_match_tp1, which holds only if the aux gradient counts
  once in a TP block (blocks.moe_partial);
* each data slot's rows route on their own (capacity, aux) when a sim
  batch holds several slots;
* the sim train step at dp 2 against the reference's shard_map step:
  the first step's metrics within STEP_RTOL (the loss includes the
  aux), the second's within TRAJ_RTOL (after AdamW's first step, a sign
  function, an element whose gradient is float noise moves +lr in one
  package and -lr in the other), params within
  torch_parity.assert_params_close.  The port's FSDP step is held to
  the reference's ZeRO-1 step, and its data-split axes to the
  reference's fsdp_specs: on this model the reference's own FSDP grad
  norm parts from its ZeRO-1 step's by 5e-5 of itself at step 1 and
  3.5e-4 at step 2 (past TRAJ_RTOL, its bound of FSDP against ZeRO-1 in
  tests/test_extended_coverage.py), while the port's FSDP and ZeRO-1
  agree within 1e-6 (ROADMAP C);
* a Trainer's checkpoint round-trips the expert stacks and the
  router;
* the train CLI trains each family (MoE, MLA, hybrid, SSM) on the
  CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import simtp as RS  # noqa: E402
from repro_torch.core import blocks as B, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
import torch_families as TF  # noqa: E402
from torch_parity import (STEP_RTOL, TRAJ_RTOL,  # noqa: E402
                          assert_params_close)
from torch_parity import one_torch_thread  # noqa: E402,F401

NAME = TF.MOE
LR = 1e-3
# (plan, microbatches, remat, fsdp) of the train step at dp 2, tp 2
STEPS = {"zero1": ("half", 2, False, False), "remat": ("none", 2, True, False),
         "fsdp": ("half", 2, False, True)}


@pytest.mark.parametrize("plan_kind", ["none", "full"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_grads_match_reference(tp, plan_kind):
    """The whole gradient tree (embedding, norms, router, expert stacks,
    shared experts) of the loss with its aux term; remat at tp 4 (the
    values do not change)."""
    rl, rg = TF.ref_grads(NAME, plan_kind, tp)
    pl, pg = TF.port_grads(NAME, plan_kind, tp, remat=tp == 4)
    np.testing.assert_allclose(pl, rl, rtol=TF.LOSS_RTOL)
    TF.close_trees(pg, rg)


@pytest.mark.parametrize("plan_kind", ["none", "full"])
def test_loss_parts_match_reference(plan_kind):
    """sum_ce, n_tok and aux of shard 0 at tp 2 equal the reference's
    loss_fn metrics, and the loss is sum_ce / n_tok + 0.01 aux."""
    rcfg, cfg, canon = TF.cfgs(NAME)
    rplan, plan = TF.plans(plan_kind, cfg.n_layers)
    b, rb = TF.calib(cfg.vocab_size)
    rsplit = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg, rplan,
                               2)
    rloss, rmet = RS.make_loss_fn(rcfg, rplan, 2, q_chunk=64)(rsplit, rb[0])
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, 2)
    loss, met = simtp.make_loss_fn(cfg, plan, 2, q_chunk=64)(split, b[0])
    for k in ("sum_ce", "n_tok", "aux"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                   rtol=TF.LOSS_RTOL, err_msg=k)
    assert float(met["aux"]) > 0
    np.testing.assert_allclose(float(loss), float(rloss), rtol=TF.LOSS_RTOL)
    np.testing.assert_allclose(
        float(loss), float(met["sum_ce"] / met["n_tok"] + 0.01 * met["aux"]),
        rtol=1e-6)


def test_tp2_grads_match_tp1():
    """tp 2 gradients merged to the padded layout equal tp 1's (qwen2-moe
    reduced pads nothing at tp 2), leaf by leaf; the losses within 2e-5.
    Routing the aux through the column entry and shared_param instead of
    the raw router would double the router's aux gradient at tp 2."""
    l1, g1 = TF.merged_grads(NAME, 1)
    l2, g2 = TF.merged_grads(NAME, 2)
    assert abs(l1 - l2) < 2e-5, (l1, l2)
    assert len(g1) == len(g2)
    for i, (a, b) in enumerate(zip(g1, g2)):
        TF.close(b, a.numpy(), f"leaf {i}")


def test_each_slot_routes_on_its_own():
    """moe_partial over two data slots' rows equals it over each slot's
    rows alone (the slot's T sets the capacity, its aux is its own), and
    differs from routing the four rows together: slot 0's 32 tokens are
    one token repeated, all routed to the same two experts, whose
    capacity is 13 a slot but 26 over both slots' 64 tokens."""
    _, cfg, canon = TF.cfgs(NAME)
    kind = layer_kinds(cfg)[0]
    assert kind.ffn == "moe"
    p = simtp.split_layer(from_reference(canon["layers"][0], cfg), cfg,
                          kind, 2)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(1, 4, 16, cfg.d_model, generator=gen)
    h[:, :2] = h[:, :1, :1]
    h = h.expand(2, 4, 16, cfg.d_model)
    with torch.no_grad():
        both, aux2 = B.moe_partial(cfg, p["moe"], h, slots=2)
        halves = [B.moe_partial(cfg, p["moe"], h[:, i:i + 2]) for i in (0, 2)]
        whole, aux1 = B.moe_partial(cfg, p["moe"], h)
    assert aux2.shape == (2, 2) and aux1.shape == (2, 1)
    torch.testing.assert_close(both, torch.cat([o for o, _ in halves], 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(aux2, torch.cat([a for _, a in halves], 1),
                               rtol=0, atol=0)
    assert (both - whole).abs().max() > 1e-3
    assert not torch.allclose(aux2.sum(-1), aux1[:, 0])


@pytest.mark.parametrize("case", list(STEPS))
def test_train_step_matches_reference(case):
    """Two steps at dp 2 x tp 2 of batch 8 x 16 tokens against the
    reference's shard_map step: each data slot's rows routed on their
    own, the loss = CE mean + aux_coef x the slots' aux over the
    microbatches; step 1's metrics within STEP_RTOL, step 2's within
    TRAJ_RTOL, params after within the sign-aware bound.  The port's
    FSDP step against the reference's ZeRO-1 step (module doc)."""
    plan_kind, nmb, remat, fsdp = STEPS[case]
    kw = dict(dp=2, tp=2, nmb=nmb, steps=2, batch=8, seq=16, remat=remat,
              lr=LR, fsdp=fsdp)
    pm, pp = TF.port_train(NAME, plan_kind, **kw)
    rm, rp = TF.ref_train(NAME, plan_kind, **dict(kw, fsdp=False))
    for i, (r, p) in enumerate(zip(rm, pm)):
        for k in ("loss", "grad_norm", "tokens", "lr"):
            np.testing.assert_allclose(p[k], r[k],
                                       rtol=TRAJ_RTOL if i else STEP_RTOL,
                                       err_msg=f"step {i + 1} {k}")
    assert_params_close(rp, pp, LR, case)


def test_fsdp_specs_match_reference():
    """FSDP's data-split axis of every leaf (the expert stacks split on
    their expert axis by TP) equals the reference's fsdp_specs at dp 2
    and tp 2."""
    TF.assert_fsdp_specs(NAME, "half")


def test_checkpoint_round_trips_expert_leaves(tmp_path):
    """The restored params and optimizer state equal those saved, leaf
    for leaf (expert stacks, router, shared experts among them), and the
    next step's loss equals the writer's own next step."""
    at2, resumed, step, loss, loss2 = TF.checkpoint_round_trip(NAME,
                                                               tmp_path)
    assert step == 2
    names = {k for lp in resumed["params"]["segs"] for k in lp["moe"]}
    assert {"router", "wu", "wg", "wd", "su", "sg", "sd"} <= names
    for a, b in zip(tree_leaves(at2), tree_leaves(resumed)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert loss2 == loss


@pytest.mark.parametrize("arch", [TF.MOE, TF.MLA, TF.HYBRID, TF.SSM])
def test_train_cli_takes_every_family(arch, tmp_path, capsys):
    """The train CLI trains each family (reduced, on the CPU): one step,
    its JSON line with a finite loss."""
    import json

    from repro_torch.launch.train import main
    rc = main(["--arch", f"{arch}-reduced", "--device", "cpu", "--steps",
               "1", "--batch", "4", "--seq", "16", "--tp", "2", "--dp", "2",
               "--spd", "0.5", "--ckpt-dir", str(tmp_path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and last["final_step"] == 1
    assert np.isfinite(last["final_loss"])
