"""PyTorch port vs JAX reference: training the MLA family (reduced
deepseek-v2-lite-16b, fp32: layer 0 MLA with a dense MLP, the rest MLA
with a routed MoE FFN; the reference's parameters perturbed off their
constants, routers made decisive: tests/torch_families.py says why).

* `make_grad_fn`'s loss (with the MoE layers' aux) and gradient tree
  against the reference's at tp 1, 2 and 4, all blocks kept and all
  dropped: LOSS_RTOL, GRAD_RTOL + GRAD_ATOL_FRAC (tests/
  test_torch_grads.py's bounds);
* the MLA block's gradient through the replicated latent projection
  (`wdkv`, `lnorm` through shared_param: every copy holds the full
  shard-summed gradient) against the reference's vmap(grad) at tp 2 and
  4, both wirings, on the dense and a MoE layer;
* tp 2 gradients, merged, equal tp 1's;
* the sim train step at dp 2 x tp 2 against the reference's shard_map
  step (ZeRO-1; FSDP against the reference's ZeRO-1 step, its
  data-split axes against the reference's fsdp_specs): step 1's
  metrics within STEP_RTOL, step 2's within TRAJ_RTOL, params within
  torch_parity.assert_params_close;
* a Trainer's checkpoint round-trips the latent leaves."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.tree import tree_leaves  # noqa: E402
import torch_families as TF  # noqa: E402
from torch_parity import (STEP_RTOL, TRAJ_RTOL,  # noqa: E402
                          assert_params_close)
from torch_parity import one_torch_thread  # noqa: E402,F401

NAME = TF.MLA
LR = 1e-3
STEPS = {"zero1": ("half", 2, False), "fsdp": ("half", 2, True)}


@pytest.mark.parametrize("plan_kind", ["none", "full"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_grads_match_reference(tp, plan_kind):
    """The whole gradient tree: embedding, the latent projection and its
    norm, the heads' wq / wuk / wuv / wo, the dense MLP, the MoE layers'
    experts; remat at tp 4 (the values do not change)."""
    rl, rg = TF.ref_grads(NAME, plan_kind, tp)
    pl, pg = TF.port_grads(NAME, plan_kind, tp, remat=tp == 4)
    np.testing.assert_allclose(pl, rl, rtol=TF.LOSS_RTOL)
    TF.close_trees(pg, rg)


@pytest.mark.parametrize("drop", [True, False], ids=["spd", "tp"])
@pytest.mark.parametrize("layer,tp", [(0, 2), (0, 4), (1, 2)])
def test_mla_block_grads_match_reference(layer, tp, drop):
    """The block probe sum(out^2): wdkv's and lnorm's gradients sum over
    the shards (the reference's shared_param in _mla_qkr)."""
    kind = TF.assert_block_grads(NAME, layer, tp, drop)
    assert kind.mixer == "mla" and kind.ffn == ("mlp" if layer == 0
                                                 else "moe")


def test_tp2_grads_match_tp1():
    """deepseek reduced pads no head at tp 2; merged leaf by leaf, the
    losses within 2e-5."""
    l1, g1 = TF.merged_grads(NAME, 1)
    l2, g2 = TF.merged_grads(NAME, 2)
    assert abs(l1 - l2) < 2e-5, (l1, l2)
    assert len(g1) == len(g2)
    for i, (a, b) in enumerate(zip(g1, g2)):
        TF.close(b, a.numpy(), f"leaf {i}")


@pytest.mark.parametrize("case", list(STEPS))
def test_train_step_matches_reference(case):
    """Two steps of batch 8 x 16 tokens at dp 2 x tp 2 (the MoE layers'
    rows routed by data slot) against the reference's ZeRO-1 shard_map
    step."""
    plan_kind, nmb, fsdp = STEPS[case]
    kw = dict(dp=2, tp=2, nmb=nmb, steps=2, batch=8, seq=16, lr=LR)
    pm, pp = TF.port_train(NAME, plan_kind, fsdp=fsdp, **kw)
    rm, rp = TF.ref_train(NAME, plan_kind, **kw)
    for i, (r, p) in enumerate(zip(rm, pm)):
        for k in ("loss", "grad_norm", "tokens", "lr"):
            np.testing.assert_allclose(p[k], r[k],
                                       rtol=TRAJ_RTOL if i else STEP_RTOL,
                                       err_msg=f"step {i + 1} {k}")
    assert_params_close(rp, pp, LR, case)


def test_fsdp_specs_match_reference():
    TF.assert_fsdp_specs(NAME, "half")


def test_checkpoint_round_trips_latent_leaves(tmp_path):
    """wdkv, lnorm, wuk and wuv restored leaf for leaf; the next step's
    loss equals the writer's own next step."""
    at2, resumed, step, loss, loss2 = TF.checkpoint_round_trip(NAME,
                                                               tmp_path)
    assert step == 2
    names = {k for lp in resumed["params"]["segs"] for k in lp["attn"]}
    assert {"wdkv", "lnorm", "wuk", "wuv"} <= names
    for a, b in zip(tree_leaves(at2), tree_leaves(resumed)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert loss2 == loss
