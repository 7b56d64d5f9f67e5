"""Training the hybrid family (reduced hymba-1.5b, fp32: attention and
SSM heads side by side, layer 0 global, the rest windowed) against the
JAX reference, and the SSD scan (B8) under autograd.

* `ssd_scan._SSDScan`, the autograd Function the card's scan runs
  through when autograd records: its backward (the VJP of the plain
  version recomputed from the saved inputs) with the plain version
  standing in for the kernel launch gives the plain version's own
  autograd gradients for all six inputs, with a ragged S over a carried
  chunk, with and without a cotangent on the final state: 1e-5 of each
  gradient's largest |value| (the same fp32 operations in another
  graph);
* `make_grad_fn`'s loss and gradient tree against the reference's at tp
  1, 2 and 4, all blocks kept and all dropped, and the hybrid block's
  gradient (windowed attention beside the SSD scan) against the
  reference's vmap(grad) on the global and a windowed layer:
  tests/test_torch_grads.py's bounds (the reference's own tp check needs
  atol 1e-3 for the SSD's exp chains; these hold at its 1e-4 + 1e-5);
* tp 2 gradients, merged, equal tp 1's;
* the sim train step at dp 2 x tp 2 against the reference's ZeRO-1
  shard_map step (FSDP too; its data-split axes against the reference's
  fsdp_specs): step 1's metrics within STEP_RTOL, step 2's within
  TRAJ_RTOL, params within torch_parity.assert_params_close;
* a Trainer's checkpoint round-trips the SSM leaves."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan as SSD  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
import torch_families as TF  # noqa: E402
from torch_parity import (STEP_RTOL, TRAJ_RTOL,  # noqa: E402
                          assert_params_close)
from torch_parity import one_torch_thread  # noqa: E402,F401

NAME = TF.HYBRID
LR = 1e-3
STEPS = {"zero1": ("half", 2, False), "fsdp": ("half", 2, True)}
FN_ATOL_FRAC = 1e-5


def _scan_inputs(s, seed=0, bt=3, h=4, p=16, g=2, n=8):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).requires_grad_()

    x, bm, cm = t(bt, s, h, p), t(bt, s, g, n), t(bt, s, g, n)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (bt, s, h)).astype(
        np.float32)).requires_grad_()
    a = torch.from_numpy(-rng.uniform(0.5, 4.0, (bt, h)).astype(
        np.float32)).requires_grad_()
    return x, dt, a, bm, cm, t(bt, h)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["y", "y+state"])
@pytest.mark.parametrize("s", [16, 37], ids=["one-chunk", "ragged"])
def test_ssd_function_backward_matches_plain(s, with_state):
    """chunk 16: S 16 is one whole chunk, S 37 three chunks (the state
    carried twice, the last chunk ragged).  The forward outputs are the
    launch's bit for bit; the gradients of sum(y * w) (+ sum(state * u))
    equal those of the plain version differentiated directly."""
    ins = _scan_inputs(s)
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(ins[0].shape, generator=gen)
    u = torch.randn(ins[0].shape[0], ins[0].shape[2], ins[0].shape[3],
                    ins[3].shape[-1], generator=gen)
    calls = []

    def launch(*a, chunk):
        calls.append(chunk)
        with torch.no_grad():
            return SSD.ssd_scan_plain(*a, chunk=chunk)

    def objective(y, state):
        return (y * w).sum() + ((state * u).sum() if with_state else 0.0)

    y, state = SSD._SSDScan.apply(launch, 16, *ins)
    assert calls == [16] and y.requires_grad
    got = torch.autograd.grad(objective(y, state), ins)
    y0, state0 = SSD.ssd_scan_plain(*ins, chunk=16)
    torch.testing.assert_close(y, y0, rtol=0, atol=0)
    torch.testing.assert_close(state, state0, rtol=0, atol=0)
    want = torch.autograd.grad(objective(y0, state0), ins)
    for name, a, b in zip(("x", "dt", "a", "bm", "cm", "dd"), got, want):
        assert a is not None, name
        torch.testing.assert_close(
            a, b, rtol=0, atol=FN_ATOL_FRAC * float(b.abs().max()),
            msg=name)
    # an input that needs no gradient gets none, the rest still theirs
    ins2 = [t.detach() if i == 2 else t for i, t in enumerate(ins)]
    y2, _ = SSD._SSDScan.apply(launch, 16, *ins2)
    g2 = torch.autograd.grad((y2 * w).sum(), [t for i, t in enumerate(ins2)
                                              if i != 2])
    assert all(g is not None for g in g2)


def test_cpu_scan_stays_plain_and_counts_nothing():
    """On the CPU the wrapper is its plain version (differentiable
    directly), and no launch is counted."""
    ins = _scan_inputs(20)
    n0 = SSD.ssd_scan.launches
    y, _ = SSD.ssd_scan(*ins, chunk=16)
    assert y.grad_fn is not None and "SSDScan" not in type(y.grad_fn).__name__
    assert SSD.ssd_scan.launches == n0


@pytest.mark.parametrize("tp,plan_kind", [(1, "none"), (2, "none"),
                                          (2, "full"), (4, "none"),
                                          (4, "full")])
def test_grads_match_reference(tp, plan_kind):
    """The whole gradient tree: attention and SSM heads, the fusion's
    norms, the conv taps, A_log, D and the dt bias; remat at tp 4.  At
    tp 1 only the kept wiring (a dropped sync at tp 1 drops nothing)."""
    rl, rg = TF.ref_grads(NAME, plan_kind, tp)
    pl, pg = TF.port_grads(NAME, plan_kind, tp, remat=tp == 4)
    np.testing.assert_allclose(pl, rl, rtol=TF.LOSS_RTOL)
    TF.close_trees(pg, rg)


@pytest.mark.parametrize("drop", [True, False], ids=["spd", "tp"])
@pytest.mark.parametrize("layer", [0, 1], ids=["global", "windowed"])
def test_hybrid_block_grads_match_reference(layer, drop):
    """hybrid_mixer_seq's backward through the attention and the scan at
    tp 2, S 40: past the reduced window (32), three chunks of 16."""
    kind = TF.assert_block_grads(NAME, layer, 2, drop, seq=40)
    assert kind.mixer == "hybrid" and (kind.window == 0) == (layer == 0)


def test_tp2_grads_match_tp1():
    l1, g1 = TF.merged_grads(NAME, 1)
    l2, g2 = TF.merged_grads(NAME, 2)
    assert abs(l1 - l2) < 2e-5, (l1, l2)
    assert len(g1) == len(g2)
    for i, (a, b) in enumerate(zip(g1, g2)):
        TF.close(b, a.numpy(), f"leaf {i}")


@pytest.mark.parametrize("case", list(STEPS))
def test_train_step_matches_reference(case):
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


def test_checkpoint_round_trips_ssm_leaves(tmp_path):
    """The SSM heads' projections, conv taps, A_log, D, dt bias and the
    fusion norms restored leaf for leaf; the next step's loss equals the
    writer's own next step."""
    at2, resumed, step, loss, loss2 = TF.checkpoint_round_trip(NAME,
                                                               tmp_path)
    assert step == 2
    names = {k for lp in resumed["params"]["segs"] for k in lp["ssm"]}
    assert {"wx", "wbc", "convx", "alog", "dd", "dtb"} <= names
    for a, b in zip(tree_leaves(at2), tree_leaves(resumed)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert loss2 == loss
