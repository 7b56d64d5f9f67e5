"""PyTorch port vs JAX reference: training and Algorithm 1 on the two
modality-frontend configs (reduced internvl2-1b and musicgen-medium,
fp32, tp 2; the reference's parameters perturbed off their constants).

* the gradient of every leaf, `front` among them, through batches that
  carry "embeds", within GRAD_RTOL of the reference's make_grad_fn (the
  prefix's projection is replicated over the model shards and its
  gradient taken inside the shard map, as `pos`'s is);
* two train steps at dp 2 x tp 2 in two microbatches against the
  reference's shard_map step (ZeRO-1), the port's FSDP step against
  the same: step 1's metrics within STEP_RTOL, step 2's within
  TRAJ_RTOL, params within the sign-aware bound;
* the trainer's embeds stream: bit for bit the reference's on an
  uninterrupted run, and on a resumed run too, where the reference
  restarts it (ROADMAP C13); a run resumed after a fault replays its
  losses;
* the train CLI on both configs;
* musicgen's Algorithm 1 on text-only calibration: the sweep's
  perplexities and the comm policy's plan equal the reference's."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.core import simtp as RS, spd as RSPD  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402
from repro.launch.mesh import make_test_mesh as ref_mesh  # noqa: E402
from repro.parallel import tp as RTP  # noqa: E402
from repro.runtime.trainer import Trainer as RTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as RTrainerConfig  # noqa: E402
from repro_torch.config.base import SPDPlanConfig  # noqa: E402
from repro_torch.core import simtp, spd as SPD  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.launch.train import main, make_trainer  # noqa: E402
from repro_torch.runtime.trainer import SimulatedFault  # noqa: E402
import torch_families as TF  # noqa: E402
from torch_parity import (STEP_RTOL, TRAJ_RTOL,  # noqa: E402
                          assert_params_close)
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ("internvl2-1b", "musicgen-medium")
TP, LR = 2, 1e-3
# a replayed step against its first attempt (test_torch_trainer.py's)
REPLAY_RTOL = 1e-6
PPL_RTOL = 1e-5             # test_torch_spd.py's


def _grad_batch(cfg, seq=24):
    return TF.train_batches(cfg.vocab_size, 1, 2, seq, TF.front_of(cfg))[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_with_embeds_match_reference(arch):
    """make_grad_fn at tp 2 with half the blocks dropped on a batch with
    embeds: loss within LOSS_RTOL, every leaf's gradient (each shard's
    copy of `front` holding the full shard-summed gradient) within
    GRAD_RTOL; `front`'s is not zero."""
    rcfg, cfg, canon = TF.cfgs(arch)
    rplan, plan = TF.plans("half", cfg.n_layers)
    b = _grad_batch(cfg)
    rsplit = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg, rplan,
                               TP)
    rloss, rg = RS.make_grad_fn(rcfg, rplan, TP, q_chunk=64)(
        rsplit, {k: jnp.asarray(v) for k, v in b.items()})
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, TP)
    loss, g = simtp.make_grad_fn(cfg, plan, TP, q_chunk=64)(split, b)
    np.testing.assert_allclose(float(loss), float(rloss),
                               rtol=TF.LOSS_RTOL)
    TF.close_trees(g, jax.tree.map(np.asarray, rg))
    assert float(g["front"].abs().max()) > 0
    torch.testing.assert_close(g["front"][0], g["front"][1], rtol=0, atol=0)


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, fsdp):
    """Two steps at dp 2 x tp 2 of batch 8 x 16 tokens with embeds, in
    two microbatches, against the reference's ZeRO-1 shard_map step;
    step 1's metrics within STEP_RTOL, step 2's within TRAJ_RTOL, params
    after within the sign-aware bound."""
    kw = dict(dp=2, tp=2, nmb=2, steps=2, batch=8, seq=16, lr=LR)
    pm, pp = TF.port_train(arch, "half", fsdp=fsdp, **kw)
    rm, rp = TF.ref_train(arch, "half", **kw)
    for i, (r, p) in enumerate(zip(rm, pm)):
        for k in ("loss", "grad_norm", "tokens", "lr"):
            np.testing.assert_allclose(p[k], r[k],
                                       rtol=TRAJ_RTOL if i else STEP_RTOL,
                                       err_msg=f"step {i + 1} {k}")
    assert_params_close(rp, pp, LR, arch)


def _port_trainer(arch, tmp_path, **kw):
    kw = dict(dict(device="cpu", steps=4, batch=4, seq=16, dp=2,
                   ckpt_every=2, ckpt_dir=str(tmp_path)), **kw)
    return make_trainer(f"{arch}-reduced", **kw)


def _embeds(it, n):
    return [next(it)["embeds"].numpy() for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_c13_embeds_stream_resumes_where_it_stopped(arch, tmp_path):
    """Uninterrupted, the port's embeds stream is the reference's bit for
    bit; resumed at step 2 it goes on with the draw of step 2, where
    the reference's restarts with the draw of step 0 (C13)."""
    tr, _ = _port_trainer(arch, tmp_path)
    whole = _embeds(tr.data_iter(0), 3)
    assert whole[0].shape == (4, tr.cfg.frontend_len, tr.cfg.frontend_dim)
    np.testing.assert_array_equal(_embeds(tr.data_iter(2), 1)[0], whole[2])
    rcfg = TF.cfgs(arch)[0]
    rtr = RTrainer(rcfg, RPlan.none(rcfg.n_layers), ref_mesh(2, 2),
                   RTP.TrainStepConfig(microbatches=1, remat=False,
                                       q_chunk=16),
                   RTrainerConfig(ckpt_dir=str(tmp_path / "ref"), batch=4,
                                  seq=16))
    rwhole = [np.asarray(next(it)["embeds"])
              for it in [rtr.data_iter(0)] for _ in range(3)]
    for a, b in zip(whole, rwhole):
        np.testing.assert_array_equal(a, b)
    rresumed = np.asarray(next(rtr.data_iter(2))["embeds"])
    np.testing.assert_array_equal(rresumed, rwhole[0])
    assert not np.array_equal(rresumed, rwhole[2])


def test_fault_resume_replays_the_same_losses(tmp_path):
    """musicgen-reduced: a fault at step 3 restores the step-2
    checkpoint; the replayed step 3 takes the same embeds and
    reproduces its first attempt's loss."""
    boom = {"armed": True}

    def hook(step):
        if step == 3 and boom["armed"]:
            boom["armed"] = False
            raise SimulatedFault()

    tr, st = _port_trainer("musicgen-medium", tmp_path, fault_hook=hook,
                           spd=0.5)
    tr.run(st)
    seen = {}
    for m in tr.metrics_log:
        seen.setdefault(m["step"], []).append(m["loss"])
    assert len(seen[3]) == 2, seen
    np.testing.assert_allclose(seen[3][1], seen[3][0], rtol=REPLAY_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_takes_the_frontends(arch, tmp_path, capsys):
    rc = main(["--arch", f"{arch}-reduced", "--device", "cpu", "--steps",
               "1", "--batch", "4", "--seq", "16", "--tp", "2", "--dp", "2",
               "--spd", "0.5", "--ckpt-dir", str(tmp_path)])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and last["final_step"] == 1
    assert np.isfinite(last["final_loss"])


def test_musicgen_algorithm1_matches_reference():
    """Text-only calibration (no embeds, as the reference's Algorithm 1
    takes none): the sweep's suffix perplexities within PPL_RTOL and
    the comm policy's drop / quant8 / exact plan at thresholds between
    the sensitivities equal the reference's."""
    rcfg, cfg, canon = TF.cfgs("musicgen-medium")
    calib = RD.calibration_batches(rcfg.vocab_size, 4, 32, batch=2)
    ref, _ = RSPD.sweep_sensitivity(rcfg, jax.tree.map(jnp.asarray, canon),
                                    calib, TP, q_chunk=64)
    res, _ = SPD.sweep_sensitivity(cfg, from_reference(canon, cfg), calib,
                                   TP, q_chunk=64)
    np.testing.assert_allclose(res.ppl_suffix, ref.ppl_suffix,
                               rtol=PPL_RTOL)
    s = np.sort(ref.sensitivity)
    scale = ref.ppl_suffix.max()
    assert np.diff(s).min() > 10 * PPL_RTOL * scale, s
    taus = float((s[0] + s[1]) / 2), float((s[-2] + s[-1]) / 2)
    kw = dict(n_spd=1, tau1=taus[0], tau2=taus[1], logits="quant8",
              q_chunk=64)
    rplan, _ = RSPD.assign_comm_policy(
        rcfg, jax.tree.map(jnp.asarray, canon), calib, TP, **kw)
    plan, _ = SPD.assign_comm_policy(cfg, from_reference(canon, cfg), calib,
                                     TP, **kw)
    assert isinstance(plan, SPDPlanConfig)
    assert plan.drop_mask == rplan.drop_mask
    assert plan.comm.block_modes == rplan.comm.block_modes
    assert {"drop", "quant8", "exact"} <= set(plan.modes()), plan.modes()
