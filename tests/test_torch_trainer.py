"""The port's fault-tolerant Trainer (runtime/trainer.py), elastic
re-mesh (runtime/elastic.py) and train CLI (launch/train.py) on the CPU:
the reference's trainer tests (tests/test_checkpoint_trainer.py,
tests/test_server_elastic.py) on the port, the CLI in a subprocess, and
the refusal of a run without --device cpu and no card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config.base import SPDPlanConfig, replace
from repro_torch.configs import get_config
from repro_torch.core import model as M
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import make_trainer
from repro_torch.parallel import tp as TP
from repro_torch.runtime.elastic import (ClusterConfigError,
                                         ElasticController,
                                         choose_mesh_shape)
from repro_torch.runtime.trainer import (SimulatedFault, Trainer,
                                         TrainerConfig)
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# a replayed step against its first attempt: the reference's bound
REPLAY_RTOL = 1e-6


def _cfg(name="smollm-360m-reduced"):
    return replace(get_config(name), dtype="float32")


def _mk_trainer(tmp_path, fault_hook=None, steps=12, mesh=None):
    cfg = _cfg()
    plan = SPDPlanConfig.first_k(cfg.n_layers, 2)
    ts = TP.TrainStepConfig(microbatches=1, remat=False, q_chunk=32,
                            lr=1e-3)
    tc = TrainerConfig(total_steps=steps, ckpt_dir=str(tmp_path),
                       ckpt_every=4, batch=4, seq=32)
    tr = Trainer(cfg, plan, mesh or make_test_mesh(2, 2), ts, tc,
                 fault_hook=fault_hook, device="cpu")
    return tr, M.init_model(cfg, seed=0)


def test_training_descends(tmp_path):
    tr, params = _mk_trainer(tmp_path, steps=32)
    state = tr.run(tr.init_state(params))
    assert state["step"] == 32
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_fault_recovery_resumes_from_checkpoint(tmp_path):
    boom = {"armed": True}

    def hook(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise SimulatedFault("node died")

    tr, params = _mk_trainer(tmp_path, fault_hook=hook, steps=12)
    state = tr.run(tr.init_state(params))
    assert state["step"] == 12
    steps_seen = [m["step"] for m in tr.metrics_log]
    assert len(steps_seen) > 12
    assert steps_seen.count(5) == 2
    # the cadence wrote step 12: the final save does not write it again
    assert [s for s, _, _ in tr.save_log] == [4, 8, 12]


@pytest.mark.parametrize("fault_at,replayed", [(6, [5, 6]), (7, [5, 6, 7])])
def test_recovery_is_deterministic(tmp_path, fault_at, replayed):
    """Same data cursor after restore: every step replayed from the
    step-4 checkpoint reproduces its first attempt's loss."""
    boom = {"armed": True}

    def hook(step):
        if step == fault_at and boom["armed"]:
            boom["armed"] = False
            raise SimulatedFault()

    tr, params = _mk_trainer(tmp_path, fault_hook=hook, steps=8)
    tr.run(tr.init_state(params))
    first, replays = {}, {}
    for m in tr.metrics_log:
        if m["step"] in first:
            replays[m["step"]] = (first[m["step"]], m["loss"])
        else:
            first[m["step"]] = m["loss"]
    assert sorted(replays) == replayed
    for step, (a, b) in replays.items():
        np.testing.assert_allclose(a, b, rtol=REPLAY_RTOL, err_msg=str(step))


def test_fault_before_first_checkpoint_raises(tmp_path):
    """The step updates the state in place: a fault with no checkpoint to
    restore raises instead of replaying trained weights from step 0."""
    def hook(step):
        if step == 2:
            raise SimulatedFault("node died")

    tr, params = _mk_trainer(tmp_path, fault_hook=hook, steps=8)
    with pytest.raises(RuntimeError, match="nothing to restore"):
        tr.run(tr.init_state(params))
    assert [m["step"] for m in tr.metrics_log] == [1, 2]


def test_trainer_defaults_to_card(monkeypatch, tmp_path):
    """No device given: the card, and an error without one; the default
    checkpoint directory is a new temporary one for each config."""
    a, b = TrainerConfig(), TrainerConfig()
    assert a.ckpt_dir != b.ckpt_dir and os.path.isdir(a.ckpt_dir)
    os.rmdir(a.ckpt_dir)
    os.rmdir(b.ckpt_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    plan = SPDPlanConfig.first_k(cfg.n_layers, 2)
    ts = TP.TrainStepConfig(microbatches=1, remat=False, q_chunk=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.build_train_step(cfg, plan, make_test_mesh(1, 2), ts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, plan, make_test_mesh(1, 2), ts,
                TrainerConfig(ckpt_dir=str(tmp_path)))


def test_straggler_detection(tmp_path):
    tr, _ = _mk_trainer(tmp_path, steps=1)
    for s in range(1, 9):
        tr._track_time(s, 0.1)
    tr._track_time(9, 0.45)           # 4.5x the EWMA -> flagged
    assert tr.straggler_events and tr.straggler_events[-1]["step"] == 9
    tr._track_time(10, 0.12)
    assert tr.straggler_events[-1]["step"] == 9


def test_elastic_shrink_remesh(tmp_path):
    """Live slots 8 -> 4: the mesh goes (4, 2) -> (2, 2), the ZeRO-1
    state is re-sharded from the checkpoint, and training resumes from
    the checkpointed step."""
    assert choose_mesh_shape(8, 2) == (4, 2)
    assert choose_mesh_shape(6, 2) == (2, 2)
    params = M.init_model(_cfg(), seed=0)
    live = {"slots": list(range(8))}

    def factory(mesh):
        return _mk_trainer(tmp_path, steps=4, mesh=mesh)[0]

    ctl = ElasticController(factory, tp=2, probe=lambda: live["slots"])
    assert tuple(ctl.mesh.devices.shape) == (4, 2)
    state = ctl.trainer.run(ctl.trainer.init_state(params), steps=4)
    w4 = {k: v["w"].clone() for k, v in state["opt"]["leaves"][
        "segs"][0]["mlp"].items()}
    live["slots"] = list(range(4))
    state = ctl.maybe_remesh(state, params)
    assert ctl.events and ctl.events[-1].new_mesh_shape == (2, 2)
    assert ctl.events[-1].old_devices == 8 and state["step"] == 4
    for k, w in w4.items():                       # (4, 2, n) -> (2, 2, 2n)
        got = state["opt"]["leaves"]["segs"][0]["mlp"][k]["w"]
        assert got.shape[0] == 2
        flat = lambda x: x.transpose(0, 1).reshape(x.shape[1], -1)  # noqa
        n = min(flat(w).shape[1], flat(got).shape[1])
        torch.testing.assert_close(flat(got)[:, :n], flat(w)[:, :n])
    state = ctl.trainer.run(state, steps=4)
    assert np.isfinite(ctl.trainer.metrics_log[-1]["loss"])
    assert state["step"] == 8


def test_elastic_default_probe_keeps_mesh(tmp_path):
    params = M.init_model(_cfg(), seed=0)
    ctl = ElasticController(
        lambda mesh: _mk_trainer(tmp_path, steps=1, mesh=mesh)[0], tp=2)
    assert ctl.mesh.shape == {"data": 1, "model": 2}
    state = ctl.trainer.init_state(params)
    assert ctl.maybe_remesh(state, params) is state and not ctl.events


def test_choose_mesh_shape_errors():
    with pytest.raises(ClusterConfigError):
        choose_mesh_shape(1, 2)
    with pytest.raises(ClusterConfigError):
        choose_mesh_shape(0, 2)
    with pytest.raises(ClusterConfigError):
        choose_mesh_shape(8, 0)


def _cli(args, **env):
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=e, capture_output=True, text=True,
                          timeout=300)


def test_train_cli_fsdp_on_cpu(tmp_path):
    res = _cli(["--arch", "smollm-360m-reduced", "--device", "cpu",
                "--fsdp", "--steps", "8", "--tp", "2", "--dp", "2",
                "--batch", "4", "--seq", "32", "--ckpt-every", "4",
                "--ckpt-dir", str(tmp_path)])
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["final_step"] == 8 and np.isfinite(out["final_loss"])
    # a second run resumes from the final checkpoint and stops there
    res = _cli(["--arch", "smollm-360m-reduced", "--device", "cpu",
                "--fsdp", "--steps", "0", "--tp", "2", "--dp", "2",
                "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert "resumed from step 8" in res.stdout, res.stderr[-2000:]


def test_train_cli_without_card_refuses(tmp_path):
    """No --device cpu and no CUDA device: a non-zero exit that names the
    device, and no step on the CPU."""
    res = _cli(["--arch", "smollm-360m-reduced", "--steps", "1",
                "--ckpt-dir", str(tmp_path)], CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "cuda" in res.stderr and "--device cpu" in res.stderr
    assert "final_step" not in res.stdout


def test_ssm_training_on_card_refuses(tmp_path):
    """Mamba2 is trainable on a CUDA device (its SSD scan runs under
    autograd there: the kernel forward, the plain VJP backward) as on
    the CPU, where it trains: check_trainable takes no device and
    passes, for the modality frontends too (ROADMAP A4 is ported)."""
    cfg = get_config("mamba2-370m-reduced")
    TP.check_trainable(cfg)
    for front in ("internvl2-1b-reduced", "musicgen-medium-reduced"):
        TP.check_trainable(get_config(front))
    tr, st = make_trainer("mamba2-370m-reduced", device="cpu", steps=1,
                          batch=2, seq=16, dp=1, ckpt_dir=str(tmp_path))
    tr.run(st)
    assert np.isfinite(tr.metrics_log[-1]["loss"])


def test_quantized_plan_trains_on_cpu(tmp_path):
    """Every kept sync at quant8 (the fused kept sync's plain version on
    the CPU, identity backward): finite losses, and the ledger of a step
    names the quantized all-reduces' two hops."""
    from repro_torch.parallel.collectives import collective_ledger
    tr, st = make_trainer("smollm-360m-reduced", device="cpu", steps=2,
                          batch=4, seq=32, dp=2, spd=0.5, comm="quant8",
                          ckpt_dir=str(tmp_path))
    with collective_ledger() as led:
        tr.run(st)
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    ops = {(e.op, e.axis) for e in led}
    assert ("reduce-scatter", "model") in ops
    assert ("all-gather", "model") in ops
