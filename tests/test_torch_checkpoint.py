"""The port's checkpoints (checkpoint/ckpt.py): the reference's four
checkpoint tests (tests/test_checkpoint_trainer.py) on the port, bf16
leaves, and cross-reading: a checkpoint the reference's Trainer writes
restores in the port's Trainer, and the other way round, at (dp 2, tp 2)
in fp32, the next step's loss equal to the writer's own next step."""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cfg
from repro.config.base import SPDPlanConfig as RPlan
from repro.launch.mesh import make_test_mesh as ref_mesh
from repro.parallel import tp as RTP
from repro.runtime.trainer import Trainer as RTrainer
from repro.runtime.trainer import TrainerConfig as RTrainerConfig
from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                         CheckpointShapeError,
                                         list_checkpoints, load_checkpoint,
                                         save_checkpoint)
from repro_torch.config.base import SPDPlanConfig, replace
from repro_torch.configs import get_config
from repro_torch.core.convert import from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import tp as TP
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves
from test_torch_train_step import _canonical
from torch_parity import STEP_RTOL, one_torch_thread  # noqa: F401

N_DROP, LR = 2, 1e-3


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 6), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.randn((3,), generator=g)}}


def _same(t1, t2):
    for a, b in zip(tree_leaves(t1), tree_leaves(t2)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t, meta={"x": 1})
    step, back, meta = load_checkpoint(str(tmp_path), tree_like=t)
    assert step == 7 and meta == {"x": 1}
    _same(t, back)


def test_corruption_detected_falls_back(tmp_path):
    t0, t1 = _tree(0), _tree(1)
    save_checkpoint(str(tmp_path), 1, t0)
    p2 = save_checkpoint(str(tmp_path), 2, t1)
    leaf = [f for f in os.listdir(p2) if f.endswith(".npy")][0]
    with open(os.path.join(p2, leaf), "r+b") as f:
        f.truncate(10)
    step, back, _ = load_checkpoint(str(tmp_path), tree_like=t0)
    assert step == 1                 # fell back to the older valid one
    _same(t0, back)


def test_partial_write_never_visible(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_0000000009"))
    assert all(not os.path.basename(p).startswith(".tmp")
               for p in list_checkpoints(str(tmp_path)))
    step, _, _ = load_checkpoint(str(tmp_path), tree_like=t)
    assert step == 3


def test_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    t = _tree()
    for s in range(1, 6):
        mgr.maybe_save(s, t)
    names = [os.path.basename(p) for p in list_checkpoints(str(tmp_path))]
    assert names == ["step_0000000004", "step_0000000005"]


def test_bf16_leaves_and_keys(tmp_path):
    """bf16 leaves go to disk as their 16-bit patterns with dtype
    "bfloat16" and come back bit for bit; keys are keystr strings; a
    shape mismatch raises the typed error."""
    t = {"p": {"segs": [{"w": torch.randn(3, 5).to(torch.bfloat16)}]},
         "s": torch.zeros((), dtype=torch.int32)}
    path = save_checkpoint(str(tmp_path), 2, t)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert list(man["leaves"]) == ["['p']['segs'][0]['w']", "['s']"]
    rec = man["leaves"]["['p']['segs'][0]['w']"]
    assert rec["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, rec["file"])).dtype == np.uint16
    _, back, _ = load_checkpoint(str(tmp_path), tree_like=t)
    _same(t, back)
    with pytest.raises(CheckpointShapeError):
        load_checkpoint(str(tmp_path), tree_like={
            "p": {"segs": [{"w": torch.zeros(5, 3)}]}, "s": t["s"]})


# ---------------------------------------------------------------------------
# Cross-reading
# ---------------------------------------------------------------------------

def _ref_trainer(d, steps):
    rcfg = make_cfg("smollm-360m")
    ts = RTP.TrainStepConfig(microbatches=1, remat=False, q_chunk=32, lr=LR)
    tc = RTrainerConfig(total_steps=steps, ckpt_dir=str(d), ckpt_every=4,
                        batch=4, seq=32)
    tr = RTrainer(rcfg, RPlan.first_k(rcfg.n_layers, N_DROP),
                  ref_mesh(2, 2), ts, tc)
    return tr, tr.init_state(jax.tree.map(jnp.asarray, _canonical()))


def _port_trainer(d, steps):
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    ts = TP.TrainStepConfig(microbatches=1, remat=False, q_chunk=32, lr=LR)
    tc = TrainerConfig(total_steps=steps, ckpt_dir=str(d), ckpt_every=4,
                       batch=4, seq=32)
    tr = Trainer(cfg, SPDPlanConfig.first_k(cfg.n_layers, N_DROP),
                 make_test_mesh(2, 2), ts, tc, device="cpu")
    return tr, tr.init_state(from_reference(_canonical(), cfg))


@functools.lru_cache(maxsize=None)
def _runs(root):
    """Each package's 5-step run, checkpoints at step 4 in its own dir."""
    out = {}
    for name, make in (("ref", _ref_trainer), ("port", _port_trainer)):
        d = os.path.join(root, name)
        tr, st = make(d, 4)
        tr.run(tr.run(st), steps=1)
        out[name] = (d, [m["loss"] for m in tr.metrics_log])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("cross")))


def test_trajectories_agree(runs):
    np.testing.assert_allclose(runs["port"][1], runs["ref"][1], rtol=2e-4)


def test_port_reads_reference_checkpoint(runs, tmp_path):
    d, ref_losses = runs["ref"]
    # the newest is the forced save after the 5th step: read step 4
    # through a directory that holds it alone
    only4 = tmp_path / "only4"
    os.makedirs(only4)
    os.symlink(os.path.join(d, "step_0000000004"),
               only4 / "step_0000000004")
    tr, st = _port_trainer(only4, 1)
    restored = tr.restore(state_like=st)
    assert restored["step"] == 4
    tr.run(restored, steps=1)
    np.testing.assert_allclose(tr.metrics_log[-1]["loss"], ref_losses[4],
                               rtol=STEP_RTOL)


def test_reference_reads_port_checkpoint(runs, tmp_path):
    d, port_losses = runs["port"]
    assert load_checkpoint(d, step=4) is not None
    only4 = tmp_path / "only4"
    os.makedirs(only4)
    os.symlink(os.path.join(d, "step_0000000004"),
               only4 / "step_0000000004")
    tr, st = _ref_trainer(only4, 1)
    restored = tr.restore(state_like=st)
    assert restored is not None and restored["step"] == 4
    tr.run(restored, steps=1)
    np.testing.assert_allclose(tr.metrics_log[-1]["loss"], port_losses[4],
                               rtol=STEP_RTOL)
