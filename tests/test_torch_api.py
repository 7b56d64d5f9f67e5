"""PyTorch port: import isolation from JAX and the reference package,
device selection, the facade's refusal of engines it does not have
(and its acceptance of the cluster and observability arguments) and of
a half-set paged geometry, the scheduler's queued-request fix (ROADMAP
C2), sampling determinism, and chip_smoke.py's refusal to run without a
card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (LLM, InvalidRequestError,  # noqa: E402
                             SamplingParams)
from repro_torch.api.scheduler import Request, Scheduler  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REDUCED = "smollm-360m-reduced"


def _load(**kw):
    kw.setdefault("tp", 2)
    kw.setdefault("cache_len", 48)
    return LLM.load(REDUCED, dtype="float32", device="cpu", **kw)


def test_port_imports_neither_jax_nor_reference():
    """In a fresh interpreter: import the whole slice (the training
    modules by name too), run one CPU generate (dense and paged), one
    train step through the train CLI and one dry-run cell on the meta
    device, and find no jax* or repro/repro.* module loaded."""
    code = """
import importlib, pkgutil, sys, tempfile
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch import checkpoint
from repro_torch.runtime import elastic, trainer
from repro_torch.parallel import fsdp, pipeline, tp, zero1
from repro_torch.launch import mesh, train
assert train.main(["--arch", "smollm-360m-reduced", "--device", "cpu",
                   "--steps", "1", "--batch", "2", "--seq", "8",
                   "--ckpt-dir", tempfile.mkdtemp()]) == 0
from repro_torch.api import LLM, SamplingParams
llm = LLM.load("smollm-360m-reduced", tp=2, spd=0.25, dtype="float32",
               cache_len=32, device="cpu", comm="quant8", comm_logits="quant8")
out = llm.generate([[1, 2, 3], [4, 5, 6, 7, 8]], SamplingParams(max_new=3))
assert all(len(o.token_ids) == 3 for o in out)
from repro_torch.api.scheduler import Request
paged = llm.serve(page_size=8, num_pages=4)
paged.submit(Request(uid=0, prompt=[1, 2, 3], max_new=3))
assert len(paged.run()[0].out) == 3
from repro_torch.launch import dryrun
rec = dryrun.run_cell("smollm-360m", "decode_32k", "single", 0.0,
                      verbose=False)
assert rec["ledger_bytes_per_device"] == {"all-reduce@model": 998400}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LOADED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "LOADED []" in res.stdout, res.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))", re.M)


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_load_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM.load(REDUCED, tp=2, dtype="float32")


@pytest.mark.parametrize("kw", [
    {"dp_replicas": 3}, {"engine": "tp_nccl"}, {"dp_replicas": 2},
    {"engine": "shard"}, {"obs": "recorder"}])
def test_later_slice_arguments_raise(kw):
    """An engine the port does not have, and the multi-process engine
    without its groups, are refused.  Cluster replicas and observability
    are ported (cluster/, obs/; tests/test_torch_cluster.py and
    tests/test_torch_obs.py): they load, `serve()` is a ClusterRouter
    over the replicas, and the recorder reaches the scheduler."""
    if "engine" in kw:
        with pytest.raises(NotImplementedError):
            _load(**kw)
    elif "obs" in kw:
        from repro_torch.obs import MetricsRegistry, Recorder
        rec = Recorder(MetricsRegistry())
        assert _load(obs=rec).serve().obs is rec
    else:
        router = _load(**kw).serve()
        assert sorted(router.replicas) == list(range(kw["dp_replicas"]))


@pytest.mark.parametrize("kw", [{"page_size": 8}, {"num_pages": 16}])
def test_paged_geometry_needs_both_fields(kw):
    """Paged serving is ported; setting only one of page_size / num_pages
    is refused as the reference's CacheConfig refuses it."""
    with pytest.raises(ValueError, match="set together"):
        _load(**kw)


def test_scheduler_drains_queue_when_admissions_finish_at_once():
    """4 requests of max_new=1 on 3 slots: the three admitted requests
    finish at admission, the 4th is still queued.  The reference's
    scheduler stops there (ROADMAP C2); the port's admits it next step."""
    llm = _load(max_batch=3)
    sched = Scheduler(llm.engine, llm.params, llm.cache)
    reqs = [Request(uid=i, prompt=np.asarray([i + 1, 7, 9]), max_new=1)
            for i in range(4)]
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    assert sorted(done) == [0, 1, 2, 3]
    assert all(r.done and len(r.out) == 1 for r in reqs)
    outs = llm.generate([[1, 2], [3, 4], [5, 6], [7, 8]],
                        SamplingParams(max_new=1))
    assert all(o.finish_reason == "length" for o in outs)


def test_generate_tp_invariant_structure_and_validation():
    llm = _load(spd=0.25, max_batch=2)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [9]]
    outs = llm.generate(prompts, SamplingParams(max_new=5))
    assert [o.index for o in outs] == [0, 1, 2, 3]
    for o, p in zip(outs, prompts):
        assert o.prompt_token_ids == p and len(o.token_ids) == 5
        assert all(0 <= t < llm.cfg.vocab_size for t in o.token_ids)
    # the scheduler is reused and left empty
    sched = llm.serve()
    assert not sched.has_work() and not sched.completed
    with pytest.raises(InvalidRequestError):
        llm.generate([list(range(48))], SamplingParams(max_new=2))
    with pytest.raises(InvalidRequestError):
        llm.generate([[]])


def test_sampled_generate_is_deterministic_per_seed():
    llm = _load(spd=0.25)
    sp = SamplingParams(max_new=6, temperature=0.9, top_k=50, top_p=0.9,
                        seed=11)
    a = [o.token_ids for o in llm.generate([[1, 2, 3], [4, 5]], sp)]
    b = [o.token_ids for o in llm.generate([[1, 2, 3], [4, 5]], sp)]
    assert a == b
    # batch composition does not change a request's stream
    c = [o.token_ids for o in llm.generate([[1, 2, 3]], sp)]
    assert c[0] == a[0]
    greedy = llm.generate([[1, 2, 3]], SamplingParams(max_new=6))
    tz = llm.generate([[1, 2, 3]], SamplingParams(max_new=6, temperature=0.0,
                                                  seed=5))
    assert greedy[0].token_ids == tz[0].token_ids


def test_set_comm_policy_rebuilds_the_engine():
    llm = _load(spd=0.5)
    p = [[2, 7, 1, 8, 2, 8]]
    exact = llm.generate(p, SamplingParams(max_new=4))[0].token_ids
    llm.set_comm_policy("quant4", logits="quant8")
    assert llm.plan.comm.block_modes == ("quant4",) * 4
    assert llm.plan.drop_mask == (True, True, False, False)
    q4 = llm.generate(p, SamplingParams(max_new=4))[0].token_ids
    assert len(q4) == len(exact) == 4
    llm.set_comm_policy("exact")
    assert llm.plan.comm is None
    assert llm.generate(p, SamplingParams(max_new=4))[0].token_ids == exact


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result; and
    alone in a directory (no repo around it) it fails too."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def test_sim_backend_rejects_data_parallelism():
    with pytest.raises(ValueError, match="dp must be 1"):
        _load(dp=2)
