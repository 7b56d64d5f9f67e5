"""The port's serve CLI (`repro_torch.launch.serve`) against the JAX
reference's (`repro.launch.serve`) on the CPU: `main([...])` with
`--device cpu --engine sim --attn-backend xla` (the reference's config
default, which its CLI has no flag for) prints the same `completed`,
`outputs`, `comm`, `paged` and `cluster` blocks as the reference's CLI
with the same flags at `--engine sim`, on the same weights (the port's seeded init is
replaced, in this test, by the reference's init carried over with
`core.convert.from_reference`: the packages draw different numbers from
one seed).  `--metrics-json` and `--trace` write files that parse, with
the reference's tracks; the comm track is priced on the NVLink rate the
port's CLI states.  Without a card and without `--device cpu` the CLI
exits 1.  Reduced SmolLM-360M, tp 2, fp32; outputs compared exactly.
The `shard` case (`--engine shard` on two gloo ranks gives sim's
outputs) runs in tests/test_torch_shard_trainer.py's spawn."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402

from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "smollm-360m-reduced"
COMMON = ["--arch", ARCH, "--tp", "2", "--requests", "6", "--max-new", "6",
          "--cache-len", "64"]
CASES = {
    # paged on a pool that preempts, chunked prefill, two replicas behind
    # prefix-affinity, observability on.  Exact kept syncs: at tp 2 the
    # packages' partials differ by ulps, and a quantized sync can turn
    # that into a code step and another token (test_torch_grads_quant.py)
    "paged-cluster-obs": ["--page-size", "8", "--num-pages", "10",
                          "--prefill-chunk", "8", "--replicas", "2",
                          "--router", "prefix-affinity", "--spd", "0.25"],
    # dense, three replicas round-robin, int4 logits gather
    "dense-cluster": ["--replicas", "3", "--router", "round-robin",
                      "--comm-logits", "quant4", "--max-batch", "2"],
}
BLOCKS = ("completed", "outputs", "comm", "paged", "cluster")


def _reference_init(cfg, *, seed=0, device="cpu", keep=None):
    """The reference's seeded init of `cfg`'s reduced config, carried
    over: what the reference's CLI serves at --seed."""
    rcfg = rreplace(rget("smollm-360m", reduced=True), dtype=cfg.dtype)
    canon = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    return from_reference(jax.tree.map(np.asarray, canon), cfg, device)


def _reference_line(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    rserve.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_line(monkeypatch, capsys, argv):
    monkeypatch.setattr(M, "init_model", _reference_init)
    assert serve.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_line_equals_reference(case, monkeypatch, capsys, tmp_path):
    argv = COMMON + CASES[case]
    obs = case.endswith("obs")
    files = {}
    for who in ("port", "ref"):
        files[who] = (["--metrics-json", str(tmp_path / f"{who}_m.json"),
                       "--trace", str(tmp_path / f"{who}_t.json")]
                      if obs else [])
    want = _reference_line(monkeypatch, capsys,
                           argv + ["--engine", "sim"] + files["ref"])
    got = _port_line(monkeypatch, capsys,
                     argv + ["--engine", "sim", "--device", "cpu",
                             "--attn-backend", "xla"] + files["port"])
    for k in BLOCKS:
        assert got.get(k) == want.get(k), k
    assert got["completed"] == 6 and "cluster" in got
    if not obs:
        assert "obs" not in got
        return
    assert got["paged"]["preemptions"] > 0
    # the files parse; the trace has the reference's tracks
    trace = json.loads((tmp_path / "port_t.json").read_text())
    rtrace = json.loads((tmp_path / "ref_t.json").read_text())
    names = [e["args"]["name"] for e in trace["traceEvents"]
             if e["name"] == "thread_name"]
    assert names == got["obs"]["tracks"] == want["obs"]["tracks"] == \
        [e["args"]["name"] for e in rtrace["traceEvents"]
         if e["name"] == "thread_name"]
    m = json.loads((tmp_path / "port_m.json").read_text())
    rm = json.loads((tmp_path / "ref_m.json").read_text())
    assert m["prometheus"].startswith("# TYPE ")
    # every metric the reference's CLI reports; equal where no clock or
    # ledger count enters (the port's ledger logs every call: C14)
    assert set(m["metrics"]) == set(rm["metrics"])
    for k in ("requests_submitted_total", "tokens_generated_total",
              "preemptions_total", "spd_dropped_syncs",
              "spd_drop_ratio", "ttft_seconds_count", "tpot_seconds_count",
              'cluster_routed_total{policy="prefix-affinity",replica="0"}'):
        assert m["metrics"][k] == rm["metrics"][k], k
    assert got["obs"]["latency"] == {"link_bytes_per_s": serve.
                                     NVLINK_BYTES_PER_S,
                                     "launch_us": serve.LAUNCH_US}
    assert got["obs"]["comm"]["entries"] > want["obs"]["comm"]["entries"]


def test_cli_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.main(COMMON) == 1
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and err.out == ""


def test_obs_off_outputs_equal_obs_on(capsys, tmp_path):
    """The port's own line with and without the observability flags: the
    same outputs, and no obs block without them (the kernels' plain
    versions: --attn-backend pallas, the CLI's default)."""
    argv = COMMON + CASES["paged-cluster-obs"] + ["--device", "cpu"]
    assert serve.main(argv) == 0
    off = json.loads(capsys.readouterr().out)
    assert serve.main(argv + ["--trace", str(tmp_path / "t.json")]) == 0
    on = json.loads(capsys.readouterr().out)
    assert on["outputs"] == off["outputs"] and "obs" not in off
    assert on["obs"]["trace"] == str(tmp_path / "t.json")
