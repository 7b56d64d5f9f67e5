"""PyTorch port: dry-run records against the reference's.

The reference's CLI (repro.launch.dryrun, 512 placeholder devices, one
process a cell) runs in subprocesses for the serving cells of the
table below, started by the first test and read by the later ones; the
port's `run_cell` counts the same cells on the meta device.  The
ledger, the shape sums of `mem_per_device` and the cell facts must be
equal.  A train cell at the production mesh takes over 30 s on meta
(16 data slots x 16 microbatches), so the train case replays the
reference's train lowering in this process at a (2 data, 4 model) mesh
and SMOKE_SHAPES, on conftest's 8 CPU devices; the CLI's own train
cell runs on the card in chip_smoke.py.  FLOPs are printed beside
benchmarks.analytic and held within the stated band.  The quantized
kept syncs at the production tp 16 (QUANT_CELL) run the same way under
the per-plan policy (`--comm quant8`) and the reference's trace-time
blanket (`--sync-q8`), their CLI runs beside the CELLS'.  Then the port's
CLI itself: the reference test's two cells with that test's asserts
(tests/test_cli_and_backend.py::test_dryrun_single_cell), and `--all`
over two archs x one shape (file names, `SKIP`, `cached`, the green
line)."""
import json
import os
import subprocess
import sys

import pytest

from benchmarks import analytic
from repro.config.base import SHAPES as REF_SHAPES
from repro.config.base import SMOKE_SHAPES as REF_SMOKE
from repro.configs import get_config as ref_config
from repro.launch import dryrun as RD
from repro.launch import mesh as RMESH
from repro_torch.config.base import SMOKE_SHAPES, replace
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
ENV.pop("XLA_FLAGS", None)
CELLS = (("smollm-360m", "decode_32k", "single", 0.0),
         ("smollm-360m", "prefill_32k", "single", 0.7),
         ("qwen2-moe-a2.7b", "decode_32k", "single", 0.7),
         ("hymba-1.5b", "long_500k", "multi", 0.7))
# quantized kept syncs at the production tp 16: the CLI flags of each
# case and the port's run_cell arguments
QUANT_CELL = ("smollm-360m", "decode_32k", "single", 0.7)
QUANT_FLAGS = {"comm-quant8": (["--comm", "quant8"], dict(comm="quant8")),
               "sync-q8": (["--sync-q8"], dict(sync_q8=True))}
EQUAL = ("params", "active_params", "tokens", "kind", "applicable",
         "n_devices", "tp", "ledger_bytes_per_device")
SHAPE_SUMS = ("argument_bytes", "alias_bytes", "output_bytes")
# port FLOPs / analytic.step_flops_global (1.81 to 2.01 on CELLS): the
# port counts the products of the padded heads at tp 16 (SmolLM's 15 q
# heads become 32 and its 5 kv heads 16), which the analytic model
# leaves out, and B1's whole causal tiles
FLOPS_BAND = (1.7, 2.1)


def _name(cell):
    arch, shape, mesh, spd = cell
    return f"{arch}_{shape}_{mesh}_spd{int(spd * 100)}"


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's CLI for CELLS and QUANT_CELL's flags, all at once
    (one process a record), keyed by cell or flags' id."""
    out = tmp_path_factory.mktemp("ref_dryrun")
    runs = [(cell, _name(cell), []) for cell in CELLS]
    runs += [(key, f"{_name(QUANT_CELL)}_{key}", flags)
             for key, (flags, _) in QUANT_FLAGS.items()]
    procs = {}
    for key, name, flags in runs:
        arch, shape, mesh, spd = key if key in CELLS else QUANT_CELL
        path = out / (name + ".json")
        procs[key] = (path, subprocess.Popen(
            [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--spd", str(spd), "--json",
             str(path)] + flags, cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    yield procs
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()


def _ref_record(ref_runs, cell):
    path, p = ref_runs[cell]
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-2000:]
    with open(path) as f:
        return json.load(f)


def _cli(args, timeout=600):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun"]
                          + args, cwd=ROOT, env=ENV, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[3]], ids=_name)
def test_cli_single_cell(cell, tmp_path, ref_runs):
    """The reference test's asserts on the port's CLI (meta device, no
    JAX); the reference's cells start beside it (ref_runs)."""
    arch, shape, mesh, spd = cell
    out = str(tmp_path / "cell.json")
    r = _cli(["--arch", arch, "--shape", shape, "--mesh", mesh, "--spd",
              str(spd), "--json", out])
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as f:
        rec = json.load(f)
    assert rec["applicable"]
    assert rec["flops_total"] > 0
    assert sum(rec["collective_op_counts"].values()) > 0
    assert any(v > 0 for v in rec["ledger_bytes_per_device"].values())
    assert r.stdout.strip().splitlines()[-1].startswith(f"OK {arch} × ")


@pytest.mark.parametrize("cell", CELLS, ids=_name)
def test_record_equals_the_references(cell, ref_runs):
    arch, shape, mesh, spd = cell
    port = D.run_cell(arch, shape, mesh, spd, verbose=False)
    ref = _ref_record(ref_runs, cell)
    for k in EQUAL:
        assert port[k] == ref[k], (k, port[k], ref[k])
    for k in SHAPE_SUMS:
        assert port["mem_per_device"][k] == ref["mem_per_device"][k], k
    assert set(port["collective_op_counts"]) == set(
        ref["hlo_collective_op_counts"])
    # every execution: at least the ledger's entries, at least one a layer
    assert port["collective_op_counts"]["all-reduce"] >= get_config(
        arch).n_layers
    assert port["mem_per_device"]["temp_bytes"] > 0
    analytic_flops = analytic.step_flops_global(ref_config(arch),
                                                REF_SHAPES[shape])
    # a batch that does not split over the data ranks (long_500k, one
    # row) runs whole on each of them: the mesh-wide product counts it
    # once a data rank
    dp_total = port["n_devices"] // port["tp"]
    copies = dp_total if port["count"]["rows"] == REF_SHAPES[
        shape].global_batch else 1
    ratio = (port["flops_total"] * port["n_devices"] / copies
             / analytic_flops)
    print(f"{_name(cell)}: flops_total x n_devices "
          f"{port['flops_total'] * port['n_devices']:.4e} ({copies} "
          f"copies), analytic {analytic_flops:.4e} (x{ratio:.3f}); XLA's "
          f"{ref['flops_total'] * ref['n_devices']:.4e}; temp_bytes "
          f"{port['mem_per_device']['temp_bytes']} vs XLA's "
          f"{ref['mem_per_device']['temp_bytes']}")
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio


@pytest.mark.parametrize("key", QUANT_FLAGS)
def test_a_quantized_kept_sync_at_tp_16_equals_the_references(key,
                                                              ref_runs):
    """ROADMAP C17: every kept sync of the plan quantized at tp 16, by the
    per-plan CommPolicy or by the reference's trace-time blanket
    (`--sync-q8`): the ledger (each sync's two quantized hops), the
    shape sums and the cell facts equal the reference's record, and the
    meta count runs the fused kept sync once a quantized kept sync."""
    from repro_torch.core.layer_kinds import layer_kinds

    port = D.run_cell(*QUANT_CELL, verbose=False, **QUANT_FLAGS[key][1])
    ref = _ref_record(ref_runs, key)
    for k in EQUAL + ("comm", "sync_q8"):
        assert port[k] == ref[k], (k, port[k], ref[k])
    for k in SHAPE_SUMS:
        assert port["mem_per_device"][k] == ref["mem_per_device"][k], k
    assert port["tp"] == 16
    assert port["ledger_bytes_per_device"]["reduce-scatter@model"] > 0
    cfg = get_config(QUANT_CELL[0])
    plan = D.spd_plan_for(cfg, QUANT_CELL[3])
    kept = sum(1 if plan.drop_mask[i] else 2
               for i, _ in enumerate(layer_kinds(cfg)))
    assert port["count"]["kernels"]["quantized_psum_absmax"]["calls"] == kept
    assert port["collective_op_counts"]["reduce-scatter"] == kept


def _ref_train_record(arch, spd, dp, tp):
    """The reference's run_cell train branch at make_test_mesh(dp, tp)
    and SMOKE_SHAPES (its own code, in this process)."""
    import jax

    from repro.parallel import tp as RTP
    from repro.parallel.collectives import collective_ledger

    cfg = ref_config(arch)
    shape = REF_SMOKE["train_4k"]
    mesh = RMESH.make_test_mesh(dp, tp)
    plan = RD.spd_plan_for(cfg, spd)
    pstructs = RD.param_structs(cfg, plan, tp)
    ins = RD.input_structs(cfg, shape, plan, tp)
    with collective_ledger() as ledger:
        ts = RTP.TrainStepConfig(microbatches=max(1, shape.global_batch // dp),
                                 remat=True,
                                 q_chunk=min(2048, shape.seq_len), fsdp=True)
        step, init, _ = RTP.build_train_step(cfg, plan, mesh, ts,
                                             stacked_shapes=pstructs)
        opt = jax.eval_shape(init, pstructs)
        lowered = step.lower(pstructs, opt, ins)
    mem = lowered.compile().memory_analysis()
    return {"ledger_bytes_per_device": D.ledger_bytes(ledger),
            "argument_bytes": mem.argument_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes}


def test_train_record_equals_the_references_at_a_test_mesh():
    arch, spd, dp, tp = "smollm-360m", 0.7, 2, 4
    ref = _ref_train_record(arch, spd, dp, tp)
    cfg = replace(get_config(arch), attn_backend="pallas")
    port = D.count_cell(cfg, SMOKE_SHAPES["train_4k"], make_test_mesh(dp, tp),
                        D.spd_plan_for(cfg, spd))
    assert port["ledger_bytes_per_device"] == ref["ledger_bytes_per_device"]
    for k in SHAPE_SUMS:
        assert port["mem_per_device"][k] == ref[k], k
    assert port["count"]["rows"] == SMOKE_SHAPES["train_4k"].global_batch
    assert port["count"]["devices"] == dp * tp
    assert port["collective_op_counts"]["all-gather"] > 0


def test_cli_all_names_cached_and_green(tmp_path):
    out = tmp_path / "sweep"
    args = ["--all", "--out-dir", str(out), "-j", "8", "--archs",
            "smollm-360m", "mamba2-370m", "--shapes", "long_500k"]
    r = _cli(args)
    assert r.returncode == 0, r.stderr[-2000:] + r.stdout[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "dry-run: 8/8 cells green"
    skips = [ln for ln in lines if ln.startswith("SKIP smollm-360m × ")]
    oks = [ln for ln in lines if ln.startswith("OK mamba2-370m × ")]
    assert len(skips) == len(oks) == 4
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(f"{a}_long_500k_{m}_spd{s}.json"
                           for a in ("smollm-360m", "mamba2-370m")
                           for m in ("single", "multi") for s in (0, 70))
    with open(out / "mamba2-370m_long_500k_multi_spd70.json") as f:
        rec = json.load(f)
    assert rec["spd"] == 0.7 and rec["kind"] == "decode"
    again = _cli(args)
    assert again.returncode == 0
    lines = again.stdout.strip().splitlines()
    assert sorted(ln for ln in lines if ln.startswith("cached")) == sorted(
        f"cached {n[:-5]}" for n in names)
    assert lines[-1] == "dry-run: 8/8 cells green"


def test_run_cell_skip_record():
    """An inapplicable cell: the reference's record, nothing counted."""
    rec = D.run_cell("qwen2-72b", "long_500k", "multi", 0.7, verbose=False)
    assert rec == {"arch": "qwen2-72b", "shape": "long_500k",
                   "mesh": "multi", "spd": 0.7, "n_devices": 512, "tp": 16,
                   "sync_q8": False, "kv_int8": False, "w_int8": False,
                   "comm": "exact", "comm_logits": "exact",
                   "applicable": False,
                   "skip_reason": rec["skip_reason"]}
    assert "quadratic" in rec["skip_reason"]
