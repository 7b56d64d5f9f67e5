"""Dry run of the production cells on PyTorch's meta device (port of
repro/launch/dryrun.py).

Every (arch x shape x mesh x spd) cell of the production layouts — the
16x16 (data, model) and 2x16x16 (pod, data, model) meshes, `train_4k`,
`prefill_32k`, `decode_32k` and `long_500k`, the ten assigned archs at
full width and depth — runs its step once on meta tensors: shapes and
dtypes, no storage, no kernel launch.  The meta device stands where the
reference forces 512 placeholder host devices; nothing is compiled.

What runs: the `sim` backend's step over one data rank's rows
(global_batch // data ranks where the batch splits over them, else the
whole batch, which every data rank then runs), all tp model shards on
the leading axis, through the hand-written kernels' meta branches
(attn_backend="pallas"; kernels/meta.py).  A train cell runs the sim
train step over every data slot of the mesh (parallel/tp.py) with the
reference's TrainStepConfig (FSDP, remat, one row a microbatch).

The record keeps the reference's keys where the port computes the same
quantity:

  * ``ledger_bytes_per_device``: the comm ledger's bytes per device by
    ``op@axis``, as the reference's shard lowering records them;
  * ``mem_per_device``: ``argument_bytes`` (params, inputs, caches and,
    in training, the FSDP optimizer state, each at its per-device shard
    size; a leaf the step never reads is left out, as XLA prunes it:
    ``count["unread_param_bytes"]``), ``alias_bytes`` (the donated
    caches, params and optimizer state), ``output_bytes`` (the step's
    per-device results plus 8 bytes a result leaf, the reference's
    output tuple table; ids as int32, as the reference's step returns
    them; the port's extra "aux" training metric left out, as its
    ledger leaves out the psum) — shape sums that match the reference's
    byte for byte — and ``temp_bytes``, the port's own measure: the peak
    bytes that the step's new storages held at once, over the devices
    its rows occupy (launch/count.py), not XLA's buffer plan;
  * ``flops_total``: the counted FLOPs per device (the aten ops' and the
    kernels' product work over the rows the run covers, over the devices
    they occupy).  The reference's figure is XLA's, which counts a
    scanned layer once; the port counts every layer;
  * ``collective_op_counts`` in place of ``hlo_collective_op_counts``:
    every collective executed, by the same five op names.

``bytes_accessed_total`` and ``code_bytes`` are left out: there is no
compiled artifact to read them from.  ``count`` holds the rows and
devices the run covered and each kernel's meta calls and work.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape \\
        train_4k --mesh single --spd 0.7 --json out.json
    python -m repro_torch.launch.dryrun --all --out-dir \\
        results/dryrun_torch -j 8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")
LONG_CTX_OK = {"mamba2-370m", "hymba-1.5b"}   # sub-quadratic only
# bytes a result leaf adds to the reference's output size (XLA's tuple
# table: one pointer a leaf)
TUPLE_ENTRY_BYTES = 8


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k" and arch not in LONG_CTX_OK:
        return False      # quadratic-attention wall; documented skip
    return True


def spd_plan_for(cfg, fraction: float, comm: str = "exact",
                 comm_logits: str = "exact"):
    from repro_torch.config.base import CommPolicy, SPDPlanConfig
    if not cfg.spd_applicable or fraction <= 0:
        plan = SPDPlanConfig.none(cfg.n_layers)
    else:
        k = int(round(cfg.n_layers * fraction))
        plan = SPDPlanConfig.first_k(cfg.n_layers, k)
    if comm != "exact" or comm_logits != "exact":
        plan = plan.with_comm(CommPolicy.uniform(cfg.n_layers, comm,
                                                 logits=comm_logits))
    return plan


def input_structs(cfg, shape_cfg, plan, tp, *, rows=None, device="meta"):
    """The step's inputs as tensors on `device` (empty on meta): the
    reference's input_structs, `rows` rows of the batch (default the
    global batch).  Decode's "caches" are `model.cache_struct`s (shape-
    logical: head axes whole), as the reference's are."""
    from repro_torch.core import model as M
    from repro_torch.core.blocks import torch_dtype

    gb = shape_cfg.global_batch if rows is None else rows
    s = shape_cfg.seq_len
    front = cfg.frontend_len if cfg.frontend_dim else 0

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    def embeds():
        return empty((gb, cfg.frontend_len, cfg.frontend_dim),
                     torch_dtype(cfg))

    if shape_cfg.kind == "train":
        toks = s - front
        batch = {"tokens": empty((gb, toks), torch.int32),
                 "labels": empty((gb, toks), torch.int32),
                 "mask": empty((gb, toks), torch.float32)}
        if cfg.frontend_dim:
            batch["embeds"] = embeds()
        return batch
    if shape_cfg.kind == "prefill":
        out = {"tokens": empty((gb, s - front), torch.int32)}
        if cfg.frontend_dim:
            out["embeds"] = embeds()
        return out
    # decode: one new token against a seq_len cache
    return {"tokens": empty((gb, 1), torch.int32),
            "pos": empty((gb,), torch.int32),
            "caches": M.cache_struct(cfg, plan, gb, s, tp)}


def param_structs(cfg, plan, tp):
    """The padded, segment-stacked parameters at `tp` as meta tensors,
    every leaf with the leading (tp, ...) shard axis (simtp.split_padded
    of the reference's stack_segments(pad_model(...)))."""
    from repro_torch.core import model as M
    from repro_torch.core import simtp
    canonical = M.init_model(cfg, device="meta")
    return simtp.split_padded(M.pad_model(canonical, cfg, tp), cfg, plan, tp)


def ledger_bytes(entries) -> dict:
    """A comm ledger's bytes by ``op@axis``."""
    out = {}
    for e in entries:
        key = f"{e.op}@{e.axis}"
        out[key] = out.get(key, 0) + e.nbytes
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _per_device(tree, read=None) -> int:
    """Bytes one model shard holds of a shard-stacked tree; with `read`
    (a MetaCount), of the leaves the step read."""
    from repro_torch.tree import tree_leaves
    return sum(_nbytes(t[0]) for t in tree_leaves(tree)
               if read is None or read.reads(t))


def _fsdp_per_device(tree, fsdp_tree, dp: int, read) -> int:
    """Bytes one device holds of the leaves the step read of a
    shard-stacked tree stored split over the data axis on each leaf's
    FSDP axis (-1: whole)."""
    from repro_torch.tree import tree_leaves
    return sum(_nbytes(t[0]) // (dp if a >= 0 else 1) for t, a in
               zip(tree_leaves(tree), tree_leaves(fsdp_tree))
               if read.reads(t))


def _int32_ids(local):
    """A decode step whose next ids come back int32, as the reference's
    step returns them."""
    def step(*args):
        ids, caches = local(*args)
        return ids.to(torch.int32), caches
    return step


def run_cell(arch, shape_name, mesh_kind, spd,
             out_json=None, verbose=True, sync_q8=False, kv_int8=False,
             w_int8=False, comm="exact", comm_logits="exact"):
    from repro_torch.config.base import SHAPES, CommPolicy, replace
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh

    cfg = replace(get_config(arch), attn_backend="pallas")
    if kv_int8:
        cfg = replace(cfg, kv_dtype="int8")
    if w_int8:
        cfg = replace(cfg, weight_dtype="int8")
    shape_cfg = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    plan = spd_plan_for(cfg, spd, comm, comm_logits)
    if sync_q8 and plan.comm is None:
        # the reference's blanket override: every kept sync of a plan
        # without a policy
        level = "quant4" if sync_q8 == "int4" else "quant8"
        plan = plan.with_comm(CommPolicy.uniform(cfg.n_layers, level))

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "spd": spd, "n_devices": mesh.size, "tp": mesh.shape["model"],
           "sync_q8": sync_q8, "kv_int8": kv_int8, "w_int8": w_int8,
           "comm": comm, "comm_logits": comm_logits,
           "applicable": cell_applicable(arch, shape_name)}
    if not rec["applicable"]:
        rec["skip_reason"] = ("full-attention arch at 524k dense KV: the "
                              "quadratic wall this shape exposes; see "
                              "DESIGN.md §Arch-applicability")
        _emit(rec, out_json, verbose)
        return rec
    rec.update(count_cell(cfg, shape_cfg, mesh, plan))
    _emit(rec, out_json, verbose)
    return rec


def serve_step(cfg, shape_cfg, mesh, plan, *, device="meta", seed=0):
    """A prefill or decode cell's step over one data rank's rows (module
    doc) on `device`, with its arguments.  On meta the arguments are
    empty; elsewhere the parameters are drawn from `seed`
    (model.init_model) and the tokens, positions and embeds from a
    generator seeded with it.  Returns {"step", "args", "params",
    "inputs", "caches" (decode, else None), "rows"}: step(*args) is the
    cell's result."""
    from repro_torch.core import model as M
    from repro_torch.parallel.backend import make_backend
    from repro_torch.runtime import forward as F

    device = torch.device(device)
    tp = mesh.shape["model"]
    dp_total = mesh.size // tp
    gb, s = shape_cfg.global_batch, shape_cfg.seq_len
    rows = gb // dp_total if gb % dp_total == 0 else gb
    backend = make_backend("sim", cfg, plan, tp=tp, device=device)
    ins = input_structs(cfg, shape_cfg, plan, tp, rows=rows, device=device)
    if device.type == "meta":
        params = param_structs(cfg, plan, tp)
    else:
        params = backend.place_params(M.pad_model(
            M.init_model(cfg, seed=seed, device=device), cfg, tp))
        gen = torch.Generator(device=device).manual_seed(seed)
        for k, t in ins.items():
            if k in ("tokens", "pos"):
                hi = cfg.vocab_size if k == "tokens" else s
                t.copy_(torch.randint(0, hi, t.shape, generator=gen,
                                      device=device))
            elif k == "embeds":
                t.copy_(torch.randn(t.shape, generator=gen, device=device))
    if shape_cfg.kind == "prefill":
        step = backend.wrap(*F.prefill_step(
            cfg, plan, tp=tp, q_chunk=min(1024, s), cache_len=0,
            gather_logits=False))
        return {"step": step, "args": (params, ins["tokens"], None,
                                       ins.get("embeds")),
                "params": params, "inputs": ins, "caches": None,
                "rows": rows}
    caches = backend.blank_caches(ins.pop("caches"))
    local, spec = F.decode_step(cfg, plan, tp=tp)
    return {"step": backend.wrap(_int32_ids(local), spec),
            "args": (params, ins["tokens"], ins["pos"], caches),
            "params": params, "inputs": ins, "caches": caches, "rows": rows}


def count_cell(cfg, shape_cfg, mesh, plan) -> dict:
    """Run one cell's step on meta at `mesh` (a `launch.mesh.SimMesh`)
    and return the record's counted fields (module doc)."""
    from repro_torch.launch.count import MetaCount
    from repro_torch.parallel import tp as TP
    from repro_torch.parallel.collectives import collective_ledger
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    tp, n_dev = mesh.shape["model"], mesh.size
    dp_total = n_dev // tp
    gb, s = shape_cfg.global_batch, shape_cfg.seq_len
    with collective_ledger() as ledger:
        if shape_cfg.kind == "train":
            rows, covers = gb, n_dev
            params = param_structs(cfg, plan, tp)
            ins = input_structs(cfg, shape_cfg, plan, tp)
            ts = TP.TrainStepConfig(microbatches=max(1, gb // dp_total),
                                    remat=True, q_chunk=min(2048, s),
                                    fsdp=True)
            step, init, specs = TP.build_train_step(cfg, plan, mesh, ts,
                                                    device="meta")
            opt = init(params)
            with MetaCount() as mc:
                _, _, metrics = step(params, opt, ins)
            fsdp, dp = specs["fsdp"].tree, mesh.shape["data"]
            opt_tree = {k: v for k, v in opt.items() if k != "step"}
            alias = (_fsdp_per_device(params, fsdp, dp, mc)
                     + _fsdp_per_device(opt_tree, {k: fsdp for k in
                                                   opt_tree}, dp, mc)
                     + _nbytes(opt["step"]))
            inputs = sum(_nbytes(t) for t in ins.values()) // dp_total
            # the reference's metrics: "aux" is the port's own
            results = [v for k, v in metrics.items() if k != "aux"]
            n_out = (len(tree_leaves(params)) + len(tree_leaves(opt))
                     + len(results))
            args = alias + inputs
            out_bytes = alias + sum(_nbytes(t) for t in results)
        else:
            cell = serve_step(cfg, shape_cfg, mesh, plan)
            params, caches = cell["params"], cell["caches"]
            rows, covers = cell["rows"], tp
            with torch.no_grad(), MetaCount() as mc:
                out = cell["step"](*cell["args"])
            alias = 0 if caches is None else _per_device(caches)
            args = (_per_device(params, mc) + alias
                    + sum(_nbytes(t) for t in cell["inputs"].values()))
            # prefill: the logits shard (tp, B, Vl), one shard's rows a
            # device; decode: the ids (B, 1)
            head = (_per_device(out[0]) if caches is None
                    else _nbytes(out[0]))
            out_bytes = head + _per_device(out[1])
            n_out = 1 + len(tree_leaves(out[1]))

    return {
        "flops_total": mc.flops / covers,
        "mem_per_device": {
            "argument_bytes": args,
            "alias_bytes": alias,
            "output_bytes": out_bytes + TUPLE_ENTRY_BYTES * n_out,
            "temp_bytes": mc.peak_bytes // covers,
        },
        "collective_op_counts": {op: mc.collectives.get(op, 0)
                                 for op in OPS},
        "ledger_bytes_per_device": ledger_bytes(ledger),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": (shape_cfg.tokens if shape_cfg.kind != "decode"
                   else shape_cfg.global_batch),
        "kind": shape_cfg.kind,
        "count": {"rows": rows, "devices": covers,
                  "aten_flops": mc.aten_flops,
                  "kernel_flops": mc.kernel_flops,
                  "peak_bytes": mc.peak_bytes, "kernels": mc.kernels,
                  "unread_param_bytes": (_per_device(params)
                                         - _per_device(params, mc)),
                  "seconds": time.perf_counter() - t0},
    }


def _emit(rec, out_json, verbose):
    if out_json:
        with open(out_json, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        if not rec.get("applicable", True):
            print(f"SKIP {rec['arch']} × {rec['shape']} × {rec['mesh']}: "
                  f"{rec['skip_reason']}")
            return
        m = rec["mem_per_device"]
        print(f"OK {rec['arch']} × {rec['shape']} × {rec['mesh']} "
              f"spd={rec['spd']}: flops={rec['flops_total']:.3e} "
              f"arg/dev={m['argument_bytes']/1e9:.2f}GB "
              f"temp/dev={m['temp_bytes']/1e9:.2f}GB "
              f"colls={rec['collective_op_counts']}")


# ---------------------------------------------------------------------------
# Orchestration (a subprocess a cell, -j of them at once)
# ---------------------------------------------------------------------------

def run_all(out_dir: str, jobs: int, archs=None, shapes=None, meshes=None,
            spds=(0.0, 0.7)):
    import itertools
    import subprocess
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.config.base import SHAPES
    from repro_torch.configs import ASSIGNED

    os.makedirs(out_dir, exist_ok=True)
    archs = archs or ASSIGNED
    shapes = shapes or list(SHAPES)
    meshes = meshes or ["single", "multi"]
    cells = list(itertools.product(archs, shapes, meshes, spds))
    lock = threading.Lock()          # one whole line at a time

    def say(line):
        with lock:
            print(line, flush=True)

    def one(cell):
        arch, shape, mesh, spd = cell
        name = f"{arch}_{shape}_{mesh}_spd{int(spd*100)}"
        out = os.path.join(out_dir, name + ".json")
        if os.path.exists(out):
            say(f"cached {name}")
            return 0
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh,
               "--spd", str(spd), "--json", out]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=3600)
        if r.returncode != 0:
            with open(os.path.join(out_dir, name + ".err"), "w") as f:
                f.write(r.stdout + "\n" + r.stderr)
            tail = (r.stderr.strip().splitlines()[-1] if r.stderr.strip()
                    else "?")
            say(f"FAIL {name}: see {name}.err (tail: {tail} )")
            return 1
        say(r.stdout.strip().splitlines()[-1] if r.stdout.strip() else name)
        return 0

    with ThreadPoolExecutor(max_workers=jobs) as ex:
        fails = sum(ex.map(one, cells))
    print(f"dry-run: {len(cells) - fails}/{len(cells)} cells green")
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--spd", type=float, default=0.0)
    ap.add_argument("--sync-q8", action="store_true")
    ap.add_argument("--sync-q4", action="store_true")
    ap.add_argument("--comm", choices=["exact", "quant8", "quant4"],
                    default="exact",
                    help="CommPolicy level for kept sync points (--sync-q8 "
                         "is the blanket override of a plan without one)")
    ap.add_argument("--comm-logits", choices=["exact", "quant8", "quant4"],
                    default="exact")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--w-int8", action="store_true")
    ap.add_argument("--json")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("-j", "--jobs", type=int, default=4)
    ap.add_argument("--archs", nargs="*")
    ap.add_argument("--shapes", nargs="*")
    ap.add_argument("--meshes", nargs="*")
    args = ap.parse_args(argv)
    if args.all:
        sys.exit(run_all(args.out_dir, args.jobs, args.archs, args.shapes,
                         args.meshes))
    run_cell(args.arch, args.shape, args.mesh, args.spd, args.json,
             sync_q8=("int4" if args.sync_q4 else args.sync_q8),
             kv_int8=args.kv_int8, w_int8=args.w_int8,
             comm=args.comm, comm_logits=args.comm_logits)


if __name__ == "__main__":
    main()
