"""Training entry point: ``python -m repro_torch.launch.train --arch
smollm-360m-reduced --steps 200 --tp 2 --dp 2`` (port of
repro/launch/train.py).

Wires the synthetic data pipeline, the train step (FSDP or ZeRO-1) on
the simulated (data, model) mesh, the checkpoint manager and the
fault-tolerant loop (runtime/trainer.py).  It runs on the card
(`--device cuda`, the default) and on the CPU only when asked
(`--device cpu`); without a card it stops with an error.  Prints
`resumed from step N` when a checkpoint is found, and as its last line
{"final_step", "final_loss", "stragglers"}.

`--engine shard` runs the same loop as one rank of a tp x dp world, one
process per (data, model) slot, as `LLM.load(engine="shard")` serves:
launch it with torchrun (RANK, WORLD_SIZE, LOCAL_RANK and the
rendezvous address in the environment),

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-360m-reduced --engine shard --tp 2 --dp 2

or call `main([...])` in each rank of `launch.dist.spawn`.  The groups
come from `launch.dist.init_tp` unless the caller built them: the
initialized default group's backend, else nccl on cuda (one card a
rank) and gloo on the CPU; the checkpoint directory is rank 0's, and
rank 0 alone prints.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def make_trainer(arch, *, steps: int = 100, tp: int = 2, dp: int = 1,
                 batch: int = 8, seq: int = 64, lr: float = 3e-4,
                 microbatches: int = 1, fsdp: bool = False,
                 spd: float = 0.0, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, ckpt_keep: int = 3, seed: int = 0,
                 dtype: str = "float32", device="cuda",
                 attn_backend: str = "pallas", q_chunk: int = 0,
                 warmup: int = 10, comm: str = "exact", fault_hook=None,
                 params=None, engine: str = "sim", pod: int = 0):
    """The CLI's trainer: (Trainer, initial state), the state restored
    from `ckpt_dir` when it holds a checkpoint (None: a new temporary
    directory).  `arch` is a config name or a ModelConfig.  `params`
    (canonical, on any device) replaces the seeded init; `comm` sets
    every kept sync's level (CommPolicy.uniform); `q_chunk` 0 takes
    min(1024, seq).  `engine` "shard": this process is a rank of the
    groups `launch.dist.init_tp` built (tp x dp), on its device; the
    seeded init is drawn there and kept on the host, as LLM.load's.
    `pod` > 0 trains on the (pod, data, model) mesh `make_test_mesh(dp,
    tp, pod)` (on "shard", a world that `init_tp(tp, dp, pod=)` built);
    the CLI takes no pod flag, as the reference's takes none."""
    import torch

    from repro_torch.api.llm import resolve_device
    from repro_torch.config.base import (CommPolicy, ModelConfig,
                                         SPDPlanConfig, replace)
    from repro_torch.configs import get_config
    from repro_torch.core import model as M
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.schedule import make_schedule
    from repro_torch.parallel import tp as TP
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_map

    from repro_torch.launch import dist as D

    if engine not in ("sim", "shard"):
        raise ValueError(f"engine must be 'sim' or 'shard', got {engine!r}")
    groups = D.current()
    if engine == "shard" and groups is None:
        raise RuntimeError("engine='shard' trains as a rank: call "
                           "launch.dist.init_tp(tp, dp, backend=...) first")
    if engine == "sim" and groups is not None:
        raise RuntimeError("this process is a rank of the shard backend: "
                           "pass engine='shard'")
    dev = groups.device if groups is not None else resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device; pass "
                           "--device cpu to train on the CPU")
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    cfg = replace(cfg, dtype=dtype, attn_backend=attn_backend)
    mesh = make_test_mesh(dp, tp, pod)
    k = int(round(cfg.n_layers * spd)) if cfg.spd_applicable else 0
    plan = SPDPlanConfig.first_k(cfg.n_layers, k)
    if comm != "exact":
        plan = plan.with_comm(CommPolicy.uniform(cfg.n_layers, comm))
    ts = TP.TrainStepConfig(microbatches=microbatches, remat=True,
                            q_chunk=q_chunk or min(1024, seq), lr=lr,
                            fsdp=fsdp)
    sched = make_schedule("cosine", base_lr=lr, warmup=warmup, total=steps)
    tc = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                       ckpt_keep=ckpt_keep, seed=seed, batch=batch, seq=seq,
                       **({} if ckpt_dir is None else {"ckpt_dir": ckpt_dir}))
    trainer = Trainer(cfg, plan, mesh, ts, tc, lr_schedule=sched,
                      fault_hook=fault_hook, device=dev)
    if params is None:
        keep = torch.device("cpu") if groups is not None else None
        params = M.init_model(cfg, seed=seed, device=dev, keep=keep)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    state = trainer.init_state(tree_map(lambda w: w.to(dt), params))
    restored = trainer.restore(state_like=state)
    if restored is not None:
        if groups is None or groups.rank == 0:
            print(f"resumed from step {restored['step']}")
        state = restored
    return trainer, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--spd", type=float, default=0.0,
                    help="fraction of blocks dropped (structural plan)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from when it holds "
                         "one (default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--attn-backend", default="pallas",
                    choices=("pallas", "xla"),
                    help="pallas: the flash kernel (its plain version on "
                         "the CPU); xla: the plain attention")
    ap.add_argument("--engine", default="sim", choices=("sim", "shard"),
                    help="sim: every slot of the mesh in this process; "
                         "shard: this process is one rank of tp x dp")
    args = ap.parse_args(argv)

    lead = True
    try:
        if args.engine == "shard":
            lead = _init_rank(args).rank == 0
        trainer, state = make_trainer(
            args.arch, steps=args.steps, tp=args.tp, dp=args.dp,
            batch=args.batch, seq=args.seq, lr=args.lr,
            microbatches=args.microbatches, fsdp=args.fsdp, spd=args.spd,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            seed=args.seed, dtype=args.dtype, device=args.device,
            attn_backend=args.attn_backend, engine=args.engine)
    except (RuntimeError, NotImplementedError) as e:
        print(f"train: {e}", file=sys.stderr)
        return 1
    if lead:
        print(f"checkpoints in {trainer.tc.ckpt_dir}")
    state = trainer.run(state)
    last = trainer.metrics_log[-1] if trainer.metrics_log else {}
    if lead:
        print(json.dumps({"final_step": state["step"],
                          "final_loss": last.get("loss"),
                          "stragglers": len(trainer.straggler_events)}))
    return 0


def _init_rank(args):
    """This process's groups for `--engine shard` (made here unless a
    caller made them): the default group's backend when one is up."""
    import torch.distributed as dist

    from repro_torch.launch import dist as D

    if D.current() is not None:
        return D.current()
    backend = (dist.get_backend() if dist.is_initialized()
               else "gloo" if args.device == "cpu" else "nccl")
    return D.init_tp(args.tp, args.dp, backend=backend, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
