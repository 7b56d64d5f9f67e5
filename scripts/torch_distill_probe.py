"""Block-to-block distillation on full-width LLaMA2-7B blocks, on one GPU.

    python3 scripts/torch_distill_probe.py

Loads llama2-7b at full width (bf16, tp=2, random weights from seed 0,
the flash kernel for attention), captures every block's input in TP mode
over chip_smoke.py's calibration batches (2 batches of (2, 128)), and
runs `b2b_distill` for 10 epochs on blocks 4, 9, 7 and 15 at lr 5e-5,
2e-5, 1e-5 and 5e-6: each line gives the mean loss of the first and the
last epoch, their ratio and every step's loss.  Then it times the parts
of one distill step (the teacher's forward, the student's forward and
backward, the AdamW update; synchronized host timers) four times and
profiles three whole steps (the top device ops), and prints the peak
device memory.  Needs a CUDA card and nvcc; exits non-zero without.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKS = (4, 9, 7, 15)
LRS = (5e-5, 2e-5, 1e-5, 5e-6)
EPOCHS = 10


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_distill_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.core import blocks as B
    from repro_torch.core import distill as D
    from repro_torch.core import model as M
    from repro_torch.core import simtp
    from repro_torch.core import spd as SPD
    from repro_torch.core.layer_kinds import layer_kinds
    from repro_torch.data import calibration_batches
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import adamw_init, adamw_update

    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", CS.card_line())
    build.build_all()
    llm = LLM.load(replace(get_config("llama2-7b"), attn_backend="pallas"),
                   tp=2, dtype="bfloat16", cache_len=512, max_batch=4,
                   seed=0)
    llm._release_engine()
    cfg, tp = llm.cfg, 2
    calib = calibration_batches(cfg.vocab_size, **CS.SWEEP_CALIB)
    hid = SPD.capture_block_inputs(cfg, M.pad_model(llm.canonical, cfg, tp),
                                   tp, calib, q_chunk=64)
    kinds = layer_kinds(cfg)
    per_epoch = len(calib)
    for lr in LRS:
        for b in BLOCKS:
            teacher = simtp.split_layer(llm.canonical["layers"][b], cfg,
                                        kinds[b], tp)
            _, losses = D.b2b_distill(cfg, kinds[b], tp, teacher,
                                      [h[b] for h in hid], lr=lr,
                                      epochs=EPOCHS, q_chunk=64)
            first = np.mean(losses[:per_epoch])
            last = np.mean(losses[-per_epoch:])
            print(f"lr={lr:g} block {b}: first {first:.4e} last {last:.4e} "
                  f"ratio {last / first:.3f} min {min(losses):.4e} steps "
                  f"{json.dumps([round(v, 6) for v in losses])}")

    b = BLOCKS[0]
    kind, lay = kinds[b], M._gqa_layout(cfg, tp)
    teacher = simtp.split_layer(llm.canonical["layers"][b], cfg, kind, tp)
    student, opt = teacher, adamw_init(teacher, master=True)
    x = hid[0][b]
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    xs = x[None].expand((tp,) + tuple(x.shape))

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(4):
        t0 = now()
        with torch.no_grad():
            out_t, _ = B.block_seq(cfg, kind, lay, teacher, xs, pos,
                                   drop=False, q_chunk=64)
        t1 = now()
        sp, leaves = simtp.grad_leaves(student)
        out_s, _ = B.block_seq(cfg, kind, lay, sp, xs, pos, drop=True,
                               q_chunk=64)
        d = (out_s - out_t).float()
        mse = (d * d).flatten(1).mean(1)
        t2 = now()
        grads = simtp.grads_of(mse.sum(), student, leaves)
        t3 = now()
        student, opt = adamw_update(grads, opt, student, lr=1e-5,
                                    weight_decay=0.0)
        t4 = now()
        print(f"step parts ms: teacher {1e3 * (t1 - t0):.2f} student fwd "
              f"{1e3 * (t2 - t1):.2f} backward {1e3 * (t3 - t2):.2f} adamw "
              f"{1e3 * (t4 - t3):.2f}")
    step = D.make_distill_step(cfg, kind, tp, lr=1e-5, q_chunk=64)
    for _ in range(2):
        student, opt, _ = step(student, opt, teacher, x, pos)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            student, opt, _ = step(student, opt, teacher, x, pos)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20,
                                    max_name_column_width=60))
    print("peak GiB", torch.cuda.max_memory_allocated() / 2 ** 30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
