"""SPD-aware block-to-block distillation — the paper's §4.2.3 / Eq 1
(port of repro/core/distill.py).

Student = the block executed with SPD wiring and its OWN parameter copy
θ_spd (initialised from θ); teacher = the same block executed as TP with
the frozen θ, run under `torch.no_grad()` (the reference's
stop_gradient).  Loss = MSE(SPD(θ_spd, x), TP(θ, x)) on hidden states x
captured at the block's input with all earlier blocks in TP mode (App.
C.1: those inputs equal the original model's).

The gradient is of the SUM over the shard axis of each shard's own fp32
MSE (the reference's grad inside the shard map; see
parallel/collectives.py), and the AdamW update (fp32 master copies, no
weight decay) runs directly on the stacked (tp, ...) leaves.  The
reported loss is shard 0's.  Under a model group (a rank of the shard
backend) the leaves are the rank's shard (1, ...), the block's syncs
run over the group, and shard 0's loss is gathered from its rank.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import blocks as B
from repro_torch.core import model as M
from repro_torch.core import simtp
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.parallel.collectives import gather_shards, local_shards


def make_distill_step(cfg, kind, tp: int, *, lr: float, q_chunk: int = 1024):
    """fn(student_split, opt_state, teacher_split, x (B,S,d), pos (B,S))
    -> (student_split, opt_state, loss float)."""
    lay = M._gqa_layout(cfg, tp)

    def step(student, opt_state, teacher, x, pos):
        xs = x[None].expand((local_shards(tp),) + tuple(x.shape))
        with torch.no_grad():
            out_t, _, _ = B.block_seq(cfg, kind, lay, teacher, xs, pos,
                                      drop=False, q_chunk=q_chunk)
        sp, leaves = simtp.grad_leaves(student)
        with torch.enable_grad():
            out_s, _, _ = B.block_seq(cfg, kind, lay, sp, xs, pos, drop=True,
                                      q_chunk=q_chunk)
            d = (out_s - out_t).float()
            mse = (d * d).flatten(1).mean(1)                  # (tp,)
            grads = simtp.grads_of(mse.sum(), student, leaves)
        new, opt_state = adamw_update(grads, opt_state, student, lr=lr,
                                      weight_decay=0.0)
        return new, opt_state, float(gather_shards(mse.detach())[0])

    return step


def b2b_distill(cfg, kind, tp: int, teacher_split, hidden_inputs: Sequence,
                *, lr: float, epochs: int = 10, q_chunk: int = 1024):
    """Distill one block.  hidden_inputs: the calibration mini-batches'
    hidden states at this block's input, each (B,S,d) (a tensor or an
    array).  Returns (student_split, losses), one loss per step."""
    dev = next(iter(teacher_split["ln1"].values())).device
    student = teacher_split       # θ_spd := θ (updates never write in place)
    opt_state = adamw_init(student, master=True)
    step = make_distill_step(cfg, kind, tp, lr=lr, q_chunk=q_chunk)
    xs = [torch.as_tensor(x).to(dev) for x in hidden_inputs]
    losses = []
    for _ in range(epochs):
        for x in xs:
            b, s = x.shape[:2]
            pos = torch.arange(s, device=dev).expand(b, s)
            student, opt_state, loss = step(student, opt_state,
                                            teacher_split, x, pos)
            losses.append(loss)
    return student, losses
