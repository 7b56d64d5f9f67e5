"""LR schedules: linear warmup + {cosine, linear, constant} decay (port
of repro/optim/schedule.py)."""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str, *, base_lr: float, warmup: int = 0,
                  total: int = 1, final_frac: float = 0.1):
    """step -> lr as a 0-d fp32 tensor, in the reference's fp32 order."""
    def sched(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        w = max(warmup, 1)
        warm = base_lr * torch.clamp(s / w, max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        if kind == "cosine":
            dec = final_frac + (1 - final_frac) * 0.5 * (
                1 + torch.cos(math.pi * prog))
        elif kind == "linear":
            dec = 1.0 - (1.0 - final_frac) * prog
        else:
            dec = torch.ones_like(s)
        return torch.where(s < warmup, warm, base_lr * dec)
    return sched
