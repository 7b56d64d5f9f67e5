"""Pipeline parallelism over a simulated "pipe" axis (port of
repro/parallel/pipeline.py, the paper's App. C.2).

GPipe-style fill-drain schedule over n_micro + n_stages - 1 ticks.
Every stage lives on the leading (stage, ...) axis of the weights and of
the activations, as the model shards do on the shard axis: one tick
runs every stage at once, and a stage boundary is the shift by one
stage (`collectives.ppermute` with the reference's permutation, logged
as its collective-permute).  Autograd runs straight through the
schedule, so the same function trains.  This is the compatibility
demonstration the appendix describes, not a production path.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.collectives import log_collective, ppermute

PIPE_AXIS = "pipe"


def _stage_ids(v, n_stages: int):
    return torch.arange(n_stages, device=v.device).view(
        (n_stages,) + (1,) * (v.dim() - 1))


def pipeline_forward(stage_fn, stage_params, x_micro, *, n_stages: int,
                     axis: str = PIPE_AXIS):
    """Run microbatches through a stage pipeline.

    stage_fn(stage_params, x (n_stages, mb, ...)) -> (n_stages, mb, ...)
    runs every stage's layers on its own input (stage_params carry the
    stage axis first).  x_micro (n_micro, mb, ...) -- every stage sees it;
    only stage 0 consumes it.  Returns (n_stages, n_micro, mb, ...): each
    stage's outputs at ticks n_stages-1 onward, valid on the LAST stage
    (the reference's per-device result, stacked over the stage axis)."""
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    first = _stage_ids(x_micro[0][None], n_stages) == 0
    inflight = torch.zeros((n_stages,) + tuple(x_micro.shape[1:]),
                           dtype=x_micro.dtype, device=x_micro.device)
    outs = []
    for t in range(ticks):
        feed = x_micro[min(t, n_micro - 1)]
        inp = torch.where(first, feed[None], inflight)
        out = stage_fn(stage_params, inp)
        inflight = ppermute(out, axis, perm)
        outs.append(out)
    return torch.stack(outs[n_stages - 1:], dim=1)


def last_stage_value(v, *, n_stages: int, axis: str = PIPE_AXIS):
    """Broadcast the last stage's value (v (n_stages, ...)) to every stage
    (the psum of the masked value).  FORWARD-ONLY, as the reference's:
    use `masked_last_stage` as the loss for gradients."""
    log_collective("all-reduce", axis, v[0].numel() * v.element_size())
    return v[n_stages - 1:n_stages].expand_as(v)


def masked_last_stage(v, *, n_stages: int, axis: str = PIPE_AXIS):
    """Per-stage loss that is v on the last stage and 0 elsewhere --
    grad-safe (no collective on the loss path; gradients reach earlier
    stages through the stage shifts)."""
    last = _stage_ids(v, n_stages) == n_stages - 1
    return torch.where(last, v, torch.zeros_like(v))
