"""The train step (port of repro/parallel/tp.py: `TrainStepConfig`,
`build_train_step`, `_grad_sq_groups`, `dp_axes`, `pod_axis`).

The reference runs the step as a shard_map over a (pod, data, model)
mesh: each device differentiates its rows' share of the global-mean
loss, and ZeRO-1 (parallel/zero1.py) or FSDP (parallel/fsdp.py) reduces,
clips and applies AdamW.  The port holds every model shard on the
leading shard axis of one card and computes the gradient of the whole
global batch at once: the sum over data slots of the reference's
per-slot partials, up to summation order.  The data axes are a layout
of the optimizer state and of the comm ledger (parallel/collectives.py:
psum_plain, psum_scatter, all_gather), logged with the bytes one device
of the mesh holds.

Microbatch m gathers the m-th microbatch of every data slot's rows (the
reference's reshape of each slot's local batch), and its loss is each
shard's CE sum over the GLOBAL token count plus aux_coef x the MoE
load-balance aux over the microbatch count (the reference's objective
per data slot and microbatch, summed over the slots), so the gradients
accumulate (in fp32, each microbatch's gradient rounded to the
parameter dtype first, as jax.value_and_grad + tree.map(add)) to that
of the global objective.  Parameters and optimizer state are updated
in place: the reference donates them.  No PartitionSpec helpers: on one card
they have no counterpart.  A MoE FFN routes each data slot's rows of
the microbatch on their own (blocks.moe_partial): its capacity counts
the slot's tokens and its aux is the slot's, as on the reference's
device of that slot.  Training uses exact comm plans, as in the
reference; a quantized kept sync trains through its identity backward
(P3), which the reference's does not give at tp > 1 (ROADMAP C5).

In a process of the `shard` backend (`launch.dist.init_tp` has built
its groups) the step runs as that rank of the mesh, the reference's
shard_map body: its params are its model shard (1, ...), its batch its
data rank's rows (`rank_rows`), and it binds the model and data groups
(collectives.rank_bound) so that the syncs, the token
count, the loss, the norm partials, the pod all-reduce and ZeRO-1's /
FSDP's reduce-scatter and all-gather run over them.  The mesh must be
the groups' layout: (data, model), or (pod, data, model) on a world
that `init_tp(tp, dp, pod=)` built; a rank then differentiates the rows
of its own (pod, data) slot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.api.llm import resolve_device
from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import model as M
from repro_torch.core.simtp import grad_leaves
from repro_torch.parallel import fsdp as F
from repro_torch.parallel import zero1 as Z
from repro_torch.parallel.collectives import (MODEL_AXIS, gather_shards,
                                              ledger_paused, ledger_share,
                                              psum_plain, rank_bound)
from repro_torch.parallel.layout import REPLICATED
from repro_torch.tree import tree_leaves, tree_unflatten


def dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def pod_axis(mesh) -> Optional[str]:
    return "pod" if "pod" in mesh.axis_names else None


def rank_groups(mesh, device=None):
    """This process's `launch.dist.TPGroups` when it is a rank of the
    shard backend, checked against `mesh` (and `device`); None on one
    process."""
    from repro_torch.launch import dist as D
    g = D.current()
    if g is None:
        return None
    have = (mesh.shape.get("pod", 1), mesh.shape["data"],
            mesh.shape[MODEL_AXIS])
    if have != (g.pod, g.dp, g.tp):
        raise ValueError(f"mesh {mesh.shape} is not this world's pod "
                         f"{g.pod} x dp {g.dp} x tp {g.tp}")
    if device is not None and torch.device(device) != g.device:
        raise ValueError(f"device {device} is not this rank's {g.device}")
    return g


def rank_rows(batch: dict, g) -> dict:
    """The rows of this rank's (pod, data) slot of a global batch (the
    reference's P(("pod", "data")) split of dim 0: slot
    pod_rank * dp + data_rank); the batch itself when `g` is None."""
    if g is None:
        return batch
    slots, slot = g.pod * g.dp, g.pod_rank * g.dp + g.data_rank
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // slots
        if v.shape[0] % slots:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split "
                             f"over {slots} data slots")
        out[k] = v[slot * n:(slot + 1) * n]
    return out


def _grad_sq_groups(grads, cfg, plan):
    """(sum of squares of the model-sharded leaves, of the replicated
    ones) of a shard-stacked gradient tree: each shard's sharded slice
    counts, a replicated leaf once (its shard 0 copy)."""
    sh = rp = torch.zeros((), dtype=torch.float32,
                          device=tree_leaves(grads)[0].device)
    for g, a in zip(tree_leaves(grads),
                    tree_leaves(M.stacked_specs(cfg, plan))):
        g = g.float()
        if a == REPLICATED:
            rp = rp + torch.sum(g[0] ** 2)
        else:
            sh = sh + torch.sum(g ** 2)
    return sh, rp


@dataclass
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    q_chunk: int = 2048
    lr: float = 3e-4
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    aux_coef: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    fsdp: bool = False     # ZeRO-3 param sharding over "data" (see fsdp.py)


def check_trainable(cfg: ModelConfig) -> None:
    """What the port cannot train: nothing any more.  Every ported
    config trains on every device, the modality frontends too (their
    batches carry "embeds", which `rank_rows` and the microbatches split
    by row like the tokens); on the card the SSD scan (B8) runs under
    autograd (its kernel forward, the plain VJP backward)."""


def build_train_step(cfg: ModelConfig, plan: SPDPlanConfig, mesh,
                     ts: TrainStepConfig, lr_schedule=None, *,
                     device=None):
    """Returns (step, init, specs).

    step(params, opt_state, batch) -> (params, opt_state, metrics
    {"loss", "grad_norm", "lr", "tokens", "aux"} 0-d tensors; "aux" the
    MoE load-balance aux the loss carries x aux_coef, summed over the
    data slots, each slot's mean over the microbatches: 0 without a MoE
    FFN); params are
    shard-stacked (simtp.split_padded), batch {"tokens", "labels",
    "mask"} (B, S) tensors on their device (and, for a frontend config,
    "embeds" (B, Flen, frontend_dim)), rows laid out over the data
    slots as the reference shards them.  init(params) -> opt_state.
    specs {"params": the TP split axes, "fsdp": FSDPSpecs or None, set
    at the first call}.  `device` is where the step will run: None is
    the card, an error without one.  metrics["loss"] includes aux_coef x the MoE aux, as the
    reference's does.

    On a rank of the shard backend (module doc) params are the rank's
    model shard, batch its rows (`rank_rows`), the state its slot; with
    `ts.fsdp`, init(params) takes the model shard whole and the step the
    data slices `specs["fsdp"].scatter(params, data_rank)` (set by
    init)."""
    g = rank_groups(mesh, device)
    if g is None:
        resolve_device(device)          # None is the card: raises without
    check_trainable(cfg)
    tp = mesh.shape[MODEL_AXIS]
    dp = mesh.shape["data"]
    pod = pod_axis(mesh)
    dpx = dp_axes(mesh)
    # the data slots this process computes: all of them on sim, its own
    # on a rank
    slots = (tuple(mesh.shape[a] for a in dpx) if g is None
             else (1,) * len(dpx))
    n_slots = int(np.prod(slots))
    red = dpx if pod else "data"
    specs = {"params": M.stacked_specs(cfg, plan), "fsdp": None}

    def fsdp_specs(params):
        if specs["fsdp"] is None:
            if g is not None:
                raise RuntimeError("on a rank, init(params) sets the FSDP "
                                   "layout before the first step")
            specs["fsdp"] = F.make_specs(params, cfg, plan, dp)
        return specs["fsdp"]

    def step(params, opt_state, batch):
        with rank_bound(g):
            return local_step(params, opt_state, batch)

    def local_step(params, opt_state, batch):
        nmb = ts.microbatches
        b = batch["tokens"].shape[0]
        if b % (n_slots * nmb):
            raise ValueError(f"batch {b} does not split into {n_slots} data "
                             f"slots x {nmb} microbatches")
        rows = b // (n_slots * nmb)

        def micro(x, m):
            rest = tuple(x.shape[1:])
            return x.reshape((n_slots, nmb, rows) + rest)[:, m].reshape(
                (n_slots * rows,) + rest)

        f_specs = fsdp_specs(params) if ts.fsdp else None
        mask = batch["mask"].float()
        total_tok = psum_plain(mask.reshape(slots + (-1,)).sum(-1), red)
        p, leaves = grad_leaves(params)
        gacc = [torch.zeros_like(w, dtype=torch.float32) for w in leaves]
        loss = torch.zeros(slots, dtype=torch.float32, device=mask.device)
        aux = torch.zeros_like(loss)
        with ledger_share(n_slots):
            for m in range(nmb):
                mb = {k: micro(v, m) for k, v in batch.items()}
                with ledger_paused(m > 0), torch.enable_grad():
                    _, met = M.loss_fn(cfg, p, plan, mb, tp=tp,
                                       q_chunk=ts.q_chunk, remat=ts.remat,
                                       fsdp=f_specs, aux_coef=ts.aux_coef,
                                       slots=n_slots)
                    # each slot's sum_ce / total_tok + aux_coef * aux / nmb
                    # (zero aux without a MoE FFN), summed over the slots
                    obj = ((met["shard_ce"] / total_tok).sum()
                           + ts.aux_coef * met["shard_aux"].sum() / nmb)
                    gs = torch.autograd.grad(obj, leaves, allow_unused=True)
                with torch.no_grad():
                    for acc, g in zip(gacc, gs):
                        if g is not None:
                            acc.add_(g)
                    loss += met["row_ce"].reshape(slots + (-1,)).sum(-1) \
                        / total_tok
                    if cfg.moe is not None:
                        # model shard 0's aux, as the reported loss is
                        # shard 0's (a dropped block's aux differs by
                        # shard): a rank gathers it over its model group
                        aux0 = gather_shards(met["shard_aux"].detach())[0]
                        aux += aux0.reshape(slots) / nmb
                del met, obj, gs
        loss += ts.aux_coef * aux
        del p, leaves
        grads = tree_unflatten(params, gacc)
        lr = (lr_schedule(opt_state["step"]) if lr_schedule is not None
              else ts.lr)
        kw = dict(lr=lr, b1=ts.b1, b2=ts.b2, weight_decay=ts.weight_decay,
                  clip_norm=ts.clip_norm, pod_axis=pod)
        if ts.fsdp:
            params, opt_state, gnorm = F.fsdp_update(
                grads, opt_state, params, cfg=cfg, plan=plan, specs=f_specs,
                **kw)
        else:
            params, opt_state, gnorm = Z.zero1_update_clipped(
                grads, opt_state, params, specs=specs["params"], dp=dp, **kw)
        del grads, gacc
        with ledger_paused(True):      # a metric the reference lacks
            aux = psum_plain(aux, red) if cfg.moe is not None else aux.sum()
        metrics = {"loss": psum_plain(loss, red), "grad_norm": gnorm,
                   "lr": torch.as_tensor(lr, dtype=torch.float32),
                   "tokens": total_tok, "aux": aux}
        return params, opt_state, metrics

    def init(params):
        with rank_bound(g):
            if not ts.fsdp:
                return Z.zero1_init_structured(params, dp)
            if g is None:
                return F.fsdp_opt_init(params)
            specs["fsdp"] = F.make_specs(params, cfg, plan, dp, tp=tp)
            return F.fsdp_opt_init(specs["fsdp"].scatter(params,
                                                         g.data_rank))

    return step, init, specs
