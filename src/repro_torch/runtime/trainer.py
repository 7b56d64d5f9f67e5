"""Fault-tolerant trainer (port of repro/runtime/trainer.py).

Wraps the train step (parallel/tp.py) with:
  * cadenced atomic checkpoints of params + optimizer state + data
    cursor; params are written as the GLOBAL stacked tree (the split
    leaves merged, simtp.merge_stacked) and the optimizer state in the
    reference's global shapes, so a reference checkpoint and a port
    checkpoint hold the same arrays;
  * restart from the newest valid checkpoint after a fault
    (SimulatedFault hooks kill the step loop at chosen points);
  * straggler detection: a per-step wall-time EWMA; steps slower than
    `straggler_factor` x EWMA are logged;
  * deterministic data resume: the synthetic pipeline's batch k is a pure
    function of (seed, k), so the saved cursor reproduces the stream.

Each step's wall time includes its device work: the metrics are read
back (a synchronising copy) inside the timed region, as the reference's
`float(v)`.

On the `shard` backend's ranks (`launch.dist.init_tp` has built the
groups; the mesh is their (data, model) layout) every rank runs this
loop: `init_state` places the rank's model shard (and, under FSDP, its
data slice) from the canonical tree, `data_iter` yields its data rank's
rows, `save` gathers the global tree over the groups and rank 0 writes
it in the same format (every rank then waits on a barrier), and
`restore` reads the global tree on every rank and keeps the rank's
slice, re-sharding a checkpoint written at another data degree.  The
checkpoint directory is rank 0's.  A checkpoint written on one process
resumes on ranks, and the other way round.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.llm import resolve_device
from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                         CheckpointShapeError, _key_paths,
                                         _rebuild, list_checkpoints,
                                         load_checkpoint)
from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import model as M
from repro_torch.core import simtp
from repro_torch.data.synthetic import make_batch_iterator
from repro_torch.parallel import tp as TP
from repro_torch.parallel.collectives import gather_rows
from repro_torch.parallel.layout import REPLICATED, shard_leaf, split_leaf
from repro_torch.parallel.zero1 import zero1_reshard
from repro_torch.tree import tree_leaves, tree_map


class SimulatedFault(RuntimeError):
    """Raised by fault-injection hooks to exercise the recovery path."""


@dataclass
class TrainerConfig:
    total_steps: int = 100
    # a new temporary directory unless one is given (resuming needs one)
    ckpt_dir: str = field(
        default_factory=lambda: tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    ckpt_every: int = 50
    ckpt_keep: int = 3
    seed: int = 0
    batch: int = 8
    seq: int = 64
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


def split_stacked(stacked: dict, cfg, plan, tp: int, rank=None,
                  device=None) -> dict:
    """Inverse of simtp.merge_stacked: global stacked trees -> every leaf
    with a leading (tp, ...) shard axis; with `rank`, only that shard,
    (1, ...), moved to `device`."""
    specs = M.stacked_specs(cfg, plan)

    def split(w, a, off):
        a = a if a == REPLICATED else a + off
        if rank is None:
            return split_leaf(w, a, tp)
        return shard_leaf(w, a, tp, rank).to(device)

    out = {k: tree_map(lambda w, a: split(w, a, 0), v, specs[k])
           for k, v in stacked.items() if k != "segs"}
    out["segs"] = [tree_map(lambda w, a: split(w, a, 1), sv, ss)
                   for sv, ss in zip(stacked["segs"], specs["segs"])]
    return out


class Trainer:
    def __init__(self, cfg: ModelConfig, plan: SPDPlanConfig, mesh,
                 ts: TP.TrainStepConfig, tc: TrainerConfig,
                 lr_schedule=None,
                 fault_hook: Optional[Callable[[int], None]] = None, *,
                 device=None):
        """`device` None is the card (an error without one); the CPU only
        when asked for.  On a rank of the shard backend, the rank's
        device."""
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.groups = TP.rank_groups(mesh, device)
        g = self.groups
        if g is not None and g.world > 1:
            tc = dataclasses.replace(tc, ckpt_dir=_shared_dir(tc.ckpt_dir))
        self.ts, self.tc = ts, tc
        self.device = g.device if g is not None else resolve_device(device)
        self.tp = mesh.shape["model"]
        self.step_fn, self.init_fn, self.specs = TP.build_train_step(
            cfg, plan, mesh, ts, lr_schedule, device=self.device)
        self.ckpt = CheckpointManager(tc.ckpt_dir, every=tc.ckpt_every,
                                      keep=tc.ckpt_keep)
        self.fault_hook = fault_hook
        self.metrics_log = []
        self.straggler_events = []
        self.save_log = []            # (step, seconds, bytes) per save
        self.restore_log = []         # (step, seconds, bytes) per restore
        self._ewma = None

    # ---------------- state management ----------------

    def init_state(self, canonical_params):
        """Placed params and fresh optimizer state.  The step updates the
        params in place, so every leaf gets storage of its own: a split
        leaf can be a view of the caller's canonical tensor."""
        g = self.groups
        if g is not None:
            # the rank's shard, cut from the canonical tree where it lies
            params = simtp.split_padded(
                M.pad_model(canonical_params, self.cfg, self.tp), self.cfg,
                self.plan, self.tp, rank=g.model_rank, device=self.device)
            opt = self.init_fn(params)
            if self.ts.fsdp:
                params = self.specs["fsdp"].scatter(params, g.data_rank)
            return {"params": params, "opt": opt, "step": 0}
        padded = tree_map(lambda w: w.to(self.device),
                          M.pad_model(canonical_params, self.cfg, self.tp))
        params = tree_map(torch.clone, simtp.split_padded(
            padded, self.cfg, self.plan, self.tp))
        return {"params": params, "opt": self.init_fn(params), "step": 0}

    def _merge(self, tree):
        return simtp.merge_stacked(tree, self.cfg, self.plan, self.tp)

    def _split(self, tree):
        g = self.groups
        if g is None:
            return split_stacked(tree, self.cfg, self.plan, self.tp)
        out = split_stacked(tree, self.cfg, self.plan, self.tp,
                            rank=g.model_rank, device=self.device)
        if self.ts.fsdp:
            out = self.specs["fsdp"].scatter(out, g.data_rank)
        return out

    def _whole(self, tree):
        """A rank's shard-stacked tree (FSDP: data slices) gathered over
        its groups to (tp, ...) whole leaves."""
        g = self.groups
        if self.ts.fsdp:
            def data(x, a):
                return x if a < 0 else gather_rows(x, a + 1, g.data_group,
                                                   g.dp)
            f = self.specs["fsdp"].tree
            tree = {k: (tree_map(data, v, f[k]) if k != "segs" else
                        [tree_map(data, sv, fs)
                         for sv, fs in zip(v, f["segs"])])
                    for k, v in tree.items()}
        return tree_map(lambda x: gather_rows(x, 0, g.model_group, g.tp),
                        tree)

    def global_tree(self, state):
        """{"params", "opt"} in the reference's global shapes: the split
        leaves merged; ZeRO-1's state is already (dp, tp, n), FSDP's
        trees merge as the params do.  On a rank every rank takes part:
        the leaves are gathered over its groups first."""
        g, opt = self.groups, state["opt"]
        whole = (lambda t: t) if g is None else self._whole
        if "master" in opt:
            opt = {k: (v if k == "step" else self._merge(whole(v)))
                   for k, v in opt.items()}
        elif g is not None:
            opt = {"step": opt["step"], "leaves": tree_map(
                lambda x: gather_rows(gather_rows(x, 0, g.data_group, g.dp),
                                      1, g.model_group, g.tp),
                opt["leaves"])}
        return {"params": self._merge(whole(state["params"])), "opt": opt}

    def _local(self, tree, step):
        """A state from a global tree: the split leaves (on a rank, its
        slot of each)."""
        opt, g = tree["opt"], self.groups
        if "master" in opt:
            opt = {k: (v if k == "step" else self._split(v))
                   for k, v in opt.items()}
        elif g is not None:
            opt = {"step": opt["step"].to(self.device), "leaves": tree_map(
                lambda x: x[g.data_rank:g.data_rank + 1,
                            g.model_rank:g.model_rank + 1].to(
                                self.device).contiguous(), opt["leaves"])}
        return {"params": self._split(tree["params"]), "opt": opt,
                "step": step}

    def save(self, state, force=False):
        """Write a checkpoint when the cadence (or `force`) says so; on
        the shard backend every rank gathers, rank 0 writes and all wait
        for it.  Returns the path (None where nothing was written)."""
        every = self.ckpt.every
        if not (force or (every > 0 and state["step"] % every == 0)):
            return None
        t0 = time.perf_counter()
        tree = self.global_tree(state)
        path = None
        if self.groups is None or self.groups.rank == 0:
            path = self.ckpt.maybe_save(
                state["step"], tree,
                meta={"data_step": state["step"], "arch": self.cfg.name,
                      "plan": list(map(bool, self.plan.drop_mask))},
                force=True)
        if self.groups is not None:
            import torch.distributed as dist
            dist.barrier()
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
        self.save_log.append((state["step"], time.perf_counter() - t0,
                              nbytes))
        return path

    def restore(self, state_like):
        """The newest checkpoint (resharded to this data degree where it
        was written under another) as a state like `state_like`, or None.
        With no checkpoint written yet nothing is gathered: on a rank the
        global tree would be the whole model and optimizer state."""
        if not list_checkpoints(self.tc.ckpt_dir):
            return None
        t0 = time.perf_counter()
        like = self.global_tree(state_like)
        try:
            res = self.ckpt.restore(like)
        except CheckpointShapeError:       # elastic re-mesh
            res = None
        if res is None:
            res = self._restore_resharded(like)
        if res is None:
            return None
        step, tree, _ = res
        state = self._local(tree, step)
        self.restore_log.append((step, time.perf_counter() - t0, sum(
            t.numel() * t.element_size() for t in tree_leaves(tree))))
        return state

    def _restore_resharded(self, like):
        """Elastic path: the checkpoint was written under another data
        degree -> params load as they are; ZeRO-1 slices are re-sharded
        (zero1_reshard) and fitted to this degree's padded length (the
        tail past a leaf's elements is zero padding)."""
        raw = load_checkpoint(self.tc.ckpt_dir)
        if raw is None or "master" in like["opt"]:
            return None               # FSDP state does not depend on dp
        step, flat, meta = raw
        try:
            params_res = self.ckpt.restore({"params": like["params"]})
        except CheckpointShapeError:
            return None
        if params_res is None:
            return None
        opt_flat = {k[len("['opt']"):]: v for k, v in flat.items()
                    if k.startswith("['opt']")}
        dp_new = self.mesh.shape["data"]
        vals = {}
        for key, proto in _key_paths(like["opt"]):
            arr = opt_flat[key]
            if arr.dim() == 3 and tuple(arr.shape) != tuple(proto.shape):
                arr = zero1_reshard({"leaves": arr, "step": None},
                                    dp_new)["leaves"]
                arr = _fit(arr, proto.shape[2])
            vals[key] = arr.to(device=proto.device, dtype=proto.dtype)
        return step, {"params": params_res[1]["params"],
                      "opt": _rebuild(like["opt"], vals)}, meta

    # ---------------- data ----------------

    def data_iter(self, start_step: int):
        """Batches from `start_step` on, this rank's rows of them.  A
        frontend config's batch also carries "embeds" (batch,
        frontend_len, frontend_dim) fp32, drawn in turn from one
        default_rng(seed + 99), as the reference's (trainer.py:153-161).
        Resumed at step k the stream first discards k draws, so step k
        gets the k-th draw as an uninterrupted run does; the reference
        restarts it and gives step k the draw of step 0 (ROADMAP
        C13)."""
        cfg, tc = self.cfg, self.tc
        it = make_batch_iterator(cfg.vocab_size, tc.batch, tc.seq,
                                 seed=tc.seed, start_step=start_step)
        shape = (tc.batch, cfg.frontend_len, cfg.frontend_dim)
        rngf = np.random.default_rng(tc.seed + 99)
        if cfg.frontend_dim:
            for _ in range(start_step):
                rngf.standard_normal(shape)
        for b in it:
            b = {k: v for k, v in b.items() if not k.startswith("_")}
            if cfg.frontend_dim:
                b["embeds"] = rngf.standard_normal(shape).astype(np.float32)
            b = TP.rank_rows(b, self.groups)
            yield {k: torch.from_numpy(v).to(self.device)
                   for k, v in b.items()}

    # ---------------- loop ----------------

    def run(self, state, *, steps: Optional[int] = None,
            max_recoveries: int = 3):
        """Run with automatic fault recovery; returns the final state,
        checkpointed unless ckpt_every <= 0 (no checkpoints at all) or the
        cadence has just written this step (the reference writes the
        final one regardless, again).  The step updates params and
        optimizer state in place, so a fault with no checkpoint to go
        back to raises: there is no earlier state to replay from."""
        target = state["step"] + (steps or self.tc.total_steps)
        recoveries = 0
        while state["step"] < target:
            try:
                state = self._run_segment(state, target)
            except SimulatedFault as fault:
                recoveries += 1
                if recoveries > max_recoveries:
                    raise
                restored = self.restore(state_like=state)
                if restored is None:
                    raise RuntimeError(
                        "a fault before the first checkpoint: the state was "
                        "updated in place and there is nothing to restore"
                    ) from fault
                state = restored
        if self.tc.ckpt_every > 0 and not (
                self.save_log and self.save_log[-1][0] == state["step"]):
            self.save(state, force=True)
        return state

    def _run_segment(self, state, target):
        for batch in self.data_iter(start_step=state["step"]):
            if state["step"] >= target:
                break
            if self.fault_hook is not None:
                self.fault_hook(state["step"])
            t0 = time.perf_counter()
            p, o, met = self.step_fn(state["params"], state["opt"], batch)
            met = {k: float(v) for k, v in met.items()}
            dt = time.perf_counter() - t0
            state = {"params": p, "opt": o, "step": state["step"] + 1}
            self._track_time(state["step"], dt)
            met["step"] = state["step"]
            met["wall"] = dt
            self.metrics_log.append(met)
            self.save(state)
        return state

    def _track_time(self, step, dt):
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.tc.straggler_factor * self._ewma and step > 3:
            self.straggler_events.append({"step": step, "wall": dt,
                                          "ewma": self._ewma})
        a = self.tc.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt


def _shared_dir(path: str) -> str:
    """Rank 0's checkpoint directory on every rank (a rank's own default
    temporary directory, left empty, is removed)."""
    import torch.distributed as dist
    box = [path]
    dist.broadcast_object_list(box, src=0)
    if (box[0] != path and os.path.basename(path).startswith(
            "repro_torch_ckpt_") and os.path.isdir(path)
            and not os.listdir(path)):
        os.rmdir(path)
    return box[0]


def _fit(x, n: int):
    """(dp, tp, n_old) -> (dp, tp, n): cut or zero-pad each shard's flat
    padded leaf to this degree's padded length, slices re-laid."""
    dp, tp, n_old = x.shape
    flat = x.transpose(0, 1).reshape(tp, dp * n_old)
    if dp * n > flat.shape[1]:
        flat = torch.nn.functional.pad(flat, (0, dp * n - flat.shape[1]))
    return flat[:, : dp * n].reshape(tp, dp, n).transpose(0, 1).contiguous()
