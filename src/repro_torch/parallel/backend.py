"""`ParallelBackend`: how a forward step becomes a program over the TP
shards (port of repro/parallel/backend.py: the protocol, the registry,
and the `sim` backend).

The step functions of `runtime/forward.py` are written over
shard-stacked tensors (dim 0 = TP shard).  A backend owns where those
live: it places parameters, materializes blank caches, and wraps each
step so per-request host arrays ("batch"/"rep" arguments) land on its
device.  `LLM.load(engine=...)` resolves backends through the registry:
`sim` (every shard on one device), `shard` (one process per shard over
torch.distributed, `launch/dist.init_tp`) and `overlap`, the comm
schedule's seams (`OverlapSeams`) on `sim` in one process and on
`shard` in a world of ranks (`backend_class`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Type

import numpy as np
import torch

# argument/result kinds a StepSpec declares (see the reference);
# "logits_shard": a result left vocab-sharded, (tp, B, Vl) on `sim`, a
# rank's (1, B / dp, Vl) slice of it on `shard`
KINDS = ("params", "cache", "batch", "rep", "logits_shard")


@dataclass(frozen=True)
class StepSpec:
    """Layout contract of one forward step: one KIND per argument and
    per result.  `shard_batch`: whether the "batch" arguments split over
    the data ranks (False: the step runs the whole batch on every data
    rank, as the paged, chunk, insert and copy steps do)."""

    in_kinds: Tuple[str, ...]
    out_kinds: Tuple[str, ...]
    shard_batch: bool = True

    def __post_init__(self):
        for k in self.in_kinds + self.out_kinds:
            if k not in KINDS:
                raise ValueError(f"unknown step-arg kind {k!r}")


class ParallelBackend:
    """Protocol base: wrap(local_fn, spec) -> step, place_params(padded),
    blank_caches(structs), and the facts tp / dp / cache_batch_axis /
    device."""

    name: str = "?"
    #: whether LatencyModel.summarize should price overlappable entries
    #: as hidden behind compute (the overlap backend's reading)
    overlaps_comm: bool = False
    cfg = plan = None
    tp: int = 1
    dp: int = 1
    cache_batch_axis: int = 1
    device = None
    #: one process per shard (the facade hands `build` the rank's groups;
    #: what the engine has not ported for it raises)
    multi_process: bool = False
    #: the class a registered name resolves to inside a world of ranks
    #: (`backend_class`); None: this one
    rank_form = None

    @property
    def dp_total(self) -> int:
        """Data ranks a sharded batch splits over (a prefill batch pads to
        a multiple of it)."""
        return 1

    def agree(self, tokens) -> None:
        """The debug seam of a multi-process backend: check that every
        rank's host saw the same tokens.  Nothing on one process."""

    @classmethod
    def build(cls, cfg, plan, *, tp: int = 1, dp: int = 1,
              device="cuda", groups=None) -> "ParallelBackend":
        raise NotImplementedError

    def wrap(self, local_fn, spec: StepSpec):
        raise NotImplementedError

    def place_params(self, padded: dict):
        """`model.pad_model` output -> the backend's parameter layout."""
        raise NotImplementedError

    def blank_caches(self, structs, *, shard_batch: bool = True):
        raise NotImplementedError

    def cache_rows(self, caches, b0: int):
        """A prefill's caches with its batch cut back to the first `b0`
        rows (the rows a padded batch added dropped)."""
        pre = (slice(None),) * self.cache_batch_axis
        from repro_torch.tree import tree_map
        return tree_map(lambda c: c[pre + (slice(None, b0),)], caches)

    def insert_slot(self, caches, caches1, b: int):
        """Copy a prefilled batch-1 cache tree into slot `b` of the dense
        serving caches, in place."""
        from repro_torch.runtime.forward import insert_slot
        return insert_slot(caches, caches1, b,
                           batch_axis=self.cache_batch_axis)


_BACKENDS: Dict[str, Type[ParallelBackend]] = {}


def register_backend(name: str):
    def deco(cls):
        cls.name = name
        _BACKENDS[name] = cls
        return cls
    return deco


def backend_names() -> Tuple[str, ...]:
    return tuple(_BACKENDS)


def resolve_backend(name: str) -> Type[ParallelBackend]:
    if name not in _BACKENDS:
        raise ValueError(f"unknown engine {name!r} "
                         f"(registered backends: {backend_names()})")
    return _BACKENDS[name]


def backend_class(name: str) -> Type[ParallelBackend]:
    """The class `name` resolves to in this process: a registered backend
    with a rank form (`overlap`) takes it inside a world of more than one
    rank (`launch.dist.init_tp`); one process keeps the registered
    class."""
    cls = resolve_backend(name)
    if cls.rank_form is not None:
        from repro_torch.launch import dist as D
        g = D.current()
        if g is not None and g.world > 1:
            return cls.rank_form
    return cls


def make_backend(name: str, cfg, plan, *, tp: int = 1, dp: int = 1,
                 device="cuda", groups=None) -> ParallelBackend:
    """`groups`: a multi-process backend's `launch.dist.TPGroups`."""
    return backend_class(name).build(cfg, plan, tp=tp, dp=dp,
                                     device=device, groups=groups)


@register_backend("sim")
class SimBackend(ParallelBackend):
    """Every TP shard on one device, on a leading (tp, ...) axis of each
    parameter and cache leaf (the reference's VmapSimBackend layout).  A
    sync is a sum over that axis, so the distributed math runs exactly
    on one card."""

    cache_batch_axis = 2          # cache leaves are (tp, layer, batch, ...)

    def __init__(self, cfg, plan, tp: int, device):
        self.cfg, self.plan, self.tp, self.dp = cfg, plan, tp, 1
        self.device = torch.device(device)

    @classmethod
    def build(cls, cfg, plan, *, tp=1, dp=1, device="cuda", groups=None):
        if dp != 1:
            raise ValueError("engine='sim' holds every TP shard on one "
                             f"device; dp must be 1 (got {dp})")
        return cls(cfg, plan, tp, device)

    def _to_device(self, a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a).to(self.device)
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return a

    def wrap(self, local_fn, spec: StepSpec):
        moves = tuple(k in ("batch", "rep") for k in spec.in_kinds)

        def step(*args):
            return local_fn(*(self._to_device(a) if m else a
                              for a, m in zip(args, moves)))
        return step

    def place_params(self, padded: dict):
        from repro_torch.core import simtp
        from repro_torch.tree import tree_map
        padded = tree_map(lambda w: w.to(self.device), padded)
        return simtp.split_padded(padded, self.cfg, self.plan, self.tp)

    def blank_caches(self, structs, *, shard_batch: bool = True):
        from repro_torch.core import model as M
        from repro_torch.parallel.layout import REPLICATED
        from repro_torch.tree import tree_map
        specs = M.cache_specs_tree(self.cfg, self.plan)

        def one(s, a):
            shp = list(s.shape)
            if a != REPLICATED:
                shp[a] //= self.tp
            return torch.zeros([self.tp] + shp, dtype=s.dtype,
                               device=self.device)

        return [tree_map(one, s, a) for s, a in zip(structs, specs)]


class OverlapSeams:
    """The overlap engine's three seams over a backend's math (mixed in
    before it: the same steps, greedy tokens equal bit for bit):

      * every step runs inside `collectives.overlap_region`, so each
        kept quantized sync logs its two hops as `ring_chunks` ring-step
        collective-permute entries instead of one RS/AG pair (the
        runnable rings are compression.ring_*; the step keeps the
        two-hop quantized_psum, as the reference's engines do);
      * `overlaps_comm=True` tells `LatencyModel.summarize` to price
        overlappable entries as hidden behind compute;
      * `Engine.decode_pipelined` issues independent decode groups back
        to back."""

    overlaps_comm = True
    #: ring-pipeline depth of each kept sync (LatencyModel.ring_chunks)
    ring_chunks: int = 4

    def wrap(self, local_fn, spec: StepSpec):
        from repro_torch.parallel.collectives import overlap_region

        def overlapped(*args):
            with overlap_region(self.ring_chunks):
                return local_fn(*args)

        return super().wrap(overlapped, spec)


@register_backend("overlap")
class OverlapBackend(OverlapSeams, SimBackend):
    """`sim` plus the overlap seams, in one process.  Inside a world of
    ranks `overlap` resolves to `rank_form` (`backend_class`): `shard`
    plus the same seams, as the reference's overlap backend subclasses
    its shard_map backend."""


@register_backend("shard")
class ShardBackend(ParallelBackend):
    """One process per TP shard (the reference's ShardMapBackend): rank
    `d * tp + m` holds shard m of every parameter and cache leaf, with
    the shard axis kept at size 1, so the step functions keep their
    (tp, ...) signatures.  Each step runs under the model group's
    context (`collectives.model_group`): the syncs reduce locally over
    dim 0, then over the group.  "batch" arguments split over the data
    ranks when the step's `shard_batch` holds, and its "batch" results
    are all-gathered back over the data group, so every rank's host
    program (LLM, Scheduler, PagePool) sees the whole batch.  A
    frontend prefill's embeds are such a "batch" argument: whole on each
    model rank, split over the data ranks like the tokens; the
    replicated `front` leaf is each rank's whole copy.  Every rank
    runs the same host program; `launch/dist.init_tp` must have built
    the groups first."""

    cache_batch_axis = 2          # cache leaves are (1, layer, batch, ...)
    multi_process = True
    #: rank 0 broadcasts each step's tokens and every rank checks its own
    #: against them (`agree`); off by default
    check_agreement: bool = False

    def __init__(self, cfg, plan, groups):
        from repro_torch.parallel.collectives import ModelGroup
        self.cfg, self.plan, self.groups = cfg, plan, groups
        self.tp, self.dp = groups.tp, groups.dp
        self.device = groups.device
        self.mctx = ModelGroup(groups.tp, groups.model_rank,
                               groups.model_group)

    @classmethod
    def build(cls, cfg, plan, *, tp=1, dp=1, device=None, groups=None):
        """`groups`: this rank's `launch.dist.TPGroups` (the facade
        passes them; `LLM.load` raises without them)."""
        if groups is None:
            raise ValueError("the shard backend needs this rank's groups "
                             "(launch.dist.init_tp)")
        g = groups
        if (g.tp, g.dp) != (tp, dp) or g.world != tp * dp:
            pod = f"pod {g.pod} x " if g.pod > 1 else ""
            raise ValueError(f"the initialized world is {pod}tp {g.tp} x dp "
                             f"{g.dp} ({g.world} ranks), not tp {tp} x dp "
                             f"{dp}")
        if device is not None and torch.device(device) != g.device:
            raise ValueError(f"device {device} is not this rank's "
                             f"{g.device}")
        return cls(cfg, plan, g)

    @property
    def dp_total(self) -> int:
        return self.dp

    # ---- data-rank slicing and gathering ----

    def _rows(self, a):
        """This data rank's rows of a "batch" argument (an array, a tensor
        or a list of one generator a row)."""
        if a is None or self.dp == 1:
            return a
        n = len(a)
        if n % self.dp:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.dp} data ranks")
        k = n // self.dp
        d = self.groups.data_rank
        return a[d * k:(d + 1) * k]

    def _gather_rows(self, t, axis: int = 0):
        """`t`'s local rows along `axis` all-gathered over the data group
        in data-rank order."""
        if self.dp == 1:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.dp)]
        dist.all_gather(parts, t, group=self.groups.data_group)
        return torch.cat(parts, axis)

    def _to_device(self, a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return a

    def wrap(self, local_fn, spec: StepSpec):
        """A "logits_shard" result stays this rank's: its vocab slice
        (sim's stacked result at [model_rank]) of its own data rank's
        rows, as the reference's P(dpx, MODEL_AXIS) places it."""
        from repro_torch.parallel.collectives import model_group
        split = spec.shard_batch and self.dp > 1

        def step(*args):
            moved = []
            for a, k in zip(args, spec.in_kinds):
                if k == "batch" and split:
                    a = self._rows(a)
                moved.append(self._to_device(a) if k in ("batch", "rep")
                             else a)
            with model_group(self.mctx):
                out = local_fn(*moved)
            if not split:
                return out
            return tuple(self._gather_rows(o) if k == "batch" else o
                         for o, k in zip(out, spec.out_kinds))
        return step

    # ---- placement ----

    def place_params(self, padded: dict):
        """Shard `groups.model_rank` of every leaf, (1, ...), copied to
        this rank's device: the padded tree (on any device, e.g. the
        host) is only sliced, never split whole."""
        from repro_torch.core import simtp
        return simtp.split_padded(padded, self.cfg, self.plan, self.tp,
                                  rank=self.groups.model_rank,
                                  device=self.device)

    def blank_caches(self, structs, *, shard_batch: bool = True):
        """(1, layer, batch / dp, ...) dense caches (the batch axis split
        over the data ranks when `shard_batch`), or whole page pools."""
        from repro_torch.core import model as M
        from repro_torch.parallel.layout import REPLICATED
        from repro_torch.tree import tree_map
        specs = M.cache_specs_tree(self.cfg, self.plan)

        def one(s, a):
            shp = list(s.shape)
            if a != REPLICATED:
                shp[a] //= self.tp
            if shard_batch:
                if shp[1] % self.dp:
                    raise ValueError(f"a batch of {shp[1]} slots does not "
                                     f"split over {self.dp} data ranks")
                shp[1] //= self.dp
            return torch.zeros([1] + shp, dtype=s.dtype, device=self.device)

        return [tree_map(one, s, a) for s, a in zip(structs, specs)]

    def cache_rows(self, caches, b0: int):
        """A sharded prefill's caches, its rows gathered from every data
        rank and cut back to the first `b0`: the reference slices its
        global cache array the same way.  Every data rank then holds the
        b0 rows."""
        from repro_torch.tree import tree_map
        ax = self.cache_batch_axis
        caches = tree_map(lambda c: self._gather_rows(c, ax), caches)
        return super().cache_rows(caches, b0)

    def insert_slot(self, caches, caches1, b: int):
        """Slot `b` lives on data rank b // (slots / dp), at its local
        index; the other data ranks leave their rows as they are."""
        if self.dp == 1:
            return super().insert_slot(caches, caches1, b)
        from repro_torch.tree import tree_leaves
        local = tree_leaves(caches)[0].shape[self.cache_batch_axis]
        d, lb = divmod(b, local)
        if d == self.groups.data_rank:
            super().insert_slot(caches, caches1, lb)
        return caches

    def agree(self, tokens) -> None:
        """With `check_agreement` on: every rank took rank 0's tokens
        (`agree_across`)."""
        if self.check_agreement:
            agree_across(self.groups, tokens, "host tokens")


class ShardOverlapBackend(OverlapSeams, ShardBackend):
    """`overlap` on the shard backend's ranks: `ShardBackend` (its
    two-launch quantized sync across ranks in every kept sync) plus the
    overlap seams."""

    name = "overlap"


OverlapBackend.rank_form = ShardOverlapBackend


def agree_across(groups, values, what: str) -> None:
    """Rank 0 broadcasts how many values it holds, then the values (a
    speculative round commits a count of tokens that the host decides;
    Algorithm 1 a plan and a ranking); every rank checks its own
    against them and raises where they differ."""
    if groups.world == 1:
        return
    import torch.distributed as dist
    mine = torch.as_tensor(np.asarray(values, np.int64)).reshape(-1)
    mine = mine.to(groups.device)
    n = torch.tensor([mine.numel()], dtype=torch.int64, device=groups.device)
    dist.broadcast(n, src=0)
    ref = (mine.clone() if groups.rank == 0 else
           torch.empty(int(n), dtype=torch.int64, device=groups.device))
    dist.broadcast(ref, src=0)
    if not torch.equal(ref, mine):
        raise RuntimeError(f"rank {groups.rank}: {what} {mine.tolist()} "
                           f"differ from rank 0's {ref.tolist()}")
