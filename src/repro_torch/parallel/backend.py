"""`ParallelBackend`: how a forward step becomes a program over the TP
shards (port of repro/parallel/backend.py: the protocol, the registry,
and the `sim` backend).

The step functions of `runtime/forward.py` are written over
shard-stacked tensors (dim 0 = TP shard).  A backend owns where those
live: it places parameters, materializes blank caches, and wraps each
step so per-request host arrays ("batch"/"rep" arguments) land on its
device.  `LLM.load(engine=...)` resolves backends through the registry:
`sim` and `overlap` here; a multi-GPU backend registers beside them in a
later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Type

import numpy as np
import torch

# argument/result kinds a StepSpec declares (see the reference)
KINDS = ("params", "cache", "batch", "rep")


@dataclass(frozen=True)
class StepSpec:
    """Layout contract of one forward step: one KIND per argument and
    per result."""

    in_kinds: Tuple[str, ...]
    out_kinds: Tuple[str, ...]

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

    @classmethod
    def build(cls, cfg, plan, *, tp: int = 1, dp: int = 1,
              device="cuda") -> "ParallelBackend":
        raise NotImplementedError

    def wrap(self, local_fn, spec: StepSpec):
        raise NotImplementedError

    def place_params(self, padded: dict):
        """`model.pad_model` output -> the backend's parameter layout."""
        raise NotImplementedError

    def blank_caches(self, structs):
        raise NotImplementedError


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


def make_backend(name: str, cfg, plan, *, tp: int = 1, dp: int = 1,
                 device="cuda") -> ParallelBackend:
    return resolve_backend(name).build(cfg, plan, tp=tp, dp=dp,
                                       device=device)


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
    def build(cls, cfg, plan, *, tp=1, dp=1, device="cuda"):
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

    def blank_caches(self, structs):
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


@register_backend("overlap")
class OverlapBackend(SimBackend):
    """`sim` plus the comm schedule that hides the syncs SPD keeps.

    The same math as `sim` (greedy tokens equal bit for bit), three
    seams:

      * every step runs inside `collectives.overlap_region`, so each
        kept quantized sync logs its two hops as `ring_chunks` ring-step
        collective-permute entries instead of one RS/AG pair (the
        runnable rings are compression.ring_*; the step keeps the
        two-hop quantized_psum, as the reference's engines do);
      * `overlaps_comm=True` tells `LatencyModel.summarize` to price
        overlappable entries as hidden behind compute;
      * `Engine.decode_pipelined` issues independent decode groups back
        to back.

    The reference's overlap backend subclasses its shard_map backend.
    The port has no multi-device backend yet; when it comes (ROADMAP
    A5), the overlap backend moves onto it."""

    overlaps_comm = True
    #: ring-pipeline depth of each kept sync (LatencyModel.ring_chunks)
    ring_chunks: int = 4

    def wrap(self, local_fn, spec: StepSpec):
        from repro_torch.parallel.collectives import overlap_region

        def overlapped(*args):
            with overlap_region(self.ring_chunks):
                return local_fn(*args)

        return super().wrap(overlapped, spec)
