"""What a step costs, counted on PyTorch's meta device (the dry run's
counter, launch/dryrun.py).

A step run on meta tensors allocates nothing and launches nothing, yet
every aten op and every kernel wrapper still sees its shapes.
`MetaCount` counts, over the code run inside it:

  * ``flops``: the aten ops' matrix-product FLOPs, by the formulas of
    `torch.utils.flop_counter` (its `flop_registry`: mm, bmm, addmm,
    baddbmm, the convolutions, SDPA; 2 a multiply-add; the backward's
    too), plus the hand-written kernels' own product work, which their
    meta branches record from the kernels' formulas (kernels/meta.py:
    B1's causal tiles, B8's chunks).  One dispatch mode does all the
    counting here;
  * ``peak_bytes``: the most bytes that storages made inside were live
    at once; what existed before (params, caches, optimizer state) is
    not counted, and in-place writes to it make no new storage;
  * ``reads(t)``: whether an op other than a view read `t`'s storage
    (a compiled step's arguments are the ones it reads: XLA prunes the
    rest);
  * ``kernels``: each kernel's meta calls, FLOPs and bytes;
  * ``collectives``: every collective executed, by op
    (collectives.collective_counts).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import meta as META
from repro_torch.parallel.collectives import collective_counts


class _Ops(TorchDispatchMode):
    """Every aten op inside: its product FLOPs, the live bytes of the
    storages it makes, and the storages it reads.

    An op's output is new when its storage is none of its inputs' (a view
    or an in-place write shares one) and was not seen before; it stays
    live until its storage is freed.  `read` holds the storages that an
    op other than a view took as an input (weakly: a freed storage's id
    may come back)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.read = WeakIdKeyDictionary()
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        sts = [t.untyped_storage() for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        ins = {id(st) for st in sts}
        if not func.is_view:
            for st in sts:
                self.read[st] = True
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if id(st) in ins or st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


class MetaCount:
    """Context manager: FLOPs, peak new bytes, reads, kernel work and
    collective executions of the code inside (module doc).  Read the
    attributes after it exits."""

    def __enter__(self):
        self._ops = _Ops()
        self._work = META.kernel_work()
        self._counts = collective_counts()
        self.kernels = self._work.__enter__()
        self.collectives = self._counts.__enter__()
        self._ops.__enter__()
        return self

    def __exit__(self, *exc):
        self._ops.__exit__(*exc)
        self._counts.__exit__(*exc)
        self._work.__exit__(*exc)
        self.aten_flops = self._ops.flops
        self.kernel_flops = sum(w["flops"] for w in self.kernels.values())
        self.flops = self.aten_flops + self.kernel_flops
        self.peak_bytes = self._ops.peak
        return False

    def reads(self, t) -> bool:
        return t.untyped_storage() in self._ops.read
