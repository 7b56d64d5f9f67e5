"""The kernels on PyTorch's meta device: what a wrapper does when it is
asked, by name, to run on `device="meta"` (the dry run,
launch/dryrun.py).

A meta tensor has a shape and a dtype and no storage, so a wrapper's
meta branch launches nothing and computes nothing: it returns empty
outputs of the kernel's shapes and dtypes and records the kernel's own
work here, from the kernel's formula at those shapes.  `flops` counts
matrix-product operations, 2 a multiply-add, as
`torch.utils.flop_counter` counts an aten matmul (B1's causal tiles,
B2's keys, B8's chunked products); an elementwise kernel records 0
flops.  `nbytes` counts each input read once and each output written
once.  Meta is never a fallback: a CPU tensor takes the plain version,
a CUDA tensor the kernel, a meta tensor this, anything else raises.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

# the open `kernel_work` captures, innermost last
_ACTIVE: List[Dict[str, dict]] = []


@contextmanager
def kernel_work():
    """Capture {kernel name: {"calls", "flops", "nbytes"}} of every meta
    branch run inside."""
    work: Dict[str, dict] = {}
    _ACTIVE.append(work)
    try:
        yield work
    finally:
        _ACTIVE.remove(work)


def launch(name: str, out, *, flops: float = 0.0, nbytes: int = 0):
    """A wrapper's meta branch: record one call of kernel `name` and
    return `out` (its empty meta outputs)."""
    for work in _ACTIVE:
        w = work.setdefault(name, {"calls": 0, "flops": 0.0, "nbytes": 0})
        w["calls"] += 1
        w["flops"] += float(flops)
        w["nbytes"] += int(nbytes)
    return out


def nbytes(*tensors) -> int:
    """Bytes of the given tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)
