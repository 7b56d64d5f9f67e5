"""Sync points and the collective ledger (port of
repro/parallel/collectives.py).

Tensors here are SHARD-STACKED: dim 0 is the TP shard axis.  A sync
point (`psum` over the model axis in the reference) is a sum over dim 0
broadcast back to every shard; dropping it (SPD) keeps the shards
divergent.

The ledger records one `CommEntry` per logical collective with the
reference's byte convention: `nbytes` is the PER-SHARD operand bytes at
wire precision (one shard's slice of the stacked tensor).  The reference
traces a segment's layers once inside `lax.scan` and multiplies the
bytes by the segment length (`ledger_scale`); the port runs the layers
in a Python loop, logs the first layer of each segment under the same
scale and pauses the ledger for the rest (`ledger_paused`), so the two
give identical entries.  Forward-only: `column_entry` / `shared_param`
are identities here (their gradient rules come with training).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

MODEL_AXIS = "model"


class CommEntry(NamedTuple):
    """One logical collective: kind, axis, per-shard payload bytes,
    whether it is a kept block sync (overlappable), the modeled times
    (0.0 in this port: no latency model yet) and its block/phase labels."""

    op: str
    axis: str
    nbytes: int
    overlappable: bool = False
    est_us: float = 0.0
    fixed_us: float = 0.0
    block: int = -1
    phase: str = ""


class _Ledger(threading.local):
    def __init__(self):
        self.active: Optional[List[CommEntry]] = None
        self.scale: int = 1
        self.paused: bool = False
        self.block: int = -1
        self.phase: str = ""


_LEDGER = _Ledger()


@contextmanager
def collective_ledger():
    """Capture a CommEntry for every collective issued inside."""
    prev = _LEDGER.active
    _LEDGER.active = []
    try:
        yield _LEDGER.active
    finally:
        _LEDGER.active = prev


@contextmanager
def ledger_scale(k: int):
    """Multiply logged bytes by k (a segment of k identical layers)."""
    prev, _LEDGER.scale = _LEDGER.scale, _LEDGER.scale * int(k)
    try:
        yield
    finally:
        _LEDGER.scale = prev


@contextmanager
def ledger_paused(paused: bool = True):
    """Log nothing inside (the 2nd..kth layers of a scaled segment)."""
    prev = _LEDGER.paused
    _LEDGER.paused = prev or bool(paused)
    try:
        yield
    finally:
        _LEDGER.paused = prev


@contextmanager
def comm_context(block: Optional[int] = None, phase: Optional[str] = None):
    """Label collectives issued inside with a block index and/or phase;
    None keeps the outer value."""
    prev = (_LEDGER.block, _LEDGER.phase)
    if block is not None:
        _LEDGER.block = int(block)
    if phase is not None:
        _LEDGER.phase = str(phase)
    try:
        yield
    finally:
        _LEDGER.block, _LEDGER.phase = prev


def comm_phase(phase: str):
    return comm_context(phase=phase)


def log_collective(op: str, axis, nbytes: int, *,
                   overlappable: bool = False) -> None:
    """Ledger entry with an explicit byte count."""
    if _LEDGER.active is None or _LEDGER.paused:
        return
    _LEDGER.active.append(CommEntry(op, axis, int(nbytes) * _LEDGER.scale,
                                    overlappable, 0.0, 0.0, _LEDGER.block,
                                    _LEDGER.phase))


def shard_nbytes(x) -> int:
    """Bytes of one shard's slice of a shard-stacked tensor."""
    return x[0].numel() * x.element_size()


def psum(x):
    """All-reduce over the shard axis: sum over dim 0, on every shard."""
    return x.sum(dim=0, keepdim=True).expand_as(x)


# accepted spellings of the kept-sync levels
_MODE_BITS = {"int8": 8, "quant8": 8, "int4": 4, "quant4": 4}


def sync_output(x, axis=MODEL_AXIS, compressible: bool = True, mode=None):
    """A sync point: the all-reduce after a row-parallel projection — the
    op SPD drops.  `mode` is the block's kept-sync level ("exact" |
    "quant8" | "quant4"; None = exact).  `compressible=False` pins exact
    reduction (the embedding lookup)."""
    if compressible and mode in _MODE_BITS:
        from repro_torch.parallel.compression import quantized_psum
        return quantized_psum(x, axis, bits=_MODE_BITS[mode])
    log_collective("all-reduce", axis, shard_nbytes(x),
                   overlappable=compressible)
    return psum(x)


def column_entry(x, axis=MODEL_AXIS):
    """Column-parallel region entry: identity forward."""
    return x


def shared_param(p, axis=MODEL_AXIS):
    """Replicated parameter used in a shard-divergent region: identity
    forward."""
    return p
