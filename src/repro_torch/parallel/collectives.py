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
give identical entries.

Gradients follow the reference's custom VJPs (Megatron's f/g pair):
`g_psum` (the sync) passes each shard its own cotangent, `f_ident` (a
column-parallel entry) and `shard_sum_grad` (a replicated parameter in
a shard-divergent region) sum the cotangent over the shards.  They are
`torch.autograd.Function`s over dim 0, applied only when autograd
records; the forward values are those of the plain ops either way.  A
loss is the SUM over dim 0 of each shard's own loss: that is what the
reference's grad-inside-vmap computes once the shard axis is a tensor
dimension, and it leaves the full shard-summed gradient on every copy
of a replicated leaf.  Backwards log nothing in the ledger.

`collective_ledger(latency=, tp=)` prices every entry as it is logged
(`LatencyModel`), and `overlap_region` is the overlap backend's ledger
seam: inside it a quantized kept sync logs its two hops as ring-step
collective-permutes (compression._log_two_hop).  `ppermute` is the ring
permutation i -> i+1 of the shard axis, which runnable ring collectives
(compression.ring_*) are built from, or any permutation of another
simulated axis (the pipeline's stage shift).

The train step's data-axis collectives (`psum_plain`, `psum_scatter`,
`all_gather`) run over SIMULATED mesh axes ("pod", "data"; the mesh is
launch/mesh.py's descriptor) on one device, which computes the whole
global batch: their values are sums, slices and concatenations over
the axis's leading slot dims, and they move no bytes.  On the `shard`
backend's ranks the train step binds a data-group context as well
(`data_group`): each rank then holds ONE (pod, data, model) slot,
every slot dim is of size 1, and the same functions run their
collective over the rank's groups (an all-reduce, a reduce-scatter, an
all-gather); each set of axes runs over the group of the ranks that
share the other axes' coordinates (`init_tp`'s data, model, pod, (pod,
data) and replica groups; `pod_all_reduce` is ZeRO-1's and FSDP's
gradient sum over "pod").  Either way each logs the entry the
reference's shard_map logs, with the bytes one device of the mesh
holds.  Inside `ledger_share(n)` a forward over the rows of n data
slots at once logs one slot's bytes.

On the `shard` backend each process holds ONE shard (dim 0 of size 1)
and the backend binds a model-group context (`model_group`) around every
step: `psum`, `pmax` and `ppermute` then reduce or permute over that
torch.distributed group after the local op over dim 0, `axis_size` is
the group's size and `shard_ids` this rank's shard index.  Without a
context (the `sim` backend) every path is the single-device one.  The
ledger logs the same entries either way.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch

MODEL_AXIS = "model"


class CommEntry(NamedTuple):
    """One logical collective: kind, axis, per-shard payload bytes,
    whether it is a kept block sync (overlappable), and its block/phase
    labels.  `est_us` is the modeled wall time (launch + ring wire time)
    and `fixed_us` its launch share, both scaled like the bytes, when
    the capture was opened with `collective_ledger(latency=, tp=)`; 0.0
    in a plain byte-accounting capture."""

    op: str
    axis: str
    nbytes: int
    overlappable: bool = False
    est_us: float = 0.0
    fixed_us: float = 0.0
    block: int = -1
    phase: str = ""


def ring_wire_bytes(op: str, payload_bytes: float, n: int) -> float:
    """Bytes one shard puts on the wire for one logical collective under
    the ring algorithms, given the ledger's byte convention."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * payload_bytes
    if op == "reduce-scatter":
        return (n - 1) / n * payload_bytes
    if op == "all-gather":
        return (n - 1) * payload_bytes
    if op == "collective-permute":
        return payload_bytes
    raise ValueError(f"unknown collective op {op!r}")


@dataclass(frozen=True)
class LatencyModel:
    """Analytic per-collective latency: `launch_us` fixed dispatch cost +
    ring wire bytes / `link_bytes_per_s`.  `ring_chunks` is how many ring
    steps an overlappable sync is split into when a backend overlaps it
    with block compute (backend.OverlapBackend):

      * a single overlappable entry (a kept exact all-reduce) keeps its
        pipeline-fill chunk and its launch on the critical path:
        exposed = fixed + (T - fixed) / ring_chunks, hidden = the rest
        (clamped at 0);
      * a collective-permute entry is one ring step of an overlap-region
        decomposition (compression._log_two_hop): its transfer hides
        entirely, its launch stays exposed.

    The link rate and the launch cost have no defaults: the caller
    states the interconnect it prices (chip_smoke.py passes the H100
    SXM's NVLink 4 data-sheet rate)."""

    link_bytes_per_s: float
    launch_us: float
    ring_chunks: int = 4

    def collective_us(self, op: str, nbytes: float, n: int) -> float:
        """Serial wall time (us) of one collective of `nbytes` payload."""
        if n <= 1:
            return 0.0
        return (self.launch_us
                + ring_wire_bytes(op, nbytes, n) / self.link_bytes_per_s
                * 1e6)

    def split_us(self, e: CommEntry) -> tuple:
        """(hidden_us, exposed_us) of one entry when the backend overlaps
        kept syncs; hidden + exposed == e.est_us."""
        if not e.overlappable or self.ring_chunks <= 1:
            return 0.0, e.est_us
        if e.op == "collective-permute":
            hidden = max(e.est_us - e.fixed_us, 0.0)
            return hidden, e.est_us - hidden
        exposed = e.fixed_us + (e.est_us - e.fixed_us) / self.ring_chunks
        hidden = max(e.est_us - exposed, 0.0)
        return hidden, e.est_us - hidden

    def summarize(self, ledger, *, overlap: bool = False) -> dict:
        """Price a latency-annotated capture: {total_us, hidden_us,
        exposed_us, kept_sync_us}.  `overlap=False` exposes everything;
        `overlap=True` hides the chunked share of every overlappable
        entry.  `kept_sync_us` is the serial time of the overlappable
        entries alone."""
        total = hidden = kept = 0.0
        for e in ledger:
            total += e.est_us
            if e.overlappable:
                kept += e.est_us
            if overlap:
                hidden += self.split_us(e)[0]
        return {"total_us": total, "hidden_us": hidden,
                "exposed_us": total - hidden, "kept_sync_us": kept}


class _Ledger(threading.local):
    def __init__(self):
        self.active: Optional[List[CommEntry]] = None
        self.scale: int = 1
        self.paused: bool = False
        self.block: int = -1
        self.phase: str = ""
        self.latency: Optional[LatencyModel] = None
        self.tp: int = 1
        self.overlap_chunks: int = 0      # 0 = not inside an overlap region
        self.share: int = 1               # data slots whose rows run at once
        self.counts: Optional[dict] = None   # op -> executions (dry run)


_LEDGER = _Ledger()


@contextmanager
def collective_ledger(latency: Optional[LatencyModel] = None,
                      tp: Optional[int] = None):
    """Capture a CommEntry for every collective issued inside.  With
    `latency=` (and `tp=`, the shard count of the run) each entry is
    priced as it is logged: est_us = scale x (launch + ring wire time),
    fixed_us = scale x launch."""
    if latency is not None and tp is None:
        raise ValueError("collective_ledger(latency=...) needs tp=")
    prev = (_LEDGER.active, _LEDGER.latency, _LEDGER.tp)
    _LEDGER.active, _LEDGER.latency = [], latency
    _LEDGER.tp = int(tp) if tp is not None else 1
    try:
        yield _LEDGER.active
    finally:
        _LEDGER.active, _LEDGER.latency, _LEDGER.tp = prev


@contextmanager
def collective_counts():
    """Count every collective executed inside, by op ({op: calls}): each
    call counts once, whether or not a ledger is open, paused or scaled
    (the ledger logs a segment's first layer for all of its layers; a
    count sees each layer, each microbatch and each recomputation)."""
    prev, _LEDGER.counts = _LEDGER.counts, {}
    try:
        yield _LEDGER.counts
    finally:
        _LEDGER.counts = prev


@contextmanager
def ledger_scale(k: int):
    """Multiply logged bytes by k (a segment of k identical layers)."""
    prev, _LEDGER.scale = _LEDGER.scale, _LEDGER.scale * int(k)
    try:
        yield
    finally:
        _LEDGER.scale = prev


@contextmanager
def ledger_share(n: int):
    """Divide logged bytes by n: the forward inside runs the rows of n
    data slots at once, and the ledger counts one slot's (one device's)
    payload, as the reference's shard_map does."""
    prev, _LEDGER.share = _LEDGER.share, _LEDGER.share * int(n)
    try:
        yield
    finally:
        _LEDGER.share = prev


@contextmanager
def ledger_unshared():
    """Undo `ledger_share` inside: payloads that are not the batch's rows
    (the FSDP weight gathers) log their bytes whole."""
    prev, _LEDGER.share = _LEDGER.share, 1
    try:
        yield
    finally:
        _LEDGER.share = prev


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
    if _LEDGER.counts is not None:
        _LEDGER.counts[op] = _LEDGER.counts.get(op, 0) + 1
    if _LEDGER.active is None or _LEDGER.paused:
        return
    nbytes = int(nbytes) // _LEDGER.share
    est = fixed = 0.0
    if _LEDGER.latency is not None and _LEDGER.tp > 1:
        est = _LEDGER.scale * _LEDGER.latency.collective_us(
            op, nbytes, _LEDGER.tp)
        fixed = _LEDGER.scale * _LEDGER.latency.launch_us
    name = axis if isinstance(axis, str) else "+".join(axis)
    _LEDGER.active.append(CommEntry(op, name, nbytes * _LEDGER.scale,
                                    overlappable, est, fixed, _LEDGER.block,
                                    _LEDGER.phase))


@contextmanager
def overlap_region(chunks: int = 4):
    """The overlap backend wraps every step in this: while active, each
    kept quantized sync logs its two hops as `chunks` ring-step
    collective-permute entries (bytes equal in total to the RS/AG pair).
    Execution is unchanged."""
    prev, _LEDGER.overlap_chunks = _LEDGER.overlap_chunks, int(chunks)
    try:
        yield
    finally:
        _LEDGER.overlap_chunks = prev


def overlap_chunks() -> int:
    """Ring-chunk count of the active overlap region (0 outside one)."""
    return _LEDGER.overlap_chunks


def shard_nbytes(x) -> int:
    """Bytes of one shard's slice of a shard-stacked tensor."""
    return x[0].numel() * x.element_size()


# ---------------------------------------------------------------------------
# The model-group context of the multi-process (`shard`) backend
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelGroup:
    """The TP group a rank's step runs in: `size` shards, this rank
    holding shard `index`, `group` the torch.distributed group."""

    size: int
    index: int
    group: object


@dataclass(frozen=True)
class DataGroup:
    """The data-parallel group of a rank's train step: `size` data ranks,
    this rank at `index`, `group` the torch.distributed group (one per
    (pod, model) pair, `launch.dist.TPGroups.data_group`).  `pod` is the
    pod factor and `wires` the groups of the other axis sets a step
    reduces over, ((axis names), group) pairs: the pod, (pod, data),
    replica and world groups of `launch.dist.TPGroups`."""

    size: int
    index: int
    group: object
    pod: int = 1
    wires: tuple = ()


class _GroupCtx(threading.local):
    def __init__(self):
        self.ctx: Optional[ModelGroup] = None
        self.data: Optional[DataGroup] = None


_GROUP = _GroupCtx()


@contextmanager
def model_group(ctx: Optional[ModelGroup]):
    """Run the syncs inside over `ctx`'s group (None: the sim layout)."""
    prev, _GROUP.ctx = _GROUP.ctx, ctx
    try:
        yield ctx
    finally:
        _GROUP.ctx = prev


def current_group() -> Optional[ModelGroup]:
    return _GROUP.ctx


@contextmanager
def data_group(ctx: Optional[DataGroup]):
    """Run the data-axis collectives inside over `ctx`'s group, each rank
    holding one data slot (None: the simulated data axes)."""
    prev, _GROUP.data = _GROUP.data, ctx
    try:
        yield ctx
    finally:
        _GROUP.data = prev


def current_data_group() -> Optional[DataGroup]:
    return _GROUP.data


def bound_groups() -> tuple:
    """The (model, data) contexts bound in this thread.  The contexts are
    thread-local, and on a CUDA device the autograd engine runs the
    backward (and a checkpoint's recomputation) on a thread of its own:
    whatever runs there binds them again (`groups_bound`)."""
    return _GROUP.ctx, _GROUP.data


@contextmanager
def groups_bound(groups: tuple):
    """Bind a `bound_groups()` pair inside."""
    with model_group(groups[0]), data_group(groups[1]):
        yield


def rank_bound(g):
    """The model and data groups of a shard-backend rank (`g`, its
    launch.dist.TPGroups) bound inside; when g is None, whatever is bound
    stays."""
    if g is None:
        from contextlib import nullcontext
        return nullcontext()
    import torch.distributed as dist

    wires = ((("pod",), g.pod_group), (("pod", "data"), g.pod_data_group),
             (("data", "model"), g.replica_group),
             (("pod", "data", "model"), dist.group.WORLD))
    return groups_bound((ModelGroup(g.tp, g.model_rank, g.model_group),
                         DataGroup(g.dp, g.data_rank, g.data_group,
                                   pod=g.pod, wires=wires)))


def local_shards(tp: int) -> int:
    """The shard-axis length of a tensor a step makes from a replicated
    one: tp on sim, 1 on a rank of the shard backend."""
    return tp if _GROUP.ctx is None else 1


def _wired() -> Optional[ModelGroup]:
    """The bound context when its group has more than one rank."""
    ctx = _GROUP.ctx
    return ctx if ctx is not None and ctx.size > 1 else None


def axis_size(x) -> int:
    """The TP degree a shard-stacked x belongs to: the bound group's size,
    else x's shard axis."""
    ctx = _GROUP.ctx
    return ctx.size if ctx is not None else x.shape[0]


def shard_ids(x):
    """The global shard index of each row of x's shard axis (int64, on
    x's device): 0..tp-1 on sim, this rank's index on `shard`."""
    ids = torch.arange(x.shape[0], device=x.device)
    ctx = _GROUP.ctx
    return ids if ctx is None else ids + ctx.index * x.shape[0]


def group_reduce(t, op: str):
    """In-place all-reduce of t over the bound group (`op` "sum", "max"
    or "min")."""
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    dist.all_reduce(t, op=ops[op], group=_GROUP.ctx.group)
    return t


def gather_shards(x):
    """x's shard axis all-gathered over the bound group, in rank order
    ((size x local, ...)); x itself without a wired group."""
    ctx = _wired()
    if ctx is None:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.size)]
    dist.all_gather(parts, x, group=ctx.group)
    return torch.cat(parts, 0)


def psum(x):
    """All-reduce over the shard axis: sum over dim 0, on every shard (then
    over the bound group's ranks)."""
    s = x.sum(dim=0, keepdim=True)
    if _wired() is not None:
        s = group_reduce(s, "sum")
    return s.expand_as(x)


def _records(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _GPsum(torch.autograd.Function):
    """Row-parallel output sync: forward psum, backward identity (the
    replicated cotangent is what every shard's partial receives)."""

    @staticmethod
    def forward(ctx, x):
        return psum(x)

    @staticmethod
    def backward(ctx, ct):
        return ct


class _SumGrad(torch.autograd.Function):
    """Identity forward, shard-summed cotangent backward: `f_ident` (a
    column-parallel entry on a replicated activation accumulates the
    per-shard cotangents) and `shard_sum_grad` (a replicated parameter in
    a shard-divergent region: its gradient is the sum of the partials).
    The sum runs over the group bound at the forward."""

    @staticmethod
    def forward(ctx, x):
        ctx.groups = bound_groups()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        # the forward's group: the backward may run on another thread
        with groups_bound(ctx.groups):
            return psum(ct)


def g_psum(x):
    return _GPsum.apply(x) if _records(x) else psum(x)


def f_ident(x):
    return _SumGrad.apply(x) if _records(x) else x


def shard_sum_grad(p):
    return _SumGrad.apply(p) if _records(p) else p


def pmax(x, axis=MODEL_AXIS):
    """Max all-reduce over the shard axis (the vocab-parallel CE's row
    max); logged as an all-reduce of the same payload."""
    log_collective("all-reduce", axis, shard_nbytes(x))
    m = x.amax(dim=0, keepdim=True)
    if _wired() is not None:
        m = group_reduce(m, "max")
    return m.expand_as(x)


def _permute_ranks(x, perm):
    """ppermute across the bound group's ranks: each rank holds one row
    (dim 0 of size 1).  The transport is the group's: NCCL sends the
    device tensors; gloo moves host memory only, so under gloo a CUDA
    row is staged through the host on every call (copied to a host
    buffer and sent; the host buffer received is copied back to the
    rank's device); on the CPU gloo sends the row itself."""
    import torch.distributed as dist

    ctx = _wired()
    n, me = ctx.size, ctx.index
    if perm is None:
        perm = [(i, (i + 1) % n) for i in range(n)]
    staged = x.is_cuda and dist.get_backend(ctx.group) != "nccl"
    send = x.cpu() if staged else x.contiguous()
    out = torch.zeros_like(send)
    ranks = dist.get_process_group_ranks(ctx.group)
    ops = [dist.P2POp(dist.isend, send, ranks[dst], ctx.group)
           for src, dst in perm if src == me and dst != me]
    ops += [dist.P2POp(dist.irecv, out, ranks[src], ctx.group)
            for src, dst in perm if dst == me and src != me]
    if any(src == dst == me for src, dst in perm):
        out.copy_(send)
    for w in dist.batch_isend_irecv(ops) if ops else ():
        w.wait()
    return out.to(x.device) if staged else out


def ppermute(x, axis=MODEL_AXIS, perm=None):
    """A permutation of the rows of a simulated axis (dim 0): with `perm`
    None the ring i -> i+1 (row j receives row j-1); else `perm` pairs
    (src, dst) and a row no pair reaches is zero, as jax.lax.ppermute's.
    Under a wired model group the rows are the group's ranks.  Logged as
    one collective-permute of one row's bytes."""
    log_collective("collective-permute", axis, shard_nbytes(x))
    if _wired() is not None and axis == MODEL_AXIS:
        if x.shape[0] != 1:
            raise ValueError("a rank of the shard backend holds one shard")
        return _permute_ranks(x, perm)
    if perm is None:
        return torch.roll(x, 1, dims=0)
    rows = [torch.zeros_like(x[0])] * x.shape[0]
    for src, dst in perm:
        rows[dst] = x[src]
    return torch.stack(rows)


#: `_axes_group`'s answer when the sum needs no wire (one rank, or sim)
_LOCAL = object()


def _axes_group(axis):
    """The torch.distributed group a data-axis collective runs over on a
    rank: the ranks that share every coordinate but those of the named
    axes wider than 1 (the data, model, pod, (pod, data) or replica
    group, or the world), or _LOCAL when no data group is bound or the
    axes span one rank."""
    d = _GROUP.data
    if d is None:
        return _LOCAL
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    m = _GROUP.ctx
    size = {"pod": d.pod, "data": d.size,
            "model": m.size if m is not None else 1}
    if not set(names) <= set(size):
        raise ValueError(f"unknown mesh axes {axis!r}")

    def wide(axes):
        return frozenset(a for a in axes if size[a] > 1)

    if not wide(names):
        return _LOCAL
    groups = {frozenset({"data"}): d.group}
    if m is not None:
        groups[frozenset({"model"})] = m.group
    for axes, g in d.wires:
        groups.setdefault(wide(axes), g)
    if wide(names) not in groups:
        raise ValueError(f"no group of this rank spans the axes {axis!r}")
    return groups[wide(names)]


def psum_plain(x, axis):
    """All-reduce over mesh axes, not differentiated (the train step's
    token count, loss and gradient-norm partials).  `axis` is a name or a
    tuple of names; x holds one partial per slot on its leading dims, one
    dim per name (of size 1 on a rank: its own slot), and their sum is
    returned, over the rank's groups on the shard backend.  Logged once
    with one slot's bytes."""
    k = 1 if isinstance(axis, str) else len(axis)
    log_collective("all-reduce", axis,
                   x[(0,) * k].numel() * x.element_size())
    s = x.sum(dim=tuple(range(k)))
    group = _axes_group(axis)
    if group is not _LOCAL:
        import torch.distributed as dist
        dist.all_reduce(s, group=group)
    return s


def pod_all_reduce(x, axis, nbytes: int):
    """The multi-pod gradient sum of ZeRO-1 and FSDP: the optimizer state
    is data-sharded within a pod and replicated across pods, so the
    pods' gradients are all-reduced once.  Logged as one all-reduce of
    `nbytes`.  On sim x already holds the sum over every slot; on a rank
    x (its partial) is summed in place over its pod group."""
    log_collective("all-reduce", axis, nbytes)
    group = _axes_group(axis)
    if group is not _LOCAL:
        import torch.distributed as dist
        dist.all_reduce(x, group=group)
    return x


def _data_wired() -> Optional[DataGroup]:
    d = _GROUP.data
    return d if d is not None and d.size > 1 else None


def psum_scatter(x, axis, n: int):
    """Reduce-scatter over a data axis of n slots (tiled, on the last
    dim) of a shard-stacked x (tp, ..., L).  Returns (n, tp, ..., L/n),
    slot i owning slice i.  On sim x is already the sum over the slots
    (the port differentiates the whole global batch at once); on a rank
    it is the rank's partial, (1, ..., L), and the result is the sum over
    the data group of its own slice, (1, 1, ..., L/n).  Logged with one
    model shard's bytes of x."""
    log_collective("reduce-scatter", axis, shard_nbytes(x))
    if x.shape[-1] % n:
        raise ValueError(f"last dim {x.shape[-1]} does not split {n} ways")
    parts = x.unflatten(-1, (n, x.shape[-1] // n)).movedim(-2, 0)
    d = _GROUP.data
    if d is None:
        return parts
    if n != d.size:
        raise ValueError(f"{n} slots on a data group of {d.size} ranks")
    if d.size == 1:
        return parts
    out = torch.empty_like(parts[:1])
    reduce_scatter(out, parts.contiguous(), d.group)
    return out


def reduce_scatter(out, parts, group):
    """out (1, ...) := the sum over `group` of row `rank` of parts (n,
    ...), n the group's size."""
    import torch.distributed as dist

    # torch >= 2.13 names it reduce_scatter_single (the old name warns)
    fn = getattr(dist, "reduce_scatter_single", None)
    (fn or dist.reduce_scatter_tensor)(out, parts, group=group)


def gather_rows(x, dim: int, group, n: int):
    """x all-gathered over `group` (n ranks), concatenated on `dim` in
    rank order (x itself when n is 1)."""
    if n == 1:
        return x
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def all_gather(x, axis):
    """All-gather over a data axis (tiled, on the last dim): x (n, tp, ...,
    m), slot i's slice of each model shard, -> (tp, ..., n*m), their
    concatenation.  On a rank x is its own slot, (1, 1, ..., m), gathered
    over the data group.  Logged with one slot's bytes of one shard."""
    log_collective("all-gather", axis, x[0, 0].numel() * x.element_size())
    d = _data_wired()
    if d is not None:
        x = gather_rows(x, 0, d.group, d.size)
    return x.movedim(0, -2).flatten(-2)


class _GatherData(torch.autograd.Function):
    """FSDP's weight gather on a rank: forward, the data group's slices
    concatenated on `dim`; backward, the transpose: the cotangent
    reduce-scattered back to this rank's slice (the reference's
    all_gather transpose)."""

    @staticmethod
    def forward(ctx, x, dim):
        d = _GROUP.data
        ctx.dim, ctx.d = dim, d
        return gather_rows(x, dim, d.group, d.size)

    @staticmethod
    def backward(ctx, ct):
        d, dim = ctx.d, ctx.dim
        parts = ct.unflatten(dim, (d.size, ct.shape[dim] // d.size))
        parts = parts.movedim(dim, 0).contiguous()
        out = torch.empty_like(parts[:1])
        reduce_scatter(out, parts, d.group)
        return out[0], None


def group_reduce_data(t):
    """In-place sum of t over the bound data group (nothing without a
    wired one): a rank's gradient of a weight every data rank holds
    whole.  Not logged: the reference's shard_map transposes it in."""
    d = _data_wired()
    if d is not None:
        import torch.distributed as dist
        dist.all_reduce(t, group=d.group)
    return t


def gather_data(x, dim: int):
    """A rank's data slice of a weight, all-gathered over the bound data
    group on `dim` (differentiable: the gradient comes back reduce-
    scattered); x itself without a wired data group.  Not logged: the
    caller logs (fsdp.gather_leaf)."""
    if _data_wired() is None:
        return x
    return _GatherData.apply(x, dim)


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
    return g_psum(x)


def column_entry(x, axis=MODEL_AXIS):
    """Column-parallel region entry: identity forward, shard-summed
    gradient."""
    return f_ident(x)


def shared_param(p, axis=MODEL_AXIS):
    """Replicated parameter used in a shard-divergent region: identity
    forward, shard-summed gradient."""
    return shard_sum_grad(p)
