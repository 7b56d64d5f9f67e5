"""Low-bit sync payloads (port of repro/parallel/compression.py).

`quantized_psum` is the two-hop low-bit all-reduce of every quantized
kept sync: quantize each shard's partial, reduce-scatter, re-quantize
the reduced slice, all-gather.  Like the reference's emulation, the math
reproduces the scheme's error (quantize before the reduction and after
it) while the reduction itself is one sum over the shard axis; the
ledger carries the true wire bytes (int codes + bf16 scales).

Both hops of a kept sync go through `kernels.quant_collectives.
quantized_psum_absmax`, one launch for the whole sync on a CUDA tensor;
the logits gather and the ring's hop 2 go through `qdq_absmax`.  Each
wrapper takes its plain version for a CPU tensor (the reference's
kernel="auto").  Each shard's payload is flattened and chunked from its
own element 0, as under the reference's per-shard `vmap`.  Under
autograd both are Functions whose forward is that same call and whose
backward is the identity: the reference's straight-through estimator
for `qdq`, and `g_psum`'s backward for the kept sync.

On the `shard` backend (a wired model group, one shard a rank) hop 1
travels as int8 codes: the send kernel (`quantize_message_absmax`)
quantizes this rank's partial, in its own dtype, into one int8 message
of codes and fp32 scales; the messages are all-gathered into the rows
of one (size, m) tensor; and the receive kernel
(`reduce_messages_absmax`) adds every rank's partial in rank order from
+0, the fused kernel's order, and runs hop 2.  Two launches and one
collective a sync, and a rank gets the `sim` engine's bits at every tp.

The runnable ring collectives at the end (`ring_all_gather`,
`ring_reduce_scatter`, `ring_quantized_psum`) execute the chunked ring
schedule that the overlap backend's ledger accounts for, one
`collectives.ppermute` per ring step: a roll of the shard axis on sim,
a send to the next rank of the model group on the shard backend (over
NCCL from the card; over gloo staged through the host).  The quantized
ring sends through the quantize kernel and receives through the fused
dequant-accumulate kernel.  The serving engines keep the two-hop
`quantized_psum` above, as the reference's engines do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.quant_collectives import (dequant_accum_absmax,
                                                   qdq_absmax,
                                                   quantize_absmax,
                                                   quantize_message_absmax,
                                                   quantized_psum_absmax,
                                                   reduce_messages_absmax)
from repro_torch.parallel.collectives import (MODEL_AXIS, axis_size,
                                              current_group, log_collective,
                                              overlap_chunks, ppermute,
                                              ring_wire_bytes, shard_ids)

QUANT_BITS = {"quant8": 8, "int8": 8, "quant4": 4, "int4": 4}
DEFAULT_CHUNK = 128
# floor on the ring-step payload an overlap region splits a hop into:
# each step pays a launch that never hides (LatencyModel), so tiny hops
# stay 1-2 steps instead of ring_chunks launches
MIN_RING_CHUNK_BYTES = 16384


def _levels(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return 7 if bits == 4 else 127


def wire_bytes(n_elems: int, bits: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Wire bytes of a quantized payload: nibble-packed int4 (rounded up)
    or int8 codes, plus one bf16 absmax scale per chunk."""
    codes = -(-n_elems // 2) if bits == 4 else n_elems
    return codes + -(-n_elems // chunk) * 2


class _StraightThrough(torch.autograd.Function):
    """The wire qdq with the reference's straight-through gradient
    (`y = flat + stop_gradient(y - flat)`): forward the round trip (the
    kernel on the card; autograd records nothing inside a Function's
    forward, so the kernel runs), backward the identity.  The forward
    value is the round trip itself: flat + (y - flat) equals y exactly
    (Sterbenz) but for a zero's sign."""

    @staticmethod
    def forward(ctx, flat, levels, chunk):
        return qdq_absmax(flat, levels=levels, chunk=chunk)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _QuantizedPsum(torch.autograd.Function):
    """Both hops of a quantized kept sync in one call (the fused kernel on
    the card), with `g_psum`'s backward: the identity.  The reference's
    `quantized_psum` reduces with a plain psum, whose transpose re-sums
    the cotangent over the shards at tp > 1 (ROADMAP C5); the port does
    not copy that."""

    @staticmethod
    def forward(ctx, flat, levels, chunk):
        return _two_hops(flat, levels, chunk)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def gather_messages(msg):
    """All-gather of this rank's wire message (1, m) over the wired model
    group into the rows of one (size, m) int8 tensor, in rank order: NCCL
    gathers straight into it, other backends into its row views."""
    import torch.distributed as dist

    ctx = current_group()
    buf = torch.empty((ctx.size, msg.shape[1]), dtype=msg.dtype,
                      device=msg.device)
    if dist.get_backend(ctx.group) == "nccl":
        dist.all_gather_into_tensor(buf, msg, group=ctx.group)
    else:
        dist.all_gather(list(buf.unbind(0)), msg[0], group=ctx.group)
    return buf


def _two_hops(flat, levels: int, chunk: int):
    """Both hops of a quantized kept sync of the shard-stacked flat
    payload: one fused launch when every shard is on this device (sim, or
    a group of one); across ranks, the send kernel -> all-gather of the
    messages -> the receive kernel (rank order from +0, then hop 2)."""
    ctx = current_group()
    if ctx is None or ctx.size == 1:
        return quantized_psum_absmax(flat, levels=levels, chunk=chunk)
    if flat.shape[0] != 1:
        raise ValueError("a rank of the shard backend holds one shard")
    msg = quantize_message_absmax(flat, levels=levels, chunk=chunk)
    return reduce_messages_absmax(gather_messages(msg), flat.shape[1],
                                  levels=levels, dtype=flat.dtype,
                                  chunk=chunk)


def _records(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def qdq(x, *, bits: int = 8, chunk: int = DEFAULT_CHUNK):
    """Absmax quantize-dequantize round trip of a shard-stacked tensor,
    each shard flattened on its own.  Returns fp32 of x's shape; the
    gradient passes straight through."""
    flat = x.float().reshape(x.shape[0], -1).contiguous()
    if _records(flat):
        y = _StraightThrough.apply(flat, _levels(bits), chunk)
    else:
        y = qdq_absmax(flat, levels=_levels(bits), chunk=chunk)
    return y.reshape(x.shape)


def _log_two_hop(axis, wire_full: int, wire_slice: int, n: int) -> None:
    """The RS entry carries the full quantized payload each shard sends,
    the AG entry the reduced per-shard slice.  Inside an overlap region
    each hop instead logs up to the region's chunk count of ring-step
    collective-permute entries whose bytes sum to the hop's ring wire
    traffic (n is the shard count)."""
    region = overlap_chunks()
    if region <= 0:
        log_collective("reduce-scatter", axis, wire_full, overlappable=True)
        log_collective("all-gather", axis, wire_slice, overlappable=True)
        return
    for wire in (ring_wire_bytes("reduce-scatter", wire_full, n),
                 ring_wire_bytes("all-gather", wire_slice, n)):
        wire = int(round(wire))
        chunks = max(1, min(region, wire // MIN_RING_CHUNK_BYTES))
        step, rem = divmod(wire, chunks)
        for c in range(chunks):
            log_collective("collective-permute", axis,
                           step + (1 if c < rem else 0), overlappable=True)


def quantized_psum(x, axis, *, bits: int = 8, chunk: int = DEFAULT_CHUNK):
    """Low-bit psum over the shard axis (dim 0); returns x's dtype:
    qdq of each shard's payload (hop 1), their sum, qdq of the sum
    (hop 2), on every shard.  Differentiable: the backward is the
    identity, as the exact sync's (`collectives.g_psum`).  `tp` is the
    bound model group's size on the shard backend (x holds one shard)."""
    tp = axis_size(x)
    n = x[0].numel()
    _log_two_hop(axis, wire_bytes(n, bits, chunk),
                 wire_bytes(-(-n // tp), bits, chunk), tp)
    flat = x.reshape(x.shape[0], -1).contiguous()
    if _records(flat):
        y = _QuantizedPsum.apply(flat, _levels(bits), chunk)
    else:
        y = _two_hops(flat, _levels(bits), chunk)
    return y.reshape(x.shape)


def quantized_gather_payload(x, axis, *, bits: int = 8,
                             chunk: int = DEFAULT_CHUNK):
    """Model a low-bit all-gather of each shard's payload (the
    vocab-parallel logits slice): qdq it and log the gather at quantized
    bytes; the caller does the gather (on the shard backend an fp32
    all-gather of the round-tripped slices)."""
    log_collective("all-gather", axis, wire_bytes(x[0].numel(), bits, chunk))
    return qdq(x, bits=bits, chunk=chunk).to(x.dtype)


# ---------------------------------------------------------------------------
# Runnable ring collectives over the shard axis.  The reference runs one
# copy per device under vmap/shard_map.  On sim every shard is a row of
# one stacked tensor; on a rank of the shard backend x is the rank's one
# row and the ring steps cross the bound model group's ranks.  Either
# way `d` holds each row's shard index (collectives.shard_ids), and each
# per-device `jnp.take(xs, i(d), axis=0)` is the gather `xs[rows, i(d)]`
# on the (rows, n, m) tensor, so that a rank's row equals the stacked
# result's row bit for bit.
# ---------------------------------------------------------------------------


def _pad_to(flat, n: int):
    """Pad the last axis of (rows, size) to a multiple of n."""
    pad = (-flat.shape[-1]) % n
    return (F.pad(flat, (0, pad)), flat.shape[-1]) if pad else \
        (flat, flat.shape[-1])


def _ring_rows(x):
    """(n, rows, d): the ring's length (the bound group's size on a
    rank, else x's shard axis), the row indices of x's shard axis and
    each row's shard index."""
    rows = torch.arange(x.shape[0], device=x.device)
    return axis_size(x), rows, shard_ids(x)


def ring_all_gather(x, axis=MODEL_AXIS):
    """Ring all-gather of shard-stacked x (rows, ...): returns (rows, n,
    ...), [r, j] = shard j's x on the shard of row r; n-1 ring steps, each
    a collective-permute."""
    n, rows, d = _ring_rows(x)
    if n == 1:
        return x[:, None]
    ar = torch.arange(n, device=x.device)
    parts, cur = [x], x
    for _ in range(n - 1):
        cur = ppermute(cur, axis)
        parts.append(cur)
    # part t holds shard (d - t) % n; reorder so column j is shard j
    stacked = torch.stack(parts, dim=1)
    return stacked[rows[:, None], (d[:, None] - ar[None, :]) % n]


def ring_reduce_scatter(x, axis=MODEL_AXIS):
    """Ring reduce-scatter of shard-stacked x (rows, ...): shard d returns
    slice d (length ceil(size/n), zero-padded) of the cross-shard sum of
    its flattened payload, fp32 (rows, ceil(size/n)).  n-1 steps, each
    forwarding one partial slice and adding the local contribution."""
    n, rows, d = _ring_rows(x)
    flat = x.float().reshape(x.shape[0], -1)
    if n == 1:
        return flat
    padded, _ = _pad_to(flat, n)
    xs = padded.reshape(x.shape[0], n, -1)
    # chunk c starts at shard c+1 with that shard's contribution; after
    # n-1 forward-and-add steps it is complete at shard c
    buf = xs[rows, (d - 1) % n]
    for t in range(n - 1):
        buf = ppermute(buf, axis)
        buf = buf + xs[rows, (d - 2 - t) % n]
    return buf


def ring_quantized_psum(x, axis=MODEL_AXIS, *, bits: int = 8,
                        chunk: int = DEFAULT_CHUNK):
    """The runnable low-bit ring psum of shard-stacked x: a quantized
    ring reduce-scatter (each step sends int8 codes + fp32 scales from
    `quantize_absmax` and the receiver adds them into its partial with
    `dequant_accum_absmax`), then the reduced slice requantized (`qdq`)
    and ring all-gathered.  Returns x's shape and dtype.  Its error grows
    with the n-1 per-step requantizations, unlike `quantized_psum`."""
    shape, dtype = x.shape, x.dtype
    n, rows, d = _ring_rows(x)
    levels = _levels(bits)
    if n == 1:
        return qdq(x, bits=bits, chunk=chunk).to(dtype)
    padded, size = _pad_to(x.float().reshape(x.shape[0], -1), n)
    xs = padded.reshape(x.shape[0], n, -1)
    # hop 1: quantized ring reduce-scatter (requantize before each send)
    buf = xs[rows, (d - 1) % n]
    for t in range(n - 1):
        q, s = quantize_absmax(buf.contiguous(), levels=levels, chunk=chunk)
        q = ppermute(q, axis)
        s = ppermute(s, axis)
        buf = dequant_accum_absmax(q, s, xs[rows, (d - 2 - t) % n],
                                   chunk=chunk)
    # hop 2: requantize the reduced slice, ring all-gather, reassemble
    buf = qdq(buf, bits=bits, chunk=chunk)
    out = ring_all_gather(buf, axis).reshape(x.shape[0], -1)[:, :size]
    return out.reshape(shape).to(dtype)
