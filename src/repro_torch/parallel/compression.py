"""Low-bit sync payloads (port of repro/parallel/compression.py, the
non-overlap half).

`quantized_psum` is the two-hop low-bit all-reduce of every quantized
kept sync: quantize each shard's partial, reduce-scatter, re-quantize
the reduced slice, all-gather.  Like the reference's emulation, the math
reproduces the scheme's error (quantize before the reduction and after
it) while the reduction itself is one sum over the shard axis; the
ledger carries the true wire bytes (int codes + bf16 scales).

The quantize-dequantize goes through `kernels.quant_collectives.
qdq_absmax`, which launches the CUDA kernel for a CUDA tensor and takes
its plain version for a CPU tensor (the reference's kernel="auto").
Each shard's payload is flattened and chunked from its own element 0,
as under the reference's per-shard `vmap`.
"""
from __future__ import annotations

from repro_torch.kernels.quant_collectives import qdq_absmax
from repro_torch.parallel.collectives import log_collective

QUANT_BITS = {"quant8": 8, "int8": 8, "quant4": 4, "int4": 4}
DEFAULT_CHUNK = 128


def _levels(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return 7 if bits == 4 else 127


def wire_bytes(n_elems: int, bits: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Wire bytes of a quantized payload: nibble-packed int4 (rounded up)
    or int8 codes, plus one bf16 absmax scale per chunk."""
    codes = -(-n_elems // 2) if bits == 4 else n_elems
    return codes + -(-n_elems // chunk) * 2


def qdq(x, *, bits: int = 8, chunk: int = DEFAULT_CHUNK):
    """Absmax quantize-dequantize round trip of a shard-stacked tensor,
    each shard flattened on its own.  Returns fp32 of x's shape."""
    flat = x.float().reshape(x.shape[0], -1).contiguous()
    return qdq_absmax(flat, levels=_levels(bits),
                      chunk=chunk).reshape(x.shape)


def _log_two_hop(axis, wire_full: int, wire_slice: int) -> None:
    """The RS entry carries the full quantized payload each shard sends,
    the AG entry the reduced per-shard slice (the reference's overlap
    branch, ring-step entries, waits for the overlap backend)."""
    log_collective("reduce-scatter", axis, wire_full, overlappable=True)
    log_collective("all-gather", axis, wire_slice, overlappable=True)


def quantized_psum(x, axis, *, bits: int = 8, chunk: int = DEFAULT_CHUNK):
    """Low-bit psum over the shard axis (dim 0); returns x's dtype."""
    tp = x.shape[0]
    n = x[0].numel()
    _log_two_hop(axis, wire_bytes(n, bits, chunk),
                 wire_bytes(-(-n // tp), bits, chunk))
    xq = qdq(x, bits=bits, chunk=chunk)                  # hop 1
    s = xq.sum(dim=0, keepdim=True).expand_as(xq)
    return qdq(s, bits=bits, chunk=chunk).to(x.dtype)    # hop 2


def quantized_gather_payload(x, axis, *, bits: int = 8,
                             chunk: int = DEFAULT_CHUNK):
    """Model a low-bit all-gather of each shard's payload (the
    vocab-parallel logits slice): qdq it and log the gather at quantized
    bytes; the caller does the gather."""
    log_collective("all-gather", axis, wire_bytes(x[0].numel(), bits, chunk))
    return qdq(x, bits=bits, chunk=chunk).to(x.dtype)
