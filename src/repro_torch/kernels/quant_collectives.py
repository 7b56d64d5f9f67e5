"""Per-chunk absmax quantization kernels: the CUDA kernels' wrappers and
their plain versions (port of repro/kernels/quant_collectives.py, the
TPU kernels, and of their oracles in repro/kernels/ref.py).

    qdq_absmax            fp32 (rows, n) -> fp32 quantize-dequantize
    quantized_psum_absmax bf16 / fp32 (tp, n) -> every row
                          qdq(sum_r qdq(x_r)): both hops of a quantized
                          kept sync in one launch
    quantize_absmax       fp32 (rows, n) -> int8 codes (rows, n),
                          fp32 scales (rows, ceil(n/128))
    dequantize_absmax     codes, scales -> fp32 (rows, n)
    dequant_accum_absmax  codes, scales, fp32 acc -> acc + codes*scales
    quantize_message_absmax  bf16 / fp32 (rows, n) -> int8 wire messages
                          (rows, m): codes, a zero pad, fp32 scales
                          (`message_layout`); the send side of a
                          quantized kept sync across ranks
    reduce_messages_absmax   gathered messages (tp, m) -> (1, n)
                          qdq(sum_r dequantize(message r)): the receive
                          side and hop 2, one launch

Rows are chunked independently from element 0: each row is one TP
shard's flattened payload, which the reference quantizes per shard
under `vmap`.  Each wrapper launches its kernel in
`csrc/quant_collectives.cu` for a CUDA tensor and takes its plain
version only for a CPU tensor (a meta tensor takes the meta branch of
kernels/meta.py); kernel and plain version agree bit for bit on the
card.  Each wrapper's `.launches` counts kernel launches.
The fused sync and the receive take any number of shards: their
kernels stream the rows `qpsum_group(tp)` at a time (the C entries pick
the group from tp by the same rule).  The launch geometry (`qpsum_grid`,
`dequant_grid`, `vector_rows`) is planned here, in Python, so that the
CPU tests reach it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import meta as META

CHUNK = 128          # the kernel's fixed chunk (one warp, 4 per lane)
LEVELS = (7, 127)    # quant4, quant8
PSUM_DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 8        # rows a lane holds at a time (8 x 4 floats)
WARPS = 8            # warps of a full block (256 threads)


def qdq_absmax_plain(x, *, levels: int, chunk: int = CHUNK):
    """x (rows, n) -> fp32 (rows, n) quantize-dequantize round trip.

    `levels` divides as a tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which is not the true division
    the reference oracle (and the kernel) performs."""
    rows, n = x.shape
    xp = F.pad(x.float(), (0, (-n) % chunk)).reshape(rows, -1, chunk)
    lv = torch.full((), levels, dtype=torch.float32, device=x.device)
    s = torch.clamp(xp.abs().amax(dim=-1, keepdim=True) / lv, min=1e-12)
    q = torch.clamp(torch.round(xp / s), -levels, levels)
    return (q * s).reshape(rows, -1)[:, :n]


def quantized_psum_absmax_plain(x, *, levels: int, chunk: int = CHUNK):
    """x (tp, n) -> x's dtype (tp, n), every row qdq(sum_r qdq(x_r)):
    hop 1 on each shard's row, the fp32 rows added one after another from
    +0 in row order (the fused kernel's order, which `sum(dim=0)` does not
    promise on the card for every tp), hop 2 on the sum, one cast."""
    xq = qdq_absmax_plain(x, levels=levels, chunk=chunk)
    acc = torch.zeros_like(xq[:1])
    for r in range(xq.shape[0]):
        acc = acc + xq[r:r + 1]
    y = qdq_absmax_plain(acc, levels=levels, chunk=chunk).to(x.dtype)
    return y.expand(xq.shape).contiguous()


def quantize_absmax_plain(x, *, levels: int, chunk: int = CHUNK):
    """x (rows, n) -> (int8 codes (rows, n), fp32 scales (rows,
    ceil(n/chunk))); `levels` divides as a tensor (see qdq_absmax_plain)."""
    rows, n = x.shape
    xp = F.pad(x.float(), (0, (-n) % chunk)).reshape(rows, -1, chunk)
    lv = torch.full((), levels, dtype=torch.float32, device=x.device)
    s = torch.clamp(xp.abs().amax(dim=-1) / lv, min=1e-12)
    q = torch.clamp(torch.round(xp / s[..., None]), -levels, levels)
    return q.to(torch.int8).reshape(rows, -1)[:, :n].contiguous(), s


def dequantize_absmax_plain(q, s, *, chunk: int = CHUNK):
    """(codes (rows, n), scales (rows, ceil(n/chunk))) -> fp32 (rows, n)."""
    rows, n = q.shape
    qp = F.pad(q.float(), (0, (-n) % chunk)).reshape(rows, -1, chunk)
    return (qp * s[..., None]).reshape(rows, -1)[:, :n]


def dequant_accum_absmax_plain(q, s, acc, *, chunk: int = CHUNK):
    """acc + dequantize(q, s): a multiply, then an add (two roundings)."""
    return acc.float() + dequantize_absmax_plain(q, s, chunk=chunk)


def message_layout(n: int, chunk: int = CHUNK) -> tuple:
    """(byte offset of the scales, bytes) of one rank's wire message for
    an n-element payload: n int8 codes, zero bytes up to the next 16-byte
    boundary, then one fp32 scale a chunk (csrc/quant_collectives.cu)."""
    pad = -(-n // 16) * 16
    return pad, pad + 4 * -(-n // chunk)


def message_parts(msg, n: int, chunk: int = CHUNK) -> tuple:
    """Views of messages (rows, m): int8 codes (rows, n) and fp32 scales
    (rows, ceil(n/chunk))."""
    pad, m = message_layout(n, chunk)
    return msg[:, :n], msg[:, pad:m].view(torch.float32)


def quantize_message_absmax_plain(x, *, levels: int, chunk: int = CHUNK):
    """x (rows, n) -> int8 messages (rows, m): row r's
    `quantize_absmax_plain` codes and scales at `message_layout`, the pad
    zero."""
    rows, n = x.shape
    q, s = quantize_absmax_plain(x, levels=levels, chunk=chunk)
    msg = torch.zeros((rows, message_layout(n, chunk)[1]), dtype=torch.int8,
                      device=x.device)
    mq, ms = message_parts(msg, n, chunk)
    mq.copy_(q)
    ms.copy_(s)
    return msg


def reduce_messages_absmax_plain(msg, n: int, *, levels: int, dtype,
                                 chunk: int = CHUNK):
    """Gathered messages (tp, m) -> dtype (1, n): the tp dequantized rows
    added one after another from +0 in row order
    (`dequant_accum_absmax_plain`), hop 2 (`qdq_absmax_plain`), one
    cast."""
    q, s = message_parts(msg, n, chunk)
    acc = torch.zeros((1, n), dtype=torch.float32, device=msg.device)
    for r in range(msg.shape[0]):
        acc = dequant_accum_absmax_plain(q[r:r + 1], s[r:r + 1], acc,
                                         chunk=chunk)
    return qdq_absmax_plain(acc, levels=levels, chunk=chunk).to(dtype)


def _check_2d(name, t, dtype) -> None:
    if t.dim() != 2:
        raise ValueError(f"want {name} (rows, n); got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"want {dtype} {name}; got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} too large for the kernel's int indexing")


def _check_chunk(chunk: int) -> None:
    if chunk != CHUNK:
        raise ValueError(f"the kernel's chunk is {CHUNK}, got {chunk}")


def _check_levels(levels: int) -> None:
    if levels not in LEVELS:
        raise ValueError(f"levels {levels} not in {LEVELS}")


def check_args(x, levels: int, chunk: int) -> None:
    _check_2d("x", x, torch.float32)
    _check_levels(levels)
    _check_chunk(chunk)


def _check_codes(q, s, chunk: int) -> None:
    _check_2d("q", q, torch.int8)
    _check_2d("s", s, torch.float32)
    _check_chunk(chunk)
    want = (q.shape[0], -(-q.shape[1] // chunk))
    if tuple(s.shape) != want:
        raise ValueError(f"want scales {want} for codes {tuple(q.shape)}; "
                         f"got {tuple(s.shape)}")
    if s.device != q.device:
        raise ValueError("codes and scales on different devices")


def qpsum_grid(n: int, sms: int) -> tuple:
    """(blocks, warps a block) of the fused kept-sync kernel: one warp a
    chunk index, and as many warps a block (up to WARPS) as keep at least
    one block a streaming multiprocessor where the payload has that many
    chunks (a decode step's 30 chunks run as 30 one-warp blocks)."""
    chunks = -(-n // CHUNK)
    warps = max(1, min(WARPS, chunks // sms))
    return -(-chunks // warps), warps


def qpsum_group(tp: int) -> int:
    """Rows (ranks) the fused sync's and the receive's kernels stream at
    a time: tp itself where it is 1, 2, 4 or 8 (one whole group, every
    loop unrolled: the small-tp path), else MAX_GROUP (the last group
    partial).  A warp loads a group's rows together, then adds them in
    row order.  The C entries choose the group from tp themselves; this
    states their rule for the CPU tests' emulations of the plan."""
    return tp if tp in (1, 2, 4, MAX_GROUP) else MAX_GROUP


def dequant_grid(rows: int, n: int, sms: int) -> int:
    """Blocks of WARPS warps for the dequantize kernel's grid-stride loop
    over rows * ceil(n/128) chunks: one chunk a warp, at most a full
    card's worth of resident blocks (8 a streaming multiprocessor)."""
    total = rows * -(-n // CHUNK)
    return max(1, min(-(-total // WARPS), 8 * sms))


def vector_rows(n: int, *tensors) -> bool:
    """True where every row of every (rows, n) tensor starts on a 4-element
    boundary: n % 4 == 0 and each base 4-element aligned, so a lane's 4
    elements are one access."""
    return n % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


_SMS: dict = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _on_card(x, what: str) -> bool:
    """False for a CPU tensor (take the plain version), True for a CUDA
    one (launch the kernel); raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    return True


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "qdq_absmax_fwd": [_P, _P, _I, _I, _I, _P],
    "quantize_absmax_fwd": [_P, _P, _P, _I, _I, _I, _P],
    "quantized_psum_absmax_fwd": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dequantize_absmax_fwd": [_P, _P, _P, _I, _I, _I, _I, _P],
    "dequant_accum_absmax_fwd": [_P, _P, _P, _P, _I, _I, _P],
    "quantize_message_absmax_fwd": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "reduce_messages_absmax_fwd": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
_FNS: dict = {}


def _bind(name: str):
    """The C entry `name`, its argument types set once and cached."""
    fn = getattr(build.load("quant_collectives"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    _FNS[name] = fn
    return fn


def _launch(name: str, device, *args) -> None:
    """Call the C entry `name` (its last argument PyTorch's current stream
    on `device`, read as the raw handle: `torch.cuda.current_stream`
    would build a Python Stream object on every call), inside `device`'s
    context only where it is not the current device; raise on the CUDA
    error it returns."""
    fn = _FNS.get(name) or _bind(name)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc:
        build.check(build.load("quant_collectives"), rc, name)


def qdq_absmax(x, *, levels: int, chunk: int = CHUNK):
    """x (rows, n) fp32 -> fp32 (rows, n), chunks restarting at each row."""
    check_args(x, levels, chunk)
    if x.is_meta:
        return META.launch("qdq_absmax", torch.empty_like(x),
                           nbytes=2 * META.nbytes(x))
    if not _on_card(x, "qdq"):
        return qdq_absmax_plain(x, levels=levels, chunk=chunk)
    build.refuse_grad("qdq", x)
    out = torch.empty_like(x)
    _launch("qdq_absmax_fwd", x.device, x.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], levels)
    qdq_absmax.launches += 1
    return out


qdq_absmax.launches = 0


def _check_psum_dtype(x) -> None:
    if x.dtype not in PSUM_DTYPES:
        raise TypeError(f"want float32 or bfloat16 x; got {x.dtype}")


def quantized_psum_absmax(x, *, levels: int, chunk: int = CHUNK):
    """x (tp, n) bf16 or fp32, row r shard r's flattened payload -> x's
    dtype (tp, n), every row qdq(sum_r qdq(x_r)): the two hops of a
    quantized kept sync, one launch."""
    _check_psum_dtype(x)
    _check_2d("x", x, x.dtype)
    _check_levels(levels)
    _check_chunk(chunk)
    if x.is_meta:
        return META.launch("quantized_psum_absmax", torch.empty_like(x),
                           nbytes=2 * META.nbytes(x))
    if not _on_card(x, "quantized-psum"):
        return quantized_psum_absmax_plain(x, levels=levels, chunk=chunk)
    build.refuse_grad("quantized-psum", x)
    tp, n = x.shape
    out = torch.empty_like(x)
    blocks, warps = qpsum_grid(n, _sm_count(x.device))
    _launch("quantized_psum_absmax_fwd", x.device, x.data_ptr(),
            out.data_ptr(), tp, n, levels, int(x.dtype == torch.bfloat16),
            blocks, warps, int(vector_rows(n, x, out)))
    quantized_psum_absmax.launches += 1
    return out


quantized_psum_absmax.launches = 0


def quantize_message_absmax(x, *, levels: int, chunk: int = CHUNK):
    """x (rows, n) bf16 or fp32, row r a rank's flattened partial -> int8
    wire messages (rows, m) at `message_layout`, in one launch and with
    no cast before it: the send side of a quantized kept sync across
    ranks."""
    _check_psum_dtype(x)
    _check_2d("x", x, x.dtype)
    _check_levels(levels)
    _check_chunk(chunk)
    rows, n = x.shape
    m = message_layout(n)[1]
    if rows * m >= 2 ** 31:
        raise ValueError("messages too large for the kernel's int indexing")
    if x.is_meta:
        msg = torch.empty((rows, m), dtype=torch.int8, device=x.device)
        return META.launch("quantize_message_absmax", msg,
                           nbytes=META.nbytes(x, msg))
    if not _on_card(x, "quantize-message"):
        return quantize_message_absmax_plain(x, levels=levels, chunk=chunk)
    build.refuse_grad("quantize-message", x)
    msg = torch.empty((rows, m), dtype=torch.int8, device=x.device)
    blocks, warps = qpsum_grid(n, _sm_count(x.device))
    _launch("quantize_message_absmax_fwd", x.device, x.data_ptr(),
            msg.data_ptr(), rows, n, levels, int(x.dtype == torch.bfloat16),
            blocks, warps, int(vector_rows(n, x)))
    quantize_message_absmax.launches += 1
    return msg


quantize_message_absmax.launches = 0


def reduce_messages_absmax(msg, n: int, *, levels: int, dtype,
                           chunk: int = CHUNK):
    """Gathered messages (tp, m) int8, row r rank r's, of n-element
    payloads -> dtype (1, n), qdq(sum_r dequantize(message r)) summed in
    row order from +0: the receive side and hop 2 of a quantized kept
    sync across ranks, one launch."""
    _check_2d("msg", msg, torch.int8)
    _check_levels(levels)
    _check_chunk(chunk)
    if dtype not in PSUM_DTYPES:
        raise TypeError(f"want a float32 or bfloat16 result; got {dtype}")
    tp, m = msg.shape
    if m != message_layout(n)[1]:
        raise ValueError(f"messages of {n} elements are "
                         f"{message_layout(n)[1]} bytes; got {m}")
    if tp < 1:
        raise ValueError("no messages to reduce")
    if msg.is_meta:
        out = torch.empty((1, n), dtype=dtype, device=msg.device)
        return META.launch("reduce_messages_absmax", out,
                           nbytes=META.nbytes(msg, out))
    if msg.data_ptr() % 4:
        raise ValueError("messages must start on a 4-byte boundary (the "
                         "kernel reads 4 codes and a scale at a time)")
    if not _on_card(msg, "reduce-messages"):
        return reduce_messages_absmax_plain(msg, n, levels=levels,
                                            dtype=dtype, chunk=chunk)
    build.refuse_grad("reduce-messages", msg)
    out = torch.empty((1, n), dtype=dtype, device=msg.device)
    blocks, warps = qpsum_grid(n, _sm_count(msg.device))
    _launch("reduce_messages_absmax_fwd", msg.device, msg.data_ptr(),
            out.data_ptr(), tp, n, levels, int(dtype == torch.bfloat16),
            blocks, warps, int(vector_rows(n, out)))
    reduce_messages_absmax.launches += 1
    return out


reduce_messages_absmax.launches = 0


def quantize_absmax(x, *, levels: int, chunk: int = CHUNK):
    """x (rows, n) fp32 -> (int8 codes (rows, n), fp32 scales (rows,
    ceil(n/128))), chunks restarting at each row."""
    check_args(x, levels, chunk)
    if x.is_meta:
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        s = torch.empty((x.shape[0], -(-x.shape[1] // chunk)),
                        dtype=torch.float32, device=x.device)
        return META.launch("quantize_absmax", (q, s),
                           nbytes=META.nbytes(x, q, s))
    if not _on_card(x, "quantize"):
        return quantize_absmax_plain(x, levels=levels, chunk=chunk)
    build.refuse_grad("quantize", x)
    rows, n = x.shape
    q = torch.empty((rows, n), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, -(-n // chunk)), dtype=torch.float32,
                    device=x.device)
    _launch("quantize_absmax_fwd", x.device, x.data_ptr(), q.data_ptr(),
            s.data_ptr(), rows, n, levels)
    quantize_absmax.launches += 1
    return q, s


quantize_absmax.launches = 0


def dequantize_absmax(q, s, *, chunk: int = CHUNK):
    """int8 codes (rows, n) and fp32 scales (rows, ceil(n/128)) -> fp32
    (rows, n)."""
    _check_codes(q, s, chunk)
    if q.is_meta:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        return META.launch("dequantize_absmax", out,
                           nbytes=META.nbytes(q, s, out))
    if not _on_card(q, "dequantize"):
        return dequantize_absmax_plain(q, s, chunk=chunk)
    build.refuse_grad("dequantize", q, s)
    rows, n = q.shape
    out = torch.empty((rows, n), dtype=torch.float32, device=q.device)
    _launch("dequantize_absmax_fwd", q.device, q.data_ptr(), s.data_ptr(),
            out.data_ptr(), rows, n,
            dequant_grid(rows, n, _sm_count(q.device)),
            int(vector_rows(n, q, out)))
    dequantize_absmax.launches += 1
    return out


dequantize_absmax.launches = 0


def dequant_accum_absmax(q, s, acc, *, chunk: int = CHUNK):
    """acc (rows, n) fp32 + codes * scales in one pass: the receive side
    of each quantized ring reduce-scatter step."""
    _check_codes(q, s, chunk)
    _check_2d("acc", acc, torch.float32)
    if tuple(acc.shape) != tuple(q.shape) or acc.device != q.device:
        raise ValueError(f"acc {tuple(acc.shape)} on {acc.device} does not "
                         f"match codes {tuple(q.shape)} on {q.device}")
    if q.is_meta:
        return META.launch("dequant_accum_absmax", torch.empty_like(acc),
                           nbytes=META.nbytes(q, s, acc, acc))
    if not _on_card(q, "dequant-accumulate"):
        return dequant_accum_absmax_plain(q, s, acc, chunk=chunk)
    build.refuse_grad("dequant-accumulate", q, s, acc)
    out = torch.empty_like(acc)
    _launch("dequant_accum_absmax_fwd", q.device, q.data_ptr(),
            s.data_ptr(), acc.data_ptr(), out.data_ptr(), q.shape[0],
            q.shape[1])
    dequant_accum_absmax.launches += 1
    return out


dequant_accum_absmax.launches = 0
