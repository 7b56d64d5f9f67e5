"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and its plain
version (port of repro/kernels/ssd_scan.py::ssd_scan, the TPU kernel, and
repro/kernels/ref.py::ssd_scan_ref, its oracle).

Both take the streams unpacked, as the model holds them: x (Bt, S, H, P);
dt (Bt, S, H) fp32; a, dd (Bt, H) fp32 (one value per stream: with the
shard axis folded into Bt each shard has its own heads); bm, cm (Bt, S, G,
N), read at group h // (H / G).  Both return (y (Bt, S, H, P) in x's
dtype, final state (Bt, H, P, N) fp32).  Unlike the TPU kernel, S need
not be a multiple of `chunk`: positions past S act as dt = 0 and x = 0,
which leaves y at real positions and the state exactly as they are.

`ssd_scan` launches `csrc/ssd_scan.cu` for CUDA tensors and takes
`ssd_scan_plain` only for CPU tensors (meta tensors: the meta branch of
kernels/meta.py, `ssd_flops`); `.launches` counts calls that
launched.  Where autograd records and an input requires grad, the
launch goes through `_SSDScan`: the forward is still the kernel (and
counts), the backward the VJP of `ssd_scan_plain` recomputed from the
saved inputs in their dtype (the reference's Pallas scan has no VJP: it
has no backward kernel either).  In bf16 one call launches three
tensor-core kernels (scores C.B^T once per (row, group, chunk); each
chunk's own state; y with the state passed between chunks) through fp32
scratch that the wrapper allocates (`scratch_shapes`); in fp32 one
CUDA-core kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta as META
from repro_torch.kernels.flash_attention import check_aligned
from repro_torch.models.ssm import ssd_chunked

DTYPES = (torch.float32, torch.bfloat16)
P_TILE = 16          # the kernel's columns per block: P must divide by it
MAX_CHUNK = 256
MAX_N = 256
# the bf16 (tensor-core) kernels: P one of these, N a multiple of 16 up
# to 128, 64-row tiles
TC_P = (16, 32, 64, 128)
TC_MAX_N = 128
TILE = 64


def ssd_scan_plain(x, dt, a, bm, cm, dd, *, chunk: int):
    """Pads S up to a multiple of `chunk` with dt = 0, x = 0 and runs the
    chunked form (models/ssm.ssd_chunked)."""
    s = x.shape[1]
    pad = -s % chunk

    def padded(t):
        if not pad:
            return t
        return torch.cat([t, t.new_zeros((t.shape[0], pad)
                                         + tuple(t.shape[2:]))], dim=1)

    y, state = ssd_chunked(padded(x), padded(dt), a, padded(bm), padded(cm),
                           dd, chunk=chunk)
    return y[:, :s], state


def check_args(x, dt, a, bm, cm, dd, chunk: int) -> None:
    """Validate what the kernel takes."""
    if x.dim() != 4 or bm.dim() != 4:
        raise ValueError(f"want x (Bt,S,H,P) and bm/cm (Bt,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(bm.shape)}")
    bt, s, h, p = x.shape
    g, n = bm.shape[2:]
    if tuple(bm.shape) != (bt, s, g, n) or tuple(cm.shape) != (bt, s, g, n):
        raise ValueError(f"bm/cm {tuple(bm.shape)}, {tuple(cm.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if tuple(dt.shape) != (bt, s, h) or tuple(a.shape) != (bt, h) \
            or tuple(dd.shape) != (bt, h):
        raise ValueError(f"want dt ({bt},{s},{h}), a and dd ({bt},{h}); got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(dd.shape)}")
    if x.dtype not in DTYPES or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise TypeError(f"want x, bm, cm all float32 or all bfloat16; got "
                        f"{x.dtype}, {bm.dtype}, {cm.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 \
            or dd.dtype != torch.float32:
        raise TypeError(f"want dt, a, dd float32; got {dt.dtype}, {a.dtype}, "
                        f"{dd.dtype}")
    if g < 1 or h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if not 1 <= n <= MAX_N or p % P_TILE:
        raise ValueError(f"want N <= {MAX_N} and P a multiple of {P_TILE}; "
                         f"got N={n}, P={p}")
    if not (x.is_contiguous() and dt.is_contiguous() and a.is_contiguous()
            and dd.is_contiguous()):
        raise ValueError("x, dt, a and dd must be contiguous")
    # the kernel reads both at bm's (batch, token) strides, each token's
    # (G, N) block contiguous; a stride of a size-1 axis is never used
    inner = ((g == 1 or bm.stride(2) == n) and (n == 1 or bm.stride(3) == 1))
    same = all(sz == 1 or sb == sc for sz, sb, sc
               in zip(bm.shape, bm.stride(), cm.stride()))
    if not (inner and same):
        raise ValueError(f"bm/cm need a contiguous (G, N) block and equal "
                         f"strides; got {bm.stride()}, {cm.stride()}")
    if len({t.device for t in (x, dt, a, bm, cm, dd)}) != 1:
        raise ValueError("ssd_scan inputs on different devices")
    if bt > 65535 or h > 65535:
        raise ValueError(f"grid too large: Bt={bt}, H={h}")
    if x.dtype == torch.bfloat16 and (p not in TC_P or n % 16
                                      or n > TC_MAX_N):
        raise ValueError(f"bf16 wants P in {TC_P} and N a multiple of 16 up "
                         f"to {TC_MAX_N}; got P={p}, N={n}")


def scratch_shapes(bt, s, h, p, g, n, chunk) -> tuple:
    """The bf16 kernels' fp32 scratch: C.B^T per (row, chunk, group) over
    the chunk rounded up to 64 rows; each chunk's own state; each chunk's
    cumsum of dt * a and dt, MAX_CHUNK rows each."""
    nc = -(-s // chunk)
    qp = -(-chunk // TILE) * TILE
    return ((bt, nc, g, qp, qp), (bt, h, nc, p, n),
            (bt, h, nc, 2, MAX_CHUNK))


def _lib():
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_fwd
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int] + [
            ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    return lib


def ssd_scan(x, dt, a, bm, cm, dd, *, chunk: int):
    """The SSD chunked scan over every (batch row, head) stream."""
    check_args(x, dt, a, bm, cm, dd, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, bm, cm, dd, chunk=chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no ssd_scan kernel for device {x.device}")
    launch = _ssd_meta if x.is_meta else _ssd_launch
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, bm, cm, dd)):
        return _SSDScan.apply(launch, chunk, x, dt, a, bm, cm, dd)
    return launch(x, dt, a, bm, cm, dd, chunk=chunk)


def ssd_flops(bt: int, s: int, h: int, p: int, g: int, n: int,
              chunk: int) -> float:
    """The scan's product work over whole chunks, 2 a multiply-add: C.B^T
    per (row, group, chunk), and per (row, head, chunk) the masked
    scores times x, the chunk's own state and the passed state's
    output."""
    nc = -(-s // chunk)
    q = chunk
    return 2.0 * bt * nc * (g * q * q * n + h * (q * q * p + 2 * q * p * n))


def _ssd_meta(x, dt, a, bm, cm, dd, *, chunk: int):
    """The meta branch: the kernel's outputs, empty, and its work."""
    bt, s, h, p = x.shape
    g, n = bm.shape[2:]
    y = torch.empty_like(x)
    state = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    return META.launch("ssd_scan", (y, state),
                       flops=ssd_flops(bt, s, h, p, g, n, chunk),
                       nbytes=META.nbytes(x, dt, a, bm, cm, dd, y, state))


class _SSDScan(torch.autograd.Function):
    """forward: `launch(x, dt, a, bm, cm, dd, chunk=)` (the kernel on the
    card; a test may pass the plain version); backward: the VJP of
    `ssd_scan_plain` at the saved inputs.  The final state's cotangent
    may be None (training reads only y)."""

    @staticmethod
    def forward(ctx, launch, chunk, x, dt, a, bm, cm, dd):
        ctx.save_for_backward(x, dt, a, bm, cm, dd)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        y, state = launch(x, dt, a, bm, cm, dd, chunk=chunk)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            y, state = ssd_scan_plain(*ins, chunk=ctx.chunk)
            outs, cts = [], []
            for o, c in ((y, dy), (state, dstate)):
                if c is not None:
                    outs.append(o)
                    cts.append(c)
            want = [t for t in ins if t.requires_grad]
            gs = iter(torch.autograd.grad(outs, want, cts, allow_unused=True)
                      if outs else [None] * len(want))
        return (None, None) + tuple(next(gs) if t.requires_grad else None
                                    for t in ins)


def _ssd_launch(x, dt, a, bm, cm, dd, *, chunk: int):
    bt, s, h, p = x.shape
    g, n = bm.shape[2:]
    bf16 = x.dtype == torch.bfloat16
    scratch = []
    if bf16:
        # 16-byte copies of B/C rows: every stride used must keep them so
        check_aligned(x, bm, cm, strides=[(bm, bm.stride(d)) for d in (0, 1)
                                          if bm.shape[d] > 1])
        scratch = [torch.empty(sh, dtype=torch.float32, device=x.device)
                   for sh in scratch_shapes(bt, s, h, p, g, n, chunk)]
    lib = _lib()
    y = torch.empty_like(x)
    state = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), dd.data_ptr(), y.data_ptr(), state.data_ptr(), bt,
            s, h, p, g, n, chunk, bm.stride(0), bm.stride(1), int(bf16),
            *([t.data_ptr() for t in scratch] or [None] * 3), stream)
    build.check(lib, rc, "ssd_scan_fwd")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
