"""Per-chunk absmax quantize-dequantize: the CUDA kernel's wrapper and
its plain version (port of repro/kernels/quant_collectives.py::
qdq_absmax, the TPU kernel, and repro/kernels/ref.py::qdq_absmax_ref,
its oracle).

The input is a (rows, n) fp32 matrix whose rows are chunked
independently from element 0: each row is one TP shard's flattened
payload, which the reference quantizes per shard under `vmap`.
`qdq_absmax` launches `csrc/quant_collectives.cu` for a CUDA tensor and
takes `qdq_absmax_plain` only for a CPU tensor; the two agree bit for
bit.  `qdq_absmax.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

CHUNK = 128          # the kernel's fixed chunk (one warp, 4 per lane)
LEVELS = (7, 127)    # quant4, quant8


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


def check_args(x, levels: int, chunk: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"want x (rows, n); got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"want float32 x; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if levels not in LEVELS:
        raise ValueError(f"levels {levels} not in {LEVELS}")
    if chunk != CHUNK:
        raise ValueError(f"the kernel's chunk is {CHUNK}, got {chunk}")
    if x.numel() >= 2 ** 31:
        raise ValueError("x too large for the kernel's int indexing")


def _lib():
    lib = build.load("quant_collectives")
    fn = lib.qdq_absmax_fwd
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def qdq_absmax(x, *, levels: int, chunk: int = CHUNK):
    """x (rows, n) fp32 -> fp32 (rows, n), chunks restarting at each row."""
    check_args(x, levels, chunk)
    if x.device.type == "cpu":
        return qdq_absmax_plain(x, levels=levels, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no qdq kernel for device {x.device}")
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.qdq_absmax_fwd(x.data_ptr(), out.data_ptr(), x.shape[0],
                                x.shape[1], levels, stream)
    build.check(lib, rc, "qdq_absmax_fwd")
    qdq_absmax.launches += 1
    return out


qdq_absmax.launches = 0
