"""Fused residual add + RMSNorm: the CUDA kernel's wrapper and its plain
version (port of repro/kernels/fused_norm.py::fused_residual_rmsnorm, the
TPU kernel, and repro/kernels/ref.py::fused_residual_rmsnorm_ref, its
oracle).

Returns (rmsnorm(x + r) * w, x + r) in x's dtype, with fp32 math, from
one pass: the sum never makes a round trip through device memory.
`fused_residual_rmsnorm` launches `csrc/fused_norm.cu` for a CUDA tensor
and takes `fused_residual_rmsnorm_plain` only for a CPU tensor (a meta
tensor takes the meta branch of kernels/meta.py);
`.launches` counts kernel launches.  The model does not call it (nor
does the reference's): `kernels.ops.fused_residual_rmsnorm` is the
public op.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import meta as META

DTYPES = (torch.float32, torch.bfloat16)


def fused_residual_rmsnorm_plain(x, r, w, *, eps: float = 1e-5):
    """x, r (T, d); w (d,) -> (rmsnorm(x+r)*w, x+r) in x's dtype."""
    s = x.float() + r.float()
    var = (s * s).mean(dim=-1, keepdim=True)
    y = s * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype), s.to(x.dtype)


def check_args(x, r, w) -> None:
    if x.dim() != 2 or tuple(r.shape) != tuple(x.shape):
        raise ValueError(f"want x, r (T, d) of one shape; got "
                         f"{tuple(x.shape)} and {tuple(r.shape)}")
    if tuple(w.shape) != (x.shape[1],):
        raise ValueError(f"want w ({x.shape[1]},); got {tuple(w.shape)}")
    if x.dtype not in DTYPES or r.dtype != x.dtype:
        raise TypeError(f"want x, r both float32 or both bfloat16; got "
                        f"{x.dtype}, {r.dtype}")
    if w.dtype not in DTYPES:
        raise TypeError(f"want w float32 or bfloat16; got {w.dtype}")
    if not (x.is_contiguous() and r.is_contiguous() and w.is_contiguous()):
        raise ValueError("x, r and w must be contiguous")
    if r.device != x.device or w.device != x.device:
        raise ValueError("x, r and w on different devices")
    if x.numel() >= 2 ** 31:
        raise ValueError("x too large for the kernel's int indexing")


def _lib():
    lib = build.load("fused_norm")
    fn = lib.fused_residual_rmsnorm_fwd
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_residual_rmsnorm(x, r, w, *, eps: float = 1e-5):
    """x, r (T, d); w (d,) -> (rmsnorm(x+r)*w, x+r) in x's dtype."""
    check_args(x, r, w)
    if x.device.type == "cpu":
        return fused_residual_rmsnorm_plain(x, r, w, eps=eps)
    if x.device.type == "meta":
        return META.launch("fused_residual_rmsnorm",
                           (torch.empty_like(x), torch.empty_like(x)),
                           nbytes=META.nbytes(x, r, w, x, x))
    if x.device.type != "cuda":
        raise ValueError(f"no fused-norm kernel for device {x.device}")
    build.refuse_grad("fused_residual_rmsnorm", x, r, w)
    lib = _lib()
    y, s = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_residual_rmsnorm_fwd(
            x.data_ptr(), r.data_ptr(), w.data_ptr(), y.data_ptr(),
            s.data_ptr(), x.shape[0], x.shape[1], float(eps),
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            stream)
    build.check(lib, rc, "fused_residual_rmsnorm_fwd")
    fused_residual_rmsnorm.launches += 1
    return y, s


fused_residual_rmsnorm.launches = 0
