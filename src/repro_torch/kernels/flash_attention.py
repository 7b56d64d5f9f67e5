"""Causal GQA flash attention: the CUDA kernel's wrapper and its plain
version (port of repro/kernels/flash_attention.py::flash_attention_bhsd,
the TPU kernel, and repro/kernels/ref.py::flash_attention_ref, its
oracle).

`flash_attention_bhsd` launches `csrc/flash_attention.cu` for a CUDA
tensor and takes `flash_attention_plain` only for a CPU tensor.  The
kernel source notes what bounds it on the card and how its design
answers that.  `flash_attention_bhsd.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, sm_scale=None):
    """q (BH,S,D), k/v (BHkv,S,D) heads-major GQA packing; causal."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    g = bh // k.shape[0]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
    s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def check_args(q, k, v) -> int:
    """Validate what the kernel takes; returns the GQA group size."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q (BH,S,D), k/v (BHkv,S,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"want float32 or bfloat16 q/k/v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    bh, s, d = q.shape
    if k.shape[1] != s or k.shape[2] != d:
        raise ValueError(f"q and k/v differ in S or D: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} (the model only needs Sq == Sk)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if k.shape[0] == 0 or bh % k.shape[0]:
        raise ValueError(f"BH={bh} is not a multiple of BHkv={k.shape[0]}")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the grid's y limit")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v on different devices")
    return bh // k.shape[0]


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_bhsd(q, k, v, *, sm_scale=None):
    """Causal flash attention; q row b reads kv row b // group.  Output in
    q's dtype."""
    group = check_args(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    bh, s, d = q.shape
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            group, s, d, scale, int(q.dtype == torch.bfloat16), stream)
    build.check(lib, rc, "flash_attention_fwd")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
