"""Shared model components: norms, activations, RoPE (port of
repro/models/common.py)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(x, w, eps: float):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def layernorm(x, w, b, eps: float):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * w + b


def norm_apply(x, p, cfg):
    """Dispatch on cfg.norm; p is {"w": ...} or {"w": ..., "b": ...}."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def _gelu_tanh(x):
    """GELU in its tanh form, the reference's `jax.nn.gelu` (whose
    default is approximate=True); F.gelu's default is the erf form."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def rope_freqs(d_rot: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_rot, 2, dtype=np.float32) / d_rot))


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x (..., S, H, Dh); positions (..., S) integer.  Rotates the first
    `fraction` of Dh, rotate-half convention."""
    dh = x.shape[-1]
    d_rot = int(dh * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    inv = torch.from_numpy(rope_freqs(d_rot, theta)).to(x.device)
    ang = positions[..., None].float() * inv        # (..., S, d_rot/2)
    cos = torch.cos(ang)[..., None, :]              # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2, xp], dim=-1).to(x.dtype)
