"""Layout plumbing around the kernels (port of repro/kernels/ops.py)."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as FA


def flash_attention(q, k, v, *, sm_scale=None):
    """q (B,S,Hq,D); k/v (B,S,Hkv,D) -> (B,S,Hq,D), causal.

    Packs to heads-major (B*H, S, D) so the kernel's GQA map (kv row =
    q row // group) holds: q row b*Hq + h reads kv row (b*Hq + h) // g =
    b*Hkv + h // g only because Hq = g * Hkv.  Under the shard-stacked
    layout the shard axis is folded into B, so the same holds per shard
    with the shard-local head counts.  No padding: the kernel masks the
    ragged S edge itself."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}: "
                         "the row // group mapping would cross sequences")
    qp = q.transpose(1, 2).reshape(b * hq, s, d).contiguous()
    kp = k.transpose(1, 2).reshape(b * hkv, k.shape[1], d).contiguous()
    vp = v.transpose(1, 2).reshape(b * hkv, v.shape[1], d).contiguous()
    out = FA.flash_attention_bhsd(qp, kp, vp, sm_scale=sm_scale)
    return out.reshape(b, hq, s, d).transpose(1, 2)
