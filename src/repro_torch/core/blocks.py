"""Decoder-block math for TP and SPD execution — the paper's §4.1
(port of repro/core/blocks.py: GQA blocks with an MLP or a routed MoE
FFN, full-causal or sliding-window, the MLA block (DeepSeek-V2's latent
attention), the pure-SSM Mamba2 block, and the hybrid (Hymba) block
whose mixer runs attention and SSM heads side by side; int8 KV caches
and weight-only int8 leaves).

Every activation is SHARD-STACKED: x (tp, B, S, d), dim 0 the TP shard.
Block inputs and outputs are replicated (all shards equal); inside an
SPD block the shards diverge.

Block wiring (Fig 3):

  TP block                       SPD block (no bias)
  h  = norm1(x)                  h   = norm1(x)
  y  = psum(attn(h))   <- SYNC   y_i = attn(h)            <- sync DROPPED
  u  = x + y                     u_i = x + y_i             (divergent)
  z  = psum(mlp(n2(u))) <- SYNC  s   = psum(mlp(n2(u_i)) + y_i)  <- SYNC
  out= u + z                     out = x + s

  With an out-proj bias b (Fig 3b): y_i = P_i + b feeds the MLP input;
  only P_i rides the deferred residual; b is re-added once after the
  sync: out = x + b + s, s = psum(Z_i + P_i).

  SSM block (single sync point, so SPD does not apply; `drop` is ignored):
  out = x + psum(ssm(norm1(x)))

  MoE FFN: every shard routes all its tokens and runs its own experts
  (the expert axis is split over the shards); the routed and shared
  experts' partials ride the FFN's sync, so the combine adds no sync.
  In a dropped block each shard routes its own divergent input.  Its
  load-balance aux is `block_seq`'s third output, for the training loss
  (moe_partial says how its gradient counts once).

  MLA: the heads are split over the shards, but the latent `c` and the
  rope key `kr` come from replicated weights (`wdkv`, `lnorm`) and are
  cached replicated; in a dropped block every shard attends over the same
  latent with its own divergent residual.

Parameters are canonical (unpadded); `pad_layer` produces the TP-layout
tensors whose split axes `layer_specs` gives.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core.layer_kinds import LayerKind
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.common import act_fn, apply_rope, norm_apply, rmsnorm
from repro_torch.parallel.collectives import (column_entry, shard_ids,
                                              shared_param, sync_output)
from repro_torch.parallel.layout import (REPLICATED, kv_head_orig,
                                         make_gqa_layout, pad_heads,
                                         q_head_orig)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def _bcast(w, x):
    """A per-shard vector (tp, n) shaped to broadcast over x (tp, ..., n)."""
    return w.reshape((w.shape[0],) + (1,) * (x.dim() - 2) + (w.shape[-1],))


def _norm(x, p, cfg):
    """norm1/norm2/lnf on a shard-stacked x with per-shard (tp, d) leaves
    (LayerNorm's bias `b` beside the weight)."""
    return norm_apply(x, {k: _bcast(v, x) for k, v in p.items()}, cfg)


def headwise_rmsnorm(x, w, eps, dh: int):
    """RMSNorm over each dh-wide head of a head-packed channel axis
    (TP-invariant, unlike a shard-local norm over d_local): x (tp, ...,
    H*dh), w (tp, H*dh)."""
    heads = (x.shape[-1] // dh, dh)
    wb = _bcast(w, x)
    xs = x.reshape(tuple(x.shape[:-1]) + heads)
    ws = wb.reshape(tuple(wb.shape[:-1]) + heads)
    return rmsnorm(xs, ws, eps).reshape(x.shape)


def ssm_heads(cfg: ModelConfig) -> int:
    """SSM heads: a hybrid layer's mirror its attention heads; a pure-SSM
    layer has expand * d_model / head_dim."""
    if cfg.family == "hybrid":
        return cfg.n_heads
    s = cfg.ssm
    return s.expand * cfg.d_model // s.head_dim


def _mm(h, w):
    """Per-shard matmul: h (tp, ..., din) @ w (tp, din, dout).  A
    weight-only int8 leaf {"q" (tp, din, dout) int8, "s" (tp, dout)} is
    (h @ q) * s in h's dtype, as the reference's: the per-output-column
    scales commute with the contraction."""
    tp, din = h.shape[0], h.shape[-1]
    if isinstance(w, dict):
        out = torch.bmm(h.reshape(tp, -1, din), w["q"].to(h.dtype))
        out = out * w["s"].to(h.dtype)[:, None, :]
    else:
        out = torch.bmm(h.reshape(tp, -1, din), w)
    return out.reshape(tuple(h.shape[:-1]) + (out.shape[-1],))


# weight-only int8: the leaves quantized after padding, by group
QUANT_LEAVES = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("wu", "wg", "wd")}


def quantize_leaf(w):
    """(in, out) -> {"q" int8 (in, out), "s" (out,) bf16}: per-column
    absmax, 127 dividing as a tensor (see models.attention.kv_quantize)."""
    w32 = w.float()
    lv = torch.full((), 127.0, dtype=torch.float32, device=w.device)
    s = torch.clamp(w32.abs().amax(0), min=1e-12) / lv
    q = torch.clamp(torch.round(w32 / s[None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.bfloat16)}


def check_weight_dtype(cfg: ModelConfig, kind: LayerKind) -> None:
    """Weight-only int8 covers GQA and SSM layers.  The reference cannot
    place an MLA layer's (`mla_specs` has no int8 leaves) nor run a
    hybrid one's (its mixer multiplies `wo` directly): ROADMAP C8."""
    if cfg.weight_dtype == "int8" and kind.mixer in ("mla", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: weight_dtype='int8' on a {kind.mixer} layer fails "
            "in the reference itself (ROADMAP C8)")


def quantize_layer_weights(padded_layer: dict, cfg: ModelConfig,
                           kind: LayerKind) -> dict:
    """Post-padding weight-only int8 for the serve path (a no-op unless
    cfg.weight_dtype == "int8"): the QUANT_LEAVES become {"q", "s"}."""
    if cfg.weight_dtype != "int8":
        return padded_layer
    check_weight_dtype(cfg, kind)
    out = dict(padded_layer)
    for grp, names in QUANT_LEAVES.items():
        if grp in out:
            out[grp] = {k: quantize_leaf(v) if k in names else v
                        for k, v in out[grp].items()}
    return out


def _qleaf_spec(axis):
    """Split axes of a quantized (in, out) leaf split on `axis`: the
    scales follow the out axis."""
    return {"q": axis, "s": 0 if axis == 1 else REPLICATED}


def _qkv(cfg, a, h, lay):
    """h (tp,B,S,d) -> q (tp,B,S,HqL,dh), k/v (tp,B,S,HkvL,dh)."""
    dh = cfg.d_head
    q, k, v = _mm(h, a["wq"]), _mm(h, a["wk"]), _mm(h, a["wv"])
    if cfg.qkv_bias:
        q = q + _bcast(a["bq"], q)
        k = k + _bcast(a["bk"], k)
        v = v + _bcast(a["bv"], v)
    lead = tuple(h.shape[:3])
    q = q.reshape(lead + (lay.q_local, dh))
    k = k.reshape(lead + (lay.kv_local, dh))
    v = v.reshape(lead + (lay.kv_local, dh))
    if cfg.qk_norm:               # per head, before RoPE
        q = rmsnorm(q, _bcast(shared_param(a["qn"]), q), cfg.norm_eps)
        k = rmsnorm(k, _bcast(shared_param(a["kn"]), k), cfg.norm_eps)
    return q, k, v


def _pack_kv(cfg, kc, vc):
    """A prefill's K/V as cache leaves: {"k","v"}, or on an int8 KV cache
    the codes and their per-(position, head) scales {"k","k_s","v","v_s"}."""
    if cfg.kv_dtype != "int8":
        return {"k": kc, "v": vc}
    kq, ks = A.kv_quantize(kc)
    vq, vs = A.kv_quantize(vc)
    return {"k": kq, "k_s": ks, "v": vq, "v_s": vs}


def _unpack_kv(cfg, cache, dtype):
    """The cache's K/V in `dtype` (an int8 cache dequantized in fp32)."""
    if cfg.kv_dtype != "int8":
        return cache["k"], cache["v"]
    return (A.kv_dequantize(cache["k"], cache["k_s"], dtype),
            A.kv_dequantize(cache["v"], cache["v_s"], dtype))


def _update_kv(cfg, cache, k_new, v_new, pos, window: int = 0):
    """Write one decode token into the cache (slot pos % window on a
    windowed layer), in place; quantized on an int8 cache."""
    if cfg.kv_dtype != "int8":
        A.cache_update(cache["k"], cache["v"], k_new, v_new, pos,
                       window=window)
        return cache
    slot = pos % window if window > 0 else pos
    bi = torch.arange(pos.shape[0], device=pos.device)
    for name, new in (("k", k_new), ("v", v_new)):
        q, sc = A.kv_quantize(new.select(-3, 0))
        cache[name][..., bi, slot, :, :] = q
        cache[name + "_s"][..., bi, slot, :] = sc
    return cache


def _rolling(kv, window: int):
    """A prefill's K or V (tp,B,S,H,D) as a windowed layer's decode
    cache: with S >= window, slot p % window holds position p of the
    last `window`; a shorter prompt keeps its S slots."""
    s = kv.shape[2]
    if not window or s < window:
        return kv
    slots = torch.arange(s - window, s, device=kv.device) % window
    out = torch.zeros_like(kv[:, :, :window])
    out[:, :, slots] = kv[:, :, -window:]
    return out


# ---------------------------------------------------------------------------
# Parameter initialization (canonical, unpadded) + TP-layout specs
# ---------------------------------------------------------------------------

def _dense(gen, d_in, d_out, cfg, device, scale=None):
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * s).to(torch_dtype(cfg))


def _norm_init(cfg, d, device):
    p = {"w": torch.ones((d,), dtype=torch_dtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((d,), dtype=torch_dtype(cfg), device=device)
    return p


def _norm_spec(cfg):
    return dict.fromkeys(("w", "b") if cfg.norm == "layernorm" else ("w",),
                         REPLICATED)


def init_attn(gen, cfg: ModelConfig, device) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    zeros = lambda n: torch.zeros((n,), dtype=torch_dtype(cfg),  # noqa: E731
                                  device=device)
    p = {"wq": _dense(gen, d, hq * dh, cfg, device),
         "wk": _dense(gen, d, hkv * dh, cfg, device),
         "wv": _dense(gen, d, hkv * dh, cfg, device),
         "wo": _dense(gen, hq * dh, d, cfg, device,
                      scale=1.0 / np.sqrt(hq * dh) / np.sqrt(2 * cfg.n_layers))}
    if cfg.qkv_bias:
        p.update(bq=zeros(hq * dh), bk=zeros(hkv * dh), bv=zeros(hkv * dh))
    if cfg.o_bias:
        p["bo"] = zeros(d)
    if cfg.qk_norm:
        p["qn"] = torch.ones((dh,), dtype=torch_dtype(cfg), device=device)
        p["kn"] = torch.ones((dh,), dtype=torch_dtype(cfg), device=device)
    return p


def attn_specs(cfg: ModelConfig) -> dict:
    if cfg.weight_dtype == "int8":
        p = {"wq": _qleaf_spec(1), "wk": _qleaf_spec(1),
             "wv": _qleaf_spec(1), "wo": _qleaf_spec(0)}
    else:
        p = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    if cfg.qkv_bias:
        p.update({"bq": 0, "bk": 0, "bv": 0})
    if cfg.o_bias:
        p["bo"] = REPLICATED
    if cfg.qk_norm:
        p.update({"qn": REPLICATED, "kn": REPLICATED})
    return p


def init_mla(gen, cfg: ModelConfig, device) -> dict:
    """MLA without a q low-rank (q_lora_rank 0, as the reference's): q
    from `wq`, the latent and the rope key from `wdkv`, the latent's
    RMSNorm `lnorm`, its up projections `wuk` / `wuv`, and `wo`."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qd = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    return {"wq": _dense(gen, d, qd, cfg, device),
            "wdkv": _dense(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, cfg,
                           device),
            "lnorm": torch.ones((m.kv_lora_rank,), dtype=torch_dtype(cfg),
                                device=device),
            "wuk": _dense(gen, m.kv_lora_rank, h * m.qk_nope_head_dim, cfg,
                          device),
            "wuv": _dense(gen, m.kv_lora_rank, h * m.v_head_dim, cfg, device),
            "wo": _dense(gen, h * m.v_head_dim, d, cfg, device,
                         scale=1.0 / np.sqrt(h * m.v_head_dim)
                         / np.sqrt(2 * cfg.n_layers))}


def mla_specs(cfg: ModelConfig) -> dict:
    """Heads split; the latent projection and its norm replicated."""
    return {"wq": 1, "wdkv": REPLICATED, "lnorm": REPLICATED,
            "wuk": 1, "wuv": 1, "wo": 0}


def init_ssm(gen, cfg: ModelConfig, device) -> dict:
    """The reference's distributions: dt bias log-uniform in [1e-3, 1e-1]
    through the inverse softplus, A = -(1..16), unit skip and gate norm,
    conv taps N(0, 1/d_conv), out projection scaled 1/sqrt(d_in)/sqrt(2L)."""
    s = cfg.ssm
    d = cfg.d_model
    h = ssm_heads(cfg)
    d_in = h * s.head_dim
    gn = s.n_groups * s.d_state
    dt = torch_dtype(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((h,), generator=gen, **f32)
    dt0 = torch.exp(np.log(1e-3) + u * (np.log(1e-1) - np.log(1e-3)))

    def conv(c):
        return (torch.randn((s.d_conv, c), generator=gen, **f32)
                / np.sqrt(s.d_conv)).to(dt)

    return {"wz": _dense(gen, d, d_in, cfg, device),
            "wx": _dense(gen, d, d_in, cfg, device),
            "wbc": _dense(gen, d, 2 * gn, cfg, device),
            "wdt": _dense(gen, d, h, cfg, device),
            "dtb": torch.log(torch.expm1(dt0)).to(dt),
            "alog": torch.log(torch.linspace(1.0, 16.0, h, **f32)).to(dt),
            "dd": torch.ones((h,), dtype=dt, device=device),
            "convx": conv(d_in),
            "convbc": conv(2 * gn),
            "gn": torch.ones((d_in,), dtype=dt, device=device),
            "wo": _dense(gen, d_in, d, cfg, device,
                         scale=1.0 / np.sqrt(d_in) / np.sqrt(2 * cfg.n_layers))}


def ssm_specs(cfg: ModelConfig) -> dict:
    """Heads split; the fused B/C projection and its conv are replicated
    (every shard's heads read the same groups)."""
    return {"wz": 1, "wx": 1, "wbc": REPLICATED, "wdt": 1, "dtb": 0,
            "alog": 0, "dd": 0, "convx": 1, "convbc": REPLICATED,
            "gn": 0, "wo": 0}


def init_mlp(gen, cfg: ModelConfig, d_ff: int, device) -> dict:
    d = cfg.d_model
    zeros = lambda n: torch.zeros((n,), dtype=torch_dtype(cfg),  # noqa: E731
                                  device=device)
    p = {"wu": _dense(gen, d, d_ff, cfg, device),
         "wd": _dense(gen, d_ff, d, cfg, device,
                      scale=1.0 / np.sqrt(d_ff) / np.sqrt(2 * cfg.n_layers))}
    if cfg.gated_mlp:
        p["wg"] = _dense(gen, d, d_ff, cfg, device)
    if cfg.mlp_bias:
        p.update(bu=zeros(d_ff), bd=zeros(d))
        if cfg.gated_mlp:
            p["bg"] = zeros(d_ff)
    return p


def mlp_specs(cfg: ModelConfig) -> dict:
    if cfg.weight_dtype == "int8":
        p = {"wu": _qleaf_spec(1), "wd": _qleaf_spec(0)}
        if cfg.gated_mlp:
            p["wg"] = _qleaf_spec(1)
    else:
        p = {"wu": 1, "wd": 0}
        if cfg.gated_mlp:
            p["wg"] = 1
    if cfg.mlp_bias:
        p.update({"bu": 0, "bd": REPLICATED})
        if cfg.gated_mlp:
            p["bg"] = 0
    return p


def init_moe(gen, cfg: ModelConfig, device) -> dict:
    """The reference's distributions: router N(0, 0.02^2), experts
    N(0, 1/d_in) (the down projections also / sqrt(2L)), the shared
    experts one MLP of n_shared * d_ff_expert."""
    mo, d = cfg.moe, cfg.d_model
    ff, e = mo.d_ff_expert, mo.n_routed
    down = 1.0 / np.sqrt(2 * cfg.n_layers)

    def experts(din, dout, scale):
        w = torch.randn((e, din, dout), generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(torch_dtype(cfg))

    p = {"router": _dense(gen, d, e, cfg, device, scale=0.02),
         "wu": experts(d, ff, 1.0 / np.sqrt(d)),
         "wd": experts(ff, d, down / np.sqrt(ff))}
    if cfg.gated_mlp:
        p["wg"] = experts(d, ff, 1.0 / np.sqrt(d))
    if mo.n_shared:
        sff = mo.n_shared * ff
        p["su"] = _dense(gen, d, sff, cfg, device)
        p["sd"] = _dense(gen, sff, d, cfg, device,
                         scale=down / np.sqrt(sff))
        if cfg.gated_mlp:
            p["sg"] = _dense(gen, d, sff, cfg, device)
    return p


def moe_specs(cfg: ModelConfig) -> dict:
    """Experts split on their own axis (expert parallelism over the TP
    shards); the router replicated; the shared experts split as an MLP."""
    p = {"router": REPLICATED, "wu": 0, "wd": 0}
    if cfg.gated_mlp:
        p["wg"] = 0
    if cfg.moe.n_shared:
        p.update({"su": 1, "sd": 0})
        if cfg.gated_mlp:
            p["sg"] = 1
    return p


def init_layer(gen, cfg: ModelConfig, kind: LayerKind, device) -> dict:
    p = {"ln1": _norm_init(cfg, cfg.d_model, device)}
    if kind.mixer in ("gqa", "hybrid"):
        p["attn"] = init_attn(gen, cfg, device)
    if kind.mixer == "mla":
        p["attn"] = init_mla(gen, cfg, device)
    if kind.mixer in ("ssm", "hybrid"):
        p["ssm"] = init_ssm(gen, cfg, device)
    if kind.mixer == "hybrid":
        hd = cfg.n_heads * cfg.d_head
        p["na"] = torch.ones((hd,), dtype=torch_dtype(cfg), device=device)
        p["ns"] = torch.ones((hd,), dtype=torch_dtype(cfg), device=device)
    if kind.ffn != "none":
        p["ln2"] = _norm_init(cfg, cfg.d_model, device)
        if kind.ffn == "moe":
            p["moe"] = init_moe(gen, cfg, device)
        else:
            p["mlp"] = init_mlp(gen, cfg, kind.d_ff or cfg.d_ff, device)
    return p


def layer_specs(cfg: ModelConfig, kind: LayerKind) -> dict:
    p = {"ln1": _norm_spec(cfg)}
    if kind.mixer in ("gqa", "hybrid"):
        p["attn"] = attn_specs(cfg)
    if kind.mixer == "mla":
        p["attn"] = mla_specs(cfg)
    if kind.mixer in ("ssm", "hybrid"):
        p["ssm"] = ssm_specs(cfg)
    if kind.mixer == "hybrid":
        p.update(na=0, ns=0)
    if kind.ffn != "none":
        p["ln2"] = _norm_spec(cfg)
        if kind.ffn == "moe":
            p["moe"] = moe_specs(cfg)
        else:
            p["mlp"] = mlp_specs(cfg)
    return p


def _pad_ssm(ss: dict, cfg: ModelConfig, hmap) -> dict:
    """Pad the SSM heads to the layout `hmap` (padded head -> source
    head, or -1).  A zero head reads zero inputs (zero `wx`, `wz`, `wdt`
    columns) and its output meets zero rows (`wo`; a hybrid layer's
    `ns` and the attention's `wo`), so it adds nothing."""
    h = ssm_heads(cfg)
    hd = cfg.ssm.head_dim
    ss = dict(ss)
    for nm in ("wz", "wx", "convx"):
        ss[nm] = pad_heads(ss[nm], 1, hmap, hd, h)
    ss["wdt"] = pad_heads(ss["wdt"], 1, hmap, 1, h)
    for nm in ("dtb", "alog", "dd"):
        ss[nm] = pad_heads(ss[nm], 0, hmap, 1, h)
    for nm in ("gn", "wo"):
        ss[nm] = pad_heads(ss[nm], 0, hmap, hd, h)
    return ss


def pad_layer(p: dict, cfg: ModelConfig, kind: LayerKind, tp: int) -> dict:
    """Pad canonical layer params so every split axis divides by tp: GQA
    heads by the head layout, a hybrid layer's SSM heads (and its `na` /
    `ns`) by the attention's q-head layout, a pure-SSM layer's SSM heads
    and the MLP width to a multiple of tp, the experts to a multiple of
    tp (their router columns zero; `MOE.route` masks them to -inf).  MLA
    heads are not padded, as in the reference: they must divide by tp."""
    out = dict(p)
    if kind.mixer == "mla" and cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: MLA's {cfg.n_heads} heads do not "
                         f"divide by tp={tp} (the reference pads no MLA "
                         "head)")
    if kind.mixer == "ssm":
        h = ssm_heads(cfg)
        hp = -(-h // tp) * tp
        hmap = np.concatenate([np.arange(h), -np.ones(hp - h, np.int64)])
        out["ssm"] = _pad_ssm(p["ssm"], cfg, hmap)
    if kind.mixer in ("gqa", "hybrid"):
        out["attn"] = _pad_attn(p["attn"], cfg, tp)
    if kind.mixer == "hybrid":
        hmap = q_head_orig(make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp))
        out["ssm"] = _pad_ssm(p["ssm"], cfg, hmap)
        for nm in ("na", "ns"):
            out[nm] = pad_heads(p[nm], 0, hmap, cfg.ssm.head_dim,
                                cfg.n_heads)
    if kind.ffn == "mlp":
        out["mlp"] = _pad_mlp(p["mlp"], tp)
    if kind.ffn == "moe":
        out["moe"] = _pad_moe(p["moe"], cfg, tp)
    return out


def _pad_attn(a: dict, cfg: ModelConfig, tp: int) -> dict:
    dh = cfg.d_head
    lay = make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
    qmap, kvmap = q_head_orig(lay), kv_head_orig(lay)
    a = dict(a)
    a["wq"] = pad_heads(a["wq"], 1, qmap, dh, cfg.n_heads)
    a["wo"] = pad_heads(a["wo"], 0, qmap, dh, cfg.n_heads)
    for nm in ("wk", "wv"):
        a[nm] = pad_heads(a[nm], 1, kvmap, dh, cfg.n_kv_heads)
    if cfg.qkv_bias:
        a["bq"] = pad_heads(a["bq"], 0, qmap, dh, cfg.n_heads)
        a["bk"] = pad_heads(a["bk"], 0, kvmap, dh, cfg.n_kv_heads)
        a["bv"] = pad_heads(a["bv"], 0, kvmap, dh, cfg.n_kv_heads)
    return a


def _pad_mlp(m: dict, tp: int) -> dict:
    m = dict(m)
    ff = m["wu"].shape[1]
    ffp = -(-ff // tp) * tp
    if ffp != ff:
        padm = np.concatenate([np.arange(ff), -np.ones(ffp - ff, np.int64)])
        for nm in ("wu", "wg", "bu", "bg"):
            if nm in m:
                m[nm] = pad_heads(m[nm], 1 if nm[0] == "w" else 0, padm, 1, ff)
        m["wd"] = pad_heads(m["wd"], 0, padm, 1, ff)
    return m


def _pad_moe(m: dict, cfg: ModelConfig, tp: int) -> dict:
    m = dict(m)
    e = cfg.moe.n_routed
    ep = -(-e // tp) * tp
    if ep != e:
        emap = np.concatenate([np.arange(e), -np.ones(ep - e, np.int64)])
        for nm in ("wu", "wg", "wd"):
            if nm in m:
                m[nm] = pad_heads(m[nm], 0, emap, 1, e)
        m["router"] = pad_heads(m["router"], 1, emap, 1, e)
    return m


# ---------------------------------------------------------------------------
# Mixers (shard-local partial output, NO sync applied here)
# ---------------------------------------------------------------------------

def gqa_mixer_seq(cfg, kind, a, h, pos, lay, *, want_cache=False,
                  q_chunk=1024):
    """Sequence (prefill) attention: h (tp,B,S,d), pos (B,S) -> (partial
    (tp,B,S,d), cache {"k","v"} (tp,B,S,HkvL,dh) or None; a windowed
    layer's cache is its rolling buffer of min(S, window) slots)."""
    q, k, v = _qkv(cfg, a, h, lay)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    tp, b, s = h.shape[:3]
    if cfg.attn_backend == "pallas" and kind.window == 0:
        # the hand-written flash kernel; the shard axis folds into batch
        from repro_torch.kernels import ops as KOPS
        o = KOPS.flash_attention(q.reshape((tp * b,) + q.shape[2:]),
                                 k.reshape((tp * b,) + k.shape[2:]),
                                 v.reshape((tp * b,) + v.shape[2:]))
    else:
        o = A.attention_any(q, k, v, pos, pos, window=kind.window,
                            q_chunk=q_chunk)
    part = _mm(o.reshape(tp, b, s, -1), a["wo"])
    if not want_cache:
        return part, None
    return part, _pack_kv(cfg, _rolling(k, kind.window),
                          _rolling(v, kind.window))


def gqa_mixer_dec(cfg, kind, a, h, pos, cache, lay):
    """Decode attention: h (tp,B,1,d), pos (B,); cache {"k","v"}
    (tp,B,S,HkvL,dh), updated in place."""
    o = _attn_dec(cfg, kind, a, h, pos, cache, lay)
    return _mm(o, a["wo"]), cache


def _attn_dec(cfg, kind, a, h, pos, cache, lay):
    """One decode token's attention output (tp,B,1,HqL*dh) before `wo`;
    its K/V written into `cache` in place (slot pos % window on a
    windowed layer; quantized on an int8 cache, which the attention reads
    dequantized)."""
    q, k, v = _qkv(cfg, a, h, lay)
    q = apply_rope(q, pos[:, None], cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos[:, None], cfg.rope_theta, cfg.rope_fraction)
    _update_kv(cfg, cache, k, v, pos, kind.window)
    kc, vc = _unpack_kv(cfg, cache, h.dtype)
    o = A.decode_attend(q, kc, vc, pos, window=kind.window)
    return o.reshape(tuple(h.shape[:3]) + (-1,))


def _mla_qkr(cfg, a, h, pos):
    """h (tp,B,S,d) -> q_nope (tp,B,S,HL,nope), q_rope (tp,B,S,HL,rope)
    rotated, the latent c (tp,B,S,lora) normed, the rope key kr
    (tp,B,S,rope) rotated (one for all heads), and HL.  c and kr come
    from the replicated `wdkv` / `lnorm` (shared_param: their gradients
    sum over the shards)."""
    m = cfg.mla
    tp, b, s = h.shape[:3]
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    hl = a["wq"].shape[-1] // dq
    q = _mm(h, a["wq"]).reshape(tp, b, s, hl, dq)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    ckr = _mm(h, shared_param(a["wdkv"]))
    c, kr = ckr[..., :m.kv_lora_rank], ckr[..., m.kv_lora_rank:]
    c = rmsnorm(c, _bcast(shared_param(a["lnorm"]), c), cfg.norm_eps)
    kr = apply_rope(kr[..., None, :], pos, cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, c, kr, hl


def mla_mixer_seq(cfg, kind, a, h, pos, *, want_cache=False, q_chunk=1024):
    """Sequence (prefill) MLA: keys and values expanded from the latent,
    the rope key shared by every head, the plain attention over q / k of
    nope + rope and v of v_head_dim at scale (nope + rope)^-1/2 (the
    reference's takes no kernel here).  h (tp,B,S,d) -> (partial
    (tp,B,S,d), cache {"c" (tp,B,S,lora), "kr" (tp,B,S,rope)} or None)."""
    m = cfg.mla
    tp, b, s = h.shape[:3]
    q_nope, q_rope, c, kr, hl = _mla_qkr(cfg, a, h, pos)
    k_nope = _mm(c, a["wuk"]).reshape(tp, b, s, hl, m.qk_nope_head_dim)
    v = _mm(c, a["wuv"]).reshape(tp, b, s, hl, m.v_head_dim)
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, kr[..., None, :].expand(
        tp, b, s, hl, m.qk_rope_head_dim)], -1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    o = A.attention_any(q_full, k_full, v, pos, pos, q_chunk=q_chunk,
                        scale=scale)
    part = _mm(o.reshape(tp, b, s, -1), a["wo"])
    return part, ({"c": c, "kr": kr} if want_cache else None)


def mla_mixer_dec(cfg, kind, a, h, pos, cache):
    """Absorbed-form MLA decode in fp32: q_nope folds through `wuk` into
    the latent space, so the scores read the cached latent and rope key
    directly and the output unfolds through `wuv` after the softmax.  h
    (tp,B,1,d), pos (B,); cache {"c","kr"} written at pos in place."""
    m = cfg.mla
    tp, b = h.shape[:2]
    q_nope, q_rope, c_new, kr_new, hl = _mla_qkr(cfg, a, h, pos[:, None])
    bi = torch.arange(b, device=h.device)
    cache["c"][:, bi, pos] = c_new[:, :, 0]
    cache["kr"][:, bi, pos] = kr_new[:, :, 0]
    c, kr = cache["c"].float(), cache["kr"].float()
    wuk = a["wuk"].reshape(tp, m.kv_lora_rank, hl, m.qk_nope_head_dim)
    q_lat = torch.einsum("tbshn,tlhn->tbshl", q_nope.float(), wuk.float())
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("tbshl,tbkl->tbhsk", q_lat, c)
              + torch.einsum("tbshr,tbkr->tbhsk", q_rope.float(), kr)) * scale
    valid = (torch.arange(c.shape[2], device=h.device)[None]
             <= pos[:, None])[:, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, A.NEG_INF))
    o_lat = torch.einsum("tbhsk,tbkl->tbshl", torch.softmax(scores, -1), c)
    wuv = a["wuv"].reshape(tp, m.kv_lora_rank, hl, m.v_head_dim)
    o = torch.einsum("tbshl,tlhv->tbshv", o_lat, wuv.float())
    return _mm(o.reshape(tp, b, 1, -1).to(h.dtype), a["wo"]), cache


def _ssm_in(cfg, ss, h, conv_state=None):
    """The SSM input path: h (tp,B,S,d) -> z (tp,B,S,d_inL), x
    (tp,B,S,HL,P), bm/cm (tp,B,S,G,N), dt (tp,B,S,HL) fp32, and the conv
    tails {"x", "bc"} (the last d_conv-1 inputs).  `conv_state` streams
    the convs from a decode cache."""
    s = cfg.ssm
    z = _mm(h, ss["wz"])
    x = _mm(h, ss["wx"])
    bc = _mm(h, shared_param(ss["wbc"]))
    dt = _mm(h, ss["wdt"]).float()
    dt = F.softplus(dt + _bcast(ss["dtb"], dt).float())
    cs = conv_state or {"x": None, "bc": None}
    # per-shard conv taps (tp, K, C) broadcast over the batch axis
    x, cs_x = SSM.causal_conv(x, ss["convx"][:, None], cs["x"])
    bc, cs_bc = SSM.causal_conv(bc, shared_param(ss["convbc"])[:, None],
                                cs["bc"])
    x, bc = F.silu(x), F.silu(bc)
    gn = s.n_groups * s.d_state
    lead = tuple(bc.shape[:3])
    bm = bc[..., :gn].reshape(lead + (s.n_groups, s.d_state))
    cm = bc[..., gn:].reshape(lead + (s.n_groups, s.d_state))
    x = x.reshape(lead + (x.shape[-1] // s.head_dim, s.head_dim))
    return z, x, bm, cm, dt, {"x": cs_x, "bc": cs_bc}


def _ssm_out(cfg, ss, y, z):
    """Gated per-head norm + out projection: y, z (tp,B,S,d_inL) -> the
    shard-local partial (tp,B,S,d)."""
    y = headwise_rmsnorm(y * F.silu(z), ss["gn"], cfg.norm_eps,
                         cfg.ssm.head_dim)
    return _mm(y, ss["wo"])


def _fold(t):
    """(tp, B, ...) -> (tp*B, ...): the shard axis folds into the batch."""
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def _per_stream(v, b):
    """A per-shard head vector (tp, HL) -> one row per (shard, batch row)."""
    return v.repeat_interleave(b, dim=0)


def _ssd_prefill(cfg, ss, x, dt, bm, cm):
    """The chunked scan of a prefill: the hand-written kernel on the card
    (kernels/ops.ssd_scan), its plain version on the CPU.  Returns (y
    (tp,B,S,HL*P), the final state (tp,B,HL,P,N) fp32)."""
    from repro_torch.kernels import ops as KOPS
    tp, b, s = x.shape[:3]
    a = -torch.exp(ss["alog"].float())
    y, state = KOPS.ssd_scan(_fold(x), _fold(dt), _per_stream(a, b),
                             _fold(bm), _fold(cm), _per_stream(ss["dd"], b),
                             chunk=cfg.ssm.chunk_size)
    return (y.reshape(tp, b, s, -1),
            state.reshape((tp, b) + tuple(state.shape[1:])))


def _ssd_dec(cfg, ss, h, cache):
    """One decode token through the SSM heads: h (tp,B,1,d) -> (y
    (tp,B,1,HL*P), z); the cache's "state" and "conv" tails updated in
    place in the model dtype."""
    tp, b = h.shape[:2]
    z, x, bm, cm, dt, conv = _ssm_in(cfg, ss, h, conv_state=cache["conv"])
    a = -torch.exp(ss["alog"].float())
    y, state = SSM.ssd_decode_step(
        _fold(x), _fold(dt), _per_stream(a, b), _fold(bm), _fold(cm),
        _per_stream(ss["dd"], b), _fold(cache["state"]))
    cache["state"].copy_(state.reshape(cache["state"].shape))
    for k in ("x", "bc"):
        cache["conv"][k].copy_(conv[k])
    return y.reshape(tp, b, 1, -1), z


def ssm_mixer_seq(cfg, ss, h, *, want_cache=False):
    """Prefill SSM mixer: h (tp,B,S,d) at the prompt's own length -> (the
    partial (tp,B,S,d), cache {"state" (tp,B,HL,P,N), "conv"} in the
    model dtype, or None)."""
    z, x, bm, cm, dt, conv = _ssm_in(cfg, ss, h)
    y, state = _ssd_prefill(cfg, ss, x, dt, bm, cm)
    part = _ssm_out(cfg, ss, y, z)
    if not want_cache:
        return part, None
    return part, {"state": state.to(torch_dtype(cfg)), "conv": conv}


def ssm_mixer_dec(cfg, ss, h, cache):
    """Decode SSM mixer: h (tp,B,1,d); cache {"state" (tp,B,HL,P,N),
    "conv" {"x", "bc"}}, updated in place in the model dtype."""
    y, z = _ssd_dec(cfg, ss, h, cache)
    return _ssm_out(cfg, ss, y, z), cache


def _hybrid_fuse(cfg, p, o_attn, y_ssm, z):
    """Hymba's mean fusion of the two head sets, each normed per head,
    through the attention's out projection: the shard-local partial."""
    y_ssm = y_ssm * F.silu(z)
    fused = 0.5 * (headwise_rmsnorm(o_attn, p["na"], cfg.norm_eps,
                                    cfg.d_head)
                   + headwise_rmsnorm(y_ssm, p["ns"], cfg.norm_eps,
                                      cfg.d_head))
    return _mm(fused, p["attn"]["wo"])


def hybrid_mixer_seq(cfg, kind, p, h, pos, lay, *, want_cache=False,
                     q_chunk=1024):
    """Hymba-style prefill mixer: attention (the plain one on every
    layer, global layers too: the reference's hybrid mixer ignores
    attn_backend) and SSM heads (the scan kernel on the card) side by
    side.  h
    (tp,B,S,d) at the prompt's own length -> (partial, cache {"k","v"
    (the rolling buffer on a windowed layer), "state", "conv"} or None)."""
    a = p["attn"]
    q, k, v = _qkv(cfg, a, h, lay)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    tp, b, s = h.shape[:3]
    o_attn = A.attention_any(q, k, v, pos, pos, window=kind.window,
                             q_chunk=q_chunk).reshape(tp, b, s, -1)
    ss = p["ssm"]
    z, x, bm, cm, dt, conv = _ssm_in(cfg, ss, h)
    y, state = _ssd_prefill(cfg, ss, x, dt, bm, cm)
    part = _hybrid_fuse(cfg, p, o_attn, y, z)
    if not want_cache:
        return part, None
    cache = _pack_kv(cfg, _rolling(k, kind.window), _rolling(v, kind.window))
    return part, dict(cache, state=state.to(torch_dtype(cfg)), conv=conv)


def hybrid_mixer_dec(cfg, kind, p, h, pos, cache, lay):
    """Hymba-style decode mixer: h (tp,B,1,d); cache {"k","v","state",
    "conv"}, updated in place."""
    o_attn = _attn_dec(cfg, kind, p["attn"], h, pos, cache, lay)
    y, z = _ssd_dec(cfg, p["ssm"], h, cache)
    return _hybrid_fuse(cfg, p, o_attn, y, z), cache


# ---------------------------------------------------------------------------
# FFN partial (shard-local, NO sync applied here)
# ---------------------------------------------------------------------------

def mlp_partial(cfg, m, h, *, divergent: bool):
    act = act_fn(cfg.act)
    up = _mm(h, m["wu"])
    if cfg.mlp_bias:
        up = up + _bcast(m["bu"], up)
    if cfg.gated_mlp:
        g = _mm(h, m["wg"])
        if cfg.mlp_bias:
            g = g + _bcast(m["bg"], g)
        hid = act(g) * up
    else:
        hid = act(up)
    return _mm(hid, m["wd"])      # the wd bias (bd) is added at the sync


def moe_partial(cfg, mo_p, h, *, h_aux=None, slots: int = 1):
    """h (tp,B,S,d) -> (the partial combine (tp,B,S,d), aux (tp, slots)).

    Each shard routes its own rows (in a dropped block they differ) over
    T = B*S tokens, pad and idle rows included, as the reference does:
    the capacity int(capacity_factor * T * k / n_routed) (at least k)
    and the queue order depend on T.  Shard i runs experts [i*E_l,
    (i+1)*E_l).  The shared experts are an MLP split over the shards.
    `aux` is the load-balance loss each shard computes (serving ignores
    it).  With `slots` > 1 the B rows are that many data slots' rows,
    slot-major (the sim train step's batch): each slot's rows route on
    their own, with their own T, capacity and aux, as on the device
    that holds the slot.

    Gradients (the reference's moe_partial): the combine's cotangents
    differ by shard, so `h` arrives through column_entry and the router
    through shared_param.  The aux loss is the same on every shard of a
    TP block; through those wrappers its gradient would count tp times.
    So in TP mode the caller passes `h_aux`, the replicated activation
    before column_entry, and where autograd records aux is taken from it
    through the raw router: counted once.  In SPD mode (`h_aux` None)
    each shard's aux is its own and the wrapped path is right."""
    b = h.shape[1]
    if b % slots:
        raise ValueError(f"{b} rows do not split into {slots} data slots")
    n = b // slots
    parts, auxs = [], []
    for i in range(slots):
        rows = slice(i * n, (i + 1) * n)
        part, aux = _moe_rows(cfg, mo_p, h[:, rows],
                              None if h_aux is None else h_aux[:, rows])
        parts.append(part)
        auxs.append(aux)
    part = parts[0] if slots == 1 else torch.cat(parts, 1)
    return part, torch.stack(auxs, -1)


def _moe_rows(cfg, mo_p, h, h_aux):
    """One data slot's rows: (partial (tp,B,S,d), aux (tp,))."""
    mo = cfg.moe
    tp, b, s, d = h.shape
    t = b * s
    hf = h.reshape(tp, t, d)
    gates, idx, aux = MOE.route(hf, shared_param(mo_p["router"]), mo.top_k,
                                mo.n_routed)
    if h_aux is not None and torch.is_grad_enabled():
        _, _, aux = MOE.route(h_aux.reshape(tp, t, d), mo_p["router"],
                              mo.top_k, mo.n_routed)
    e_l = mo_p["wu"].shape[1]
    cap = max(int(mo.capacity_factor * t * mo.top_k / max(mo.n_routed, 1)),
              mo.top_k)
    slot_token, tok_slot = MOE.dispatch_local(
        idx, shard_ids(h) * e_l, e_l, cap)
    part = MOE.moe_local(hf, gates, tok_slot, slot_token, mo_p.get("wg"),
                         mo_p["wu"], mo_p["wd"], cfg.act, cfg.gated_mlp)
    part = part.to(h.dtype)
    if mo.n_shared:
        act = act_fn(cfg.act)
        up = _mm(hf, mo_p["su"])
        hid = act(_mm(hf, mo_p["sg"])) * up if cfg.gated_mlp else act(up)
        part = part + _mm(hid, mo_p["sd"])
    return part.reshape(tp, b, s, d), aux


# ---------------------------------------------------------------------------
# Full blocks: TP vs SPD wiring
# ---------------------------------------------------------------------------

def _mixer_seq(cfg, kind, p, x, pos, lay, want_cache, q_chunk):
    """norm1 -> column entry -> mixer partial: (partial, bias_o, cache)."""
    h = column_entry(_norm(x, p["ln1"], cfg))
    if kind.mixer == "hybrid":
        part, cache = hybrid_mixer_seq(cfg, kind, p, h, pos, lay,
                                       want_cache=want_cache,
                                       q_chunk=q_chunk)
    elif kind.mixer == "mla":
        part, cache = mla_mixer_seq(cfg, kind, p["attn"], h, pos,
                                    want_cache=want_cache, q_chunk=q_chunk)
    else:
        part, cache = gqa_mixer_seq(cfg, kind, p["attn"], h, pos, lay,
                                    want_cache=want_cache, q_chunk=q_chunk)
    return part, p["attn"].get("bo"), cache


def _ffn_partial(cfg, kind, p, u, *, divergent, slots=1):
    """norm2 -> (column entry) -> ffn partial: (z_partial, bias_d, aux).
    A MoE FFN's aux (tp, slots) is its load-balance loss (see
    moe_partial: in TP mode taken from the activation before the column
    entry, so its gradient counts once); an MLP has none (None)."""
    ln2 = ({k: shared_param(v) for k, v in p["ln2"].items()} if divergent
           else p["ln2"])
    h2_raw = _norm(u, ln2, cfg)
    h2 = h2_raw if divergent else column_entry(h2_raw)
    if kind.ffn == "moe":
        z, aux = moe_partial(cfg, p["moe"], h2,
                             h_aux=None if divergent else h2_raw,
                             slots=slots)
        return z, None, aux
    return (mlp_partial(cfg, p["mlp"], h2, divergent=divergent),
            p["mlp"].get("bd"), None)


def _wire_post_mixer(cfg, kind, p, x, part, bo, *, drop: bool, comm=None,
                     slots=1):
    """TP/SPD post-mixer wiring (Fig 3) shared by every mode: (block
    output, the FFN's aux (tp, slots) or None; the cached paths drop the
    aux).
    x is the block input, `part` the shard-local mixer partial, `comm`
    the block's kept-sync level."""
    if not drop:
        y = sync_output(part, mode=comm)
        if bo is not None:
            y = y + _bcast(bo, y)
        u = x + y
        z, bd, aux = _ffn_partial(cfg, kind, p, u, divergent=False,
                                  slots=slots)
        z = sync_output(z, mode=comm)
        if bd is not None:
            z = z + _bcast(bd, z)
        return u + z, aux
    # ---- SPD wiring ----
    y_i = part
    if bo is not None:
        y_i = y_i + _bcast(shared_param(bo), y_i)   # b on the divergent path
    u_i = column_entry(x) + y_i
    z_i, bd, aux = _ffn_partial(cfg, kind, p, u_i, divergent=True,
                                slots=slots)
    out = x + sync_output(z_i + part, mode=comm)     # deferred residual: P_i
    if bo is not None:
        out = out + _bcast(bo, out)                  # bias re-added once
    if bd is not None:
        out = out + _bcast(bd, out)
    return out, aux


def block_seq(cfg, kind, lay, p, x, pos, *, drop: bool, want_cache=False,
              q_chunk=1024, comm=None, slots=1):
    """Sequence-mode block (prefill, training): x (tp,B,S,d).  Returns
    (out, cache, aux): aux (tp, slots) is a MoE FFN's load-balance loss,
    each of `slots` data slots' rows routed on their own (moe_partial);
    None for any other block."""
    if kind.mixer == "ssm":
        h = column_entry(_norm(x, p["ln1"], cfg))
        part, cache = ssm_mixer_seq(cfg, p["ssm"], h, want_cache=want_cache)
        return x + sync_output(part, mode=comm), cache, None
    part, bo, cache = _mixer_seq(cfg, kind, p, x, pos, lay, want_cache,
                                 q_chunk)
    out, aux = _wire_post_mixer(cfg, kind, p, x, part, bo, drop=drop,
                                comm=comm, slots=slots)
    return out, cache, aux


def block_dec(cfg, kind, lay, p, x, pos, cache, *, drop: bool, comm=None):
    """Decode-mode block: x (tp,B,1,d), pos (B,).  Returns (out, cache)."""
    h = column_entry(_norm(x, p["ln1"], cfg))
    if kind.mixer == "ssm":
        part, cache = ssm_mixer_dec(cfg, p["ssm"], h, cache)
        return x + sync_output(part, mode=comm), cache
    if kind.mixer == "hybrid":
        part, cache = hybrid_mixer_dec(cfg, kind, p, h, pos, cache, lay)
    elif kind.mixer == "mla":
        part, cache = mla_mixer_dec(cfg, kind, p["attn"], h, pos, cache)
    else:
        part, cache = gqa_mixer_dec(cfg, kind, p["attn"], h, pos, cache,
                                    lay)
    out, _ = _wire_post_mixer(cfg, kind, p, x, part, p["attn"].get("bo"),
                              drop=drop, comm=comm)
    return out, cache


# ---------------------------------------------------------------------------
# Cache-extension mode (chunked prefill, speculative verify and the
# drafter's steps): a chunk of C tokens runs seq-mode against an existing
# dense decode cache, writing its K/V at absolute positions and attending
# over the whole buffer with position masking.  Full-causal GQA layers
# only, with an MLP or a MoE FFN (model.supports_chunked_prefill gates
# callers).  The attention is
# the plain one in every backend, as in the reference (its `attention_any`
# / `attend` here, `core/blocks.py:978-982`): these chunks have no TPU
# kernel.
# ---------------------------------------------------------------------------

def gqa_mixer_ext(cfg, kind, a, h, pos, cache, lay, *, q_chunk=1024,
                  spos=None, anc=None):
    """Extension attention: h (tp,B,C,d); pos (B,C) absolute positions of
    the chunk; cache {"k","v"} (tp,B,S,HkvL,dh) spans the slot's whole
    buffer, written in place (slots past S dropped: `A.write_chunk`).

    Tree mode: `spos` (B,C) gives the WRITE slots (pos+chunk index) while
    `pos` keeps the tree positions (RoPE), and `anc` (C,C) switches the
    chunk's visibility to the ancestor matrix (`A.tree_mask`).  An int8
    cache takes the chunk's codes and scales, and the attention reads it
    dequantized."""
    q, k, v = _qkv(cfg, a, h, lay)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    tp, b, c = h.shape[:3]
    wpos = pos if spos is None else spos
    for name, val in _pack_kv(cfg, k, v).items():
        if name.endswith("_s"):          # scales: no head-dim axis
            A.write_chunk(cache[name][..., None], val[..., None], wpos)
        else:
            A.write_chunk(cache[name], val, wpos)
    kc, vc = _unpack_kv(cfg, cache, h.dtype)
    s_kv = kc.shape[-3]
    kv_pos = torch.arange(s_kv, device=h.device)[None].expand(b, s_kv)
    if anc is None:
        o = A.attention_any(q, kc, vc, pos, kv_pos, q_chunk=q_chunk)
    else:
        o = A.attend(q, kc, vc, A.tree_mask(wpos[:, 0], anc, kv_pos))
    part = _mm(o.reshape(tp, b, c, -1), a["wo"])
    return part, cache


def block_ext(cfg, kind, lay, p, x, pos, cache, *, drop: bool, q_chunk=1024,
              comm=None, spos=None, anc=None):
    """Cache-extension block: x (tp,B,C,d), pos (B,C).  Returns (out,
    cache)."""
    h = column_entry(_norm(x, p["ln1"], cfg))
    part, cache = gqa_mixer_ext(cfg, kind, p["attn"], h, pos, cache, lay,
                                q_chunk=q_chunk, spos=spos, anc=anc)
    out, _ = _wire_post_mixer(cfg, kind, p, x, part, p["attn"].get("bo"),
                              drop=drop, comm=comm)
    return out, cache


# ---------------------------------------------------------------------------
# Paged-cache mode: the per-layer K/V caches are physical page POOLS
# (tp, P+1, ps, HkvL, dh) shared across slots, indexed through a page
# table; no contiguous per-slot view is built.  New tokens scatter straight
# into their pages (in place); attention reads K/V through the table: the
# hand-written paged kernel on attn_backend="pallas", else the plain
# gather-only-the-table path.  GQA full-causal fp-cache layers only, with
# an MLP or a MoE FFN (model.supports_paged_attention gates callers).
# ---------------------------------------------------------------------------

def gqa_mixer_page(cfg, kind, a, h, pos, cache, page_table, lay,
                   depths=None, anc=None):
    """Paged attention over a chunk: h (tp,B,C,d); pos (B,) absolute
    start position of each slot's chunk; cache {"k","v"} page pools,
    written in place.

    Tree mode: `depths` (C,) replaces the contiguous chunk offsets for
    RoPE (token j sits at tree position pos+depths[j]) and `anc` (C,C)
    switches the chunk's visibility to the ancestor matrix; the scatter
    stays chunk-contiguous (slot pos+j).  A tree chunk takes the plain
    `paged_attend` under every backend, as the reference's does
    (`core/blocks.py:1025-1036`): there is no TPU kernel for it."""
    from repro_torch.kernels import ops as KOPS
    q, k, v = _qkv(cfg, a, h, lay)
    tp, b, c = h.shape[:3]
    if depths is None:
        pos2 = pos[:, None] + torch.arange(c, device=pos.device)[None]
    else:
        pos2 = pos[:, None] + depths[None]
    q = apply_rope(q, pos2, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos2, cfg.rope_theta, cfg.rope_fraction)
    KOPS.scatter_tokens_pages(cache["k"], k, page_table, pos)
    KOPS.scatter_tokens_pages(cache["v"], v, page_table, pos)
    if cfg.attn_backend == "pallas" and anc is None:
        o = KOPS.paged_attention(q, cache["k"], cache["v"], page_table, pos)
    else:
        o = A.paged_attend(q, cache["k"], cache["v"], page_table, pos,
                           anc=anc)
    part = _mm(o.reshape(tp, b, c, -1), a["wo"])
    return part, cache


def block_page(cfg, kind, lay, p, x, pos, cache, page_table, *, drop: bool,
               comm=None, depths=None, anc=None):
    """Paged-cache block (decode C=1, suffix prefill or verify C>1): x
    (tp,B,C,d), pos (B,) chunk starts.  Returns (out, cache)."""
    h = column_entry(_norm(x, p["ln1"], cfg))
    part, cache = gqa_mixer_page(cfg, kind, p["attn"], h, pos, cache,
                                 page_table, lay, depths=depths, anc=anc)
    out, _ = _wire_post_mixer(cfg, kind, p, x, part, p["attn"].get("bo"),
                              drop=drop, comm=comm)
    return out, cache
