"""Decoder-block math for TP and SPD execution — the paper's §4.1
(port of repro/core/blocks.py: the dense GQA blocks and the pure-SSM
Mamba2 block).

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
from repro_torch.models import ssm as SSM
from repro_torch.models.common import act_fn, apply_rope, norm_apply, rmsnorm
from repro_torch.parallel.collectives import (column_entry, shared_param,
                                              sync_output)
from repro_torch.parallel.layout import (REPLICATED, kv_head_orig,
                                         make_gqa_layout, pad_heads,
                                         q_head_orig)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.kv_dtype != "model" or cfg.weight_dtype != "model":
        raise NotImplementedError("int8 KV caches and int8 weights are not "
                                  "ported yet (kv_dtype/weight_dtype must be "
                                  "'model')")


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
    """SSM heads of a pure-SSM layer: expand * d_model / head_dim."""
    s = cfg.ssm
    return s.expand * cfg.d_model // s.head_dim


def _mm(h, w):
    """Per-shard matmul: h (tp, ..., din) @ w (tp, din, dout)."""
    tp, din = h.shape[0], h.shape[-1]
    out = torch.bmm(h.reshape(tp, -1, din), w)
    return out.reshape(tuple(h.shape[:-1]) + (w.shape[-1],))


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
    _check_ported(cfg)
    return {"k": kc, "v": vc}


def _update_kv(cfg, cache, k_new, v_new, pos):
    """Write one decode token into the cache, in place."""
    _check_ported(cfg)
    kc, vc = A.cache_update(cache["k"], cache["v"], k_new, v_new, pos)
    return {"k": kc, "v": vc}


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
    p = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    if cfg.qkv_bias:
        p.update({"bq": 0, "bk": 0, "bv": 0})
    if cfg.o_bias:
        p["bo"] = REPLICATED
    if cfg.qk_norm:
        p.update({"qn": REPLICATED, "kn": REPLICATED})
    return p


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
    p = {"wu": 1, "wd": 0}
    if cfg.gated_mlp:
        p["wg"] = 1
    if cfg.mlp_bias:
        p.update({"bu": 0, "bd": REPLICATED})
        if cfg.gated_mlp:
            p["bg"] = 0
    return p


def init_layer(gen, cfg: ModelConfig, kind: LayerKind, device) -> dict:
    if kind.mixer == "ssm":
        return {"ln1": _norm_init(cfg, cfg.d_model, device),
                "ssm": init_ssm(gen, cfg, device)}
    return {"ln1": _norm_init(cfg, cfg.d_model, device),
            "attn": init_attn(gen, cfg, device),
            "ln2": _norm_init(cfg, cfg.d_model, device),
            "mlp": init_mlp(gen, cfg, kind.d_ff or cfg.d_ff, device)}


def layer_specs(cfg: ModelConfig, kind: LayerKind) -> dict:
    if kind.mixer == "ssm":
        return {"ln1": _norm_spec(cfg), "ssm": ssm_specs(cfg)}
    return {"ln1": _norm_spec(cfg), "attn": attn_specs(cfg),
            "ln2": _norm_spec(cfg), "mlp": mlp_specs(cfg)}


def _pad_ssm(ss: dict, cfg: ModelConfig, tp: int) -> dict:
    """Pad the SSM heads to a multiple of tp (zero heads: zero in/out
    projections, so they add nothing)."""
    h = ssm_heads(cfg)
    hd = cfg.ssm.head_dim
    hp = -(-h // tp) * tp
    hmap = np.concatenate([np.arange(h), -np.ones(hp - h, np.int64)])
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
    """Pad canonical layer params so every split axis divides by tp."""
    _check_ported(cfg)
    if kind.mixer == "ssm":
        return dict(p, ssm=_pad_ssm(p["ssm"], cfg, tp))
    dh = cfg.d_head
    lay = make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
    qmap, kvmap = q_head_orig(lay), kv_head_orig(lay)
    a = dict(p["attn"])
    a["wq"] = pad_heads(a["wq"], 1, qmap, dh, cfg.n_heads)
    a["wo"] = pad_heads(a["wo"], 0, qmap, dh, cfg.n_heads)
    for nm in ("wk", "wv"):
        a[nm] = pad_heads(a[nm], 1, kvmap, dh, cfg.n_kv_heads)
    if cfg.qkv_bias:
        a["bq"] = pad_heads(a["bq"], 0, qmap, dh, cfg.n_heads)
        a["bk"] = pad_heads(a["bk"], 0, kvmap, dh, cfg.n_kv_heads)
        a["bv"] = pad_heads(a["bv"], 0, kvmap, dh, cfg.n_kv_heads)
    m = dict(p["mlp"])
    ff = m["wu"].shape[1]
    ffp = -(-ff // tp) * tp
    if ffp != ff:
        padm = np.concatenate([np.arange(ff), -np.ones(ffp - ff, np.int64)])
        for nm in ("wu", "wg", "bu", "bg"):
            if nm in m:
                m[nm] = pad_heads(m[nm], 1 if nm[0] == "w" else 0, padm, 1, ff)
        m["wd"] = pad_heads(m["wd"], 0, padm, 1, ff)
    return dict(p, attn=a, mlp=m)


# ---------------------------------------------------------------------------
# Mixers (shard-local partial output, NO sync applied here)
# ---------------------------------------------------------------------------

def gqa_mixer_seq(cfg, kind, a, h, pos, lay, *, want_cache=False,
                  q_chunk=1024):
    """Sequence (prefill) attention: h (tp,B,S,d), pos (B,S) -> (partial
    (tp,B,S,d), cache {"k","v"} (tp,B,S,HkvL,dh) or None)."""
    q, k, v = _qkv(cfg, a, h, lay)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    tp, b, s = h.shape[:3]
    if cfg.attn_backend == "pallas":
        # the hand-written flash kernel; the shard axis folds into batch
        from repro_torch.kernels import ops as KOPS
        o = KOPS.flash_attention(q.reshape((tp * b,) + q.shape[2:]),
                                 k.reshape((tp * b,) + k.shape[2:]),
                                 v.reshape((tp * b,) + v.shape[2:]))
    else:
        o = A.attention_any(q, k, v, pos, pos, q_chunk=q_chunk)
    part = _mm(o.reshape(tp, b, s, -1), a["wo"])
    return part, (_pack_kv(cfg, k, v) if want_cache else None)


def gqa_mixer_dec(cfg, kind, a, h, pos, cache, lay):
    """Decode attention: h (tp,B,1,d), pos (B,); cache {"k","v"}
    (tp,B,S,HkvL,dh), updated in place."""
    q, k, v = _qkv(cfg, a, h, lay)
    q = apply_rope(q, pos[:, None], cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos[:, None], cfg.rope_theta, cfg.rope_fraction)
    cache = _update_kv(cfg, cache, k, v, pos)
    o = A.decode_attend(q, cache["k"], cache["v"], pos)
    part = _mm(o.reshape(tuple(h.shape[:3]) + (-1,)), a["wo"])
    return part, cache


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


def ssm_mixer_seq(cfg, ss, h, *, want_cache=False):
    """Prefill SSM mixer: h (tp,B,S,d) at the prompt's own length -> (the
    partial (tp,B,S,d), cache {"state" (tp,B,HL,P,N), "conv"} in the
    model dtype, or None).  The chunked scan is the hand-written kernel on
    the card (kernels/ops.ssd_scan), its plain version on the CPU."""
    from repro_torch.kernels import ops as KOPS
    tp, b, s = h.shape[:3]
    z, x, bm, cm, dt, conv = _ssm_in(cfg, ss, h)
    a = -torch.exp(ss["alog"].float())
    y, state = KOPS.ssd_scan(_fold(x), _fold(dt), _per_stream(a, b),
                             _fold(bm), _fold(cm), _per_stream(ss["dd"], b),
                             chunk=cfg.ssm.chunk_size)
    part = _ssm_out(cfg, ss, y.reshape(tp, b, s, -1), z)
    if not want_cache:
        return part, None
    state = state.reshape((tp, b) + tuple(state.shape[1:]))
    return part, {"state": state.to(torch_dtype(cfg)), "conv": conv}


def ssm_mixer_dec(cfg, ss, h, cache):
    """Decode SSM mixer: h (tp,B,1,d); cache {"state" (tp,B,HL,P,N),
    "conv" {"x", "bc"}}, updated in place in the model dtype."""
    tp, b = h.shape[:2]
    z, x, bm, cm, dt, conv = _ssm_in(cfg, ss, h, conv_state=cache["conv"])
    a = -torch.exp(ss["alog"].float())
    y, state = SSM.ssd_decode_step(
        _fold(x), _fold(dt), _per_stream(a, b), _fold(bm), _fold(cm),
        _per_stream(ss["dd"], b), _fold(cache["state"]))
    cache["state"].copy_(state.reshape(cache["state"].shape))
    for k in ("x", "bc"):
        cache["conv"][k].copy_(conv[k])
    part = _ssm_out(cfg, ss, y.reshape(tp, b, 1, -1), z)
    return part, cache


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


# ---------------------------------------------------------------------------
# Full blocks: TP vs SPD wiring
# ---------------------------------------------------------------------------

def _mixer_seq(cfg, kind, p, x, pos, lay, want_cache, q_chunk):
    """norm1 -> column entry -> mixer partial: (partial, bias_o, cache)."""
    h = column_entry(_norm(x, p["ln1"], cfg))
    part, cache = gqa_mixer_seq(cfg, kind, p["attn"], h, pos, lay,
                                want_cache=want_cache, q_chunk=q_chunk)
    return part, p["attn"].get("bo"), cache


def _ffn_partial(cfg, kind, p, u, *, divergent):
    """norm2 -> (column entry) -> ffn partial: (z_partial, bias_d)."""
    ln2 = ({k: shared_param(v) for k, v in p["ln2"].items()} if divergent
           else p["ln2"])
    h2 = _norm(u, ln2, cfg)
    h2 = h2 if divergent else column_entry(h2)
    return mlp_partial(cfg, p["mlp"], h2, divergent=divergent), \
        p["mlp"].get("bd")


def _wire_post_mixer(cfg, kind, p, x, part, bo, *, drop: bool, comm=None):
    """TP/SPD post-mixer wiring (Fig 3) shared by prefill and decode.  x
    is the block input, `part` the shard-local mixer partial, `comm` the
    block's kept-sync level."""
    if not drop:
        y = sync_output(part, mode=comm)
        if bo is not None:
            y = y + _bcast(bo, y)
        u = x + y
        z, bd = _ffn_partial(cfg, kind, p, u, divergent=False)
        z = sync_output(z, mode=comm)
        if bd is not None:
            z = z + _bcast(bd, z)
        return u + z
    # ---- SPD wiring ----
    y_i = part
    if bo is not None:
        y_i = y_i + _bcast(shared_param(bo), y_i)   # b on the divergent path
    u_i = column_entry(x) + y_i
    z_i, bd = _ffn_partial(cfg, kind, p, u_i, divergent=True)
    out = x + sync_output(z_i + part, mode=comm)     # deferred residual: P_i
    if bo is not None:
        out = out + _bcast(bo, out)                  # bias re-added once
    if bd is not None:
        out = out + _bcast(bd, out)
    return out


def block_seq(cfg, kind, lay, p, x, pos, *, drop: bool, want_cache=False,
              q_chunk=1024, comm=None):
    """Sequence-mode block (prefill): x (tp,B,S,d).  Returns (out, cache)."""
    if kind.mixer == "ssm":
        h = column_entry(_norm(x, p["ln1"], cfg))
        part, cache = ssm_mixer_seq(cfg, p["ssm"], h, want_cache=want_cache)
        return x + sync_output(part, mode=comm), cache
    part, bo, cache = _mixer_seq(cfg, kind, p, x, pos, lay, want_cache,
                                 q_chunk)
    out = _wire_post_mixer(cfg, kind, p, x, part, bo, drop=drop, comm=comm)
    return out, cache


def block_dec(cfg, kind, lay, p, x, pos, cache, *, drop: bool, comm=None):
    """Decode-mode block: x (tp,B,1,d), pos (B,).  Returns (out, cache)."""
    h = column_entry(_norm(x, p["ln1"], cfg))
    if kind.mixer == "ssm":
        part, cache = ssm_mixer_dec(cfg, p["ssm"], h, cache)
        return x + sync_output(part, mode=comm), cache
    part, cache = gqa_mixer_dec(cfg, kind, p["attn"], h, pos, cache, lay)
    out = _wire_post_mixer(cfg, kind, p, x, part, p["attn"].get("bo"),
                           drop=drop, comm=comm)
    return out, cache


# ---------------------------------------------------------------------------
# Cache-extension mode (chunked prefill, speculative verify and the
# drafter's steps): a chunk of C tokens runs seq-mode against an existing
# dense decode cache, writing its K/V at absolute positions and attending
# over the whole buffer with position masking.  Full-causal GQA layers
# only (model.supports_chunked_prefill gates callers).  The attention is
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
    chunk's visibility to the ancestor matrix (`A.tree_mask`)."""
    _check_ported(cfg)
    q, k, v = _qkv(cfg, a, h, lay)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    tp, b, c = h.shape[:3]
    wpos = pos if spos is None else spos
    A.write_chunk(cache["k"], k, wpos)
    A.write_chunk(cache["v"], v, wpos)
    s_kv = cache["k"].shape[-3]
    kv_pos = torch.arange(s_kv, device=h.device)[None].expand(b, s_kv)
    if anc is None:
        o = A.attention_any(q, cache["k"], cache["v"], pos, kv_pos,
                            q_chunk=q_chunk)
    else:
        o = A.attend(q, cache["k"], cache["v"],
                     A.tree_mask(wpos[:, 0], anc, kv_pos))
    part = _mm(o.reshape(tp, b, c, -1), a["wo"])
    return part, cache


def block_ext(cfg, kind, lay, p, x, pos, cache, *, drop: bool, q_chunk=1024,
              comm=None, spos=None, anc=None):
    """Cache-extension block: x (tp,B,C,d), pos (B,C).  Returns (out,
    cache)."""
    h = column_entry(_norm(x, p["ln1"], cfg))
    part, cache = gqa_mixer_ext(cfg, kind, p["attn"], h, pos, cache, lay,
                                q_chunk=q_chunk, spos=spos, anc=anc)
    out = _wire_post_mixer(cfg, kind, p, x, part, p["attn"].get("bo"),
                           drop=drop, comm=comm)
    return out, cache


# ---------------------------------------------------------------------------
# Paged-cache mode: the per-layer K/V caches are physical page POOLS
# (tp, P+1, ps, HkvL, dh) shared across slots, indexed through a page
# table; no contiguous per-slot view is built.  New tokens scatter straight
# into their pages (in place); attention reads K/V through the table: the
# hand-written paged kernel on attn_backend="pallas", else the plain
# gather-only-the-table path.  GQA full-causal fp-cache layers only
# (model.supports_paged_attention gates callers).
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
    _check_ported(cfg)
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
    out = _wire_post_mixer(cfg, kind, p, x, part, p["attn"].get("bo"),
                           drop=drop, comm=comm)
    return out, cache
