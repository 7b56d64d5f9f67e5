"""Full-model serving forward (port of repro/core/model.py: the serving
forwards and the forward-only loss).

Layers are grouped into SEGMENTS of equal (kind, drop flag, sync level);
each segment's parameters are stacked on a layer axis, as in the
reference, and its layers run in a Python loop where the reference runs
`lax.scan`.  Parameters after `simtp.split_padded` are shard-stacked:
every leaf has a leading (tp, ...) axis and segment leaves are
(tp, layers, ...).  The vocab axis of the embedding is split over the
shards; the LM head is the tied embedding or, untied, a `head` (d, V)
split on its vocab axis.  A learned position table (`pos`, OPT) is
replicated and added at absolute positions.  A modality frontend's
`front` (frontend_dim, d) is replicated too: it projects precomputed
embeddings (B, Flen, frontend_dim) into a prefix of the token stream
(`forward_seq(embeds=)`).  Pure-SSM layers carry
recurrent state (the scan state and the conv tails) instead of K/V
caches; hybrid layers carry both.  A sliding-window layer's K/V is a
rolling buffer of min(window, cache_len) slots.  An MLA layer caches its
latent and rope key, replicated over the shards; an int8 KV cache holds
codes beside bf16 scales.  Weight-only int8 quantizes the attention and
MLP leaves after padding (blocks.quantize_layer_weights).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.config.base import ModelConfig, SPDPlanConfig
from repro_torch.core import blocks as B
from repro_torch.core.layer_kinds import layer_kinds, plan_segments
from repro_torch.parallel.collectives import (column_entry, comm_context,
                                              ledger_paused, ledger_scale,
                                              pmax, shard_ids, sync_output)
from repro_torch.parallel.layout import REPLICATED, make_gqa_layout
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# Init / specs / padding
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, *, seed: int = 0, device="cpu",
               keep=None) -> dict:
    """Canonical (unpadded, unstacked) parameters from a seeded
    torch.Generator (not the reference's numbers: parity tests carry the
    reference's parameters across with `core.convert.from_reference`).
    The numbers are drawn on `device`; `keep` moves each leaf there as
    soon as its layer is drawn (the shard backend keeps the canonical
    tree on the host, so a rank's card holds only its shard).  On
    `device="meta"` nothing is drawn: the leaves are meta tensors of the
    parameters' shapes and dtypes (the dry run's parameter structs)."""
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    dt = B.torch_dtype(cfg)

    def kept(t):
        return t if keep is None else tree_map(lambda w: w.to(keep), t)

    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      **f32) * 0.02
    p = {"emb": kept(emb.to(dt)),
         "lnf": kept(B._norm_init(cfg, cfg.d_model, device)),
         "layers": [kept(B.init_layer(gen, cfg, k, device))
                    for k in layer_kinds(cfg)]}
    del emb
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.d_model, cfg.vocab_size), generator=gen,
                           **f32) / cfg.d_model ** 0.5
        p["head"] = kept(head.to(dt))
    if cfg.pos_emb == "learned":
        pos = torch.randn((cfg.max_seq_len, cfg.d_model), generator=gen,
                          **f32) * 0.02
        p["pos"] = kept(pos.to(dt))
    if cfg.frontend_dim:
        front = torch.randn((cfg.frontend_dim, cfg.d_model), generator=gen,
                            **f32) / cfg.frontend_dim ** 0.5
        p["front"] = kept(front.to(dt))
    return p


def vocab_pad(cfg: ModelConfig, tp: int) -> int:
    return -(-cfg.vocab_size // tp) * tp


def pad_model(p: dict, cfg: ModelConfig, tp: int, device=None) -> dict:
    """Canonical -> TP-layout (padded) params; layers stay a list.  With
    weight_dtype="int8" the attention and MLP leaves are quantized after
    padding, as the reference's are; given a `device`, each layer is
    quantized there and comes back where it was (the shard engine keeps
    the canonical tree on the host and quantizes on the rank's card, one
    layer at a time)."""
    out = {k: v for k, v in p.items() if k != "layers"}
    pad = vocab_pad(cfg, tp) - cfg.vocab_size
    if pad:
        out["emb"] = torch.cat([p["emb"], p["emb"].new_zeros(
            (pad, cfg.d_model))], 0)
        if "head" in p:
            out["head"] = torch.cat([p["head"], p["head"].new_zeros(
                (cfg.d_model, pad))], 1)

    def layer(lp, k):
        if device is None or cfg.weight_dtype != "int8":
            return B.quantize_layer_weights(B.pad_layer(lp, cfg, k, tp),
                                            cfg, k)
        home = p["emb"].device
        lp = tree_map(lambda w: w.to(device), lp)
        return tree_map(lambda w: w.to(home), B.quantize_layer_weights(
            B.pad_layer(lp, cfg, k, tp), cfg, k))

    out["layers"] = [layer(lp, k)
                     for lp, k in zip(p["layers"], layer_kinds(cfg))]
    return out


def model_specs(cfg: ModelConfig) -> dict:
    s = {"emb": 0, "lnf": B._norm_spec(cfg),
         "layers": [B.layer_specs(cfg, k) for k in layer_kinds(cfg)]}
    if not cfg.tie_embeddings:
        s["head"] = 1
    if cfg.pos_emb == "learned":
        s["pos"] = REPLICATED
    if cfg.frontend_dim:
        s["front"] = REPLICATED
    return s


def stacked_specs(cfg: ModelConfig, plan: SPDPlanConfig) -> dict:
    s = model_specs(cfg)
    out = {k: v for k, v in s.items() if k != "layers"}
    out["segs"] = [s["layers"][start] for (start, _, _, _)
                   in plan_segments(cfg, plan.drop_mask, plan.qmodes)]
    return out


def unstack_segments(stacked: dict, cfg: ModelConfig,
                     plan: SPDPlanConfig) -> dict:
    """Per-segment stacked trees (layer axis 0) -> padded per-layer list
    (views of the stacked leaves)."""
    layers = [None] * cfg.n_layers
    for seg_i, (start, length, _, _) in enumerate(
            plan_segments(cfg, plan.drop_mask, plan.qmodes)):
        for j in range(length):
            layers[start + j] = tree_map(lambda w, j=j: w[j],
                                         stacked["segs"][seg_i])
    out = {k: v for k, v in stacked.items() if k != "segs"}
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# Embedding / head (vocab-parallel)
# ---------------------------------------------------------------------------

def embed_tokens(emb, tokens):
    """emb (tp, Vl, d); tokens (B,S) -> (tp,B,S,d) via a masked psum."""
    tp, vl = emb.shape[:2]
    shard = shard_ids(emb).view(tp, 1, 1)
    local = tokens[None] - shard * vl
    valid = (local >= 0) & (local < vl)
    rows = torch.arange(tp, device=emb.device).view(tp, 1, 1)
    e = emb[rows, local.clamp(0, vl - 1)]
    e = torch.where(valid[..., None], e, torch.zeros_like(e))
    return sync_output(e, compressible=False)


def lm_logits(p, cfg, x):
    """x (tp,B,S,d) replicated -> shard-local logits (tp,B,S,Vl) fp32."""
    w = p["emb"].transpose(1, 2) if cfg.tie_embeddings else p["head"]
    return B._mm(column_entry(x), w).float()


def serve_logits(p, cfg, x, plan):
    """lm_logits for the serving paths, honoring the comm policy's
    logits level: a quantized level puts each shard's slice through the
    wire qdq and logs the all-gather at quantized bytes."""
    lg = lm_logits(p, cfg, x)
    mode = plan.logits_mode if plan is not None else "exact"
    if mode != "exact":
        from repro_torch.parallel.compression import (QUANT_BITS,
                                                      quantized_gather_payload)
        lg = quantized_gather_payload(lg, "model", bits=QUANT_BITS[mode])
    return lg


def _final_norm(stacked, cfg, x):
    return B._norm(x, stacked["lnf"], cfg)


def _add_positions(stacked, cfg, x, pos):
    """Learned absolute positions (OPT): x (tp,B,C,d) + pos_table[pos],
    pos (B,C).  RoPE models rotate q/k in the blocks instead.  A position
    past the table (only an idle slot's pad can be one) reads its last
    row: an out-of-range index would be a device-side assert."""
    if cfg.pos_emb != "learned":
        return x
    table = stacked["pos"]
    return x + table[:, pos.clamp(0, table.shape[1] - 1)]


def _gqa_layout(cfg, tp):
    """The attention head layout, or None for an attention-free or an MLA
    model (MLA's heads are not padded)."""
    if cfg.attn_free or cfg.mla is not None:
        return None
    return make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)


def has_recurrent_state(cfg) -> bool:
    """Whether some layer carries recurrent state (an SSM scan state and
    conv tails: pure-SSM and hybrid layers).  Such a model is prefilled
    at the prompt's own length: a pad token would be scanned into the
    state (ROADMAP C3)."""
    return any(k.mixer in ("ssm", "hybrid") for k in layer_kinds(cfg))


def _layer(seg_params, j):
    return tree_map(lambda w: w[:, j], seg_params)


# ---------------------------------------------------------------------------
# Prefill / decode (serving)
# ---------------------------------------------------------------------------

# cache leaves with a sequence axis (tp, B, S, ...): attention K/V, their
# int8 scales, MLA's latent and rope key
SEQ_LEAVES = ("k", "v", "k_s", "v_s", "c", "kr")


def _seg_cache(kind, cache: dict, length: int, cache_len: int) -> dict:
    """Zero segment caches shaped after one layer's prefill cache (leaves
    (tp, B, ...)): a layer axis after the shard axis; the SEQ_LEAVES
    padded along the sequence to the decode buffer, min(window,
    cache_len) slots on a windowed layer (the reference pads to the
    window, which is the same whenever the window fits the buffer)."""
    target = min(kind.window, cache_len) if kind.window else cache_len

    def one(name, leaf):
        shp = (leaf.shape[0], length) + tuple(leaf.shape[1:])
        if name in SEQ_LEAVES:
            shp = shp[:3] + (max(leaf.shape[2], target),) + shp[4:]
        return leaf.new_zeros(shp)

    return {name: tree_map(lambda a, name=name: one(name, a), sub)
            for name, sub in cache.items()}


def _prepend_front(view, x, embeds):
    """A modality prefix (reference model.py:228-235): embeds (B, Flen,
    frontend_dim), cast to the activation dtype, projected by each
    shard's copy of the replicated `front` and put before the token
    embeddings x (tp,B,S,d).  Returns (x (tp,B,Flen+S,d), Flen)."""
    e = embeds.to(x.dtype)
    e = e[None].expand((x.shape[0],) + tuple(e.shape))
    return torch.cat([B._mm(e, view["front"]), x], 2), embeds.shape[1]


def forward_seq(cfg, stacked, plan: SPDPlanConfig, tokens, *, tp,
                q_chunk=1024, cache_len: int = 0, want_cache=False,
                drop_flags=None, remat=False, fsdp=None, slots: int = 1,
                embeds=None):
    """Sequence forward.  tokens (B,S); `embeds` (B, Flen, frontend_dim)
    for a modality-frontend config, whose projection is the stream's
    first Flen positions (positions, RoPE or learned, run over the
    combined stream).  Returns (hidden (tp,B,S,d) after the final norm,
    caches, aux, prefix), S counting the prefix and `prefix` its length
    (0 without embeds) — caches per segment: attention layers'
    {"k","v"} of shape (tp, layers, B, max(S, cache_len), HkvL, dh), zero
    past S (a windowed layer's rolling buffer: max(min(S, window),
    min(window, cache_len)) slots; an int8 cache's codes and "k_s"/"v_s"
    scales (tp, layers, B, S', HkvL)); MLA layers' {"c" (tp, layers, B,
    S', lora), "kr" (..., rope)}; SSM layers' {"state" (tp, layers, B,
    HL, P, N), "conv" {"x", "bc"} (tp, layers, B, d_conv-1, C)}; hybrid
    layers' both.

    `drop_flags` (L,) overrides the plan's drop mask layer by layer (the
    sensitivity sweep: one placement under the no-SPD plan serves every
    suffix plan).  The reference's dual mode computes both wirings and
    selects one; here only the selected wiring runs, with the same
    values.  The ledger still scales a segment's first layer over it,
    whatever the flags: the sweep reads no ledger.

    `remat=True` (training, no caches) recomputes each block in the
    backward (`torch.utils.checkpoint`, the reference's jax.checkpoint of
    the scan body); the values do not change.

    `fsdp` (parallel/fsdp.FSDPSpecs, training) logs the all-gathers of
    the data-sharded weights where the reference gathers them: the
    embedding, the frontend projection, each layer (one layer's, scaled
    over its segment) and the final norm.  On one device the weights are
    whole: nothing moves.

    `aux` is the MoE load-balance aux summed over the layers, (tp, slots)
    fp32 (zeros without a MoE FFN; each layer's by its own wiring, also
    under `drop_flags`, as the reference's dual mode selects it).
    `slots` > 1 routes each of that many data slots' rows on their own
    (blocks.moe_partial: the sim train step)."""
    lay = _gqa_layout(cfg, tp)
    view = stacked if fsdp is None else fsdp.gather_top(stacked, ("emb",))
    x = embed_tokens(view["emb"], tokens)
    prefix = 0
    if cfg.frontend_dim and embeds is not None:
        if fsdp is not None:
            view = fsdp.gather_top(view, ("front",))
        x, prefix = _prepend_front(view, x, embeds)
    b, s = x.shape[1:3]
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    if fsdp is not None:
        view = fsdp.gather_top(view, ("pos",))
    x = _add_positions(view, cfg, x, pos)
    aux_total = None
    caches = []
    for seg_i, (start, length, kind, dropped) in enumerate(
            plan_segments(cfg, plan.drop_mask, plan.qmodes)):
        sp = stacked["segs"][seg_i]
        seg_cache = None
        with ledger_scale(length), comm_context(block=start, phase="prefill"):
            for j in range(length):
                drop = (dropped if drop_flags is None
                        else bool(drop_flags[start + j]))
                with ledger_paused(j > 0):
                    lp = _layer(sp, j)
                    if fsdp is not None:
                        lp = fsdp.gather_layer(lp, seg_i)
                    if remat and not want_cache:
                        x, c, aux = _remat_block(cfg, kind, lay, lp, x, pos,
                                                 drop, q_chunk,
                                                 plan.block_mode(start),
                                                 slots)
                    else:
                        x, c, aux = B.block_seq(cfg, kind, lay, lp, x, pos,
                                                drop=drop,
                                                want_cache=want_cache,
                                                q_chunk=q_chunk,
                                                comm=plan.block_mode(start),
                                                slots=slots)
                    if aux is not None:
                        aux_total = aux if aux_total is None else (
                            aux_total + aux)
                if want_cache:
                    if seg_cache is None:
                        seg_cache = _seg_cache(kind, c, length, cache_len)
                    # K/V fill their first S positions; a recurrent
                    # leaf's axis 2 is whole, so the same slice covers it
                    tree_map(lambda dst, src: dst[:, j, :, :src.shape[2]]
                             .copy_(src), seg_cache, c)
        caches.append(seg_cache)
    if fsdp is not None:
        view = fsdp.gather_top(stacked, ("lnf",))
    if aux_total is None:
        aux_total = torch.zeros((x.shape[0], slots), dtype=torch.float32,
                                device=x.device)
    return (_final_norm(view, cfg, x), caches if want_cache else None,
            aux_total, prefix)


def _remat_block(cfg, kind, lay, layer_p, x, pos, drop, q_chunk, comm,
                 slots):
    """One block whose activations the backward recomputes: block_seq's
    (out, None, aux), no cache.  The recomputation logs nothing: the
    ledger counts the forward.  It syncs over the groups bound now (a
    rank's): on a CUDA device it runs on the autograd engine's thread,
    which has none bound."""

    from torch.utils.checkpoint import checkpoint

    from repro_torch.parallel.collectives import bound_groups, groups_bound
    calls = []
    groups = bound_groups()

    def run(xc, *leaves):
        calls.append(1)
        with ledger_paused(len(calls) > 1), groups_bound(groups):
            return B.block_seq(cfg, kind, lay, tree_unflatten(layer_p, leaves),
                               xc, pos, drop=drop, q_chunk=q_chunk,
                               comm=comm, slots=slots)

    return checkpoint(run, x, *tree_leaves(layer_p), use_reentrant=False)


def token_ce(logits, labels, cfg):
    """Per-token cross entropy with the vocab split over the shards.

    logits (tp,B,S,Vl) fp32 shard-local; labels (B,S) int.  The padded
    vocab columns are masked, the row max is taken across shards (pmax),
    and the exp-sum and the label logit travel through exact syncs; the
    row max carries no gradient, as the reference's stop_gradient.
    Returns ce (tp,B,S): every shard holds the same values, each through
    its own graph."""
    vl = logits.shape[-1]
    shard = shard_ids(logits)
    gcol = shard[:, None] * vl + torch.arange(vl, device=logits.device)
    logits = torch.where((gcol < cfg.vocab_size)[:, None, None], logits,
                         torch.full_like(logits, -1e30))
    m = pmax(logits.amax(-1).detach())                        # (tp,B,S)
    se = sync_output(torch.exp(logits - m[..., None]).sum(-1),
                     compressible=False)
    local = labels[None].long() - shard[:, None, None] * vl
    ok = (local >= 0) & (local < vl)
    lbl = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    lbl = sync_output(torch.where(ok, lbl, torch.zeros_like(lbl)),
                      compressible=False)
    return torch.log(se) + m - lbl


def loss_fn(cfg, stacked, plan, batch, *, tp, q_chunk=1024,
            drop_flags=None, remat=False, fsdp=None, aux_coef=0.01,
            slots: int = 1):
    """The LM loss plus `aux_coef` x the MoE load-balance aux, as the
    reference's.  batch {"tokens", "labels", "mask"} (B,S) tensors and,
    for a frontend config, "embeds" (B, Flen, frontend_dim): the logits
    are the token positions' (after the prefix).
    Returns (shard 0's mean CE over the mask + aux_coef * aux, {"sum_ce",
    "n_tok", "aux", "shard_loss" (tp,), "shard_ce" (tp,), "shard_aux"
    (tp, slots), "row_ce" (B,)}): a gradient is taken of
    shard_loss.sum(), the reference's grad inside the shard map; the
    train step takes it of shard_ce.sum() over the GLOBAL token count
    plus aux_coef x shard_aux.sum() over the microbatches instead
    (parallel/tp.py).  `aux` is shard 0's aux summed over the slots
    (zero without a MoE FFN); `slots` > 1 routes each data slot's rows
    on their own (forward_seq).  `row_ce` is shard 0's masked CE sum of
    each row, without a graph.  `fsdp` logs the head's all-gather as
    the reference does (see forward_seq)."""
    x, _, aux, prefix = forward_seq(cfg, stacked, plan, batch["tokens"],
                                    tp=tp, q_chunk=q_chunk,
                                    drop_flags=drop_flags, remat=remat,
                                    fsdp=fsdp, slots=slots,
                                    embeds=batch.get("embeds"))
    head = stacked if fsdp is None else fsdp.gather_top(
        stacked, ("emb",) if cfg.tie_embeddings else ("head",))
    mask = batch["mask"].float()
    ce = token_ce(lm_logits(head, cfg, x[:, :, prefix:]), batch["labels"],
                  cfg)
    shard_ce = torch.stack([(c * mask).sum() for c in ce])
    n_tok = mask.sum()
    shard_loss = shard_ce / n_tok.clamp_min(1.0) + aux_coef * aux.sum(-1)
    return shard_loss[0], {"sum_ce": shard_ce[0], "n_tok": n_tok,
                           "aux": aux[0].sum(),
                           "shard_loss": shard_loss,
                           "shard_ce": shard_ce, "shard_aux": aux,
                           "row_ce": (ce[0].detach() * mask).sum(-1)}


def prefill(cfg, stacked, plan, tokens, *, tp, q_chunk=1024,
            cache_len: int = 0, lengths=None, embeds=None):
    """Returns (next-token logits (tp,B,Vl) fp32 shard-local, caches).

    `cache_len` pads the caches' sequence axis to the decode buffer
    length; `lengths` (B,) are the real prompt lengths of a right-padded
    batch (decode overwrites the padded cache slots before they become
    causally visible).  `embeds` (B, Flen, frontend_dim) prefills a
    modality prefix before the tokens; decode then goes on at Flen +
    lengths.  The logits are taken at the last real token, Flen +
    lengths - 1: the reference takes them at lengths - 1 of the combined
    stream, inside the prefix (ROADMAP C12)."""
    x, caches, _, prefix = forward_seq(cfg, stacked, plan, tokens, tp=tp,
                                       q_chunk=q_chunk, cache_len=cache_len,
                                       want_cache=True, embeds=embeds)
    if lengths is None:
        xq = x[:, :, -1:]
    else:
        idx = (prefix + lengths.long() - 1).clamp(0, x.shape[2] - 1)
        xq = x[:, torch.arange(x.shape[1], device=x.device), idx][:, :, None]
    return serve_logits(stacked, cfg, xq, plan)[:, :, 0], caches


def decode_step(cfg, stacked, plan, tokens, pos, caches, *, tp):
    """One decode step: tokens (B,1), pos (B,), caches per segment
    (updated in place).  Returns (logits (tp,B,Vl) fp32, caches)."""
    lay = _gqa_layout(cfg, tp)
    x = embed_tokens(stacked["emb"], tokens)
    x = _add_positions(stacked, cfg, x, pos[:, None])
    for seg_i, (start, length, kind, dropped) in enumerate(
            plan_segments(cfg, plan.drop_mask, plan.qmodes)):
        sp, cs = stacked["segs"][seg_i], caches[seg_i]
        with ledger_scale(length), comm_context(block=start, phase="decode"):
            for j in range(length):
                with ledger_paused(j > 0):
                    x, _ = B.block_dec(cfg, kind, lay, _layer(sp, j), x, pos,
                                       _layer(cs, j), drop=dropped,
                                       comm=plan.block_mode(start))
    x = _final_norm(stacked, cfg, x)
    return serve_logits(stacked, cfg, x, plan)[:, :, 0], caches


def supports_chunked_prefill(cfg) -> bool:
    """Full-causal GQA stacks (MLP or MoE FFNs) without a modality
    prefix; windowed, SSM and hybrid layers and frontend configs prefill
    whole (reference model.py:532-539), so they neither speculate nor
    take the fused paged forward."""
    return (not cfg.frontend_dim
            and all(k.mixer == "gqa" and k.window == 0
                    for k in layer_kinds(cfg)))


def _ext_forward(cfg, stacked, plan, tokens, pos2, caches, *, tp, q_chunk,
                 phase, spos=None, anc=None):
    """The cache-extension forward shared by `prefill_chunk` and
    `verify_step`: tokens (B,C) at positions pos2 (B,C) through every
    block's `block_ext`.  Returns the final-normed hidden (tp,B,C,d)."""
    lay = _gqa_layout(cfg, tp)
    x = embed_tokens(stacked["emb"], tokens)
    x = _add_positions(stacked, cfg, x, pos2)
    for seg_i, (start, length, kind, dropped) in enumerate(
            plan_segments(cfg, plan.drop_mask, plan.qmodes)):
        sp, cs = stacked["segs"][seg_i], caches[seg_i]
        with ledger_scale(length), comm_context(block=start, phase=phase):
            for j in range(length):
                with ledger_paused(j > 0):
                    x, _ = B.block_ext(cfg, kind, lay, _layer(sp, j), x,
                                       pos2, _layer(cs, j), drop=dropped,
                                       q_chunk=q_chunk,
                                       comm=plan.block_mode(start),
                                       spos=spos, anc=anc)
    return _final_norm(stacked, cfg, x)


def prefill_chunk(cfg, stacked, plan, tokens, start, caches, *, tp,
                  lengths=None, q_chunk=1024):
    """One chunk of incremental prefill (see supports_chunked_prefill).

    tokens (B,C) at absolute positions [start, start+C); caches in
    decode_step layout, sequence axes sized to the decode buffer
    (updated in place; positions past it are dropped).  Returns (logits
    (tp,B,Vl) fp32 shard-local taken at position clip(lengths-1-start, 0,
    C-1) within the chunk -- meaningful only for the chunk holding
    lengths-1 -- and the caches)."""
    b, c = tokens.shape
    pos = (int(start) + torch.arange(c, device=tokens.device))[None]
    pos = pos.expand(b, c)
    x = _ext_forward(cfg, stacked, plan, tokens, pos, caches, tp=tp,
                     q_chunk=q_chunk, phase="prefill")
    if lengths is None:
        idx = torch.full((b,), c - 1, dtype=torch.long, device=x.device)
    else:
        idx = (lengths.long() - 1 - int(start)).clamp(0, c - 1)
    xq = x[:, torch.arange(b, device=x.device), idx][:, :, None]
    return serve_logits(stacked, cfg, xq, plan)[:, :, 0], caches


def supports_spec_decode(cfg) -> bool:
    """Self-speculative decoding needs a second sync point per block to
    drop (spd_applicable) and the cache-extension forward that scores
    several drafted tokens in one step (chunked prefill's coverage)."""
    return cfg.spd_applicable and supports_chunked_prefill(cfg)


def _tree_tensors(tree, device):
    """The static (depths, anc) tuples of spec.verify.tree_layout as
    tensors: depths (C,) int64, anc (C,C) bool."""
    depths, anc = tree
    return (torch.tensor(depths, dtype=torch.long, device=device),
            torch.tensor(anc, dtype=torch.bool, device=device))


def verify_step(cfg, stacked, plan, tokens, pos, caches, *, tp,
                q_chunk=1024, tree=None):
    """Multi-token verify forward for speculative decoding on dense
    caches.

    tokens (B,C): the last accepted token and C-1 drafts; pos (B,): each
    row's absolute position of tokens[:, 0] (rows may sit at different
    positions).  Writes token j's K/V at pos+j (in place; slots past the
    buffer dropped) and returns (logits (tp,B,C,Vl) fp32 shard-local --
    entry j scores the token after tokens[:, j] -- and the caches).

    `tree=(depths, anc)` verifies a draft TREE: token j keeps slot pos+j
    but sits at tree position pos+depths[j] (RoPE, learned positions) and
    attends committed history plus its in-chunk ancestors.

    Rollback: rejected-suffix K/V stays in the cache but is never
    causally visible and is overwritten when the position counter passes
    it again, so dense rollback is the scheduler rewinding pos."""
    c = tokens.shape[1]
    spos2 = pos.long()[:, None] + torch.arange(c, device=pos.device)[None]
    if tree is None:
        pos2, spos, anc = spos2, None, None
    else:
        depths, anc = _tree_tensors(tree, pos.device)
        pos2 = pos.long()[:, None] + depths[None]
        spos = spos2
    x = _ext_forward(cfg, stacked, plan, tokens, pos2, caches, tp=tp,
                     q_chunk=q_chunk, phase="verify", spos=spos, anc=anc)
    return serve_logits(stacked, cfg, x, plan), caches


def supports_paged_attention(cfg) -> bool:
    """Whether the fused paged forward (paged_step / blocks.block_page)
    covers `cfg`: full-causal GQA stacks (MLP or MoE FFNs) with fp KV
    caches, whose every cache leaf is a {"k","v"} page pool.  Other stacks
    (int8 KV, MLA, windowed, hybrid, SSM) page through the gather ->
    dense step -> scatter fallback of runtime/forward.py, as in the
    reference."""
    return supports_chunked_prefill(cfg) and cfg.kv_dtype != "int8"


def paged_step(cfg, stacked, plan, tokens, pos, caches, page_table, *, tp,
               tree=None):
    """Fused paged forward: decode (C=1), suffix prefill and speculative
    verify (C>1).

    tokens (B, C) at per-row absolute positions pos (B,)..pos+C-1;
    caches per segment hold paged K/V pools (tp, layers, P+1, ps, HkvL,
    dh) shared across slots, written in place; page_table (B, n) int
    (-1 = unallocated).  Returns (logits (tp, B, C, Vl) fp32 shard-local
    -- entry j scores the token after tokens[:, j] -- and the caches).
    Every C logs under phase "decode", as the reference does.
    `tree=(depths, anc)` switches the chunk to tree verification as in
    `verify_step` (the scatter stays chunk-contiguous, so a tree chunk
    rolls back as a chain does)."""
    lay = _gqa_layout(cfg, tp)
    x = embed_tokens(stacked["emb"], tokens)
    c = tokens.shape[1]
    if tree is None:
        depths = anc = None
        pos2 = pos[:, None] + torch.arange(c, device=pos.device)[None]
    else:
        depths, anc = _tree_tensors(tree, pos.device)
        pos2 = pos.long()[:, None] + depths[None]
    x = _add_positions(stacked, cfg, x, pos2)
    for seg_i, (start, length, kind, dropped) in enumerate(
            plan_segments(cfg, plan.drop_mask, plan.qmodes)):
        sp, cs = stacked["segs"][seg_i], caches[seg_i]
        with ledger_scale(length), comm_context(block=start, phase="decode"):
            for j in range(length):
                with ledger_paused(j > 0):
                    x, _ = B.block_page(cfg, kind, lay, _layer(sp, j), x,
                                        pos, _layer(cs, j), page_table,
                                        drop=dropped,
                                        comm=plan.block_mode(start),
                                        depths=depths, anc=anc)
    x = _final_norm(stacked, cfg, x)
    return serve_logits(stacked, cfg, x, plan), caches


# ---------------------------------------------------------------------------
# Cache allocation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheStruct:
    """Shape and dtype of one cache leaf (shard-logical: head axes carry
    the full padded head count; backends split it)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_struct(cfg, plan: SPDPlanConfig, batch: int, seq_len: int,
                 tp: int):
    """Per segment CacheStructs (shard-logical: head axes carry the full
    padded head count).  Attention layers: {"k","v"} (layers, batch,
    S_kv, kv_layout, dh), S_kv = seq_len, or min(window, seq_len) on a
    windowed layer (its rolling buffer); an int8 KV cache holds int8
    codes and bf16 scales {"k_s","v_s"} (layers, batch, S_kv, kv_layout).
    MLA layers: {"c" (layers, batch, seq_len, kv_lora_rank), "kr" (...,
    qk_rope_head_dim)} in the model dtype (kv_dtype does not apply, as in
    the reference).  SSM layers: {"state" (layers, batch, H_pad, P, N),
    "conv" {"x" (layers, batch, d_conv-1, H_pad*P), "bc" (layers, batch,
    d_conv-1, 2*G*N)}}, no sequence axis; H_pad the q-head layout's h_pad
    on a hybrid layer, which holds both trees."""
    lay = _gqa_layout(cfg, tp)
    dt = B.torch_dtype(cfg)
    out = []
    for (_, length, kind, _) in plan_segments(cfg, plan.drop_mask,
                                              plan.qmodes):
        lead = (length, batch)
        seg = {}
        if kind.mixer in ("ssm", "hybrid"):
            s = cfg.ssm
            hp = (lay.h_pad if kind.mixer == "hybrid"
                  else -(-B.ssm_heads(cfg) // tp) * tp)
            seg["state"] = CacheStruct(lead + (hp, s.head_dim, s.d_state), dt)
            seg["conv"] = {
                "x": CacheStruct(lead + (s.d_conv - 1, hp * s.head_dim), dt),
                "bc": CacheStruct(lead + (s.d_conv - 1,
                                          2 * s.n_groups * s.d_state), dt)}
        if kind.mixer == "mla":
            m = cfg.mla
            seg.update(c=CacheStruct(lead + (seq_len, m.kv_lora_rank), dt),
                       kr=CacheStruct(lead + (seq_len, m.qk_rope_head_dim),
                                      dt))
        if kind.mixer in ("gqa", "hybrid"):
            s_kv = min(kind.window, seq_len) if kind.window else seq_len
            kv = lead + (s_kv, lay.kv_layout)
            if cfg.kv_dtype == "int8":
                seg.update(k=CacheStruct(kv + (cfg.d_head,), torch.int8),
                           v=CacheStruct(kv + (cfg.d_head,), torch.int8),
                           k_s=CacheStruct(kv, torch.bfloat16),
                           v_s=CacheStruct(kv, torch.bfloat16))
            else:
                seg.update(k=CacheStruct(kv + (cfg.d_head,), dt),
                           v=CacheStruct(kv + (cfg.d_head,), dt))
        out.append(seg)
    return out


def cache_specs_tree(cfg, plan: SPDPlanConfig):
    """Split axis of each cache leaf in the cache_struct layout: the kv
    heads (axis 3), MLA's latent and rope key replicated."""
    out = []
    for (_, _, kind, _) in plan_segments(cfg, plan.drop_mask, plan.qmodes):
        seg = {}
        if kind.mixer in ("ssm", "hybrid"):
            seg.update(state=2, conv={"x": 3, "bc": REPLICATED})
        if kind.mixer == "mla":
            seg.update(c=REPLICATED, kr=REPLICATED)
        if kind.mixer in ("gqa", "hybrid"):
            seg.update(k=3, v=3)
            if cfg.kv_dtype == "int8":
                seg.update(k_s=3, v_s=3)
        out.append(seg)
    return out


def cache_pageable_tree(cfg, plan: SPDPlanConfig):
    """Which cache leaves get PAGED (bool tree matching cache_struct): the
    leaves with a full-length sequence axis -- full-causal layers' K/V
    (and their int8 scales) and MLA's latent and rope key.  Rolling-window
    K/V (already bounded to the window), SSM state and conv tails (no
    sequence axis) stay dense per slot."""
    out = []
    for (_, _, kind, _) in plan_segments(cfg, plan.drop_mask, plan.qmodes):
        seg = {}
        if kind.mixer in ("ssm", "hybrid"):
            seg.update(state=False, conv={"x": False, "bc": False})
        if kind.mixer == "mla":
            seg.update(c=True, kr=True)
        if kind.mixer in ("gqa", "hybrid"):
            names = (("k", "v", "k_s", "v_s") if cfg.kv_dtype == "int8"
                     else ("k", "v"))
            seg.update(dict.fromkeys(names, kind.window == 0))
        out.append(seg)
    return out


def paged_cache_struct(cfg, plan: SPDPlanConfig, batch: int, seq_len: int,
                       tp: int, *, page_size: int, num_pages: int):
    """cache_struct with pageable leaves' (batch, seq) axes replaced by
    (num_pages + 1, page_size); the extra page is the trash page (see
    runtime/paging.py).  Dense leaves keep (batch, ...); the kv-head
    axis stays axis 3, so `cache_specs_tree` splits paged and dense
    leaves alike."""
    structs = cache_struct(cfg, plan, batch, seq_len, tp)
    flags = cache_pageable_tree(cfg, plan)

    def one(f, s):
        if not f:
            return s
        return CacheStruct((s.shape[0], num_pages + 1, page_size)
                           + s.shape[3:], s.dtype)

    return [tree_map(one, f, s) for f, s in zip(flags, structs)]
