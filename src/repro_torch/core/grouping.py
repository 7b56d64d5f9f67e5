"""SPD-aware attention head grouping — the paper's §4.2.4 (ESB recovery)
(port of repro/core/grouping.py).

Two steps, both realised as WEIGHT PERMUTATIONS (runtime code unchanged):

* Head scattering (Eq 2): partition heads into tp groups maximising the
  intra-group sum of pairwise euclidean distances between per-head
  attention-score vectors (anti-clustering: functionally diverse heads
  land on every device).
* MLP matching (Eq 3): assign head groups to MLP shards maximising
  Σ ||MLP_m(A_i)|| via an exact bitmask-DP assignment (tp ≤ 16).

GQA adaptation: the movable unit is a KV GROUP (a kv head moves with
all its query heads); with n_kv == n_heads (the paper's MHA models) it
is the paper's per-head method.  For MLA the unit is one head over the
shared latent (its rows of `wq`, `wuk`, `wuv` and `wo` move; `wdkv` and
`lnorm` are replicated and stay).  The features and the MLP scores are
torch on the device, in the model's dtype as the reference's are; the
combinatorial parts (the greedy anti-clustering with its pairwise-swap
search, the bitmask DP) are the reference's numpy.  Layers without a
supported grouping (kv < tp replication, a MoE FFN, hybrid and SSM
mixers) return the identity grouping with `supported=False`, as the
reference's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.layer_kinds import LayerKind
from repro_torch.models.attention import attend, causal_mask
from repro_torch.models.common import act_fn, apply_rope, norm_apply, rmsnorm


@dataclass
class GroupingResult:
    supported: bool
    groups: List[List[int]]        # per device: unit indices
    assignment: List[int]          # assignment[m] = group index on MLP shard m
    score: float


def _positions(b: int, s: int, dev):
    return torch.arange(s, device=dev).expand(b, s)


def _qkv_heads(cfg, a, h, pos, *, with_v: bool):
    """Canonical (unsplit) projections -> q (B,S,H,dh), k [, v]
    (B,S,Hkv,dh) after qk-norm and RoPE, in the model dtype."""
    b, s = h.shape[:2]
    dh = cfg.d_head
    q, k = h @ a["wq"], h @ a["wk"]
    v = h @ a["wv"] if with_v else None
    if cfg.qkv_bias:
        q, k = q + a["bq"], k + a["bk"]
        v = v + a["bv"] if with_v else None
    q = q.reshape(b, s, cfg.n_heads, dh)
    k = k.reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, a["qn"], cfg.norm_eps)
        k = rmsnorm(k, a["kn"], cfg.norm_eps)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_fraction)
    if with_v:
        v = v.reshape(b, s, cfg.n_kv_heads, dh)
    return q, k, v


def _mla_heads(cfg, a, h, pos, *, with_v: bool):
    """MLA's canonical heads -> q (B,S,H,nope+rope), k (B,S,H,nope+rope)
    with the one rope key broadcast over the heads [, v (B,S,H,v_dim)],
    and the score scale (nope + rope)^-1/2."""
    m = cfg.mla
    b, s = h.shape[:2]
    hq = cfg.n_heads
    q = (h @ a["wq"]).reshape(b, s, hq, -1)
    qn, qr = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    qr = apply_rope(qr, pos, cfg.rope_theta)
    ckr = h @ a["wdkv"]
    c = rmsnorm(ckr[..., :m.kv_lora_rank], a["lnorm"], cfg.norm_eps)
    kr = apply_rope(ckr[..., None, m.kv_lora_rank:], pos, cfg.rope_theta)
    kn = (c @ a["wuk"]).reshape(b, s, hq, m.qk_nope_head_dim)
    k = torch.cat([kn, kr.expand(b, s, hq, m.qk_rope_head_dim)], -1)
    v = (c @ a["wuv"]).reshape(b, s, hq, m.v_head_dim) if with_v else None
    return (torch.cat([qn, qr], -1), k, v,
            (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)


# ---------------------------------------------------------------------------
# Per-head attention-score features (canonical weights, direct math)
# ---------------------------------------------------------------------------

@torch.no_grad()
def head_score_features(cfg: ModelConfig, kind: LayerKind, layer_p: dict,
                        x, *, max_pos: int = 64) -> np.ndarray:
    """x (B,S,d) block input (calibration).  Returns (H, F) per-head
    attention-score vectors (softmax probs, subsampled to max_pos rows),
    fp32 numpy."""
    x = torch.as_tensor(x)
    h = norm_apply(x, layer_p["ln1"], cfg)
    b, s, _ = h.shape
    sp = min(s, max_pos)
    pos = _positions(b, s, x.device)
    if cfg.mla is not None:
        q, k, _, scale = _mla_heads(cfg, layer_p["attn"], h, pos,
                                    with_v=False)
    else:
        q, k, _ = _qkv_heads(cfg, layer_p["attn"], h, pos, with_v=False)
        k = k.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
        scale = cfg.d_head ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q[:, :sp].float(),
                          k[:, :sp].float()) * scale
    mask = torch.ones(sp, sp, dtype=torch.bool, device=x.device).tril()
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)             # (B,H,sp,sp)
    feats = probs.transpose(0, 1).reshape(cfg.n_heads, -1)
    return feats.cpu().numpy()


# ---------------------------------------------------------------------------
# Eq 2: head scattering (greedy anti-clustering over movable units)
# ---------------------------------------------------------------------------

def scatter_units(features: np.ndarray, n_groups: int) -> List[List[int]]:
    """features (U, F) -> n_groups lists of U/n_groups unit indices
    maximising intra-group pairwise distance sums (Eq 2's anti-cluster):
    greedy construction + pairwise-swap local search to a local optimum."""
    u = features.shape[0]
    assert u % n_groups == 0, (u, n_groups)
    cap = u // n_groups
    d2 = ((features[:, None] - features[None]) ** 2).sum(-1)
    dist = np.sqrt(np.maximum(d2, 0.0))
    order = np.argsort(-dist.sum(1), kind="stable")     # most distinct first
    groups: List[List[int]] = [[] for _ in range(n_groups)]
    for unit in order:
        best, best_gain = None, -np.inf
        for gi, g in enumerate(groups):
            if len(g) >= cap:
                continue
            gain = sum(dist[unit, m] for m in g)
            # prefer emptier groups on ties to spread seeds
            gain -= 1e-9 * len(g)
            if gain > best_gain:
                best, best_gain = gi, gain
        groups[best].append(int(unit))

    # ---- swap refinement: exchange units across groups while the total
    # intra-group distance improves (terminates: objective is bounded) ----
    assign = np.empty(u, np.int64)
    for gi, g in enumerate(groups):
        for m in g:
            assign[m] = gi

    def contrib(m, gi):
        return sum(dist[m, x] for x in range(u)
                   if assign[x] == gi and x != m)

    improved = True
    it = 0
    while improved and it < 20:
        improved = False
        it += 1
        for a_ in range(u):
            for b_ in range(a_ + 1, u):
                ga, gb = assign[a_], assign[b_]
                if ga == gb:
                    continue
                # a joins gb\{b}, b joins ga\{a}:
                delta = ((contrib(a_, gb) - dist[a_, b_])
                         + (contrib(b_, ga) - dist[a_, b_])
                         - contrib(a_, ga) - contrib(b_, gb))
                if delta > 1e-12:
                    assign[a_], assign[b_] = gb, ga
                    improved = True
    return [[int(m) for m in range(u) if assign[m] == gi]
            for gi in range(n_groups)]


def intra_group_distance(features: np.ndarray,
                         groups: List[List[int]]) -> float:
    tot = 0.0
    for g in groups:
        for i in range(len(g)):
            for j in range(i + 1, len(g)):
                tot += float(np.linalg.norm(features[g[i]] - features[g[j]]))
    return tot


# ---------------------------------------------------------------------------
# Eq 3: MLP matching (exact max-assignment via bitmask DP)
# ---------------------------------------------------------------------------

def max_assignment(score: np.ndarray) -> List[int]:
    """score (G, M) -> assignment a with a[m] = group for MLP shard m,
    maximising sum_m score[a[m], m].  Exact DP over subsets (G == M ≤ 16)."""
    g, m = score.shape
    assert g == m
    full = 1 << g
    dp = np.full(full, -np.inf)
    par = np.full((full,), -1, np.int64)
    dp[0] = 0.0
    for mask in range(full):
        if dp[mask] == -np.inf:
            continue
        mi = bin(mask).count("1")       # next MLP shard to fill
        if mi == m:
            continue
        for gi in range(g):
            if mask & (1 << gi):
                continue
            nm = mask | (1 << gi)
            val = dp[mask] + score[gi, mi]
            if val > dp[nm]:
                dp[nm] = val
                par[nm] = gi
    out = [0] * m
    mask = full - 1
    for mi in range(m - 1, -1, -1):
        gi = int(par[mask])
        out[mi] = gi
        mask ^= 1 << gi
    return out


@torch.no_grad()
def mlp_match_scores(cfg: ModelConfig, kind: LayerKind, layer_p: dict, x,
                     groups: List[List[int]], units_to_heads) -> np.ndarray:
    """score[gi, m] = mean ||MLP_m(norm2(x + Y_{A_gi}))||.

    Y_{A} = attention output restricted to group A's heads (their wo rows);
    MLP_m = the m-th 1/tp slice of the MLP weights."""
    x = torch.as_tensor(x)
    b, s, d = x.shape
    tp = len(groups)
    a = layer_p["attn"]
    pos = _positions(b, s, x.device)
    h = norm_apply(x, layer_p["ln1"], cfg)
    if cfg.mla is not None:
        q, k, v, scale = _mla_heads(cfg, a, h, pos, with_v=True)
        dh_v = cfg.mla.v_head_dim
    else:
        q, k, v = _qkv_heads(cfg, a, h, pos, with_v=True)
        scale, dh_v = None, cfg.d_head
    o = attend(q, k, v, causal_mask(pos, pos), scale)   # (B,S,H,dh_v)
    wo = a["wo"].reshape(cfg.n_heads, dh_v, d)
    mlp = layer_p["mlp"]
    ffl = mlp["wu"].shape[1] // tp
    act = act_fn(cfg.act)
    out = np.zeros((tp, tp))
    for gi, grp in enumerate(groups):
        hsel = torch.as_tensor(sorted(hh for u in grp
                                      for hh in units_to_heads[u]),
                               device=x.device)
        y = torch.einsum("bshv,hvd->bsd", o[:, :, hsel].float(),
                         wo[hsel].float())
        h2 = norm_apply(x + y.to(x.dtype), layer_p["ln2"], cfg)
        for mi in range(tp):
            sl = slice(mi * ffl, (mi + 1) * ffl)
            up = h2 @ mlp["wu"][:, sl]
            if cfg.mlp_bias:
                up = up + mlp["bu"][sl]
            if cfg.gated_mlp:
                g_ = h2 @ mlp["wg"][:, sl]
                if cfg.mlp_bias and "bg" in mlp:
                    g_ = g_ + mlp["bg"][sl]
                hid = act(g_) * up
            else:
                hid = act(up)
            z = hid @ mlp["wd"][sl]
            out[gi, mi] = float(torch.linalg.vector_norm(
                z.float(), dim=-1).mean())
    return out


# ---------------------------------------------------------------------------
# Grouping + weight permutation
# ---------------------------------------------------------------------------

def _units(cfg: ModelConfig):
    """Movable units -> list of q-head lists (kv-group granularity; one
    head each on MLA)."""
    if cfg.mla is not None:
        return [[h] for h in range(cfg.n_heads)]
    g = cfg.n_heads // cfg.n_kv_heads
    return [list(range(kv * g, (kv + 1) * g)) for kv in range(cfg.n_kv_heads)]


def group_heads(cfg: ModelConfig, kind: LayerKind, layer_p: dict, x,
                tp: int) -> GroupingResult:
    ident = GroupingResult(False, [], list(range(tp)), 0.0)
    if kind.mixer not in ("gqa", "mla") or kind.ffn != "mlp":
        return ident
    units = _units(cfg)
    if len(units) % tp != 0:
        return ident            # kv-replication case: documented fallback
    feats = head_score_features(cfg, kind, layer_p, x)
    unit_feats = np.stack([feats[u].mean(0) for u in units])
    groups = scatter_units(unit_feats, tp)
    score = mlp_match_scores(cfg, kind, layer_p, x, groups, units)
    assignment = max_assignment(score)
    total = float(sum(score[assignment[m], m] for m in range(tp)))
    return GroupingResult(True, groups, assignment, total)


def apply_grouping(layer_p: dict, cfg: ModelConfig, res: GroupingResult,
                   tp: int) -> dict:
    """Permute canonical attention weights so head group res.groups[a[m]]
    lands on device m (MLP weights untouched)."""
    if not res.supported:
        return layer_p
    units = _units(cfg)
    order = [u for m in range(tp) for u in res.groups[res.assignment[m]]]
    a = dict(layer_p["attn"])
    dev = a["wq"].device
    idx = torch.as_tensor([hh for u in order for hh in units[u]],
                          device=dev)
    kv_idx = torch.as_tensor(order, device=dev)   # kv heads, unit order
    dh, d = cfg.d_head, cfg.d_model

    def perm_cols(w, n_heads, sel, width=dh):
        return w.reshape(w.shape[0], n_heads, width)[:, sel].reshape(
            w.shape[0], -1)

    if cfg.mla is not None:       # heads over the shared latent
        m = cfg.mla
        a["wq"] = perm_cols(a["wq"], cfg.n_heads, idx,
                            m.qk_nope_head_dim + m.qk_rope_head_dim)
        a["wuk"] = perm_cols(a["wuk"], cfg.n_heads, idx, m.qk_nope_head_dim)
        a["wuv"] = perm_cols(a["wuv"], cfg.n_heads, idx, m.v_head_dim)
        a["wo"] = a["wo"].reshape(cfg.n_heads, m.v_head_dim, d)[idx].reshape(
            -1, d)
        return dict(layer_p, attn=a)

    def perm_vec(v, n_heads, sel):
        return v.reshape(n_heads, dh)[sel].reshape(-1)

    a["wq"] = perm_cols(a["wq"], cfg.n_heads, idx)
    a["wk"] = perm_cols(a["wk"], cfg.n_kv_heads, kv_idx)
    a["wv"] = perm_cols(a["wv"], cfg.n_kv_heads, kv_idx)
    a["wo"] = a["wo"].reshape(cfg.n_heads, dh, d)[idx].reshape(-1, d)
    if cfg.qkv_bias:
        a["bq"] = perm_vec(a["bq"], cfg.n_heads, idx)
        a["bk"] = perm_vec(a["bk"], cfg.n_kv_heads, kv_idx)
        a["bv"] = perm_vec(a["bv"], cfg.n_kv_heads, kv_idx)
    out = dict(layer_p)
    out["attn"] = a
    return out
