"""Acceptance math for self-speculative decoding (a copy of
repro/spec/verify.py: the port imports nothing of the reference, and this
module is host-side numpy in both packages, so the same inputs and the
same `spec_rng` give the same decisions).

The verify forward (runtime/engines.py `verify` / `verify_paged`) scores
the last accepted token plus k drafted tokens in one step and hands the
full-vocab target logits to this module.  Two schemes:

  * greedy rows (temperature <= 0): accept draft i iff it equals the
    target argmax after the accepted prefix; the first mismatch (or the
    position after the last accepted draft) commits the target argmax
    instead, so the committed stream equals plain greedy decoding token
    for token;
  * sampled rows: the rejection scheme (Leviathan et al. / Chen et al.):
    draft d ~ q is accepted with probability min(1, p(d)/q(d)); on
    rejection the replacement comes from max(p - q, 0)/Z, and when every
    draft survives a bonus token is drawn from the target's next
    position.  With q the exact distribution each draft was drawn from,
    the committed tokens are distributed as sampling the target alone.

Both p and q go through `filtered_probs`, the numpy mirror of the
sampling step's temperature / top-k / top-p filtering
(runtime/sampling.py `sample_core`).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["filtered_probs", "accept_greedy", "accept_speculative",
           "spec_rng", "tree_layout", "alt_candidates",
           "accept_greedy_tree", "accept_speculative_tree"]

_TINY = 1e-12


def _softmax(x):
    m = np.max(x)
    if not np.isfinite(m):
        # all -inf (fully filtered) cannot happen: the top token always
        # survives both filters; guard anyway
        return np.full_like(x, 1.0 / x.size)
    e = np.exp(x - m)
    return e / e.sum()


def filtered_probs(logits, temperature: float, top_k: int,
                   top_p: float) -> np.ndarray:
    """One row's sampling distribution under SamplingParams filtering.

    Mirrors `runtime.sampling.sample_core`: temperature <= 0 is greedy
    (a one-hot at the argmax, first index on ties); top-k keeps the k
    highest logits (threshold = k-th largest); top-p keeps the smallest
    descending-probability prefix reaching mass p (top token always
    kept), with the cutoff carried back as a logit threshold.
    """
    lg = np.asarray(logits, np.float64).copy()
    v = lg.shape[-1]
    if temperature <= 0.0:
        p = np.zeros(v)
        p[int(np.argmax(lg))] = 1.0
        return p
    t = max(float(temperature), 1e-6)
    desc = np.sort(lg)[::-1]
    if top_k > 0:
        kth = desc[min(max(int(top_k) - 1, 0), v - 1)]
        lg = np.where(lg < kth, -np.inf, lg)
        desc = np.where(desc < kth, -np.inf, desc)
    ds = desc / t
    ps = _softmax(ds)
    keep = (np.cumsum(ps) - ps) < float(top_p)
    thr = np.min(np.where(keep, ds, np.inf))
    scaled = np.where(lg / t < thr, -np.inf, lg / t)
    return _softmax(scaled)


def spec_rng(seed: int, n_generated: int) -> np.random.Generator:
    """Per-request, per-round RNG: a function of (seed, committed token
    count) only — independent of batch composition and scheduling, like
    the jitted sampling step's fold_in keys."""
    return np.random.default_rng([seed & 0xFFFFFFFF, n_generated])


def accept_greedy(draft_toks, target_argmax) -> Tuple[List[int], int]:
    """Greedy acceptance from argmax ids alone (the all-greedy fast
    path: only (k+1,) ints leave the device, mirroring the fused-greedy
    decode).  target_argmax[i] is the target's argmax after draft i-1
    (i=0: after the accepted prefix).  Identical decisions to
    `accept_speculative` on greedy rows."""
    draft_toks = np.asarray(draft_toks)
    committed: List[int] = []
    for i in range(draft_toks.shape[0]):
        g = int(target_argmax[i])
        committed.append(g)
        if int(draft_toks[i]) != g:
            return committed, i
    committed.append(int(target_argmax[draft_toks.shape[0]]))
    return committed, draft_toks.shape[0]


def accept_speculative(draft_toks, draft_probs, target_logits, *,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0,
                       rng: np.random.Generator | None = None,
                       ) -> Tuple[List[int], int]:
    """One row's acceptance decision.

    draft_toks    (k,)    drafted tokens
    draft_probs   (k, V)  the exact distribution each draft was drawn
                          from (ignored for greedy rows)
    target_logits (k+1, V) verify-forward logits; row i scores the token
                          after draft i-1 (row 0 after the accepted
                          prefix), row k the bonus position
    returns (committed tokens, n_accepted) with len(committed) ==
    n_accepted + 1 — every round commits at least one target-approved
    token, so speculative decoding never stalls.
    """
    draft_toks = np.asarray(draft_toks)
    k = draft_toks.shape[0]
    greedy = temperature <= 0.0
    committed: List[int] = []
    for i in range(k):
        d = int(draft_toks[i])
        if greedy:
            g = int(np.argmax(target_logits[i]))
            if d == g:
                committed.append(d)
                continue
            committed.append(g)
            return committed, i
        p = filtered_probs(target_logits[i], temperature, top_k, top_p)
        q = np.asarray(draft_probs[i], np.float64)
        if rng.random() < p[d] / max(q[d], _TINY):
            committed.append(d)
            continue
        resid = np.maximum(p - q, 0.0)
        z = resid.sum()
        if z <= _TINY:          # q covers p exactly: resample from p
            resid, z = p, p.sum()
        committed.append(int(rng.choice(resid.shape[0], p=resid / z)))
        return committed, i
    # every draft accepted: bonus token from the target's next position
    if greedy:
        committed.append(int(np.argmax(target_logits[k])))
    else:
        p = filtered_probs(target_logits[k], temperature, top_k, top_p)
        committed.append(int(rng.choice(p.shape[0], p=p)))
    return committed, k


# ---------------------------------------------------------------------------
# tree speculation (docs/speculative.md "Tree verification")
# ---------------------------------------------------------------------------
#
# The verify chunk for a width-w tree round is
#
#     [cur, d_1 .. d_k, a_1 .. a_{w-1}]        (C = k + w positions)
#
# where d_1..d_k is the greedy draft CHAIN and a_j are the draft's
# top-2..top-w candidates at the FIRST position only (the cheapest tree
# that can help: position 0 is where rejection is most likely, and a
# depth-1 alternative needs no extra draft forwards).  Chunk token KV
# scatters to DISTINCT cache slots pos..pos+C-1 but attends at its TREE
# position pos+depth (RoPE), seeing committed history plus its in-chunk
# ancestors only — tree_layout builds the static (depths, anc) masks the
# runtime threads through verify_step.


def tree_layout(k: int, width: int):
    """Static (depths, anc) tuples for a k-chain + (width-1)-alternative
    verify chunk; hashable, so one compiled verify serves each (k, w).

    depths[i]  tree depth of chunk token i (cur=0, d_i=i, alts=1) —
               token i attends/encodes at stream position pos+depths[i].
    anc[i][j]  chunk token i may attend chunk token j (self included):
               chain tokens see the chain prefix, each alternative sees
               only cur and itself.
    """
    c = k + width
    depths = [0] + list(range(1, k + 1)) + [1] * (width - 1)
    anc = [[False] * c for _ in range(c)]
    for i in range(k + 1):
        for j in range(i + 1):
            anc[i][j] = True
    for j in range(1, width):
        anc[k + j][0] = anc[k + j][k + j] = True
    return tuple(depths), tuple(tuple(r) for r in anc)


def alt_candidates(logits_row, d1: int, width: int) -> List[int]:
    """Top width-1 first-position candidates excluding the chain draft
    d1 (host-side mirror of the fused tree draft's device top-k, used by
    the sampled path where the draft returns full logits)."""
    order = np.argsort(np.asarray(logits_row))[::-1]
    return [int(t) for t in order if int(t) != int(d1)][:width - 1]


def accept_greedy_tree(draft_toks, alts, target_argmax, alt_argmax
                       ) -> Tuple[List[int], int, int]:
    """Greedy tree acceptance from argmax ids alone.

    Runs the chain scheme first; if the FIRST draft is rejected and the
    target's correction equals one of the verified alternatives, the
    round still commits TWO tokens — the alternative plus the target's
    argmax after it (alt_argmax[j], already scored by the same verify
    forward).  Returns (committed, n_accepted_chain, used_alt) with
    used_alt the 1-based alternative index, 0 when unused — the caller
    must then relocate the alternative's KV from its chunk slot to the
    committed stream position (scheduler copy_pos contract)."""
    committed, n_acc = accept_greedy(draft_toks, target_argmax)
    if n_acc == 0 and alts is not None:
        for j, a in enumerate(np.asarray(alts).tolist()):
            if committed[0] == int(a):
                return [int(a), int(alt_argmax[j])], 0, j + 1
    return committed, n_acc, 0


def accept_speculative_tree(draft_toks, draft_probs, target_logits,
                            alts, alt_logits, *,
                            temperature: float = 0.0, top_k: int = 0,
                            top_p: float = 1.0,
                            rng: np.random.Generator | None = None,
                            ) -> Tuple[List[int], int, int]:
    """Tree acceptance for sampled rows — distribution-preserving.

    The chain runs the standard rejection scheme untouched, so the
    position-0 commit keeps its exact distribution.  Only when the
    residual replacement happens to EQUAL a verified alternative does
    the round commit a second token, drawn from the target's filtered
    distribution after that alternative (alt_logits[j] — exact
    conditional, scored in the same verify forward).  Position 1's
    marginal is the exact conditional either way: committed now from
    alt_logits, or next round by plain decode — so the committed stream
    remains distributed exactly as target-only sampling."""
    committed, n_acc = accept_speculative(
        draft_toks, draft_probs, target_logits, temperature=temperature,
        top_k=top_k, top_p=top_p, rng=rng)
    if n_acc == 0 and alts is not None:
        for j, a in enumerate(np.asarray(alts).tolist()):
            if committed[0] != int(a):
                continue
            if temperature <= 0.0:
                bonus = int(np.argmax(alt_logits[j]))
            else:
                p = filtered_probs(alt_logits[j], temperature, top_k,
                                   top_p)
                bonus = int(rng.choice(p.shape[0], p=p))
            return [int(a), bonus], 0, j + 1
    return committed, n_acc, 0
