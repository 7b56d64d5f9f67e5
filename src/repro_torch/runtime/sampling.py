"""Token sampling behind every decode (port of repro/runtime/sampling.py).

Greedy is the exact argmax over the full vocab, first index on ties.
Sampling (temperature, top-k, top-p) draws from per-request
`torch.Generator`s: a request's generator is seeded from its seed and
the number of tokens it has generated, so its stream depends only on
those two, never on batching or scheduling (the numbers differ from
JAX's PRNG; the contract is the same).
"""
from __future__ import annotations

import numpy as np
import torch


def greedy_tokens(logits):
    """(B, V) -> (B,) int64; the first maximal index wins."""
    return torch.argmax(logits, dim=-1)


def make_generators(seeds, counts, device):
    """One generator per row, seeded from (seed, count)."""
    return [torch.Generator(device=device).manual_seed(
        (int(s) & 0xFFFFFFFF) * 1_000_003 + int(c))
        for s, c in zip(seeds, counts)]


def draft_generators(seeds, counts, k: int, device):
    """Generators for a speculative round's k draft draws: draw i of a
    row seeds from the count counts * 131 + 17 + i, disjoint from the
    committed-token stream's count (the reference folds the same counts
    into its keys, api/scheduler.py).  Returns k lists of one generator a
    row."""
    counts = np.asarray(counts, np.int64)
    return [make_generators(seeds, counts * 131 + 17 + i, device)
            for i in range(k)]


def sample_core(logits, temperature, top_k, top_p, generators):
    """Per-row sampling step.

    logits (B, V) any float dtype; temperature (B,) (<= 0 = greedy row);
    top_k (B,) (0 disables); top_p (B,) (>= 1 disables); generators one
    per row.  Returns (B,) int64."""
    out = []
    for i in range(logits.shape[0]):
        lg = logits[i].float()
        t, k, p = float(temperature[i]), int(top_k[i]), float(top_p[i])
        if t <= 0.0:
            out.append(torch.argmax(lg))
            continue
        v = lg.shape[-1]
        t_s = max(t, 1e-6)             # as the reference clamps
        desc = torch.sort(lg, descending=True).values
        kth = desc[min(max(k - 1, 0), v - 1)]
        neg = torch.tensor(float("-inf"), device=lg.device)
        desc_scaled = torch.where((k > 0) & (desc < kth), neg, desc) / t_s
        ps = torch.softmax(desc_scaled, dim=-1)
        # nucleus: keep the smallest descending prefix reaching mass p
        # (the top token always survives); applied as a logit threshold
        keep = (torch.cumsum(ps, dim=-1) - ps) < p
        thr = torch.min(torch.where(keep, desc_scaled, -neg))
        scaled = torch.where((k > 0) & (lg < kth), neg, lg) / t_s
        scaled = torch.where(scaled < thr, neg, scaled)
        probs = torch.softmax(scaled, dim=-1)
        out.append(torch.multinomial(probs, 1, generator=generators[i])[0])
    return torch.stack(out)
