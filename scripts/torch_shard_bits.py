"""Which per-shard products give other bits for one shard than for two
stacked (run on the GPU host from the repo root):

    python3 scripts/torch_shard_bits.py

The sim engine computes a (tp, ...) product in one batched call; a rank
of the shard engine computes its (1, ...) slice alone.  For LLaMA2-7B's
shapes at tp 2 (bf16 weight products of a batch-4 decode step and of
prefill buckets; the fp32 decode attention's einsums) this prints, for
each product, whether shard 1 of the stacked call equals the call on
shard 1 alone bit for bit, and the same for the per-shard form
(`torch.mm` on each shard's slice).
"""
from __future__ import annotations

import json
import subprocess

import torch


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d, ff, vl = 4096, 11008 // 2, 16000
    out = {}
    for m in (4, 17, 32, 64, 256, 512):
        for k, n in ((d, d // 2), (d // 2, d), (d, ff), (ff, d), (d, vl)):
            h = torch.randn(2, m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            w = (torch.randn(2, k, n, generator=gen, device=dev)
                 / k ** 0.5).to(torch.bfloat16)
            both = torch.bmm(h, w)[1]
            one = torch.bmm(h[1:], w[1:])[0]
            mm = torch.mm(h[1], w[1])
            out[f"bmm m{m} k{k} n{n}"] = dict(
                stacked_vs_alone=bool(torch.equal(both, one)),
                mm_vs_bmm_alone=bool(torch.equal(mm, one)))
    for s in (64, 512):
        q = torch.randn(2, 4, 1, 16, 1, 128, generator=gen, device=dev)
        kk = torch.randn(2, 4, s, 16, 128, generator=gen, device=dev)
        both = torch.einsum("...qhgd,...khd->...hgqk", q, kk)[1]
        one = torch.einsum("...qhgd,...khd->...hgqk", q[1:], kk[1:])[0]
        out[f"attention scores s{s}"] = dict(
            stacked_vs_alone=bool(torch.equal(both, one)))
        p = torch.softmax(both, -1)
        v = torch.randn(2, 4, s, 16, 128, generator=gen, device=dev)
        pp = torch.stack([p, p])
        both = torch.einsum("...hgqk,...khd->...qhgd", pp, v)[1]
        one = torch.einsum("...hgqk,...khd->...qhgd", pp[1:], v[1:])[0]
        out[f"attention values s{s}"] = dict(
            stacked_vs_alone=bool(torch.equal(both, one)))
    for key, val in out.items():
        print(json.dumps({key: val}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
