"""What one product call per shard would cost the sim engine against its
one batched call (run on the GPU host from the repo root):

    python3 scripts/torch_sim_products_cost.py

The sim engine multiplies the stacked shards of each per-shard product
in one batched call: `torch.bmm` in `core/blocks._mm` ((tp, m, k) @ (tp,
k, n) weights) and `torch.einsum` in the plain attention
(`models/attention._gqa_scores` / `_gqa_combine`, the decode
attention).  cuBLAS picks its algorithm by the batch count, so shard i
of a batched call can round otherwise than a rank of the shard engine
multiplying its one shard alone (`scripts/torch_shard_bits.py`).  One
call per shard would give sim a rank's bits, at tp calls a product
instead of one.  This prints, in one process, at chip_smoke's main-path
settings (tp 2, spd 0.25, quant8 kept syncs and logits gather, bf16,
flash prefill, prompts of 17, 64, 200 and 300 tokens, 16 greedy tokens
each), `decode_ms_per_token` and `prefill_ms` of SmolLM-360M and
LLaMA2-7B and the ms of a SmolLM-360M training step (chip_smoke's
training settings) with the batched form (the engine's own) and with
the per-shard form (patched in here), in the order batched, per-shard,
per-shard, batched.
"""
from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

ORDER = ("batched", "per-shard", "per-shard", "batched")
TRAIN_STEPS = 3


def per_shard_bmm(a, b):
    """(tp, m, k) @ (tp, k, n), one `torch.mm` a shard."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return torch.stack([torch.mm(a[i], b[i]) for i in range(a.shape[0])])
    out = a.new_empty((a.shape[0], a.shape[1], b.shape[2]))
    for i in range(a.shape[0]):
        torch.mm(a[i], b[i], out=out[i])
    return out


def per_shard_mm(h, w):
    """blocks._mm with one product a shard."""
    tp, din = h.shape[0], h.shape[-1]
    if isinstance(w, dict):
        out = per_shard_bmm(h.reshape(tp, -1, din), w["q"].to(h.dtype))
        out = out * w["s"].to(h.dtype)[:, None, :]
    else:
        out = per_shard_bmm(h.reshape(tp, -1, din), w)
    return out.reshape(tuple(h.shape[:-1]) + (out.shape[-1],))


def per_shard(fn):
    """An attention product one index of the leading (shard) axis at a
    time where both operands carry it (the decode attention's operands,
    (tp, B, ...)); as it is elsewhere."""
    def call(a, b):
        if a.dim() < 5 or b.dim() != a.dim() or b.shape[0] != a.shape[0]:
            return fn(a, b)
        return torch.stack([fn(a[i], b[i]) for i in range(a.shape[0])])
    return call


@contextlib.contextmanager
def form(name):
    """The per-shard form patched into blocks and attention, or nothing."""
    from repro_torch.core import blocks as B
    from repro_torch.models import attention as A
    if name == "batched":
        yield
        return
    saved = B._mm, A._gqa_scores, A._gqa_combine
    B._mm = per_shard_mm
    A._gqa_scores, A._gqa_combine = per_shard(saved[1]), per_shard(saved[2])
    try:
        yield
    finally:
        B._mm, A._gqa_scores, A._gqa_combine = saved


def serve_times(arch, card):
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config

    cfg = replace(get_config(arch), attn_backend="pallas")
    llm = LLM.load(cfg, tp=2, spd=0.25, comm="quant8", comm_logits="quant8",
                   dtype="bfloat16", cache_len=512, max_batch=4, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in CS.PROMPT_LENS]
    times = CS.timed_engine(torch, llm.engine)
    out = []
    for name in ORDER:
        with form(name):
            llm.generate([prompts[0][:8]], SamplingParams(max_new=2))
            for v in times.values():
                v.clear()
            toks = [o.token_ids for o in llm.generate(
                prompts, SamplingParams(max_new=CS.MAX_NEW))]
        dec = times["decode"]
        row = dict(arch=arch, form=name,
                   decode_ms_per_token=1e3 * sum(dec) / len(dec),
                   prefill_ms=1e3 * sum(times["prefill"]), steps=len(dec),
                   tokens=toks)
        out.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "tokens"}),
              flush=True)
    same = sum(a == b for r in out[1:] for t, u in zip(r["tokens"],
                                                       out[0]["tokens"])
               for a, b in zip(t, u))
    print(f"{arch} [{card}]: tokens of the other three runs equal to the "
          f"first's: {same}/{3 * sum(len(t) for t in out[0]['tokens'])}")
    del llm
    CS.release(torch)
    return out


def train_times(card):
    from repro_torch.config.base import replace
    from repro_torch.core import model as M

    cfg = replace(CS.train_cfg(), dtype="bfloat16", attn_backend="pallas")
    canon = M.init_model(cfg, seed=0, device=torch.device("cuda"))
    out = []
    with tempfile.TemporaryDirectory() as root:
        for i, name in enumerate(ORDER):
            with form(name):
                tr, st = CS.trainer_for(root, f"{i}", canon,
                                        steps=TRAIN_STEPS, ckpt_every=0)
                tr.run(st)
            walls = [m["wall"] for m in tr.metrics_log]
            row = dict(arch=cfg.name, layers=cfg.n_layers, form=name,
                       step_ms=1e3 * float(np.mean(walls[1:])),
                       first_step_ms=1e3 * walls[0],
                       losses=[m["loss"] for m in tr.metrics_log])
            out.append(row)
            print(json.dumps(row), flush=True)
            del tr, st
            CS.release(torch)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sim_products_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    rows = serve_times("smollm-360m", card)
    rows += serve_times("llama2-7b", card)
    rows += train_times(card)
    summary = {}
    for r in rows:
        key = f"{r['arch']} {r['form']}"
        for m in ("decode_ms_per_token", "prefill_ms", "step_ms"):
            if m in r:
                summary.setdefault(key, {}).setdefault(m, []).append(r[m])
    print(f"card: {card}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
