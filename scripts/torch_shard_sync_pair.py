"""The quantized kept sync across ranks as two launches (the engine's own)
against the transport it replaced, in one call on one card (run on the GPU host
from the repo root):

    python3 scripts/torch_shard_sync_pair.py

Two shard ranks on card 0 over gloo, as chip_smoke's shard phase (b), at
its settings (SmolLM-360M at full width, tp 2, spd 0.25, quant8 kept
syncs and logits gather, bf16, prompts of 17, 64, 200 and 300 tokens, 16
greedy tokens each), load the model once and then serve the same
requests in the order new, old, old, new, twice.  "new" is the engine's
sync (the send kernel, one all-gather into a (tp, m) tensor, the receive
kernel); "old" is the replaced one, patched in here (the cast, B4, a packed
all-gather, B6 once a rank from +0, B3, the cast back).  Each run prints
rank 0's decode_ms_per_token and prefill_ms (host timers around the
engine's synchronized steps) and its kept-sync launches.  The two
transports give the same bits, so every run's tokens must equal the
first run's on both ranks.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

ORDER = ("new", "old", "old", "new") * 2


def old_two_hops(flat, levels: int, chunk: int):
    """The quantized kept sync across ranks that the two kernels replaced."""
    import torch.distributed as dist

    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel.collectives import current_group

    ctx = current_group()
    q, s = QC.quantize_absmax(flat.float().contiguous(), levels=levels,
                              chunk=chunk)
    n = q.shape[1]
    msg = torch.cat([q.reshape(-1), s.reshape(-1).view(torch.int8)])
    parts = [torch.empty_like(msg) for _ in range(ctx.size)]
    dist.all_gather(parts, msg, group=ctx.group)
    got = torch.stack(parts)
    qa = got[:, :n].contiguous()
    sa = got[:, n:].contiguous().view(torch.float32)
    acc = torch.zeros_like(flat, dtype=torch.float32)
    for r in range(ctx.size):
        acc = QC.dequant_accum_absmax(qa[r:r + 1], sa[r:r + 1], acc,
                                      chunk=chunk)
    return QC.qdq_absmax(acc, levels=levels, chunk=chunk).to(flat.dtype)


def rank_fn(rank):
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.dist import init_tp
    from repro_torch.parallel import compression as C

    torch.backends.cuda.matmul.allow_tf32 = False
    init_tp(2, 1, backend="gloo", device="cuda:0")
    cfg = replace(get_config("smollm-360m"), attn_backend="pallas")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in CS.PROMPT_LENS]
    llm = LLM.load(cfg, engine="shard", **CS.SHARD_KW)
    llm.engine.backend.check_agreement = True
    llm.generate(prompts, SamplingParams(max_new=2))   # every shape once
    times = CS.timed_engine(torch, llm.engine)
    kernels = CS.all_kernels()
    new = C._two_hops
    out = []
    for form in ORDER:
        C._two_hops = new if form == "new" else old_two_hops
        llm.generate([prompts[0][:8]], SamplingParams(max_new=2))  # warm
        for v in times.values():
            v.clear()
        for k in kernels:
            k.launches = 0
        outs = llm.generate(prompts, SamplingParams(max_new=CS.MAX_NEW))
        torch.cuda.synchronize()
        out.append(dict(
            form=form, decode_ms=1e3 * float(np.mean(times["decode"])),
            prefill_ms=1e3 * sum(times["prefill"]),
            steps=len(times["decode"]),
            tokens=[o.token_ids for o in outs],
            launches={k.__name__: k.launches for k in kernels
                      if k.launches}))
    C._two_hops = new
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch.dist import spawn

    build.build_all()                  # the ranks only load the kernels
    card = CS.card_line()
    ranks = spawn(rank_fn, 2, backend="gloo", device="cuda:0",
                  deadline_s=CS.SHARD_DEADLINE_S, timeout_s=300)
    first = ranks[0][0]["tokens"]
    for r, runs in enumerate(ranks):
        for i, run in enumerate(runs):
            if run["tokens"] != first:
                raise AssertionError(f"rank {r} run {i} ({run['form']}): "
                                     "tokens differ from the first run's")
    for i, run in enumerate(ranks[0]):
        print(f"run {i} {run['form']} [{card}]: decode_ms_per_token="
              f"{run['decode_ms']:.2f} ({run['steps']} steps) prefill_ms="
              f"{run['prefill_ms']:.2f} launches {json.dumps(run['launches'])}")
    for form in ("new", "old"):
        dec = [run["decode_ms"] for run in ranks[0] if run["form"] == form]
        pre = [run["prefill_ms"] for run in ranks[0] if run["form"] == form]
        print(f"{form} [{card}]: decode_ms_per_token median "
              f"{float(np.median(dec)):.2f} (runs {', '.join(f'{d:.2f}' for d in dec)}); "
              f"prefill_ms median {float(np.median(pre)):.2f}")
    print("tokens equal on both ranks in every run: True")
    return 0


if __name__ == "__main__":
    sys.exit(main())
