"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, and builds every kernel from src/repro_torch/csrc with nvcc
   (one process per source, in parallel) into build/.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at the serving path's shapes, with the stated
   tolerance; timed with CUDA events beside its plain version, a
   library call where one exists, and its bound on the card.
3. Main path: full-width SmolLM-360M through LLM.load(tp=2, spd=0.25,
   kept syncs and logits gather at quant8, flash prefill) -> generate on
   4 seeded prompts, 16 greedy tokens each.  Every kernel's launch count
   is zeroed just before and read just after; each must be > 0.
   A profiled generate then shows the device-busy share and the top
   kernels by device time.
4. Teacher-forced check: one prompt's prefill logits with the flash
   kernel ("pallas") against the plain attention ("xla") on the same
   parameters, in bf16 and in fp32.
5. Prints the kernels JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failure raises (non-zero exit, no result line).  Without a CUDA
device it exits non-zero at once.  Weights are random, from a seed.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# card peaks for the bound (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

FLASH_SHAPES = (16, 100, 512)          # S; q (2*1*9, S, 64), kv (2*1*3, S, 64)
FLASH_FP32_ATOL = 2e-5                 # fp32 online vs one-shot softmax
QDQ_NS = (960, 3840, 16 * 960, 24576)  # (2, N) payloads; bit-identical
PROMPT_LENS = (17, 64, 200, 300)
MAX_NEW = 16
# prefill logits, flash kernel vs plain attention through 32 layers
# (exact syncs): bf16 rounds each layer's attention output differently
# (2^-8 relative per layer), fp32 only reorders sums
TF_BF16_REL = 0.05                     # x max |logit|
TF_FP32_ATOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(torch, fn, iters=50, warmup=5) -> float:
    """Mean device time of fn over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bh, bhkv, d = 2 * 1 * 9, 2 * 1 * 3, 64
    timed = None
    for dtype in (torch.bfloat16, torch.float32):
        for s in FLASH_SHAPES:
            q = torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(bhkv, s, d, generator=gen, device=dev).to(dtype)
            v = torch.randn(bhkv, s, d, generator=gen, device=dev).to(dtype)
            out = FA.flash_attention_bhsd(q, k, v)
            ref = FA.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
                   2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3))
            print(f"flash {str(dtype)[6:]} S={s}: max_abs_err={err:.3e} "
                  f"tol={tol:.3e}")
            if not err <= tol:
                raise AssertionError(f"flash kernel disagrees at {dtype} "
                                     f"S={s}: {err} > {tol}")
            if dtype == torch.bfloat16 and s == max(FLASH_SHAPES):
                timed = (q, k, v, err)
    q, k, v, err = timed
    s = q.shape[1]
    ms = cuda_ms(torch, lambda: FA.flash_attention_bhsd(q, k, v))
    plain_ms = cuda_ms(torch, lambda: FA.flash_attention_plain(q, k, v))
    q4 = q.view(2, 9, s, d)
    k4, v4 = k.view(2, 3, s, d), v.view(2, 3, s, d)
    try:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True, enable_gqa=True)
        lib()
    except TypeError:                  # torch without enable_gqa
        k4r, v4r = k4.repeat_interleave(3, 1), v4.repeat_interleave(3, 1)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4r, v4r, is_causal=True)
    library_ms = cuda_ms(torch, lib)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4.0 * bh * (s * (s + 1) / 2) * d   # QK^T and PV, causal half
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:187",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "shape": f"q ({bh},{s},{d}) kv ({bhkv},{s},{d}) bf16"}


def qdq_phase(torch):
    from repro_torch.kernels import quant_collectives as QC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    timed = None
    for n in QDQ_NS:
        x = torch.randn(2, n, generator=gen, device=dev)
        x[1] *= 10.0
        for levels in (127, 7):
            out = QC.qdq_absmax(x, levels=levels)
            ref = QC.qdq_absmax_plain(x, levels=levels)
            torch.cuda.synchronize()
            same = torch.equal(out, ref)
            err = (out - ref).abs().max().item()
            print(f"qdq (2,{n}) L={levels}: bit-identical={same}")
            if not same:
                raise AssertionError(f"qdq kernel not bit-identical at "
                                     f"(2,{n}) L={levels}: {err}")
            if n == 3840 and levels == 127:
                timed = (x, err)
    x, err = timed
    ms = cuda_ms(torch, lambda: QC.qdq_absmax(x, levels=127), iters=200)
    plain_ms = cuda_ms(torch, lambda: QC.qdq_absmax_plain(x, levels=127),
                       iters=200)
    nbytes = 2 * x.numel() * 4          # read x, write y
    flops = 7.0 * x.numel()             # abs, max, div, rint, 2 clamps, mul
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    return {"name": "qdq_absmax", "route": "cuda",
            "source": "src/repro_torch/csrc/quant_collectives.cu",
            "replaces": "src/repro/kernels/quant_collectives.py:73",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": "(2,3840) fp32, a decode step's kept sync"}


def timed_engine(torch, engine):
    """Wrap the engine's prefill/decode with synchronized host timers."""
    times = {"prefill": [], "decode": []}
    for name in ("prefill", "decode"):
        fn = getattr(engine, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_name].append(time.perf_counter() - t0)
            return out
        setattr(engine, name, wrapped)
    return times


def main_path(torch, np, card):
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC

    cfg = replace(get_config("smollm-360m"), attn_backend="pallas")
    t0 = time.perf_counter()
    llm = LLM.load(cfg, tp=2, spd=0.25, comm="quant8", comm_logits="quant8",
                   dtype="bfloat16", cache_len=512, max_batch=4, seed=0)
    torch.cuda.synchronize()
    print(f"main path: loaded {cfg.name} (L={cfg.n_layers} d={cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} -> "
          f"{llm.engine.tp}x{len(llm.params['segs'])} segments) in "
          f"{time.perf_counter() - t0:.1f} s; plan drops "
          f"{llm.plan.n_dropped}/{cfg.n_layers} syncs")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))   # warm-up
    times = timed_engine(torch, llm.engine)

    FA.flash_attention_bhsd.launches = 0
    QC.qdq_absmax.launches = 0
    t0 = time.perf_counter()
    outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_bhsd": FA.flash_attention_bhsd.launches,
                "qdq_absmax": QC.qdq_absmax.launches}

    for o, p in zip(outs, prompts):
        if (o.finish_reason != "length" or len(o.token_ids) != MAX_NEW
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids)):
            raise AssertionError(f"request {o.index} (prompt {len(p)}) "
                                 f"did not finish cleanly: {o}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    n_tok = sum(len(o.token_ids) for o in outs)
    prefill_ms = 1e3 * sum(times["prefill"])
    decode_ms = 1e3 * sum(times["decode"]) / max(len(times["decode"]), 1)
    print(f"main path launches: {json.dumps(launches)}")
    print(f"main path [{card}]: prefill_ms={prefill_ms:.2f} "
          f"(4 requests, prompts {list(PROMPT_LENS)}) "
          f"decode_ms_per_token={decode_ms:.2f} (one batch-4 decode step "
          f"per token of each request, {len(times['decode'])} steps) "
          f"tokens_per_s={n_tok / wall:.1f} "
          f"({n_tok} tokens in {wall:.2f} s)")
    print("main path tokens[0]:", outs[0].token_ids)
    return llm, prompts, launches


def profile_phase(torch, llm, prompts, card):
    """Where the main path's time goes: one more generate (4 prompts, 4
    tokens each) under torch.profiler; device-busy share of the wall time
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import SamplingParams

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts, SamplingParams(max_new=4))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies); a CPU op also
        # reports its kernels' time, which would count them twice
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print("profile: the profiler saw no device time")
        return
    rows.sort(reverse=True)
    print(f"profile [{card}]: generate 4x4 tokens wall_ms={wall_us / 1e3:.1f} "
          f"device_busy_ms={busy_us / 1e3:.1f} "
          f"device_idle_share={1 - busy_us / wall_us:.3f} "
          f"device_ops={sum(r[1] for r in rows)}")
    for dev_us, count, key in rows[:8]:
        print(f"  profile top: {dev_us / 1e3:8.2f} ms {count:6d}x {key[:90]}")
    for name in ("flash_fwd_kernel", "qdq_kernel"):   # the port's own
        hits = [(us, n) for us, n, key in rows if name in key]
        us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
        if n:
            print(f"  profile kernel: {name} {n}x, device "
                  f"{us / n:.2f} us per launch")


def teacher_forced(torch, llm, prompt):
    """Prefill logits with the flash kernel vs the plain attention, same
    canonical weights and drop mask, in the serving dtype (bf16) and in
    fp32.  The syncs run exact here: a quantized sync turns a last-ulp
    difference into a whole quant step (a flipped code), which would
    measure the quantizer, not the attention kernel."""
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.core import blocks as B
    from repro_torch.runtime.forward import bucketed_prefill
    from repro_torch.tree import tree_map

    for dtype in ("bfloat16", "float32"):
        logits = {}
        for backend in ("pallas", "xla"):
            cfg = replace(llm.cfg, attn_backend=backend, dtype=dtype)
            params = tree_map(lambda w: w.to(B.TORCH_DTYPES[dtype]),
                              llm.canonical)
            other = LLM.load(cfg, tp=2, plan=llm.plan.with_comm(None),
                             cache_len=512, max_batch=1, params=params)
            lg, _ = bucketed_prefill(other.engine, other.params, prompt,
                                     len(prompt), 512)
            logits[backend] = lg.float()
            del other
        err = (logits["pallas"] - logits["xla"]).abs().max().item()
        scale = logits["xla"].abs().max().item()
        tol = TF_BF16_REL * scale if dtype == "bfloat16" else TF_FP32_ATOL
        same_top = int(logits["pallas"].argmax()) == int(logits["xla"].argmax())
        print(f"teacher-forced prefill ({len(prompt)} tokens, {dtype}): "
              f"max_abs_err={err:.3e} tol={tol:.3e} max|logit|={scale:.3e} "
              f"same argmax={same_top}")
        if not err <= tol:
            raise AssertionError(f"pallas vs xla prefill logits disagree "
                                 f"({dtype}): {err} > {tol}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({', '.join(reports) or 'cached'})")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    kernels = [flash_phase(torch), qdq_phase(torch)]
    llm, prompts, launches = main_path(torch, np, card)
    profile_phase(torch, llm, prompts, card)
    teacher_forced(torch, llm, prompts[2])

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(f"card: {card}")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys}
                                  for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
