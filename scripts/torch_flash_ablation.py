"""Ablations of the bf16 tensor-core flash kernel on one GPU: what sets its
time at the serving shapes.

    python3 scripts/torch_flash_ablation.py

Builds variants of src/repro_torch/csrc/flash_attention.cu, each made by
a textual patch of the source (every patch must apply, or the script
fails): a deeper cp.async ring, and twice a tile's Q K^T products,
exponentials, P V products or K/V loads (the doubled work is arranged so
that the output stays the same).  Each variant is checked against the
plain version within the card tolerance (2^-7 x max|ref|) and timed by
the profiler (device us per launch) at q (18, S, 64), kv (6, S, 64) for
S in 64, 256, 512, and for one q row alone (bh 1, 8 blocks at S 512).
If doubling a piece of work moves the time, that piece is on the
critical path.  Needs a CUDA card and nvcc; exits non-zero without.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (64, 256, 512)

QK = """        mma_bf16(sacc[j], qf[kk], b[0], b[1]);
        mma_bf16(sacc[j + 1], qf[kk], b[2], b[3]);
"""
PV = """        mma_bf16(oacc[j], pa, b[0], b[1]);
        mma_bf16(oacc[j + 1], pa, b[2], b[3]);
"""
LOAD = """      load_tile<D>(ks + (nxt % STAGES) * TK * LD, kg, nxt * TK, s, tid);
      load_tile<D>(vs + (nxt % STAGES) * TK * LD, vg, nxt * TK, s, tid);
"""
RING = "constexpr int STAGES = 2;"
EXP = "const float p0 = exp2f(sacc[j][2 * h] - m_use);"
# each variant: (old, new) replacements of the source
VARIANTS = {
    "base": [],
    "ring3": [(RING, "constexpr int STAGES = 3;")],
    "ring4": [(RING, "constexpr int STAGES = 4;")],
    # sacc accumulates Q K^T twice, then is halved: the same scores
    "dup_qk": [(QK, QK + QK), (
        "    const int k0 = t * TK;\n",
        "    for (int j = 0; j < NS; ++j)\n"
        "      for (int e = 0; e < 4; ++e) sacc[j][e] *= 0.5f;\n"
        "    const int k0 = t * TK;\n")],
    # exp2(x) as exp2(x/2)^2 for half the probabilities
    "dup_exp": [(EXP, "const float p0 = exp2f(0.5f * (sacc[j][2 * h] - "
                      "m_use)) * exp2f(0.5f * (sacc[j][2 * h] - m_use));")],
    # P V twice into O, and the row sums doubled to match
    "dup_pv": [(PV, PV + PV), ("      l[h] = l[h] * corr + rs;",
                               "      l[h] = l[h] * corr + 2.f * rs;")],
    # each next K/V tile copied twice into its slot
    "dup_load": [(LOAD, LOAD + LOAD)],
}


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA

    card = C.card_line()
    print(f"card: {card}")
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        cu = out_dir / f"flash_{name}.cu"
        cu.write_text(patched(src, edits))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"libflash_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libflash_{name}.so"))
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p]
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    for s in SHAPES:
        q, k, v = C.flash_inputs(torch, gen, s, 64, torch.bfloat16)
        ref = FA.flash_attention_plain(q, k, v).float()
        tol = 2.0 ** -7 * ref.abs().max().item()
        o = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        cases = [("bh18", 18)] + ([("bh1", 1)] if s == max(SHAPES) else [])
        for label, bh in cases:
            res = []
            for name, lib in libs.items():
                def call(lib=lib, bh=bh):
                    rc = lib.flash_attention_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), bh, 3 if bh > 1 else 1, s, 64,
                        0.125, 1, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                err = (o[:bh].float() - ref[:bh]).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"{name} S={s}: {err} > {tol}")
                us = C.device_us(torch, call, ("flash_fwd_tc_kernel",),
                                 iters=50)["flash_fwd_tc_kernel"]
                res.append(f"{name}={us:.2f}")
            print(f"flash ablation [{card}] q ({label[2:]},{s},64) device us "
                  f"per launch: {' '.join(res)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
