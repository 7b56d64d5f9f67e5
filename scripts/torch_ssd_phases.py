"""Where the bf16 SSD scan's time goes, block by block, on one GPU.

    python3 scripts/torch_ssd_phases.py

Builds a copy of src/repro_torch/csrc/ssd_scan.cu in which thread 0 of
every block of the states and output kernels reads the card's global
timer (%globaltimer, ns) at the boundaries of its phases, and writes them
to a device array (every patch must apply once, or the script fails).  At
the mamba path's layer shape (x (2, S, 16, 64) bf16, B/C (2, S, 1, 128),
chunk 256) for S 300 and 512 it calls the kernels, checks y and the
final state against the plain version at chip_smoke's tolerances, and
prints, for each kernel and each kind of block (chunk c; for the output
kernel also its query tile qt), the blocks' start and end and the mean
and largest time of each phase, µs from the kernel's first block:

  states: issue copies | wait for them | weights and hi/rest split |
          products | store;
  output: issue copies | state passing | key-tile loop | halves summed |
          store y.

Then the profiler's device µs per kernel for the uninstrumented build.
Needs a CUDA card and nvcc; exits non-zero without.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NB = 4096                               # blocks recorded per kernel
STAMP = ("if (threadIdx.x == 0) { const int id = blockIdx.x + gridDim.x * "
         "(blockIdx.y + gridDim.y * blockIdx.z); if (id < %d) { unsigned "
         "long long* d = %s[id]; d[0] = T0; d[1] = T1; d[2] = T2; d[3] = T3;"
         " d[4] = T4; d[5] = gt(); d[6] = %s; } }\n")
PATCHES = [
    ("namespace {\n\n// ----",
     "namespace {\n__device__ unsigned long long dbg_o[%d][7];\n"
     "__device__ unsigned long long dbg_s[%d][7];\n"
     "__device__ __forceinline__ unsigned long long gt() { unsigned long "
     "long t; asm volatile(\"mov.u64 %%0, %%globaltimer;\" : \"=l\"(t)); "
     "return t; }\n\n// ----" % (NB, NB)),
    # output kernel
    ("  load_floats(csum, scan_s + (size_t)c * SCAN_ROW, SCAN_ROW);\n",
     "  unsigned long long T0 = gt();\n"
     "  load_floats(csum, scan_s + (size_t)c * SCAN_ROW, SCAN_ROW);\n"),
    ("  // the state entering the chunk (fp32 sums), rounded to bf16 [p][n]\n",
     "  unsigned long long T1 = gt();\n"
     "  // the state entering the chunk (fp32 sums), rounded to bf16 [p][n]\n"),
    ("  float acc[NP][4] = {};\n  const int r_lo",
     "  unsigned long long T2 = gt();\n  float acc[NP][4] = {};\n"
     "  const int r_lo"),
    ("  // the second half hands its sums to the first (through the scores'\n",
     "  unsigned long long T3 = gt();\n"
     "  // the second half hands its sums to the first (through the scores'\n"),
    ("  __syncthreads();\n  if (kh) return;\n",
     "  __syncthreads();\n  unsigned long long T4 = gt();\n"
     "  if (kh) return;\n"),
    ("          acc[j][2 * u] + o.x + dv * xv.x, acc[j][2 * u + 1] + o.y + "
     "dv * xv.y);\n    }\n  }\n}\n",
     "          acc[j][2 * u] + o.x + dv * xv.x, acc[j][2 * u + 1] + o.y + "
     "dv * xv.y);\n    }\n  }\n  " + STAMP % (NB, "dbg_o", "qt * 16 + c")
     + "}\n"),
    # states kernel
    ("  load_floats(csum, scan + (sid * nc + c) * SCAN_ROW, SCAN_ROW);\n",
     "  unsigned long long T0 = gt();\n"
     "  load_floats(csum, scan + (sid * nc + c) * SCAN_ROW, SCAN_ROW);\n"),
    ("  cp_async_commit();\n  cp_async_wait<0>();\n  __syncthreads();\n"
     "  const float total",
     "  cp_async_commit();\n  unsigned long long T1 = gt();\n"
     "  cp_async_wait<0>();\n  __syncthreads();\n"
     "  unsigned long long T2 = gt();\n  const float total"),
    ("  const int pt = warp % PT;",
     "  unsigned long long T3 = gt();\n  const int pt = warp % PT;"),
    ("  float* out = cstate + (sid * nc + c) * P * n +",
     "  unsigned long long T4 = gt();\n"
     "  float* out = cstate + (sid * nc + c) * P * n +"),
    ("                      acc[m][u][3] + acl[m][u][3]);\n    }\n  }\n}\n",
     "                      acc[m][u][3] + acl[m][u][3]);\n    }\n  }\n  "
     + STAMP % (NB, "dbg_s", "c") + "}\n"),
]
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int] + [
    ctypes.c_void_p] * 4


def instrumented(src: str) -> str:
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int get_stamps(void* o, void* s) {\n'
                  '  cudaMemcpyFromSymbol(o, dbg_o, sizeof(dbg_o));\n'
                  '  return cudaMemcpyFromSymbol(s, dbg_s, sizeof(dbg_s));\n'
                  '}\n'
                  'extern "C" int clear_stamps() {\n'
                  '  void* p;\n'
                  '  cudaGetSymbolAddress(&p, dbg_o);\n'
                  '  cudaMemset(p, 0, sizeof(dbg_o));\n'
                  '  cudaGetSymbolAddress(&p, dbg_s);\n'
                  '  return cudaMemset(p, 0, sizeof(dbg_s));\n'
                  '}\n')


def report(name, d, phases, tag_name):
    d = d[d[:, 5] > 0].astype(np.int64)
    rel = (d[:, :6] - d[:, 0].min()) / 1e3
    print(f"  {name}: {len(d)} blocks, last end {rel[:, 5].max():.2f} us; "
          f"phases: {' | '.join(phases)}")
    for tag in sorted(set(d[:, 6].tolist())):
        sel = rel[d[:, 6] == tag]
        ph = np.diff(sel, axis=1)
        print(f"    {tag_name(tag)}: n={len(sel)} start {sel[:, 0].mean():.2f}"
              f" end {sel[:, 5].mean():.2f} (last {sel[:, 5].max():.2f}); "
              f"mean " + " ".join(f"{v:.2f}" for v in ph.mean(0))
              + "; max " + " ".join(f"{v:.2f}" for v in ph.max(0)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as SS

    card = C.card_line()
    print(f"card: {card}")
    out = build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "ssd_phases.cu"
    cu.write_text(instrumented((build.CSRC / "ssd_scan.cu").read_text()))
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(out / "libssd_phases.so"), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out / "libssd_phases.so"))
    lib.ssd_scan_fwd.argtypes = ARGTYPES

    chunk = C.SSD_SHAPE["chunk"]
    for s in (300, 512):
        x, dt, a, bm, cm, dd = C.ssd_inputs(torch, s, torch.bfloat16)
        bt, _, h, p = x.shape
        g, n = bm.shape[2:]
        scratch = [torch.empty(sh, device="cuda")
                   for sh in SS.scratch_shapes(bt, s, h, p, g, n, chunk)]
        y = torch.empty_like(x)
        st = torch.empty(bt, h, p, n, device="cuda")

        def call():
            rc = lib.ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                cm.data_ptr(), dd.data_ptr(), y.data_ptr(), st.data_ptr(),
                bt, s, h, p, g, n, chunk, bm.stride(0), bm.stride(1), 1,
                *[t.data_ptr() for t in scratch],
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        yp, stp = SS.ssd_scan_plain(x, dt, a, bm, cm, dd, chunk=chunk)
        ey = (y.float() - yp.float()).abs().max().item()
        es = (st - stp).abs().max().item()
        if not (ey <= C.SSD_BF16_Y_REL * yp.float().abs().max().item()
                and es <= C.SSD_BF16_STATE_REL * stp.abs().max().item()):
            raise AssertionError(f"instrumented kernels disagree: {ey} {es}")
        lib.clear_stamps()
        call()
        torch.cuda.synchronize()
        do = np.zeros((NB, 7), np.uint64)
        dst = np.zeros((NB, 7), np.uint64)
        lib.get_stamps(do.ctypes.data, dst.ctypes.data)
        print(f"S={s} [{card}] (us from each kernel's first block)")
        report("states", dst, ("issue copies", "wait", "weights and split",
                               "products", "store"),
               lambda t: f"chunk {t}")
        report("output", do, ("issue copies", "state passing",
                              "key-tile loop", "halves summed", "store y"),
               lambda t: f"chunk {t % 16} tile {t // 16}")
        us = C.device_us(torch, lambda: SS.ssd_scan(x, dt, a, bm, cm, dd,
                                                    chunk=chunk),
                         C.SSD_KERNELS[:3], iters=20)
        print(f"  profiler, uninstrumented [{card}]: "
              + " ".join(f"{k}={v:.2f}" for k, v in us.items())
              + f" sum={sum(us.values()):.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
