"""What sets the time of the bf16 paged chunk kernel (B2 at C > 1) on one
GPU: the chain of one block's key tiles, what in a tile is on it, and
what splitting the key tiles over a cluster of blocks buys.

    python3 scripts/torch_paged_chunk_chain.py

At the warm suffix prefill's shape (q (2, 4, 32, 9, 64) bf16, only row 2
live, a 32-page table of 16-key pages, pools a layer of a pool leaf), row
2's position is set so that every query tile walks k key tiles of 64
(pos = 64 k - 32, k = 1..8; the serving shape, pos 256, walks 5).  Two
builds of the source: "split", as it is (the key tiles split over a
cluster of up to 8 blocks that merge their partials), and "one", patched
to launch clusters of one block (one block walks every key tile: the
kernel's design before the split).

1. Chain: both builds timed by the profiler (paged_chunk_tc_kernel
   device us per launch, two rounds: k rising, then falling); a line
   fitted to "one"'s time against k gives the cost of one tile of the
   chain and the fixed cost of a launch.
2. Ablation of "one": variants built from textual patches (each must
   apply once, or the script fails), timed at k = 1, 5, 8: a ring of 3,
   4 or 6 K/V stages (2 as built); the table row staged in shared memory at the start
   (no table read in the key loop); one block per SM promised to the
   compiler (__launch_bounds__); and twice a tile's K/V copies, Q K^T
   products, exponentials or P V products (arranged so that the output
   stays the same).  A piece whose doubling moves the time is on the
   chain.
3. Phases: copies of both builds that stamp the GPU's global timer
   (%globaltimer, ns) in thread 0 of each block at its start, after its
   first table entries are published, when each of its key tiles has
   landed and when its math is done, after its key loop, when the
   cluster's partial rows have arrived (split), and at its end; the
   median over 5 launches of the timelines of kv head 0's blocks of shard
   0's live row, from the first block's start, at k = 1 and 5, with the
   spread of every block's start, the last block's end, and how many
   clusters of the launch the card holds at once.
4. The split rule: the device time of B2's decode combine kernel at its
   serving shape (what a split with a second launch would add) and of a
   minimal launch (fill_ of one element), set against what a split into
   one-tile blocks could take off "one"'s serving chain.

Every call is checked against the plain version (2^-7 of the largest
output).  Needs a CUDA card and nvcc; exits non-zero without.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TILES = tuple(range(1, 9))
ABLATION_TILES = (1, 5, 8)
SERVING_TILES = 5                      # pos 256 + C 32 = 288 keys

# clusters of one block: every key tile in one block
ONE = [("  cfg.gridDim = dim3((g * c + CQ - 1) / CQ * n_splits, hkv, "
        "tp * batch);", "  cfg.gridDim = dim3((g * c + CQ - 1) / CQ, hkv, "
        "tp * batch);"),
       ("  attr[0].val.clusterDim.x = n_splits;",
        "  attr[0].val.clusterDim.x = 1;")]
RING = "constexpr int CSTAGES = 2;"
QK = """          mma_bf16(sacc[j], qf[kk], bf[0], bf[1]);
          mma_bf16(sacc[j + 1], qf[kk], bf[2], bf[3]);
"""
PV = """          mma_bf16(oacc[j], pa, bf[0], bf[1]);
          mma_bf16(oacc[j + 1], pa, bf[2], bf[3]);
"""
EXP = "const float e0 = exp2f(sacc[j][2 * hh] - m_use);"
COPY_NEXT = "    issue(i + CSTAGES - 1);\n"
PUBLISH0 = "    for (int u = 0; u < CSTAGES; ++u) publish(u, ent0[u]);\n  }\n"
# the ablation of "one": (old, new) replacements of the source
VARIANTS = {
    "one": [],
    "ring3": [(RING, "constexpr int CSTAGES = 3;")],
    "ring4": [(RING, "constexpr int CSTAGES = 4;")],
    "ring6": [(RING, "constexpr int CSTAGES = 6;")],
    # the table row (n <= 64 here) in shared memory before the loop
    "table_smem": [
        ("  __shared__ uint32_t kbits[CSLOTS][2];\n",
         "  __shared__ uint32_t kbits[CSLOTS][2];\n  __shared__ int tsm[64];\n"),
        (PUBLISH0, PUBLISH0 + "  for (int e = tid; e < n && e < 64; "
                              "e += CTHREADS) tsm[e] = trow[e];\n"),
        ("trow[kn / ps]", "tsm[kn / ps]")],
    # one block per SM promised to the compiler (more registers)
    "bounds1": [("__launch_bounds__(CTHREADS)\npaged_chunk_tc_kernel(",
                 "__launch_bounds__(CTHREADS, 1)\npaged_chunk_tc_kernel(")],
    # each next K/V tile copied twice into its stage
    "dup_load": [(COPY_NEXT, COPY_NEXT + COPY_NEXT)],
    # sacc accumulates Q K^T twice, then is halved: the same scores
    "dup_qk": [(QK, QK + QK), (
        "      // masks only where",
        "      for (int j = 0; j < NS; ++j)\n"
        "        for (int e = 0; e < 4; ++e) sacc[j][e] *= 0.5f;\n"
        "      // masks only where")],
    # exp2(x) as exp2(x/2)^2 for half the probabilities
    "dup_exp": [(EXP, "const float e0 = exp2f(0.5f * (sacc[j][2 * hh] - "
                      "m_use)) * exp2f(0.5f * (sacc[j][2 * hh] - m_use));")],
    # P V twice into O, and the row sums doubled to match
    "dup_pv": [(PV, PV + PV), ("        l[hh] = l[hh] * corr + rs;",
                               "        l[hh] = l[hh] * corr + 2.f * rs;")],
}

# the phases copies: 16 stamps per block, for up to 512 blocks
STAMPS = [
    ('#include "mma_sm90.cuh"\n',
     '#include "mma_sm90.cuh"\n'
     "__device__ unsigned long long dbg_t[512][16];\n"
     "#define STAMP(i) do { const int id_ = blockIdx.x + gridDim.x * "
     "(blockIdx.y + gridDim.y * blockIdx.z); if (threadIdx.x == 0 && "
     "id_ < 512) { unsigned long long t_; asm volatile(\"mov.u64 %0, "
     "%%globaltimer;\" : \"=l\"(t_)); dbg_t[id_][i] = t_; } } while (0)\n"),
    ("  int ent0[CSTAGES];\n", "  STAMP(0);\n  int ent0[CSTAGES];\n"),
    (PUBLISH0 + "  __syncthreads();\n",
     PUBLISH0 + "  __syncthreads();\n  STAMP(1);\n"),
    ("    __syncthreads();                   // part; the barrier: "
     "everyone's)\n",
     "    __syncthreads();                   // part; the barrier: "
     "everyone's)\n    if (i < 5) STAMP(2 + 2 * i);\n"),
    ("    // slot (i + CSTAGES) % CSLOTS is tile i - 1's",
     "    if (i < 5) STAMP(3 + 2 * i);\n"
     "    // slot (i + CSTAGES) % CSLOTS is tile i - 1's"),
    ("  cp_async_wait<0>();                  // no copy outlives the loop\n",
     "  cp_async_wait<0>();                  // no copy outlives the loop\n"
     "  STAMP(14);\n"),
    ("                                    oacc[j][2 * hh + 1] * inv);\n"
     "        }\n      }\n    }\n    return;\n",
     "                                    oacc[j][2 * hh + 1] * inv);\n"
     "        }\n      }\n    }\n    STAMP(15);\n    return;\n"),
    ("  cluster.sync();                      // every partial row has "
     "arrived\n",
     "  cluster.sync();                      // every partial row has "
     "arrived\n  STAMP(12);\n"),
    ("                   *reinterpret_cast<uint32_t*>(&hi));\n  }\n}\n",
     "                   *reinterpret_cast<uint32_t*>(&hi));\n  }\n"
     "  STAMP(15);\n}\n"),
]
STAMP_EXPORTS = (
    '\nextern "C" int get_stamps(void* dst) {\n'
    "  return cudaMemcpyFromSymbol(dst, dbg_t, sizeof(dbg_t));\n}\n"
    'extern "C" int clear_stamps() {\n  void* p;\n'
    "  cudaGetSymbolAddress(&p, dbg_t);\n"
    "  return cudaMemset(p, 0, sizeof(dbg_t));\n}\n"
    # how many clusters of ns blocks (D 64) the card holds at once
    'extern "C" int max_clusters(int ns) {\n'
    "  constexpr int smem = chunk_smem_bytes<64>();\n"
    "  cudaFuncSetAttribute(paged_chunk_tc_kernel<64>,\n"
    "      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
    "  cudaLaunchConfig_t cfg = {};\n"
    "  cfg.gridDim = dim3(2 * ns, 3, 8);\n"
    "  cfg.blockDim = dim3(CTHREADS);\n"
    "  cfg.dynamicSmemBytes = smem;\n"
    "  cudaLaunchAttribute attr[1];\n"
    "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
    "  attr[0].val.clusterDim.x = ns;\n"
    "  attr[0].val.clusterDim.y = 1;\n"
    "  attr[0].val.clusterDim.z = 1;\n"
    "  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n"
    "  int n = -1;\n"
    "  cudaOccupancyMaxActiveClusters(&n, paged_chunk_tc_kernel<64>, &cfg);\n"
    "  return n;\n}\n")


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"patch does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def sources(src: str) -> dict:
    """Every build's source: "split" as it is, the ablation of "one",
    and the two phases copies."""
    out = {"split": src}
    out.update({name: patched(src, ONE + edits)
                for name, edits in VARIANTS.items()})
    out["stamps_split"] = patched(src, STAMPS) + STAMP_EXPORTS
    out["stamps_one"] = patched(src, ONE + STAMPS) + STAMP_EXPORTS
    return out


def build_variants(build) -> dict:
    """One nvcc per build, all started together; {name: CDLL}."""
    out_dir = build.BUILD_DIR / "chunk_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources(
            (build.CSRC / "paged_attention.cu").read_text()).items():
        cu = out_dir / f"paged_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"libpaged_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"libpaged_{name}.so"))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def phases(torch, FA, build, lib, args, k, ns, label, card, reps=5):
    """Median over `reps` launches of each live block's stamps, in us
    from the first block's start; `ns` blocks per cluster."""
    import numpy as np

    build._LIBS["paged_attention"] = lib
    lib.get_stamps.argtypes = [ctypes.c_void_p]
    runs = []
    for _ in range(reps + 1):          # the first launch warms up
        lib.clear_stamps()
        FA.paged_flash_attention(*args)
        torch.cuda.synchronize()
        buf = np.zeros((512, 16), np.uint64)
        lib.get_stamps(buf.ctypes.data)
        runs.append(buf.astype(np.int64))
    d = np.stack(runs[1:])             # (reps, block, stamp)
    t0 = np.where(d[:, :, 0] > 0, d[:, :, 0], np.iinfo(np.int64).max)
    rel = np.where(d > 0, d - t0.min(axis=1)[:, None, None], -1)
    med = np.median(rel, axis=0) / 1e3
    q, hkv = args[0], args[1].shape[-2]
    gx = -(-(q.shape[-2] // hkv) * q.shape[-3] // 64) * ns
    nb = min(512, gx * hkv * q.shape[0] * q.shape[1])
    last = int(np.argmax(med[:nb, 15]))
    print(f"phases [{card}] {label} {k} tiles: {nb} blocks, starts "
          f"{med[:nb, 0].min():.2f}..{med[:nb, 0].max():.2f} us "
          f"({int((med[:nb, 0] > 1.0).sum())} after 1 us), last end "
          f"{med[last, 15]:.2f} us (block {last}: query tile "
          f"{gx // ns - 1 - last % gx // ns}, split {last % gx % ns}, kv "
          f"head {last // gx % hkv}, row {last // gx // hkv}); the card "
          f"holds {lib.max_clusters(ns)} clusters of {ns} at once; its "
          f"stamps {' '.join(f'{t:.2f}' for t in med[last])}")
    for bid in range(nb):
        bx, rest = bid % gx, bid // gx
        h, r = rest % hkv, rest // hkv
        if r != 2 or h or med[bid, 0] < 0:
            continue                   # shard 0's live row, kv head 0
        tiles = " ".join(f"{med[bid, 2 + 2 * t]:.2f}/{med[bid, 3 + 2 * t]:.2f}"
                         for t in range(5) if med[bid, 2 + 2 * t] >= 0)
        merge = (f", partial rows arrived {med[bid, 12]:.2f}"
                 if med[bid, 12] >= 0 else "")
        print(f"phases [{card}] {label} {k} tiles, block (query tile "
              f"{gx // ns - 1 - bx // ns}, split {bx % ns}, kv head {h}, row "
              f"{r}): start {med[bid, 0]:.2f}, table entries published "
              f"{med[bid, 1]:.2f}, tiles landed/math done [{tiles}], key "
              f"loop done {med[bid, 14]:.2f}{merge}, end {med[bid, 15]:.2f}"
              f" us")


def main() -> int:
    import numpy as np
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
    libs = build_variants(build)
    cases = {}
    for k in TILES:
        q, kv, vv, table, pos = C.paged_case(
            torch, torch.bfloat16, 32, pos=(0, 0, 64 * k - 32, 0))
        table[[0, 1, 3]] = -1          # one live row, as in a warm admission
        ref = torch.stack([FA.paged_flash_attention_plain(
            q[t], kv[t], vv[t], table, pos) for t in range(q.shape[0])])
        cases[k] = ((q, kv, vv, table, pos),
                    2.0 ** -7 * ref.float().abs().max().item(), ref.float())
    ns = min(FA.CHUNK_MAX_SPLITS, -(-table.shape[1] * kv.shape[-3]
                                    // FA.CHUNK_KEYS_PER_TILE))

    def timed(name, k, iters=20):
        """Device us per launch of build `name` at k tiles, after a check
        against the plain version."""
        build._LIBS["paged_attention"] = libs[name]
        args, tol, ref = cases[k]
        out = FA.paged_flash_attention(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{name} at {k} tiles: {err} > {tol}")
        return C.device_us(torch, lambda: FA.paged_flash_attention(*args),
                           ("paged_chunk_tc_kernel",),
                           iters=iters)["paged_chunk_tc_kernel"]

    mean = {}
    for name in ("one", "split"):
        times = {k: [] for k in TILES}
        for order in (TILES, TILES[::-1]):
            for k in order:
                times[k].append(timed(name, k))
        mean[name] = {k: sum(v) / len(v) for k, v in times.items()}
        for k in TILES:
            print(f"chain [{card}] {name}: {k} key tiles (pos {64 * k - 32})"
                  f": paged_chunk_tc_kernel {mean[name][k]:.2f} us device "
                  f"(rounds {', '.join(f'{t:.2f}' for t in times[k])})")
    slope, fixed = np.polyfit(np.asarray(TILES, float),
                              np.asarray([mean["one"][k] for k in TILES]), 1)
    print(f"chain fit (one): {slope:.3f} us per key tile + {fixed:.3f} us "
          f"fixed")

    for name in VARIANTS:
        res = {k: timed(name, k) for k in ABLATION_TILES}
        print(f"ablation [{card}] {name}: device us at "
              + " ".join(f"{k} tiles={res[k]:.2f}" for k in ABLATION_TILES)
              + f"; {(res[8] - res[5]) / 3:.2f} us per tile over tiles 6-8")

    for k in (1, SERVING_TILES):
        phases(torch, FA, build, libs["stamps_one"], cases[k][0], k, 1,
               "one", card)
        phases(torch, FA, build, libs["stamps_split"], cases[k][0], k, ns,
               "split", card)

    build._LIBS["paged_attention"] = libs["split"]
    q, kv, vv, table, pos = C.paged_case(torch, torch.bfloat16, 1)
    dec = C.device_us(torch, lambda: FA.paged_flash_attention(
        q, kv, vv, table, pos), ("paged_decode_split_kernel",
                                 "paged_decode_combine_kernel"))
    combine = dec["paged_decode_combine_kernel"]
    floor = C.launch_floor_us(torch)
    saved = slope * (SERVING_TILES - 1)
    print(f"split rule: at the serving shape ({SERVING_TILES} tiles, one "
          f"{mean['one'][SERVING_TILES]:.2f} us) one-tile blocks could take "
          f"at most {saved:.2f} us off the chain; a second launch to combine "
          f"costs {combine:.2f} us (the decode combine at its serving shape; "
          f"launch floor {floor:.2f} us): "
          f"{'split pays' if saved > combine else 'split does not pay'}; "
          f"measured split (one launch, cluster of {ns}): "
          f"{mean['split'][SERVING_TILES]:.2f} us [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
