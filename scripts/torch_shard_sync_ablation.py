"""Ablations of the shard sync's send and receive kernels on one GPU: what
sets their time at the shard path's payloads.

    python3 scripts/torch_shard_sync_ablation.py

Builds variants of src/repro_torch/csrc/quant_collectives.cu, each made by
a textual patch of the send (`quant_message_kernel`) and receive
(`reduce_messages_kernel`) kernels (every patch must apply, or the script
fails), loads each with ctypes and runs both at (1, n) bf16, L 127, two
ranks' messages, for n in 3840, 491520 and 2097152:

    base        the kernels as they are (the grid of `qpsum_grid`)
    cpw2, cpw4  each warp takes 2 or 4 chunk indices (w, w + W, ...), all
                its loads first: more bytes in flight a lane, a grid 2 or
                4 times smaller
    dup_reduce  the warp's absmax reduced twice (the same value)
    dup_div     every true division done twice, by an opaque copy of the
                scale (the same value)
    rcp_div     x * (1 / s) in place of x / s: NOT the reference's
                arithmetic, so its bits are reported, not required

Each variant is held to the plain versions (bit for bit, rcp_div apart)
and timed by the profiler (device us per launch), beside one copy_ that
moves the same bytes.  If doubling a piece of work moves the time, that
piece is on the critical path.  Needs a CUDA card and nvcc; exits
non-zero without.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIZES = (3840, 491520, 2097152)
TP = 2
SEND = ("// One warp a chunk c of row blockIdx.y",
        "// One warp a chunk index c of all TP messages")
RECV = ("// One warp a chunk index c of all TP messages", "}  // namespace")

# the send and receive with CPW chunk indices a warp, strided by the grid's
# warp count W; loads of every chunk first, then each chunk's work
CPW_SEND = """// CPW chunks a warp
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_message_kernel(const T* __restrict__ x, int8_t* __restrict__ msg,
                     int n, int pad, int m, int chunks, float levels,
                     int vec) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int W = gridDim.x * (blockDim.x >> 5);
  const int lane = threadIdx.x & 31;
  const T* xr = x + (size_t)blockIdx.y * n;
  int8_t* out = msg + (size_t)blockIdx.y * m;
  float v[CPW][PER_LANE];
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int c = w + k * W;
    if (c < chunks) load4(xr, c * CHUNK + lane * PER_LANE, n, vec, v[k]);
  }
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int c = w + k * W;
    if (c >= chunks) break;
    const int i0 = c * CHUNK + lane * PER_LANE;
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) mx = fmaxf(mx, fabsf(v[k][j]));
    const float s = fmaxf(warp_absmax(mx) / levels, 1e-12f);
    if (lane == 0) reinterpret_cast<float*>(out + pad)[c] = s;
    if (i0 < pad)
      *reinterpret_cast<char4*>(out + i0) = make_char4(
          code_one(v[k][0], s, levels), code_one(v[k][1], s, levels),
          code_one(v[k][2], s, levels), code_one(v[k][3], s, levels));
  }
}

"""
CPW_RECV = """// CPW chunks a warp
template <typename T, int TP>
__global__ void __launch_bounds__(THREADS)
reduce_messages_kernel(const int8_t* __restrict__ msg, T* __restrict__ y,
                       int n, int pad, int m, int chunks, float levels,
                       int vec) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int W = gridDim.x * (blockDim.x >> 5);
  const int lane = threadIdx.x & 31;
  char4 q[CPW][TP];
  float s[CPW][TP];
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int c = w + k * W;
    if (c >= chunks) break;
    const int i0 = c * CHUNK + lane * PER_LANE;
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int8_t* row = msg + (size_t)r * m;
      q[k][r] = i0 < n ? *reinterpret_cast<const char4*>(row + i0)
                       : make_char4(0, 0, 0, 0);
      s[k][r] = lane == 0 ? reinterpret_cast<const float*>(row + pad)[c]
                          : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < CPW; ++k) {
    const int c = w + k * W;
    if (c >= chunks) break;
    const int i0 = c * CHUNK + lane * PER_LANE;
    float acc[PER_LANE] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const float sr = __shfl_sync(FULL, s[k][r], 0);
      const signed char b[PER_LANE] = {q[k][r].x, q[k][r].y, q[k][r].z,
                                       q[k][r].w};
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const float qf = i0 + j < n ? static_cast<float>(b[j]) : 0.f;
        acc[j] = __fadd_rn(acc[j], __fmul_rn(qf, sr));
      }
    }
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) mx = fmaxf(mx, fabsf(acc[j]));
    const float s2 = fmaxf(warp_absmax(mx) / levels, 1e-12f);
    Pack4<T> out;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      out.v[j] = from_f<T>(qdq_one(acc[j], s2, levels));
    if (vec) {
      if (i0 < n) *reinterpret_cast<Pack4<T>*>(y + i0) = out;
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (i0 + j < n) y[i0 + j] = out.v[j];
    }
  }
}

"""
# the send's and the receive's scale lines, and their divisions
SEND_S = ("  const float s = fmaxf(warp_absmax(mx) / levels, 1e-12f);\n"
          "  if (lane == 0)")
RECV_S = "  const float s2 = fmaxf(warp_absmax(mx) / levels, 1e-12f);\n"
SEND_CODE = "code_one(v[{j}], s, levels)"
RECV_QDQ = "out.v[j] = from_f<T>(qdq_one(acc[j], s2, levels));"
OPAQUE = ("  const float sb = __shfl_sync(FULL, {s}, lane);  // == {s}\n")
# each variant: {"send" | "recv": [(old, new), ...]} or a whole body
VARIANTS = {
    "base": {},
    "cpw2": {"send": CPW_SEND.replace("CPW", "2"),
             "recv": CPW_RECV.replace("CPW", "2")},
    "cpw4": {"send": CPW_SEND.replace("CPW", "4"),
             "recv": CPW_RECV.replace("CPW", "4")},
    "dup_reduce": {
        "send": [(SEND_S, SEND_S.replace("warp_absmax(mx)",
                                         "warp_absmax(warp_absmax(mx))"))],
        "recv": [(RECV_S, RECV_S.replace("warp_absmax(mx)",
                                         "warp_absmax(warp_absmax(mx))"))]},
    "dup_div": {
        "send": [(SEND_S, SEND_S.replace("  if (lane == 0)",
                                         OPAQUE.format(s="s")
                                         + "  if (lane == 0)"))]
        + [(SEND_CODE.format(j=j),
            f"static_cast<signed char>(fmaxf({SEND_CODE.format(j=j)}, "
            f"code_one(v[{j}], sb, levels)))") for j in range(4)],
        "recv": [(RECV_S, RECV_S + OPAQUE.format(s="s2")),
                 (RECV_QDQ, "out.v[j] = from_f<T>(fmaxf(qdq_one(acc[j], s2, "
                            "levels), qdq_one(acc[j], sb, levels)));")]},
    "rcp_div": {
        "send": [(SEND_CODE.format(j=j),
                  f"static_cast<signed char>(fminf(fmaxf(rintf(v[{j}] * "
                  "(1.f / s)), -levels), levels))") for j in range(4)],
        "recv": [(RECV_QDQ, "out.v[j] = from_f<T>(__fmul_rn(fminf(fmaxf("
                            "rintf(acc[j] * (1.f / s2)), -levels), levels), "
                            "s2));")]},
}
EXACT = {"rcp_div": False}


def cut(src: str, marks) -> tuple:
    i = src.index(marks[0])
    j = src.index(marks[1], i + 1)
    return i, j


def patched(src: str, spec) -> str:
    for side, marks in (("send", SEND), ("recv", RECV)):
        edit = spec.get(side)
        if edit is None:
            continue
        i, j = cut(src, marks)
        body = src[i:j]
        if isinstance(edit, str):
            body = edit
        else:
            for old, new in edit:
                if old not in body:
                    raise SystemExit(f"patch does not apply to {side}: "
                                     f"{old[:60]!r}")
                body = body.replace(old, new)
        src = src[:i] + body + src[j:]
    return src


def build(src_text: str, name: str, out_dir: Path, kb):
    cu = out_dir / f"qc_{name}.cu"
    cu.write_text(src_text)
    so = out_dir / f"libqc_{name}.so"
    r = subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(so),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for f in (lib.quantize_message_absmax_fwd, lib.reduce_messages_absmax_fwd):
        f.argtypes = [p, p, i, i, i, i, i, i, i, p]
        f.restype = i
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import quant_collectives as QC

    out_dir = ROOT / "build" / "sync_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "src/repro_torch/csrc/quant_collectives.cu").read_text()
    libs = {name: build(patched(src, spec), name, out_dir, kb)
            for name, spec in VARIANTS.items()}
    card = CS.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(26)
    names = ("quant_message_kernel", "reduce_messages_kernel")
    for n in SIZES:
        x = torch.randn(TP, n, generator=gen, device=dev).to(torch.bfloat16)
        mine = x[:1]
        msgs = QC.quantize_message_absmax_plain(x, levels=127)
        m = msgs.shape[1]
        want_msg = msgs[:1]
        want_y = QC.reduce_messages_absmax_plain(msgs, n, levels=127,
                                                 dtype=torch.bfloat16)
        src_b = torch.empty((2 * n + m) // 2, dtype=torch.uint8, device=dev)
        dst_b = torch.empty_like(src_b)
        src_r = torch.empty((TP * m + 2 * n) // 2, dtype=torch.uint8,
                            device=dev)
        dst_r = torch.empty_like(src_r)
        copy_send, _ = CS.device_total_us(torch, lambda: dst_b.copy_(src_b))
        copy_recv, _ = CS.device_total_us(torch, lambda: dst_r.copy_(src_r))
        b_send = CS.bound_ms(2 * n + m, 6.0 * n, "float32")[0] * 1e3
        b_recv = CS.bound_ms(TP * m + 2 * n, 11.0 * n, "float32")[0] * 1e3
        print(f"(1,{n}) bf16 tp {TP} [{card}]: bound send {b_send:.3f} us, "
              f"receive {b_recv:.3f} us; a copy_ of the same bytes "
              f"{copy_send:.3f} and {copy_recv:.3f} us on the device")
        chunks = -(-n // QC.CHUNK)
        for name, lib in libs.items():
            cpw = int(name[3:]) if name.startswith("cpw") else 1
            blocks, warps = QC.qpsum_grid(-(-chunks // cpw) * QC.CHUNK, sms)
            msg = torch.empty_like(want_msg)
            y = torch.empty_like(want_y)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                rc = lib.quantize_message_absmax_fwd(
                    mine.data_ptr(), msg.data_ptr(), 1, n, 127, 1, blocks,
                    warps, 1, stream)
                rc |= lib.reduce_messages_absmax_fwd(
                    msgs.data_ptr(), y.data_ptr(), TP, n, 127, 1, blocks,
                    warps, 1, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            run()
            torch.cuda.synchronize()
            same = (torch.equal(msg, want_msg)
                    and CS.same_bits(torch, y, want_y))
            if EXACT.get(name, True) and not same:
                raise AssertionError(f"{name} at (1,{n}) is not bit for bit "
                                     "the plain versions")
            us = CS.device_us(torch, run, names, need=names)
            print(f"  {name:10s} grid {blocks}x{warps}: send "
                  f"{us[names[0]]:.3f} us, receive {us[names[1]]:.3f} us; "
                  f"bits equal the plain versions: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
