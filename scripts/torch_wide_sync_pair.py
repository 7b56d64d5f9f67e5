"""The widened fused kept sync and receive kernels (any tp: rows streamed
in groups of `qpsum_group(tp)`) against the kernels they replaced (one
template a tp, tp <= 8), in one call on one card (run on the GPU host from
the repo root):

    python3 scripts/torch_wide_sync_pair.py OLD_SOURCE

OLD_SOURCE is the earlier `csrc/quant_collectives.cu`, the one of commit
148313a (one template a tp), for instance

    git show 148313a:src/repro_torch/csrc/quant_collectives.cu > build/OLD.cu

Both sources' two entries have the same C signature.  It is built with
the same nvcc flags into build/ beside the current library.  Then:

  * the current fused sync and send -> receive at tp 1 to 16 (bf16 and
    fp32, L 127 and 7, n 3840 and a ragged 1001) bit for bit against
    their plain versions, and the earlier kernels at tp 1 to 8 bit for bit
    against the current ones;
  * the device time a launch (torch.profiler) of both at the tp 2 shapes
    that PERF.md records (the fused sync at (2, 3840) and (2, 2097152),
    the receive at tp 2 for (1, 3840) and (1, 2097152), bf16 L 127), in
    the order earlier, current, current, earlier, each beside PERF.md's
    time; and of the current kernels at tp 9 and 16.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_collectives as QC  # noqa: E402

ORDER = ("earlier", "current", "current", "earlier")
_P, _I = ctypes.c_void_p, ctypes.c_int


def load_earlier(src: Path):
    """The earlier library's two entries (the current ones' signature)."""
    out = build.BUILD_DIR / "libquant_collectives-earlier.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    fns = {}
    for name in ("quantized_psum_absmax_fwd", "reduce_messages_absmax_fwd"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P] + [_I] * 7 + [_P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def earlier_call(fns, name, src, out, tp, n, bf16):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, warps = QC.qpsum_grid(n, sms)
    vec = QC.vector_rows(n, src, out) if name.startswith("quantized") \
        else QC.vector_rows(n, out)
    rc = fns[name](src.data_ptr(), out.data_ptr(), tp, n, 127, bf16, blocks,
                   warps, int(vec), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier {name}: CUDA error {rc}")
    return out


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = CS.card_line()
    print(f"card: {card}")
    fns = load_earlier(Path(sys.argv[1]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(34)
    bf = torch.bfloat16
    for tp in range(1, 17):
        for n in (3840, 1001):
            base = torch.randn(tp, n, generator=gen, device=dev)
            base *= torch.logspace(0, 1, tp, device=dev)[:, None]
            base[0, :QC.CHUNK] = 0.0
            for dtype in (bf, torch.float32):
                x = base.to(dtype)
                for levels in (127, 7):
                    y = QC.quantized_psum_absmax(x, levels=levels)
                    msg = QC.quantize_message_absmax(x, levels=levels)
                    r = QC.reduce_messages_absmax(msg, n, levels=levels,
                                                  dtype=dtype)
                    torch.cuda.synchronize()
                    ok = (CS.same_bits(torch, y,
                                       QC.quantized_psum_absmax_plain(
                                           x, levels=levels))
                          and CS.same_bits(torch, r,
                                           QC.reduce_messages_absmax_plain(
                                               msg, n, levels=levels,
                                               dtype=dtype)))
                    if ok and tp <= 8 and levels == 127:
                        b16 = int(dtype == bf)
                        ok = CS.same_bits(torch, y, earlier_call(
                            fns, "quantized_psum_absmax_fwd", x,
                            torch.empty_like(x), tp, n, b16)) and \
                            CS.same_bits(torch, r, earlier_call(
                                fns, "reduce_messages_absmax_fwd", msg,
                                torch.empty_like(r), tp, n, b16))
                        torch.cuda.synchronize()
                    if not ok:
                        raise AssertionError(f"tp {tp} n {n} {dtype} "
                                             f"L={levels}: bits differ")
    print("current kernels bit-identical to the plain versions at tp 1-16 "
          "and to the earlier kernels at tp 1-8")

    for (name, tp, n), was in CS.WIDE_KEPT_US:
        x = torch.randn(tp, n, generator=gen, device=dev).to(bf)
        if name == "quantized_psum_absmax":
            kname, src = "quantized_psum_kernel", x
            cur = lambda: QC.quantized_psum_absmax(x, levels=127)  # noqa
            out = torch.empty_like(x)
        else:
            kname = "reduce_messages_kernel"
            src = QC.quantize_message_absmax(x, levels=127)
            cur = lambda: QC.reduce_messages_absmax(  # noqa: E731
                src, n, levels=127, dtype=bf)
            out = torch.empty((1, n), dtype=bf, device=dev)
        old = lambda: earlier_call(  # noqa: E731
            fns, name + "_fwd", src, out, tp, n, 1)
        times = {"earlier": [], "current": []}
        for which in ORDER:
            fn = old if which == "earlier" else cur
            times[which].append(CS.device_us(torch, fn, (kname,), iters=200,
                                             need=(kname,))[kname])
        print(f"{name} tp {tp} n {n} bf16 [{card}]: device_us earlier "
              f"{times['earlier']} current {times['current']}; PERF.md "
              f"{was}")
    for tp in (9, 16):
        x = torch.randn(tp, CS.WIDE_N, generator=gen, device=dev).to(bf)
        msg = QC.quantize_message_absmax(x, levels=127)
        us = CS.device_us(torch, lambda: (
            QC.quantized_psum_absmax(x, levels=127),
            QC.reduce_messages_absmax(msg, CS.WIDE_N, levels=127, dtype=bf)),
            ("quantized_psum_kernel", "reduce_messages_kernel"), iters=200,
            need=("quantized_psum_kernel", "reduce_messages_kernel"))
        print(f"tp {tp} n {CS.WIDE_N} bf16 [{card}]: device_us {us}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
