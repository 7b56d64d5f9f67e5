"""What torch.distributed accepts on this machine's cards (run on the GPU
host from the repo root):

    python3 scripts/torch_dist_probe.py

1. gloo, two ranks on card 0 (CUDA tensors staged through the host):
   all-gather in list form and into one tensor (fp32, bf16, int8),
   all-reduce sum (fp32, bf16), max (fp32), min (int64) and broadcast,
   the reduce-scatter into one tensor that the train step's ZeRO-1
   and FSDP run over the data group (fp32, bf16; collectives.
   reduce_scatter), a barrier and an object broadcast (the trainer's
   checkpoint directory), each printed ok or with its error; then, in a
   spawn of its own, a ring of isend / irecv (gloo may abort a rank
   there).
2. nccl, two ranks on card 0: expected to be refused; its error printed.
3. nccl at the card count, one rank a card: an all-reduce.
4. With two or more cards, nccl at the card count: the quantized kept
   sync across ranks (`compression.quantized_psum` under the model
   group: the send kernel, `all_gather_into_tensor`, the receive kernel)
   against sim's fused sync on the same partials, bit for bit, at 3,
   130, 3840 and 491520 elements, fp32 and bf16, int8 and int4.

Prints one JSON line per case and the card (nvidia-smi name and power
limit).  Every spawn has a deadline, so a hang fails the case.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def gloo_cases(rank):
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        x = torch.full((5,), rank + 1, dtype=dt, device=dev)
        name = str(dt).split(".")[-1]
        try:
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            ok = torch.cat(parts).cpu().tolist() == [1] * 5 + [2] * 5
            out[f"all_gather list {name}"] = "ok" if ok else "wrong"
        except Exception as e:                      # noqa: BLE001
            out[f"all_gather list {name}"] = repr(e)[:160]
        try:
            y = torch.empty((10,), dtype=dt, device=dev)
            dist.all_gather_into_tensor(y, x)
            ok = y.cpu().tolist() == [1] * 5 + [2] * 5
            out[f"all_gather_into_tensor {name}"] = "ok" if ok else "wrong"
        except Exception as e:                      # noqa: BLE001
            out[f"all_gather_into_tensor {name}"] = repr(e)[:160]
    for dt, op, want in ((torch.float32, "SUM", 3), (torch.bfloat16, "SUM", 3),
                         (torch.float32, "MAX", 2), (torch.int64, "MIN", 1)):
        name = f"all_reduce {op} {str(dt).split('.')[-1]}"
        try:
            z = torch.full((5,), rank + 1, dtype=dt, device=dev)
            dist.all_reduce(z, op=getattr(dist.ReduceOp, op))
            out[name] = "ok" if z.cpu().tolist() == [want] * 5 else "wrong"
        except Exception as e:                      # noqa: BLE001
            out[name] = repr(e)[:160]
    try:
        b = torch.full((3,), rank, dtype=torch.int64, device=dev)
        dist.broadcast(b, src=0)
        out["broadcast int64"] = "ok" if b.cpu().tolist() == [0] * 3 \
            else "wrong"
    except Exception as e:                          # noqa: BLE001
        out["broadcast int64"] = repr(e)[:160]
    from repro_torch.parallel.collectives import reduce_scatter
    for dt in (torch.float32, torch.bfloat16):
        name = f"reduce_scatter {str(dt).split('.')[-1]}"
        try:
            parts = torch.arange(6, dtype=dt, device=dev).reshape(2, 3) \
                * (rank + 1)
            y = torch.empty((1, 3), dtype=dt, device=dev)
            reduce_scatter(y, parts, None)
            want = (3 * torch.arange(6).reshape(2, 3)[rank]).tolist()
            out[name] = "ok" if y[0].float().cpu().tolist() == want \
                else "wrong"
        except Exception as e:                      # noqa: BLE001
            out[name] = repr(e)[:160]
    try:
        dist.barrier()
        box = [f"dir of rank {rank}"]
        dist.broadcast_object_list(box, src=0)
        out["barrier, broadcast_object_list"] = (
            "ok" if box == ["dir of rank 0"] else "wrong")
    except Exception as e:                          # noqa: BLE001
        out["barrier, broadcast_object_list"] = repr(e)[:160]
    return out


def gloo_p2p(rank):
    """A ring of isend / irecv of CUDA tensors: its own spawn, since gloo
    may abort the rank's process (an exception on its I/O thread)."""
    import torch
    import torch.distributed as dist

    x = torch.full((4,), float(rank), device=torch.device("cuda", 0))
    r = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, 1 - rank),
           dist.P2POp(dist.irecv, r, 1 - rank)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return "ok" if r.cpu().tolist() == [float(1 - rank)] * 4 else "wrong"


def nccl_all_reduce(rank):
    import torch
    import torch.distributed as dist

    z = torch.full((5,), rank + 1.0, device=torch.device("cuda"))
    dist.all_reduce(z)
    torch.cuda.synchronize()
    return z.cpu().tolist()


def nccl_quantized_sync(rank):
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.launch.dist import init_tp
    from repro_torch.parallel import compression as C
    from repro_torch.parallel.collectives import ModelGroup, model_group

    n = dist.get_world_size()
    g = init_tp(n, 1, backend="nccl", device="cuda")
    ctx = ModelGroup(g.tp, g.model_rank, g.model_group)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    out = {}
    for size in (3, 130, 3840, 491520):
        gen = torch.Generator(device=g.device).manual_seed(size)
        x = torch.randn(n, size, generator=gen, device=g.device)
        for dt in (torch.float32, torch.bfloat16):
            for bits in (8, 4):
                xs = x.to(dt)
                with model_group(ctx):
                    y = C.quantized_psum(xs[rank:rank + 1], "model",
                                         bits=bits)
                want = QC.quantized_psum_absmax(
                    xs, levels=127 if bits == 8 else 7)[rank:rank + 1]
                same = torch.equal(y.view(ints[dt]), want.view(ints[dt]))
                out[f"{size} {str(dt).split('.')[-1]} int{bits}"] = (
                    "bit for bit" if same else "DIFFERS")
    out["send, receive launches"] = [QC.quantize_message_absmax.launches,
                                     QC.reduce_messages_absmax.launches]
    return out


def main() -> int:
    import torch
    from repro_torch.launch.dist import spawn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()}")
    res = spawn(gloo_cases, 2, backend="gloo", device="cuda:0",
                deadline_s=120, timeout_s=60)
    print(json.dumps({"gloo two ranks on card 0": res}))
    try:
        got = spawn(gloo_p2p, 2, backend="gloo", device="cuda:0",
                    deadline_s=60, timeout_s=30)
        print(json.dumps({"gloo isend/irecv fp32 on card 0": got}))
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        print(json.dumps({"gloo isend/irecv fp32 on card 0 refused":
                          lines[-3:]}))
    try:
        got = spawn(nccl_all_reduce, 2, backend="nccl", device="cuda:0",
                    deadline_s=90, timeout_s=30)
        print(json.dumps({"nccl two ranks on card 0": got}))
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        print(json.dumps({"nccl two ranks on card 0 refused":
                          lines[-3:]}))
    n = torch.cuda.device_count()
    got = spawn(nccl_all_reduce, n, backend="nccl", device="cuda",
                deadline_s=120, timeout_s=60)
    print(json.dumps({f"nccl one rank a card, world {n}": got}))
    if n < 2:
        print(json.dumps({"quantized sync across ranks over nccl":
                          "needs two or more cards"}))
        return 0
    got = spawn(nccl_quantized_sync, n, backend="nccl", device="cuda",
                deadline_s=180, timeout_s=60)
    print(json.dumps({f"quantized sync across ranks over nccl, world {n}":
                      got}))
    return 0 if all(v != "DIFFERS" for r in got for v in r.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
