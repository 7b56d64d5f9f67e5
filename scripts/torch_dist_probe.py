"""What torch.distributed accepts on this machine's cards (run on the GPU
host from the repo root):

    python3 scripts/torch_dist_probe.py

1. gloo, two ranks on card 0 (CUDA tensors staged through the host):
   all-gather in list form and into one tensor (fp32, bf16, int8),
   all-reduce sum (fp32, bf16), max (fp32), min (int64), broadcast and a
   ring of isend / irecv; each printed ok or with its error.
2. nccl, two ranks on card 0: expected to be refused; its error printed.
3. nccl at the card count, one rank a card: an all-reduce.

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
    try:
        x = torch.full((4,), float(rank), device=dev)
        r = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, 1 - rank),
               dist.P2POp(dist.irecv, r, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out["isend/irecv fp32"] = ("ok" if r.cpu().tolist()
                                   == [float(1 - rank)] * 4 else "wrong")
    except Exception as e:                          # noqa: BLE001
        out["isend/irecv fp32"] = repr(e)[:160]
    return out


def nccl_all_reduce(rank):
    import torch
    import torch.distributed as dist

    z = torch.full((5,), rank + 1.0, device=torch.device("cuda"))
    dist.all_reduce(z)
    torch.cuda.synchronize()
    return z.cpu().tolist()


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
