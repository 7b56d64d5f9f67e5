"""chip_smoke.py's frontend phase (21f) and its shard case (22 (d)) alone,
in one call on one card (run on the GPU host from the repo root):

    python3 scripts/torch_frontend_phase.py

Builds the kernels, runs `chip_smoke.frontend_phase` (the kernels at the
frontend shapes, internvl2-1b and musicgen-medium served text-only and
with a frontend prefill, their fp32 cuts and their training), then two
shard ranks on card 0 over gloo serving musicgen-medium's 8-layer cut's
frontend prefill (`shard_rank_frontend`), held to sim's run by
`check_shard_frontend`.  Prints each part's seconds after the build and
the frontend kernels-line rows.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402


def rank(r):
    import numpy as np
    import torch
    from repro_torch.launch.dist import init_tp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = init_tp(2, 1, backend="gloo", device="cuda:0")
    return CS.shard_rank_frontend(torch, np, g)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch.dist import spawn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = CS.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    t = time.perf_counter()
    _, rows = CS.frontend_phase(torch, np, card)
    CS.clock(t, "the frontend phase")
    CS.release(torch)
    ranks = spawn(rank, 2, backend="gloo", device="cuda:0",
                  deadline_s=400, timeout_s=300)
    CS.check_shard_frontend(np, ranks, CS.SIM_RUNS[CS.FRONT_SHARD_LABEL],
                            "gloo (host-staged, one card)", card)
    CS.clock(t, "shard (d)")
    keys = ("name", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "device_us", "library_device_us",
            "context_ms", "context_device_us", "shape")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
