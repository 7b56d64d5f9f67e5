"""The mamba path of chip_smoke.py from two checkouts in turn, on one GPU.

    python3 scripts/torch_mamba_pair.py OTHER_ROOT [THIS_ROOT]

Runs the mamba path (full-width Mamba2-370M through LLM.load(tp=2,
quant8, bf16): 4 prompts of 17, 64, 200 and 300 tokens, 16 greedy tokens
each) and its profiled generate from OTHER_ROOT, THIS_ROOT, THIS_ROOT,
OTHER_ROOT, each in a process of its own (THIS_ROOT defaults to this
checkout), and prints each run's lines: prefill_ms, decode_ms_per_token,
device-busy ms, idle share and the SSD kernels' time per launch.  Two
versions are compared only inside one call, on one card, in turns.
Each root needs its own src/ and chip_smoke.py; it builds its kernels
into its own build/.  Needs a CUDA card and nvcc; exits non-zero without.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys
root = sys.argv[1]
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as C
from repro_torch.configs import get_config
from repro_torch.kernels import build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
card = C.card_line()
rng = np.random.default_rng(0)
vocab = get_config("smollm-360m").vocab_size
prompts = [rng.integers(0, vocab, n) for n in C.PROMPT_LENS]
llm, launches, tokens = C.mamba_path(torch, np, prompts, card)
C.profile_phase(torch, llm, prompts, card, label="mamba profile")
"""
KEEP = ("mamba path [", "mamba path launches", "mamba profile")


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2] if len(sys.argv) == 3
                else Path(__file__).resolve().parents[1]).resolve()
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        res = subprocess.run([sys.executable, "-c", CHILD, str(root)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        for line in res.stdout.splitlines():
            if line.strip().startswith(KEEP):
                print(f"[{label} {root.name}] {line.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
