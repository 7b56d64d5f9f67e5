"""Architecture registry of the port: the configurations it serves, in
the reference's `_MODULES` order (repro/configs/__init__.py)."""
from __future__ import annotations

from repro_torch.config.base import ModelConfig
from repro_torch.configs import (deepseek_v2_lite_16b, hymba_1p5b,
                                 internvl2_1b, llama2_7b, mamba2_370m,
                                 musicgen_medium, opt_6p7b, qwen2_72b,
                                 qwen2_moe_a2p7b, qwen3_1p7b, smollm_360m,
                                 stablelm_1p6b)

_MODULES = {
    # the assigned pool
    "smollm-360m": smollm_360m, "qwen3-1.7b": qwen3_1p7b,
    "qwen2-72b": qwen2_72b, "stablelm-1.6b": stablelm_1p6b,
    "musicgen-medium": musicgen_medium,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "qwen2-moe-a2.7b": qwen2_moe_a2p7b, "hymba-1.5b": hymba_1p5b,
    "internvl2-1b": internvl2_1b, "mamba2-370m": mamba2_370m,
    # the paper's own models
    "llama2-7b": llama2_7b, "opt-6.7b": opt_6p7b}

ASSIGNED = list(_MODULES)[:10]


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name.endswith("-reduced"):
        name, reduced = name[: -len("-reduced")], True
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.reduced() if reduced else mod.config()
