"""Architecture registry of the port: only the configurations this
slice serves are registered."""
from __future__ import annotations

from repro_torch.config.base import ModelConfig
from repro_torch.configs import mamba2_370m, smollm_360m

_MODULES = {"smollm-360m": smollm_360m, "mamba2-370m": mamba2_370m}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name.endswith("-reduced"):
        name, reduced = name[: -len("-reduced")], True
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.reduced() if reduced else mod.config()
