"""Carry the JAX reference's canonical parameters into the port.

`from_reference` takes the reference's canonical tree as numpy arrays
(`repro.core.model.init_model(...)` after `jax.tree.map(np.asarray, .)`,
done by the caller) and returns the port's canonical tree of tensors.
Padding, stacking and splitting then go through the port's own
`pad_model` / `simtp.prepare_params`.  Imports neither JAX
nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blocks import torch_dtype
from repro_torch.tree import tree_map


def from_reference(canonical_np: dict, cfg, device="cpu") -> dict:
    dt = torch_dtype(cfg)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # ml_dtypes; torch cannot wrap it
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dt)

    return tree_map(one, canonical_np)
