"""Simulated mesh descriptors (port of repro/launch/mesh.py).

One card holds every slot of the mesh: the model axis is the leading
shard axis of every split tensor, and the data axes ("pod", "data") are
a layout of the optimizer state and of the comm ledger (parallel/tp.py).
A `SimMesh` carries what the reference's callers read of a
`jax.sharding.Mesh`: `.shape` (axis name -> degree), `.axis_names` and
`.devices`, an array of slot ids shaped like the mesh.  It is not a
`torch.distributed` mesh: the real-device counterpart of
`make_test_mesh` is `launch/dist.init_tp` (one process per shard, rank
(p * dp + d) * tp + m at pod rank p, data rank d and model rank m),
which the `shard` engine serves and trains on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclass(frozen=True, eq=False)
class SimMesh:
    axis_names: Tuple[str, ...]
    devices: np.ndarray            # slot ids, shaped like the mesh

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(slots: Sequence[int], shape: Tuple[int, ...],
              axes: Tuple[str, ...]) -> SimMesh:
    """The first prod(shape) of `slots`, laid out as `shape`."""
    need = int(np.prod(shape))
    if len(slots) < need or len(shape) != len(axes):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need} slots, "
                         f"have {len(slots)}")
    return SimMesh(tuple(axes),
                   np.asarray(list(slots)[:need]).reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> SimMesh:
    """The reference's production layouts, 16x16 (data, model) or
    2x16x16 (pod, data, model), as a descriptor: nothing on one card
    runs them."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(range(int(np.prod(shape))), shape, axes)


def make_test_mesh(dp: int, tp: int, pod: int = 0) -> SimMesh:
    if pod:
        shape, axes = (pod, dp, tp), ("pod", "data", "model")
    else:
        shape, axes = (dp, tp), ("data", "model")
    return make_mesh(range(int(np.prod(shape))), shape, axes)
