"""Elastic scaling: rebuild the mesh from the live slots and re-shard
(port of repro/runtime/elastic.py).

Policy: the TP degree is pinned (SPD plans and distilled weights are
TP-degree-specific), the DATA axis shrinks or grows with the fleet,
snapped to a power of two.  Checkpoints store the global stacked params,
so a re-mesh is: pick the new (dp, tp) -> rebuild the trainer -> restore
the same trees under the new layout (ZeRO-1 slices re-sharded).  The
slots are the simulated mesh's (launch/mesh.py): `probe` returns the
live ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.launch.mesh import make_mesh


class ClusterConfigError(ValueError):
    """A slot topology that can never be built (e.g. fewer live slots
    than the pinned TP degree)."""


def snap_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 0


def choose_mesh_shape(n_devices: int, tp: int):
    """Largest power-of-two dp such that dp*tp <= n_devices.  A fleet
    smaller than one TP group cannot host the model at all: that is a
    `ClusterConfigError`."""
    if tp <= 0:
        raise ClusterConfigError(f"tp must be positive, got tp={tp}")
    if n_devices < tp:
        raise ClusterConfigError(
            f"{n_devices} device(s) cannot host one pinned TP group of "
            f"tp={tp}: a replica needs at least tp devices")
    return (snap_pow2(n_devices // tp), tp)


def make_mesh_from(devices: List, tp: int):
    dp, tp = choose_mesh_shape(len(devices), tp)
    return make_mesh(devices, (dp, tp), ("data", "model"))


@dataclass
class ElasticEvent:
    step: int
    old_devices: int
    new_devices: int
    new_mesh_shape: tuple


class ElasticController:
    """Re-meshes a Trainer when the live slot set changes.

    `probe` returns the live slots (tests inject shrinking lists to
    simulate node loss); without one the live set is the current mesh's
    own slots, starting from one TP group, and nothing changes."""

    def __init__(self, trainer_factory, tp: int, probe=None):
        self.trainer_factory = trainer_factory
        self.tp = tp
        self.probe = probe or self._own_slots
        self.mesh = None
        self.events: List[ElasticEvent] = []
        self.mesh = make_mesh_from(self.probe(), tp)
        self.trainer = trainer_factory(self.mesh)

    def _own_slots(self):
        if self.mesh is None:
            return list(range(self.tp))
        return list(self.mesh.devices.reshape(-1))

    def maybe_remesh(self, state, canonical_params):
        devs = self.probe()
        n_now = self.mesh.devices.size
        dp, tp = choose_mesh_shape(len(devs), self.tp)
        if dp * tp == n_now:
            return state
        self.mesh = make_mesh_from(devs, self.tp)
        self.trainer = self.trainer_factory(self.mesh)
        # re-shard from the last checkpoint
        fresh = self.trainer.init_state(canonical_params)
        restored = self.trainer.restore(state_like=fresh)
        state = restored if restored is not None else fresh
        self.events.append(ElasticEvent(
            step=state["step"], old_devices=n_now,
            new_devices=self.mesh.devices.size,
            new_mesh_shape=tuple(self.mesh.devices.shape)))
        return state
