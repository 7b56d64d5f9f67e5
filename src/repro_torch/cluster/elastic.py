"""Elastic replica scaling: grow/shrink the cluster under traffic (port
of repro/cluster/elastic.py).

`runtime/elastic.py` owns the intra-replica story — the TP degree is
PINNED (SPD plans and distilled weights are TP-degree-specific) and
`choose_mesh_shape` snaps the data axis to the largest power-of-two dp
that fits the live fleet.  This module reuses exactly that machinery at
the cluster level: the device budget bounds `max_replicas` at the dp of
`choose_mesh_shape(n_devices, tp)` (one TP group per replica), and a
topology that cannot host even one replica raises the same typed
`ClusterConfigError`.

`ElasticScaler.observe()` is called once per cluster round (after
`router.step()`); it reacts to the router's backlog:

* **scale up** — backlog per routable replica exceeds
  `scale_up_backlog` (measured in outstanding TOKENS, the same unit the
  least-outstanding policy balances): build a replica via the injected
  factory, warm it, add it to the router;
* **scale down** — the cluster has been idle (no outstanding work) for
  `scale_down_idle` consecutive rounds: drain the highest-rid replica
  (drain = re-route its queue, finish in-flight, retire — never drops
  work);
* a `cooldown` of rounds between operations damps oscillation.

Every operation is recorded as a `ScaleEvent` (mirroring
`runtime.elastic.ElasticEvent`) so tests and callers can assert the
scaling trajectory.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional

from repro_torch.cluster.replica import Replica
from repro_torch.cluster.router import ClusterRouter
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.runtime.elastic import ClusterConfigError, choose_mesh_shape

__all__ = ["ElasticConfig", "ElasticScaler", "ScaleEvent"]


@dataclass(frozen=True)
class ElasticConfig:
    """Scaling thresholds (tokens / rounds, see module doc)."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_backlog: int = 64     # outstanding tokens per routable replica
    scale_down_idle: int = 8       # consecutive idle rounds before shrink
    cooldown: int = 4              # rounds between scale operations

    def __post_init__(self):
        if self.min_replicas < 1 or self.max_replicas < self.min_replicas:
            raise ClusterConfigError(
                f"bad replica bounds: min={self.min_replicas}, "
                f"max={self.max_replicas}")


@dataclass
class ScaleEvent:
    round: int                     # router round the operation fired at
    action: str                    # "up" | "down"
    rid: int                       # replica added / drained
    n_replicas: int                # live replicas after the operation
    # appended with defaults so legacy positional construction binds
    # unchanged: WHY the operation fired and the backlog-per-routable-
    # replica signal at that instant (tokens; 0.0 for idle shrink)
    reason: str = ""
    backlog: float = 0.0


class ElasticScaler:
    """Drives a `ClusterRouter`'s capacity from its traffic.

    `replica_factory(rid)` must return a fresh CREATED `Replica` (the
    scaler starts it; `LLM.replica_factory()` provides one over the
    loaded engine).  `n_devices`/`tp` cap `max_replicas` at the device
    budget under the pinned-TP policy."""

    def __init__(self, router: ClusterRouter,
                 replica_factory: Callable[[int], Replica],
                 cfg: Optional[ElasticConfig] = None, *,
                 n_devices: Optional[int] = None, tp: int = 1,
                 warmup: bool = True, obs=None):
        self.obs = (obs if obs is not None
                    else getattr(router, "obs", None) or NULL_RECORDER)
        cfg = cfg or ElasticConfig()
        if n_devices is not None:
            dp, _ = choose_mesh_shape(n_devices, tp)   # typed errors
            if dp < cfg.min_replicas:
                raise ClusterConfigError(
                    f"{n_devices} devices at tp={tp} fit only {dp} "
                    f"replica(s) < min_replicas={cfg.min_replicas}")
            if dp < cfg.max_replicas:
                cfg = dataclasses.replace(cfg, max_replicas=dp)
        self.router = router
        self.replica_factory = replica_factory
        self.cfg = cfg
        self.warmup = warmup
        self.events: List[ScaleEvent] = []
        self._idle_rounds = 0
        self._last_op_round = -(10 ** 9)
        self._next_rid = 1 + max(
            list(router.replicas) + list(router.retired), default=-1)

    # ---------------- signals ----------------

    def _backlog_per_replica(self) -> float:
        """Outstanding tokens per routable replica (the queue the router
        has not routed yet counts fully — it lands somewhere)."""
        routable = self.router._routable()
        return (self.router.outstanding_tokens()
                / max(len(routable), 1))

    # ---------------- the control loop ----------------

    def observe(self) -> Optional[ScaleEvent]:
        """Call once per cluster round, after `router.step()`.  Returns
        the ScaleEvent when an operation fired, else None."""
        router, cfg = self.router, self.cfg
        if router.outstanding_tokens() == 0:
            self._idle_rounds += 1
        else:
            self._idle_rounds = 0
        if router.rounds - self._last_op_round < cfg.cooldown:
            return None

        n_live = router.n_replicas
        bpr = self._backlog_per_replica()
        if n_live < cfg.max_replicas and bpr >= cfg.scale_up_backlog:
            rep = self.replica_factory(self._next_rid)
            self._next_rid += 1
            router.add_replica(rep, warmup=self.warmup)
            return self._record("up", rep.rid, reason="backlog",
                                backlog=bpr)

        if (n_live > cfg.min_replicas
                and self._idle_rounds >= cfg.scale_down_idle):
            # shrink newest-first: the longest-lived replicas keep their
            # warm prefix caches, the burst capacity drains away
            rid = max(router.replicas)
            router.drain_replica(rid)
            self._idle_rounds = 0
            return self._record("down", rid, reason="idle")
        return None

    def _record(self, action: str, rid: int, reason: str = "",
                backlog: float = 0.0) -> ScaleEvent:
        self._last_op_round = self.router.rounds
        ev = ScaleEvent(round=self.router.rounds, action=action, rid=rid,
                        n_replicas=self.router.n_replicas,
                        reason=reason, backlog=backlog)
        self.events.append(ev)
        self.obs.inc("cluster_scale_ops_total", action=action)
        if self.obs.enabled:
            self.obs.instant("cluster", f"scale_{action}", rid=rid,
                             reason=reason, backlog=round(backlog, 2),
                             n_replicas=ev.n_replicas, round=ev.round)
        return ev
