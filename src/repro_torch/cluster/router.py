"""Cluster-level request router: DP-over-TP admission across replicas
(port of repro/cluster/router.py).

`ClusterRouter` fronts N `Replica`s (each one TP group + one SPD-aware
`Scheduler`) with the same external surface the single-replica
`Scheduler` exposes — `submit` / `validate` / `queue` / `step` / `run` /
`cancel` / `completed` / `has_work` — so `LLM.generate` and every
loop written against a Scheduler works unchanged against a cluster
(`LLM.load(..., dp_replicas=N)`).

Routing is pluggable through a registry (mirroring the ParallelBackend
registry pattern — a new policy is one new class):

* ``round-robin``        — cycle the routable replicas;
* ``least-outstanding``  — fewest outstanding TOKENS (prefill + decode
  budget backlog, `Scheduler.outstanding_tokens`), not request counts,
  so one long prompt weighs as much as many short ones;
* ``prefix-affinity``    — steer shared-prefix prompts to the replica
  whose page pool already holds the cached prefix (the pool's
  chain-digest prefix index), falling back to least-outstanding for cold
  prefixes;
  a sticky digest→replica map keeps a burst of identical prefixes
  together even before the first of them has registered its pages.

The router never reorders work inside a replica and never touches
per-replica numerics: routing chooses WHERE a request runs, the
replica's scheduler alone decides HOW — a single-replica cluster is
bit-identical to a bare Scheduler.  A replica's tokens equal a lone
scheduler's where its rows are computed independently of one another;
under quantized kept syncs a row can share a 128-element quantization
chunk with its neighbour slot, so the co-batch routing gives a request
can move its bits (ROADMAP C15).

On the `shard` engine every rank holds the same replicas and routes
alike: the policies read only host state that the ranks agree on
(outstanding tokens, the prefix digests of the tokens the ranks agree
on at every step).

One step() == one cluster round: pending requests are routed, then
every live replica advances one scheduler round.  Per-replica wall
times for the round are recorded in `last_step_times`; a real
deployment steps replicas concurrently, so a caller charges each round
at max(per-replica time).  On the card `last_step_times` is the host's
time of each round, which ends where the replica reads its step's
tokens back.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.cluster.replica import (CREATED, DRAINING, READY,
                                         Replica, STOPPED)
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.runtime.elastic import ClusterConfigError
from repro_torch.runtime.paging import page_hashes

__all__ = ["ClusterRouter", "RoutePolicy", "register_policy",
           "make_policy", "route_policy_names", "RoundRobinPolicy",
           "LeastOutstandingPolicy", "PrefixAffinityPolicy"]


# ---------------------------------------------------------------------------
# Policy registry
# ---------------------------------------------------------------------------

ROUTE_POLICIES: Dict[str, type] = {}


def register_policy(name: str):
    """Class decorator: `@register_policy("my-policy")` makes the policy
    constructible by name everywhere a policy string is accepted
    (`LLM.load(router=...)`, `--router`, `ClusterRouter(policy=...)`)."""
    def deco(cls):
        cls.name = name
        ROUTE_POLICIES[name] = cls
        return cls
    return deco


def route_policy_names() -> List[str]:
    return sorted(ROUTE_POLICIES)


def make_policy(policy) -> "RoutePolicy":
    """Policy instance | registered name -> policy instance."""
    if isinstance(policy, RoutePolicy):
        return policy
    if isinstance(policy, str):
        if policy not in ROUTE_POLICIES:
            raise ClusterConfigError(
                f"unknown router policy {policy!r}: expected one of "
                f"{route_policy_names()}")
        return ROUTE_POLICIES[policy]()
    raise TypeError(f"policy must be a name or RoutePolicy: {policy!r}")


class RoutePolicy:
    """Chooses which routable replica admits a request.

    `choose` receives the CURRENT routable replicas (READY + healthy,
    never empty) and the request; it must return one of them.
    `on_removed` lets stateful policies forget a retired replica."""

    name = "?"

    def choose(self, replicas: List[Replica], req) -> Replica:
        raise NotImplementedError

    def on_removed(self, rid: int):
        pass


@register_policy("round-robin")
class RoundRobinPolicy(RoutePolicy):
    """Cycle through the routable replicas in rid order."""

    def __init__(self):
        self._turn = 0

    def choose(self, replicas, req):
        replicas = sorted(replicas, key=lambda r: r.rid)
        rep = replicas[self._turn % len(replicas)]
        self._turn += 1
        return rep


@register_policy("least-outstanding")
class LeastOutstandingPolicy(RoutePolicy):
    """Fewest outstanding tokens wins; rid breaks ties deterministically."""

    def choose(self, replicas, req):
        return min(replicas, key=lambda r: (r.outstanding_tokens, r.rid))


@register_policy("prefix-affinity")
class PrefixAffinityPolicy(RoutePolicy):
    """Steer shared-prefix prompts to the replica that is already warm.

    The routing key is the chain digest of the prompt's FIRST full page
    (the port's runtime/paging.page_hashes) — exactly the digest the prefix cache
    indexes, so `Replica.holds_prefix` is a ground-truth "my pool has
    this prefix resident" signal.  Resolution order:

      1. a replica whose pool HOLDS the digest (least-outstanding among
         holders when several do);
      2. the STICKY map entry recorded when this digest was first
         routed — keeps a burst of identical prefixes on one replica
         even before the first request has prefilled and registered;
      3. fall back to least-outstanding (and record the choice).

    Prompts too short to ever share their first page (<= one page — the
    admission cap needs one position left to prefill) skip affinity
    entirely.  `hit_rate` reports the fraction of affinity-eligible
    requests routed warm/sticky."""

    def __init__(self):
        self._fallback = LeastOutstandingPolicy()
        self.affinity: Dict[bytes, int] = {}
        self.queries = 0
        self.hits = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.queries, 1)

    @staticmethod
    def _digest(replicas, req) -> Optional[bytes]:
        cache = replicas[0].sched.cache
        if not cache.paged:
            return None
        ps = cache.page_size
        prompt = np.asarray(req.prompt)
        if len(prompt) <= ps:        # first page could never be shared
            return None
        return page_hashes(prompt[:ps], ps)[0]

    def choose(self, replicas, req):
        d = self._digest(replicas, req)
        if d is None:
            return self._fallback.choose(replicas, req)
        self.queries += 1
        holders = [r for r in replicas if r.holds_prefix(d)]
        if holders:
            self.hits += 1
            rep = min(holders, key=lambda r: (r.outstanding_tokens, r.rid))
        else:
            rid = self.affinity.get(d)
            sticky = next((r for r in replicas if r.rid == rid), None)
            if sticky is not None:
                self.hits += 1
                rep = sticky
            else:
                rep = self._fallback.choose(replicas, req)
        self.affinity[d] = rep.rid
        return rep

    def on_removed(self, rid: int):
        for d in [d for d, r in self.affinity.items() if r == rid]:
            del self.affinity[d]


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


class ClusterRouter:
    """Admit requests across N replicas; Scheduler-compatible surface.

    Requests land in the router's own queue and are routed to a replica
    at the start of each `step()` (so a policy always sees the freshest
    load/affinity signals, and elastic scale-up between submit and step
    still gets to serve the backlog).  Draining replicas keep stepping
    until their in-flight work completes, then retire; retired replicas
    stay visible through `completed` / `stats` so no results are lost.
    """

    def __init__(self, replicas=(), policy="least-outstanding",
                 warmup: bool = True, obs=None):
        self.obs = obs if obs is not None else NULL_RECORDER
        self.policy = make_policy(policy)
        self.replicas: Dict[int, Replica] = {}
        self.retired: Dict[int, Replica] = {}
        self.queue: deque = deque()
        self.rounds = 0
        self.n_routed = 0
        self.last_step_times: Dict[int, float] = {}
        for rep in replicas:
            self.add_replica(rep, warmup=warmup)

    # ---------------- replica lifecycle ----------------

    def add_replica(self, rep: Replica, warmup: bool = True) -> Replica:
        """Scale up: register (and if necessary start) a replica."""
        if rep.rid in self.replicas or rep.rid in self.retired:
            raise ClusterConfigError(
                f"duplicate replica rid {rep.rid}")
        if rep.state == CREATED:
            rep.start(warmup=warmup)
        self.replicas[rep.rid] = rep
        return rep

    def drain_replica(self, rid: int) -> Replica:
        """Scale down: drain `rid` — its unadmitted queue re-routes to
        the surviving replicas, its in-flight work completes over the
        following rounds, and the replica retires once empty."""
        rep = self.replicas[rid]
        for req in reversed(rep.drain()):
            self.queue.appendleft(req)     # keep cluster FIFO order
        if rep.state == STOPPED:
            self._retire(rep)
        return rep

    def _retire(self, rep: Replica):
        self.replicas.pop(rep.rid, None)
        self.retired[rep.rid] = rep
        self.policy.on_removed(rep.rid)

    def _routable(self) -> List[Replica]:
        return [r for r in self.replicas.values() if r.routable]

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    # ---------------- Scheduler-compatible surface ----------------

    def validate(self, req):
        """Admission validation against the cluster's (shared) cache
        geometry — raises InvalidRequestError exactly like a Scheduler."""
        reps = list(self.replicas.values()) or list(self.retired.values())
        if not reps:
            raise ClusterConfigError("cluster has no replicas")
        reps[0].sched.validate(req)

    def submit(self, req):
        self.validate(req)
        self.queue.append(req)

    def route_pending(self) -> int:
        """Drain the router queue onto replicas via the policy."""
        n = 0
        while self.queue:
            routable = self._routable()
            if not routable:
                break
            req = self.queue.popleft()
            rep = self.policy.choose(routable, req)
            rep.enqueue(req)
            self.n_routed += 1
            n += 1
            if self.obs.enabled:
                self.obs.inc("cluster_routed_total", replica=rep.rid,
                             policy=self.policy.name)
                self.obs.instant("cluster", "route", uid=req.uid,
                                 replica=rep.rid)
        return n

    def step(self) -> bool:
        """One cluster round: route pending, then advance every live
        replica one scheduler round (a real deployment steps them
        concurrently — `last_step_times` records each replica's wall
        time so a caller can charge the round at the max)."""
        if not self.replicas:
            return False
        self.route_pending()
        self.rounds += 1
        if self.obs.enabled:
            self.obs.gauge("cluster_replicas", len(self.replicas))
            self.obs.gauge("cluster_queue_depth", len(self.queue))
        self.last_step_times = {}
        progressed = False
        for rep in list(self.replicas.values()):
            if rep.state not in (READY, DRAINING):
                continue
            t0 = time.perf_counter()
            p = rep.step()
            self.last_step_times[rep.rid] = time.perf_counter() - t0
            progressed = progressed or p
            if rep.state == STOPPED:
                self._retire(rep)
        # un-routed backlog only counts as work while somewhere routable
        # exists to ever serve it (otherwise a caller would spin forever)
        return progressed or (bool(self.queue) and bool(self._routable()))

    def has_work(self) -> bool:
        return bool(self.queue) or any(r.sched.has_work()
                                       for r in self.replicas.values())

    def run(self, max_steps: int = 10_000) -> Dict[int, object]:
        steps = 0
        while self.has_work() and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.completed

    def cancel(self, reqs):
        """Withdraw requests wherever they live: the router queue, any
        replica's queue/slots, or any completed map (retired included)."""
        targets = {id(r) for r in reqs}
        if not targets:
            return
        self.queue = deque(r for r in self.queue if id(r) not in targets)
        for rep in list(self.replicas.values()) + list(
                self.retired.values()):
            rep.sched.cancel(reqs)

    @property
    def completed(self) -> Dict[int, object]:
        """Merged completed map over live AND retired replicas."""
        out: Dict[int, object] = {}
        for rep in list(self.retired.values()) + list(
                self.replicas.values()):
            out.update(rep.sched.completed)
        return out

    def outstanding_tokens(self) -> int:
        from repro_torch.api.scheduler import Scheduler
        n = sum(len(r.prompt) + Scheduler._max_new(r) for r in self.queue)
        n += sum(rep.outstanding_tokens for rep in self.replicas.values())
        return n

    # ---------------- reporting ----------------

    def stats(self) -> dict:
        st = {"rounds": self.rounds, "routed": self.n_routed,
              "policy": self.policy.name,
              "queued": len(self.queue),
              "replicas": {rid: rep.stats()
                           for rid, rep in self.replicas.items()},
              "retired": {rid: rep.stats()
                          for rid, rep in self.retired.items()}}
        if isinstance(self.policy, PrefixAffinityPolicy):
            st["prefix_affinity_hit_rate"] = round(
                self.policy.hit_rate, 4)
        return st
