"""One serving replica: a `Scheduler` + engine + comm policy behind a
warm-up / drain lifecycle (port of repro/cluster/replica.py).

A replica is the unit the cluster router load-balances over: one TP
group running one continuous-batching `Scheduler` (its own KV pool,
prefix cache, and draft state) under one SPD comm policy.  The router
only talks to replicas through this wrapper, so admission control,
utilization accounting, and the drain protocol live here rather than
leaking into every policy.

State machine:

    CREATED --start()--> [WARMING] --> READY --drain()--> DRAINING
                                                              |
                                      (in-flight work empty)  v
                                                           STOPPED

* **warm-up** (`start(warmup=True)`): a throwaway request runs through
  the scheduler (a prefill and a decode step: on the card they launch
  the path's kernels and fill the allocator's cache before traffic
  arrives), then `Scheduler.reset` restores the scheduler's fresh state
  (page pool reset, counters zeroed, the drafter's positions and
  counters too, where the reference leaves its speculation counters
  counting the warm-up round) — a warmed replica serves what a cold one
  serves, so warm-up can never perturb serving numerics.  It runs under
  the null recorder: no metric or trace event of it remains.
* **drain** (`drain()`): the replica stops accepting routed work, hands
  its not-yet-admitted queue back for re-routing, keeps stepping its
  in-flight slots to completion, and flips to STOPPED once empty.  The
  router retires STOPPED replicas.
* **health**: `mark_unhealthy(reason)` takes a replica out of the
  routable set without touching its scheduler (operators drain or drop
  it); `healthy` is checked by the router before routing.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["Replica", "ReplicaStateError",
           "CREATED", "WARMING", "READY", "DRAINING", "STOPPED"]

CREATED = "created"
WARMING = "warming"
READY = "ready"
DRAINING = "draining"
STOPPED = "stopped"

# uid of the warm-up request: far outside both the facade's negative
# uid range and any plausible user uid, and removed before READY anyway
_WARMUP_UID = -(1 << 62)


class ReplicaStateError(RuntimeError):
    """An operation illegal in the replica's current lifecycle state."""


class Replica:
    """One `Scheduler` + engine + comm policy with a serving lifecycle.

    `comm` is the CommPolicy the replica's engine was built with (None =
    every sync exact) — carried for reporting; the engine itself already
    bakes the policy into its compiled steps.
    """

    def __init__(self, rid: int, sched, comm=None):
        self.rid = rid
        self.sched = sched
        self.comm = comm
        self.state = CREATED
        self.healthy = True
        self.health_reason: Optional[str] = None
        # utilization accounting (the router reads these for its stats)
        self.rounds = 0           # step() calls that reached the scheduler
        self.busy_rounds = 0      # rounds that made progress
        self.active_sum = 0       # sum of active slots after each round
        self.n_routed = 0         # requests the router handed this replica

    def __repr__(self):
        return (f"Replica(rid={self.rid}, state={self.state}, "
                f"routed={self.n_routed}, "
                f"outstanding={self.outstanding_tokens})")

    # ---------------- lifecycle ----------------

    def start(self, warmup: bool = True, warmup_prompt=None) -> "Replica":
        """CREATED -> READY, optionally compiling the serve path first.

        `warmup_prompt` overrides the default throwaway prompt with a
        representative one (longer prompts warm larger prefill buckets).
        """
        if self.state != CREATED:
            raise ReplicaStateError(
                f"replica {self.rid}: start() in state {self.state}")
        if warmup:
            self._warmup(warmup_prompt)
        self.state = READY
        return self

    def _warmup(self, prompt=None):
        """Run one throwaway request end to end (an admission prefill and
        a decode step), then restore the scheduler's fresh state so that
        warm-up is invisible to serving."""
        from repro_torch.api.scheduler import Request
        from repro_torch.obs.recorder import NULL_RECORDER

        self.state = WARMING
        sched = self.sched
        if prompt is None:
            cfg = getattr(sched.engine, "cfg", None)
            vocab = getattr(cfg, "vocab_size", None) or 8
            prompt = 1 + np.arange(4, dtype=np.int64) % max(vocab - 1, 1)
        req = Request(uid=_WARMUP_UID, prompt=np.asarray(prompt, np.int64),
                      max_new=2)
        # warm-up is observability-invisible too: the throwaway request
        # would otherwise pollute TTFT and the trace with its first-call
        # time
        prev_obs = sched.set_obs(NULL_RECORDER)
        try:
            sched.submit(req)
            sched.run(max_steps=64)
        finally:
            sched.set_obs(prev_obs)
        sched.reset()

    def drain(self) -> List:
        """Stop accepting work; return the NOT-yet-admitted queued
        requests (in FIFO order) for the router to re-route.  In-flight
        slots keep decoding until empty, then the state flips STOPPED."""
        if self.state == STOPPED:
            return []
        if self.state not in (READY, DRAINING):
            raise ReplicaStateError(
                f"replica {self.rid}: drain() in state {self.state}")
        requeue = list(self.sched.queue)
        self.sched.queue.clear()
        self.state = DRAINING
        if not self.sched.has_work():
            self.state = STOPPED
        return requeue

    def mark_unhealthy(self, reason: str):
        """Take the replica out of the routable set (state untouched —
        operators decide whether to drain or drop it)."""
        self.healthy = False
        self.health_reason = reason

    # ---------------- routed admission + stepping ----------------

    @property
    def routable(self) -> bool:
        return self.state == READY and self.healthy

    def enqueue(self, req):
        """Router-routed admission into this replica's scheduler."""
        if not self.routable:
            raise ReplicaStateError(
                f"replica {self.rid}: not routable "
                f"(state={self.state}, healthy={self.healthy})")
        self.sched.submit(req)
        self.n_routed += 1

    def step(self) -> bool:
        """One scheduler round (admit + grow + decode/spec).  DRAINING
        replicas keep stepping their in-flight work and flip STOPPED
        when it completes."""
        if self.state not in (READY, DRAINING):
            return False
        self.rounds += 1
        progressed = bool(self.sched.step())
        self.busy_rounds += progressed
        self.active_sum += self.active_slots
        if self.state == DRAINING and not self.sched.has_work():
            self.state = STOPPED
        return progressed

    # ---------------- load / utilization signals ----------------

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self.sched.slots)

    @property
    def outstanding_tokens(self) -> int:
        return self.sched.outstanding_tokens()

    @property
    def is_idle(self) -> bool:
        return not self.sched.has_work()

    @property
    def utilization(self) -> float:
        """Mean slot occupancy over the rounds this replica stepped."""
        return self.active_sum / max(self.rounds * self.sched.max_batch, 1)

    def tokens_out(self) -> int:
        """Tokens generated so far (completed + in-flight)."""
        n = sum(len(r.out) for r in self.sched.completed.values())
        n += sum(len(s.out) for s in self.sched.slots if s is not None)
        return n

    def holds_prefix(self, digest: bytes) -> bool:
        """Whether this replica's page pool has the prefix page for
        `digest` resident (the prefix-affinity routing signal)."""
        if not self.sched.cache.paged:
            return False
        return digest in self.sched.pool.prefix_index

    def stats(self) -> dict:
        out = {"state": self.state, "healthy": self.healthy,
               "routed": self.n_routed, "rounds": self.rounds,
               "busy_rounds": self.busy_rounds,
               "utilization": round(self.utilization, 4),
               "active_slots": self.active_slots,
               "outstanding_tokens": self.outstanding_tokens,
               "tokens_out": self.tokens_out(),
               "preemptions": self.sched.n_preemptions}
        if self.sched.cache.paged:
            out["pool_high_water"] = self.sched.pool.high_water
            out["prefix_queries"] = self.sched.kv.prefix_queries
            out["prefix_hits"] = self.sched.kv.prefix_hits
        return out
