"""`Recorder` / `NullRecorder` — the one observability handle the
serving stack threads through itself (port of repro/obs/recorder.py,
the same method set).

Every instrumentation site in the scheduler, router, page pool, and
drafter holds a recorder and calls it unconditionally; with the default
`NULL_RECORDER` each call is an attribute lookup plus an empty method —
no clocks read, no dicts touched, no events stored — which is the
"zero overhead when disabled" contract (observability can never
perturb tokens because it never touches tensors either way: no hook
reads the device, synchronizes it or launches a kernel).

A live `Recorder` bundles a `MetricsRegistry` and a `Tracer` (sharing
the tracer's clock for span math) and exposes the thin convenience
surface the call sites use:

    obs.inc("preemptions_total")                counters
    obs.gauge("pool_pages_used", 37)            gauges
    obs.observe("ttft_seconds", 0.012)          histograms
    with obs.span("scheduler", "step"): ...     timed slices
    obs.instant("cluster", "scale_up", ...)     markers
    obs.record_comm(entries, latency, tp=8)     ledger -> comm track

Guard genuinely non-trivial preparation (building an args dict, string
formatting) behind `if obs.enabled:` — the recorder methods themselves
are cheap either way.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.trace import Tracer, emit_comm

__all__ = ["Recorder", "NullRecorder", "NULL_RECORDER"]


class _NullCtx:
    """Reusable no-op context manager (also yields a throwaway dict so
    `with obs.span(...) as s: s["k"] = v` works unchanged)."""

    def __enter__(self):
        return {}

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullRecorder:
    """Every method a no-op; `enabled` is False.  One shared instance
    (`NULL_RECORDER`) is the default everywhere."""

    enabled = False
    metrics: Optional[MetricsRegistry] = None
    tracer: Optional[Tracer] = None

    def now(self) -> float:
        return 0.0

    def inc(self, name, value=1.0, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def span(self, track, name, **args):
        return _NULL_CTX

    def instant(self, track, name, **args):
        pass

    def complete(self, track, name, start_s, dur_s, **args):
        pass

    def counter_event(self, track, name, value):
        pass

    def record_comm(self, entries, latency=None, *, tp=1, overlap=False):
        return {}

    def snapshot(self):
        return {}


NULL_RECORDER = NullRecorder()


class Recorder(NullRecorder):
    """Live metrics + tracing (module docstring).

    `metrics=None` binds the process-global default registry; pass a
    fresh `MetricsRegistry()` to isolate a run (serve CLI, tests).
    `tracer=None` builds a wall-clock tracer; inject
    `Tracer(clock=VirtualClock(...))` for deterministic tests."""

    enabled = True

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, clock=None):
        self.metrics = metrics if metrics is not None else default_registry()
        self.tracer = tracer if tracer is not None else Tracer(clock=clock)

    def now(self) -> float:
        return self.tracer.now()

    # ---------------- metrics ----------------

    def inc(self, name, value=1.0, **labels):
        self.metrics.inc(name, value, **labels)

    def gauge(self, name, value, **labels):
        self.metrics.set(name, value, **labels)

    def observe(self, name, value, **labels):
        self.metrics.observe(name, value, **labels)

    def snapshot(self):
        return self.metrics.snapshot()

    # ---------------- tracing ----------------

    def span(self, track, name, **args):
        return self.tracer.span(track, name, **args)

    def instant(self, track, name, **args):
        self.tracer.instant(track, name, args or None)

    def complete(self, track, name, start_s, dur_s, **args):
        self.tracer.complete(track, name, start_s, dur_s, args or None)

    def counter_event(self, track, name, value):
        self.tracer.counter(track, name, value)

    def record_comm(self, entries, latency=None, *, tp=1, overlap=False):
        """Comm-ledger entries -> "comm" track slices + comm metrics
        (obs.trace.emit_comm)."""
        return emit_comm(self.tracer, entries, latency, tp=tp,
                         overlap=overlap, metrics=self.metrics)
