"""`Tracer` — structured span/instant/counter events on an injected
clock, exported as Chrome/Perfetto `trace_event` JSON (port of
repro/obs/trace.py: the same calls give the same events).

Clock contract: the tracer never calls `time` directly — it is handed a
zero-arg callable returning SECONDS (default `time.perf_counter`;
`VirtualClock` for deterministic tests).  Event timestamps are recorded
as MICROSECONDS relative to the tracer's construction instant, which is
what the Chrome trace format expects in `ts`/`dur`.  The clock is the
host's: on the card a span covers what the host waited for, and the
scheduler's spans end where it reads a step's tokens back.

Track model: a track is a named timeline (one Perfetto "thread").  The
first event on a track registers it — a `thread_name` metadata event
plus a `thread_sort_index` keeping registration order — so the Perfetto
UI shows e.g.:

    slot0..N            per-slot request lifecycle slices
                        (queue -> prefill -> serve)
    scheduler           one slice per Scheduler.step round
    spec                draft / verify slices per speculative round
    cluster             routing instants + elastic scale events
    comm                one slice per comm-ledger entry (est_us-sized,
                        hidden/exposed split in args; emit_comm below)

Everything here is host-side bookkeeping: events are plain dicts
appended to a list; `save()`/`to_dict()` serialize the
`{"traceEvents": [...]}` wrapper `chrome://tracing` and Perfetto's UI
load directly.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

__all__ = ["Tracer", "VirtualClock", "emit_comm"]

PID = 1                      # one logical process per trace


class VirtualClock:
    """Deterministic injectable clock: starts at `start` seconds and
    advances `tick` seconds every read (plus explicit `advance`)."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.t
        self.t += self.tick
        return t

    def advance(self, dt: float):
        self.t += float(dt)


class Tracer:
    """Append-only trace-event collector (module docstring)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock = clock if clock is not None else time.perf_counter
        self._t0 = self._clock()
        self.events: List[dict] = []
        self._tids: Dict[str, int] = {}

    # ---------------- time ----------------

    def now(self) -> float:
        """Seconds since tracer construction (the span-math timebase)."""
        return self._clock() - self._t0

    # ---------------- tracks ----------------

    def track(self, name: str) -> int:
        """tid of `name`, registering metadata events on first use."""
        tid = self._tids.get(name)
        if tid is None:
            tid = self._tids[name] = len(self._tids) + 1
            self.events.append({"name": "thread_name", "ph": "M",
                                "pid": PID, "tid": tid,
                                "args": {"name": name}})
            self.events.append({"name": "thread_sort_index", "ph": "M",
                                "pid": PID, "tid": tid,
                                "args": {"sort_index": tid}})
        return tid

    def tracks(self) -> List[str]:
        return list(self._tids)

    # ---------------- events ----------------

    def _ev(self, ph: str, track: str, name: str, ts_s: float,
            args: Optional[dict] = None, **extra) -> dict:
        ev = {"name": name, "ph": ph, "pid": PID,
              "tid": self.track(track),
              "ts": round(ts_s * 1e6, 3)}
        ev.update(extra)
        if args:
            ev["args"] = args
        self.events.append(ev)
        return ev

    def complete(self, track: str, name: str, start_s: float,
                 dur_s: float, args: Optional[dict] = None) -> dict:
        """One finished slice: `start_s`/`dur_s` in seconds on the
        tracer timebase (a `ph="X"` complete event)."""
        return self._ev("X", track, name, start_s, args,
                        dur=round(max(dur_s, 0.0) * 1e6, 3))

    def instant(self, track: str, name: str,
                args: Optional[dict] = None,
                ts_s: Optional[float] = None) -> dict:
        """A zero-duration marker (`ph="i"`, thread-scoped)."""
        ts = self.now() if ts_s is None else ts_s
        return self._ev("i", track, name, ts, args, s="t")

    def counter(self, track: str, name: str, value: float,
                ts_s: Optional[float] = None) -> dict:
        """A counter sample (`ph="C"` — Perfetto renders a step plot)."""
        ts = self.now() if ts_s is None else ts_s
        return self._ev("C", track, name, ts, {name: value})

    @contextmanager
    def span(self, track: str, name: str, **args):
        """Measure the enclosed block as a complete slice.  Yields a
        dict merged into the slice args at exit (annotate results)."""
        t0 = self.now()
        out: dict = dict(args)
        try:
            yield out
        finally:
            self.complete(track, name, t0, self.now() - t0, out or None)

    # ---------------- export ----------------

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)


def emit_comm(tracer: Tracer, entries, latency=None, *, tp: int = 1,
              overlap: bool = False, track: str = "comm",
              t0_s: float = 0.0, metrics=None) -> dict:
    """Re-emit comm-ledger entries (`parallel.collectives.CommEntry`) as
    sequential slices on a trace track, split hidden-vs-exposed.

    Each entry becomes one `est_us`-long slice named after its op, laid
    end to end from `t0_s`, with args carrying the payload bytes, the
    block/phase attribution labels, and the `LatencyModel.split_us`
    hidden/exposed decomposition (`overlap=True` reads the ledger the
    way the overlap backend schedules it).  The port runs eagerly, so its
    ledger logs every call: a segment's layers appear once at their
    `ledger_scale`-multiplied cost (as the reference's scan body does),
    but every forward of a run logs its entries, where the reference's
    compiled-and-reused step logs them only at its first compilation.

    When `metrics` (a MetricsRegistry) is given, aggregates land there
    too: `comm_hidden_us_total` / `comm_exposed_us_total` /
    `comm_kept_sync_us_total` counters, per-op `comm_entries_total` and
    `comm_wire_bytes_total`, and `spd_quant_bytes_total` (bytes of the
    kept quantized block syncs — the overlappable non-all-reduce
    entries, i.e. the two-hop RS/AG pairs and their ring-step
    decompositions).  Returns the aggregate dict."""
    cursor = float(t0_s)
    agg = {"total_us": 0.0, "hidden_us": 0.0, "exposed_us": 0.0,
           "kept_sync_us": 0.0, "quant_bytes": 0, "entries": 0}
    for e in entries:
        est = float(e.est_us)
        if est == 0.0 and latency is not None and tp > 1:
            # byte-only capture: price it here (same formula the ledger
            # applies when opened with latency=/tp=)
            e = e._replace(est_us=latency.collective_us(e.op, e.nbytes, tp),
                           fixed_us=latency.launch_us)
            est = float(e.est_us)
        if e.overlappable and latency is not None and overlap:
            hidden, exposed = latency.split_us(e)
        else:
            hidden, exposed = 0.0, est
        block = getattr(e, "block", -1)
        phase = getattr(e, "phase", "")
        args = {"op": e.op, "axis": e.axis, "bytes": int(e.nbytes),
                "hidden_us": round(hidden, 4),
                "exposed_us": round(exposed, 4)}
        if block >= 0:
            args["block"] = int(block)
        if phase:
            args["phase"] = phase
        name = e.op if not phase else f"{e.op}[{phase}]"
        tracer.complete(track, name, cursor, est * 1e-6, args)
        cursor += est * 1e-6
        agg["total_us"] += est
        agg["hidden_us"] += hidden
        agg["exposed_us"] += exposed
        agg["entries"] += 1
        if e.overlappable:
            agg["kept_sync_us"] += est
            if e.op != "all-reduce":
                agg["quant_bytes"] += int(e.nbytes)
        if metrics is not None:
            metrics.inc("comm_entries_total", op=e.op)
            metrics.inc("comm_wire_bytes_total", int(e.nbytes), op=e.op)
    if metrics is not None:
        metrics.inc("comm_hidden_us_total", agg["hidden_us"])
        metrics.inc("comm_exposed_us_total", agg["exposed_us"])
        metrics.inc("comm_kept_sync_us_total", agg["kept_sync_us"])
        metrics.inc("spd_quant_bytes_total", agg["quant_bytes"])
    return agg
