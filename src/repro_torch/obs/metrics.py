"""`MetricsRegistry` — labeled counters, gauges, and fixed-bucket
histograms with a flat-dict snapshot and a Prometheus-style text
exposition (port of repro/obs/metrics.py, kept line for line: the same
calls give the same snapshot and the same text).

Design rules:

  * pure host-side Python — no torch import, no device sync, safe to
    call from any scheduler/router/pool hot path;
  * every metric is LABELED: a metric name owns one type and one bucket
    layout, each distinct label set is an independent series;
  * histograms use FIXED buckets chosen at first registration (no
    dynamic rebucketing — snapshots are stable across runs);
  * one process-global default registry (`default_registry()`) for code
    without an injected `Recorder`, plus freely constructible instances
    (tests and `launch/serve.py` isolate themselves with fresh ones).

Snapshot format (`snapshot()`): a flat `{series_name: value}` dict —
`name` or `name{k="v",...}` for counters/gauges; histograms expand to
`name_bucket{le="..."}` cumulative counts plus `name_sum` / `name_count`
(the Prometheus data model, so the text exposition is a straight
rendering of the same dict).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "set_default_registry", "DEFAULT_BUCKETS"]

# generic latency-ish buckets (seconds); callers with different units
# register their histogram explicitly with their own layout
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: LabelKey, extra: Iterable = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return f"{name}{{{body}}}"


class _Metric:
    """Shared bookkeeping: one metric name, many labeled series."""

    kind = "?"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def _check_labels(self, labels: dict) -> LabelKey:
        return _key(labels)


class Counter(_Metric):
    """Monotonic labeled counter (negative increments are rejected)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.series: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        k = self._check_labels(labels)
        self.series[k] = self.series.get(k, 0.0) + value

    def get(self, **labels) -> float:
        return self.series.get(_key(labels), 0.0)

    def snapshot_into(self, out: Dict[str, float]):
        for k, v in sorted(self.series.items()):
            out[_series_name(self.name, k)] = v


class Gauge(_Metric):
    """Labeled point-in-time value (last write wins)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels):
        self.series[self._check_labels(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels):
        k = self._check_labels(labels)
        self.series[k] = self.series.get(k, 0.0) + value

    def get(self, **labels) -> float:
        return self.series.get(_key(labels), 0.0)

    def snapshot_into(self, out: Dict[str, float]):
        for k, v in sorted(self.series.items()):
            out[_series_name(self.name, k)] = v


class Histogram(_Metric):
    """Fixed-bucket labeled histogram (cumulative le-style buckets plus
    sum/count, the Prometheus layout)."""

    kind = "histogram"

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS, help: str = ""):
        super().__init__(name, help)
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"non-empty strictly increasing sequence")
        self.buckets = b
        # per label set: [per-bucket counts..., +Inf count], sum
        self.series: Dict[LabelKey, list] = {}
        self.sums: Dict[LabelKey, float] = {}

    def observe(self, value: float, **labels):
        k = self._check_labels(labels)
        counts = self.series.get(k)
        if counts is None:
            counts = self.series[k] = [0] * (len(self.buckets) + 1)
            self.sums[k] = 0.0
        v = float(value)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self.sums[k] += v

    def count(self, **labels) -> int:
        return sum(self.series.get(_key(labels), []))

    def sum(self, **labels) -> float:
        return self.sums.get(_key(labels), 0.0)

    def cumulative(self, key: LabelKey) -> list:
        """Cumulative per-bucket counts including the +Inf bucket."""
        counts = self.series[key]
        out, running = [], 0
        for c in counts:
            running += c
            out.append(running)
        return out

    def snapshot_into(self, out: Dict[str, float]):
        for k in sorted(self.series):
            cum = self.cumulative(k)
            for ub, c in zip(self.buckets, cum[:-1]):
                out[_series_name(f"{self.name}_bucket", k,
                                 [("le", format_le(ub))])] = c
            out[_series_name(f"{self.name}_bucket", k,
                             [("le", "+Inf")])] = cum[-1]
            out[_series_name(f"{self.name}_sum", k)] = self.sums[k]
            out[_series_name(f"{self.name}_count", k)] = cum[-1]


def format_le(ub: float) -> str:
    """Bucket upper bound rendered without float noise ("0.005", "1")."""
    s = f"{ub:.10g}"
    return s


class MetricsRegistry:
    """A namespace of metrics; see module docstring for the contract."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    # ---------------- registration ----------------

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS,
                  help: str = "") -> Histogram:
        h = self._get(name, Histogram, buckets=buckets, help=help)
        if h.buckets != tuple(float(x) for x in buckets):
            raise ValueError(f"histogram {name!r} already registered "
                             f"with buckets {h.buckets}")
        return h

    # ---------------- convenience (auto-registering) ----------------

    def inc(self, name: str, value: float = 1.0, **labels):
        self.counter(name).inc(value, **labels)

    def set(self, name: str, value: float, **labels):
        self.gauge(name).set(value, **labels)

    def observe(self, name: str, value: float, buckets=None, **labels):
        h = (self.histogram(name) if buckets is None
             else self.histogram(name, buckets=buckets))
        h.observe(value, **labels)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # ---------------- export ----------------

    def snapshot(self) -> Dict[str, float]:
        """Flat `{series_name: value}` dict (module docstring format)."""
        out: Dict[str, float] = {}
        for name in sorted(self._metrics):
            self._metrics[name].snapshot_into(out)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one HELP/TYPE header per metric,
        one line per labeled series)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            series: Dict[str, float] = {}
            m.snapshot_into(series)
            for sname, v in series.items():
                if isinstance(v, float) and v == int(v):
                    lines.append(f"{sname} {int(v)}")
                else:
                    lines.append(f"{sname} {v}")
        return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry (code without an injected Recorder)."""
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, reg
    return prev
