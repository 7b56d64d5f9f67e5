"""`repro_torch.obs` — end-to-end observability for the serving stack
(port of repro/obs/).

Three layers:

  * `MetricsRegistry` — labeled counters / gauges / fixed-bucket
    histograms; flat-dict snapshot + Prometheus text exposition;
  * `Tracer` — span/instant/counter events on an injected clock,
    exported as Chrome/Perfetto `trace_event` JSON;
  * `Recorder` / `NULL_RECORDER` — the handle the scheduler, cluster
    router, page pool, and drafter thread through themselves; the null
    recorder makes every hook a no-op, so observability off is the
    zero-overhead default and can never perturb tokens.

Entry points: `LLM.load(obs=Recorder(...))`, `Scheduler.metrics()`,
and `launch/serve.py --metrics-json PATH --trace PATH`.
"""
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     default_registry, set_default_registry)
from repro_torch.obs.recorder import NULL_RECORDER, NullRecorder, Recorder
from repro_torch.obs.trace import Tracer, VirtualClock, emit_comm

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "default_registry", "set_default_registry",
    "Recorder", "NullRecorder", "NULL_RECORDER",
    "Tracer", "VirtualClock", "emit_comm",
]
