"""PyTorch port's observability (`repro_torch.obs`) against the JAX
reference's (`repro.obs`): the metrics registry, the Chrome-trace
tracer, the comm-ledger re-emission (`emit_comm`) and the scheduler's
hooks.

  * the same calls on both registries give the same snapshot and the
    same Prometheus text; the same calls on both tracers under a
    VirtualClock give the same events (exactly: host arithmetic on the
    same floats);
  * `emit_comm` on the same entries and the same explicit LatencyModel,
    and on the priced ledger of one prefill and one decode step of
    reduced SmolLM (tp 2, quant8 kept syncs), gives the same aggregate
    and events within EMIT_TOL;
  * the port's ledger logs every call where the reference's logs a
    compiled step once (ROADMAP C14);
  * both packages' schedulers on the same paged workload (a pool small
    enough to preempt, a warm prefix admission) under
    Recorder(MetricsRegistry(), Tracer(VirtualClock(tick=1e-3))): every
    counter and gauge equal, every histogram's count equal, the trace's
    (ph, track, name) sequence equal; with speculation (adaptive, tree
    width 2) too; greedy tokens equal with obs on and off; a replica's
    warm-up leaves no metric and no event.
Reduced SmolLM-360M, fp32, the reference's parameters with every norm
leaf moved off its constant (torch_parity.perturbed_canonical)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as RO  # noqa: E402
from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.api.scheduler import Request as RRequest  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.parallel import collectives as RC  # noqa: E402
from repro.spec import SpecConfig as RSpec  # noqa: E402

from repro_torch import obs as O  # noqa: E402
from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.api.scheduler import Request  # noqa: E402
from repro_torch.cluster import Replica  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "smollm-360m"
TP, CACHE, PS = 2, 64, 8
TICK = 1e-3
# emit_comm's aggregate and event times: the same float formulas over
# the same bytes in both packages; sums in the same order
EMIT_TOL = 1e-9
# one link model for both packages (the reference CLI's defaults are
# not this card's): NVLink 4's data-sheet rate, an assumed launch cost
LINK, LAUNCH = 450e9, 5.0
# a paged workload that preempts on a 6-page pool and admits one prompt
# warm (request 2 extends request 1's prompt past two full pages)
POOL = dict(cache_len=CACHE, max_batch=3, page_size=PS, num_pages=6)
LENS = (4, 19, 11, 26, 7)
MAX_NEW = 7
HIST = ("ttft_seconds", "tpot_seconds", "queue_wait_seconds",
        "spec_acceptance_ratio", "spec_request_acceptance")


# ---------------------------------------------------------------------------
# Registry and tracer: the same calls, the same outputs
# ---------------------------------------------------------------------------

def _registry_calls(mod):
    reg = mod.MetricsRegistry()
    reg.inc("reqs_total")
    reg.inc("reqs_total", 2.0)
    reg.inc("reqs_total", reason="stop")
    reg.counter("hits_total", help="prefix hits").inc(3, kind="a")
    reg.set("depth", 7, queue="main")
    reg.set("depth", 3, queue="main")
    reg.gauge("pages").inc(5)
    h = reg.histogram("lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0, 1.0):
        h.observe(v)
    reg.observe("auto", 0.0123)
    reg.observe("ratio", 0.25, buckets=(0.0, 0.5, 1.0), slot="1")
    return reg


def test_registry_snapshot_and_prometheus_equal_reference():
    got, want = _registry_calls(O), _registry_calls(RO)
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus() == want.to_prometheus()
    assert O.DEFAULT_BUCKETS == RO.DEFAULT_BUCKETS
    with pytest.raises(TypeError):
        got.set("reqs_total", 1.0)               # counter vs gauge
    with pytest.raises(ValueError):
        got.histogram("lat", buckets=(0.1, 2.0))  # the layout is fixed
    with pytest.raises(ValueError):
        got.inc("reqs_total", -1.0)               # counters are monotonic


def test_default_registry_swap_roundtrip():
    mine = O.MetricsRegistry()
    prev = O.set_default_registry(mine)
    try:
        assert O.default_registry() is mine
        O.Recorder().inc("x")                     # metrics=None binds it
        assert mine.snapshot() == {"x": 1.0}
    finally:
        O.set_default_registry(prev)
    assert O.default_registry() is prev


def _trace_calls(mod):
    tr = mod.Tracer(clock=mod.VirtualClock(start=5.0, tick=0.5))
    with tr.span("sched", "step", round=1) as s:
        s["active"] = 2
    tr.instant("cluster", "scale_up", {"rid": 1})
    tr.counter("sched", "active_slots", 2)
    tr.complete("slot0", "queue", 0.25, 0.125, {"uid": 3})
    return tr


def test_tracer_chrome_schema_equals_reference(tmp_path):
    got, want = _trace_calls(O), _trace_calls(RO)
    assert got.events == want.events
    assert got.tracks() == want.tracks() == ["sched", "cluster", "slot0"]
    assert got.to_dict() == want.to_dict()
    p = tmp_path / "trace.json"
    got.save(str(p))
    assert json.loads(p.read_text()) == want.to_dict()


def test_null_recorder_is_inert():
    null = O.NULL_RECORDER
    assert not null.enabled and null.now() == 0.0
    null.inc("x")
    null.gauge("x", 1)
    null.observe("x", 1)
    null.instant("t", "n")
    null.counter_event("t", "n", 1)
    with null.span("t", "n") as s:
        s["k"] = "v"                              # a writable throwaway
    assert null.snapshot() == {} and null.record_comm([], None) == {}
    assert [m for m in dir(RO.NullRecorder) if not m.startswith("_")] == \
        [m for m in dir(O.NullRecorder) if not m.startswith("_")]


# ---------------------------------------------------------------------------
# Comm-ledger re-emission
# ---------------------------------------------------------------------------

def _entries(mod, lat, tp):
    def priced(op, nbytes, overlappable, block=-1, phase=""):
        return mod.CommEntry(op, "model", nbytes, overlappable,
                             lat.collective_us(op, nbytes, tp),
                             lat.launch_us, block, phase)
    return [priced("all-reduce", 4096, True, 3, "prefill"),
            priced("reduce-scatter", 2048, True, 5, "decode"),
            priced("all-gather", 1024, True, 5, "decode"),
            priced("collective-permute", 512, True, 6, "decode"),
            priced("all-gather", 8192, False),
            mod.CommEntry("all-reduce", "model", 1 << 20, True)]  # unpriced


def _emitted(mod, entries, lat, tp, overlap):
    tr = mod.Tracer(clock=mod.VirtualClock())
    reg = mod.MetricsRegistry()
    agg = mod.emit_comm(tr, entries, lat, tp=tp, overlap=overlap,
                        metrics=reg)
    return agg, tr.events, reg.snapshot()


def _assert_emitted_close(got, want):
    (agg, ev, snap), (ragg, rev, rsnap) = got, want
    assert agg.keys() == ragg.keys()
    for k in agg:
        assert agg[k] == pytest.approx(ragg[k], rel=EMIT_TOL, abs=EMIT_TOL), k
    assert snap.keys() == rsnap.keys()
    for k in snap:
        assert snap[k] == pytest.approx(rsnap[k], rel=EMIT_TOL), k
    assert len(ev) == len(rev)
    for a, b in zip(ev, rev):
        assert {k: a[k] for k in a if k not in ("ts", "dur", "args")} == \
            {k: b[k] for k in b if k not in ("ts", "dur", "args")}
        for k in ("ts", "dur"):
            assert a.get(k, 0.0) == pytest.approx(b.get(k, 0.0),
                                                  abs=EMIT_TOL), (k, a, b)
        assert a.get("args", {}) == pytest.approx(b.get("args", {}),
                                                  abs=EMIT_TOL)


@pytest.mark.parametrize("overlap", [False, True])
def test_emit_comm_equals_reference(overlap):
    tp = 4
    lat = C.LatencyModel(link_bytes_per_s=LINK, launch_us=LAUNCH)
    rlat = RC.LatencyModel(link_bytes_per_s=LINK, launch_us=LAUNCH)
    got = _emitted(O, _entries(C, lat, tp), lat, tp, overlap)
    want = _emitted(RO, _entries(RC, rlat, tp), rlat, tp, overlap)
    _assert_emitted_close(got, want)
    agg = got[0]
    assert agg["hidden_us"] + agg["exposed_us"] == pytest.approx(
        agg["total_us"], rel=EMIT_TOL)
    assert (agg["hidden_us"] > 0.0) == overlap
    assert agg["quant_bytes"] == 2048 + 1024 + 512
    # without a latency model the unpriced entry stays byte accounting
    assert O.emit_comm(O.Tracer(clock=O.VirtualClock()),
                       _entries(C, lat, tp)[-1:])["total_us"] == 0.0


# ---------------------------------------------------------------------------
# The reduced model on both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(reference LLM, port LLM) on the same canonical parameters: tp 2,
    spd 0.25, exact kept syncs (at tp 2 the packages' partials differ by
    ulps, which a quantized sync can turn into a code step and another
    token: test_torch_grads_quant.py), dense caches (schedulers with other
    geometry come from serve(**cc))."""
    rcfg = rreplace(rget(ARCH, reduced=True), dtype="float32")
    cfg = replace(get_config(ARCH, reduced=True), dtype="float32")
    canon = perturbed_canonical(rcfg)
    kw = dict(tp=TP, spd=0.25, cache_len=CACHE, max_batch=3)
    ref = RLLM.load(rcfg, params=jax.tree.map(jnp.asarray, canon), **kw)
    port = LLM.load(cfg, device="cpu", params=from_reference(canon, cfg),
                    **kw)
    return ref, port


def _prompts(vocab, lens=LENS, seed=4):
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    # a prompt extending prompt 1 (19 tokens: two full pages), admitted in
    # the same round right after it, admits warm
    ps.insert(2, np.concatenate([ps[1], rng.integers(0, vocab, 5)
                                 .astype(np.int32)]))
    return ps


def test_priced_prefill_and_decode_emit_as_reference(models):
    """One prefill and one decode step of the served model under a ledger
    priced with the same LatencyModel in both packages: emit_comm gives
    the same aggregate, metrics and comm-track events (the reference's
    jitted steps log at their tracing, here their first call).  The
    engines run the served plan with quant8 kept syncs and logits gather:
    the ledger's entries depend on shapes alone."""
    from repro.config.base import CommPolicy as RComm
    from repro_torch.config.base import CommPolicy
    ref, port = models
    p = _prompts(port.cfg.vocab_size)[3]
    toks = np.zeros((1, 32), np.int32)
    toks[0, :len(p)] = p
    ln = np.asarray([len(p)], np.int32)
    lat = C.LatencyModel(link_bytes_per_s=LINK, launch_us=LAUNCH)
    rlat = RC.LatencyModel(link_bytes_per_s=LINK, launch_us=LAUNCH)
    n = port.cfg.n_layers
    reng = ref._make_engine(ref.plan.with_comm(
        RComm.uniform(n, "quant8", logits="quant8")))   # fresh: traced
    rparams = ref._place(ref.canonical, padded=False, engine=reng)
    eng = port._make_engine(port.plan.with_comm(
        CommPolicy.uniform(n, "quant8", logits="quant8")))
    params = port._place(eng)
    with RC.collective_ledger(latency=rlat, tp=TP) as rled:
        _, rc = reng.prefill(rparams, jnp.asarray(toks),
                             cache_len=CACHE, lengths=jnp.asarray(ln))
        reng.decode(rparams, jnp.asarray([[7]], jnp.int32),
                    jnp.asarray(ln), rc)
    with C.collective_ledger(latency=lat, tp=TP) as led:
        _, c = eng.prefill(params, toks.astype(np.int64), cache_len=CACHE,
                           lengths=ln.astype(np.int64))
        eng.decode(params, np.asarray([[7]]), ln.astype(np.int64), c)
    assert len(led) == len(rled) > 0
    assert {e.phase for e in led} >= {"prefill", "decode"}
    assert {e.op for e in led} >= {"reduce-scatter", "all-gather"}
    for overlap in (False, True):
        _assert_emitted_close(_emitted(O, led, lat, TP, overlap),
                              _emitted(RO, rled, rlat, TP, overlap))


def _tuples(led):
    return [(e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)
            for e in led]


def test_c14_port_ledger_logs_every_call(models):
    """ROADMAP C14: a generate of 1 prefill + 3 decode steps logs the
    reference's prefill entries once and its decode entries once (its
    compiled decode step logged when it was traced), the port's decode
    entries once a step."""
    ref, port = models
    p = _prompts(port.cfg.vocab_size)[2]
    rfresh = RLLM.load(ref.cfg, tp=TP, plan=ref.plan, cache_len=CACHE,
                       max_batch=3, params=ref.canonical)
    with RC.collective_ledger() as rled:
        rout = rfresh.generate([p], RSP(max_new=4))
    with C.collective_ledger() as led:
        out = port.generate([p], SamplingParams(max_new=4))
    with C.collective_ledger() as led1:       # the prefill alone
        port.generate([p], SamplingParams(max_new=1))
    assert out[0].token_ids == rout[0].token_ids
    want, n = _tuples(rled), len(led1)
    assert _tuples(led1) == want[:n]
    assert len(want) > n and _tuples(led) == want[:n] + want[n:] * 3


# ---------------------------------------------------------------------------
# The scheduler's hooks against the reference's
# ---------------------------------------------------------------------------

def _recorder(mod):
    return mod.Recorder(mod.MetricsRegistry(),
                        mod.Tracer(clock=mod.VirtualClock(tick=TICK)))


def _served(llm, mod, req_cls, obs=True, **cc):
    """A fresh scheduler of `llm` with `cc` under a virtual-clock
    recorder (or none): the workload submitted and run.  Returns
    (scheduler, recorder, {uid: tokens})."""
    sched = llm.serve(**dict(POOL, **cc))
    rec = _recorder(mod) if obs else None
    if rec is not None:
        sched.set_obs(rec)
    for uid, p in enumerate(_prompts(llm.cfg.vocab_size)):
        sched.submit(req_cls(uid=uid, prompt=p, max_new=MAX_NEW))
    done = sched.run()
    return sched, rec, {u: r.out for u, r in sorted(done.items())}


def _is_hist(key):
    return any(key.startswith(h + "_") for h in HIST)


def _assert_obs_equal(rec, rrec):
    snap, rsnap = rec.snapshot(), rrec.snapshot()
    assert snap.keys() == rsnap.keys()
    plain = {k: v for k, v in snap.items() if not _is_hist(k)}
    assert plain == {k: rsnap[k] for k in plain}
    counts = [k for k in snap if k.endswith("_count")]
    assert counts and all(snap[k] == rsnap[k] for k in counts)
    seq = [(e["ph"], e["tid"], e["name"]) for e in rec.tracer.events]
    rseq = [(e["ph"], e["tid"], e["name"]) for e in rrec.tracer.events]
    assert rec.tracer.tracks() == rrec.tracer.tracks()
    assert seq == rseq
    return snap


def test_scheduler_obs_equals_reference(models):
    """Paged, a 6-page pool: both preempt, one prompt admits warm; the
    snapshots' counters and gauges, histogram counts and the trace's
    (ph, track, name) sequence are equal."""
    ref, port = models
    rs, rrec, rtoks = _served(ref, RO, RRequest)
    s, rec, toks = _served(port, O, Request)
    assert toks == rtoks
    assert s.n_preemptions == rs.n_preemptions > 0
    assert s.kv.prefix_hits == rs.kv.prefix_hits > 0
    snap = _assert_obs_equal(rec, rrec)
    n = len(toks)
    assert snap["requests_submitted_total"] == n
    assert snap["ttft_seconds_count"] == snap["tpot_seconds_count"] == n
    assert snap["preemptions_total"] == s.n_preemptions
    assert snap["prefix_cache_hits_total"] == s.kv.prefix_hits
    assert snap["pages_shared_total"] > 0
    steps = sum(1 for e in rec.tracer.events
                if e["ph"] == "X" and e["name"] == "step")
    assert steps == sum(1 for e in rec.tracer.events if e["ph"] == "C") > 0
    marks = [e for e in rec.tracer.events
             if e["ph"] == "i" and e["name"] == "preempt"]
    assert len(marks) == s.n_preemptions
    assert s.metrics()["registry"] == snap


def test_spec_scheduler_obs_equals_reference(models):
    """The same workload with adaptive speculation (k 2..4, tree width
    2): the spec counters, the per-slot spec_k gauges, both acceptance
    histograms (whole: ratios, not times) and the draft / verify spans
    equal the reference's."""
    ref, port = models
    ref.enable_spec(RSpec(k=2, adaptive=True, k_max=4, tree_width=2))
    port.enable_spec(SpecConfig(k=2, adaptive=True, k_max=4, tree_width=2))
    try:
        rs, rrec, rtoks = _served(ref, RO, RRequest, num_pages=12)
        s, rec, toks = _served(port, O, Request, num_pages=12)
    finally:
        ref.disable_spec()
        port.disable_spec()
    assert toks == rtoks
    snap = _assert_obs_equal(rec, rrec)
    rsnap = rrec.snapshot()
    for k in snap:
        if k.startswith(("spec_acceptance_ratio", "spec_request_acc")):
            assert snap[k] == pytest.approx(rsnap[k], rel=1e-12), k
    assert snap["spec_drafted_total"] == s.spec_drafted > 0
    assert snap["spec_accepted_total"] == s.spec_accepted
    assert snap["spec_draft_rounds_total"] == s.spec_rounds
    assert any(k.startswith('spec_k{slot="') for k in snap)
    spans = [e for e in rec.tracer.events
             if e["ph"] == "X" and e["name"] in ("draft", "verify")]
    assert spans and all(e["args"]["tree"] == 2 for e in spans)


def test_obs_on_off_token_parity(models):
    """Greedy tokens, preemptions and the pool's tables are the same with
    a recorder attached or the null recorder."""
    _, port = models
    on, _, a = _served(port, O, Request)
    off, _, b = _served(port, O, Request, obs=False)
    assert a == b and on.n_preemptions == off.n_preemptions
    assert np.array_equal(on.pool.table, off.pool.table)
    assert off.obs is O.NULL_RECORDER
    assert off.metrics().get("registry") is None
    assert on.metrics()["completed"] == len(a)


def test_warmup_is_obs_invisible(models):
    """A replica's warm-up request runs under the null recorder and the
    scheduler is reset after it: no metric, no event, the recorder
    restored on the scheduler and its pool, the pool's high-water mark
    at 0 and the tokens a cold scheduler serves."""
    _, port = models
    rec = _recorder(O)
    sched = port.serve(**POOL)
    sched.set_obs(rec)
    rep = Replica(0, sched)
    rep.start(warmup=True)
    assert rec.snapshot() == {} and rec.tracer.events == []
    assert sched.obs is rec and sched.pool.obs is rec
    assert sched.pool.high_water == 0 and not sched.completed
    cold, _, want = _served(port, O, Request, obs=False)
    for uid, p in enumerate(_prompts(port.cfg.vocab_size)):
        rep.enqueue(Request(uid=uid, prompt=p, max_new=MAX_NEW))
    got = {u: r.out for u, r in sorted(sched.run().items())}
    assert got == want
    assert rec.snapshot()["requests_submitted_total"] == len(want)
