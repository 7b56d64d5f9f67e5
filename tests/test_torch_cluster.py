"""PyTorch port's cluster serving (`repro_torch.cluster`) against the JAX
reference's (`repro.cluster`), mirroring tests/test_cluster.py on the
reduced model instead of its closed-form fake engine: the replica state
machine, drain and health, warm-up leaving a scheduler that serves as a
cold one, the policy registry, round-robin and least-outstanding
choices, the router's Scheduler surface, elastic scale-up, scale-down,
the device cap and the scale events on the trace.  Then against the
reference on the same parameters and requests: the routing (the replica
of each request), `ClusterRouter.stats()` and the tokens under each
policy, directly and through `LLM.load(dp_replicas=2, router=p)`, whose
tokens also equal one replica's.

Reduced SmolLM-360M, tp 2, spd 0.25, exact kept syncs (rows computed
independently of one another, so a request's tokens cannot depend on
its co-batch; ROADMAP C15), fp32, paged (8-token pages, a pool that
holds every request at once: no preemption, whose re-prefill would
change the numerics), the reference's parameters with every norm leaf
moved off its constant.  Token comparisons are exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import cluster as RCL  # noqa: E402
from repro import obs as RO  # noqa: E402
from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.api.scheduler import Request as RRequest  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402

from repro_torch import cluster as CL, obs as O  # noqa: E402
from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.api.scheduler import (InvalidRequestError,  # noqa: E402
                                       Request)
from repro_torch.cluster import (CREATED, DRAINING, READY,  # noqa: E402
                                 STOPPED, ClusterConfigError, ClusterRouter,
                                 ElasticConfig, ElasticScaler,
                                 LeastOutstandingPolicy, ReplicaStateError,
                                 RoutePolicy,
                                 make_policy, register_policy,
                                 route_policy_names)
from repro_torch.cluster.router import ROUTE_POLICIES  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "smollm-360m"
CC = dict(cache_len=32, max_batch=3, page_size=8, num_pages=12)
POLICIES = ("round-robin", "least-outstanding", "prefix-affinity")


@pytest.fixture(scope="module")
def models():
    """(reference LLM, port LLM) on the same canonical parameters."""
    rcfg = rreplace(rget(ARCH, reduced=True), dtype="float32")
    cfg = replace(get_config(ARCH, reduced=True), dtype="float32")
    canon = perturbed_canonical(rcfg, seed=1)
    kw = dict(tp=2, spd=0.25, **CC)
    ref = RLLM.load(rcfg, params=jax.tree.map(jnp.asarray, canon), **kw)
    port = LLM.load(cfg, device="cpu", params=from_reference(canon, cfg),
                    **kw)
    return ref, port


def mk_requests(n, seed=0, max_new=4, cls=Request, vocab=512):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(2, 10))
                                           ).astype(np.int64),
                max_new=max_new)
            for i in range(n)]


def _factory(llm):
    """rid -> a fresh CREATED replica of `llm` (its own paged scheduler)."""
    return llm.replica_factory(llm.serve(**CC).cache)


@pytest.fixture(scope="module")
def streams(models):
    """One scheduler's greedy streams of every request set used below,
    keyed by (n, seed, max_new)."""
    _, port = models
    memo = {}

    def want(n, seed, max_new=4):
        key = (n, seed, max_new)
        if key not in memo:
            sched = port.serve(**CC)
            for r in mk_requests(n, seed, max_new):
                sched.submit(r)
            memo[key] = {u: r.out for u, r in sched.run().items()}
        return memo[key]
    return want


# ---------------------------------------------------------------------------
# Replica lifecycle
# ---------------------------------------------------------------------------

def test_replica_state_machine(models):
    rep = _factory(models[1])(0)
    assert rep.state == CREATED and not rep.routable
    with pytest.raises(ReplicaStateError):
        rep.enqueue(mk_requests(1)[0])     # not routable before start
    with pytest.raises(ReplicaStateError):
        rep.drain()                        # can't drain an unstarted replica
    rep.start(warmup=False)
    assert rep.state == READY and rep.routable
    with pytest.raises(ReplicaStateError):
        rep.start()                        # double start
    req = mk_requests(1)[0]
    rep.enqueue(req)
    assert rep.drain() == [req]            # unadmitted queue handed back
    assert rep.state == STOPPED            # nothing in flight -> stopped


def test_replica_drain_hands_back_queue_and_finishes_inflight(models,
                                                             streams):
    rep = _factory(models[1])(0).start(warmup=False)
    reqs = mk_requests(5, seed=1)
    for r in reqs:
        rep.enqueue(r)
    rep.step()                             # admits up to max_batch
    inflight = {r.uid for r in rep.sched.slots if r is not None}
    assert inflight
    handed_back = rep.drain()
    assert {r.uid for r in handed_back} == \
        {r.uid for r in reqs} - inflight - set(rep.sched.completed)
    assert rep.state == DRAINING and not rep.routable
    with pytest.raises(ReplicaStateError):
        rep.enqueue(mk_requests(1)[0])
    while rep.state != STOPPED:
        assert rep.step() or rep.sched.has_work() is False
    assert set(rep.sched.completed) == inflight
    want = streams(5, 1)
    for uid in inflight:
        assert rep.sched.completed[uid].out == want[uid]
    assert rep.drain() == []               # idempotent once stopped


def test_replica_warmup_is_invisible(models):
    """A warmed replica's scheduler is a cold one's: no residue in the
    queue, slots, counters, pool (free-list order, prefix index, high
    water) or drafter, and it serves the same streams."""
    factory = _factory(models[1])
    warm, cold = factory(0), factory(1)
    warm.start(warmup=True)
    cold.start(warmup=False)
    sw, sc = warm.sched, cold.sched
    assert not sw.completed and not sw.queue and sw._req_meta == {}
    assert sw._seq == sc._seq == 0 and sw.n_preemptions == 0
    assert (sw.pos == sc.pos).all() and (sw.cur == sc.cur).all()
    assert (sw.admit_seq == sc.admit_seq).all()
    assert sw.pool.free == sc.pool.free    # exact free-list order
    assert not sw.pool.page_hash and not sw.pool.prefix_index
    assert not sw.pool.cached and sw.pool.high_water == 0
    assert np.array_equal(sw.pool.table, sc.pool.table)
    assert sw.kv.prefix_queries == sw.kv.prefix_hits == 0
    assert sw.kv._admit_hashes == {}
    for rep in (warm, cold):
        for r in mk_requests(4, seed=2):
            rep.enqueue(r)
    a = {u: r.out for u, r in warm.sched.run().items()}
    b = {u: r.out for u, r in cold.sched.run().items()}
    assert a == b


def test_replica_unhealthy_not_routable(models):
    factory = _factory(models[1])
    rep = factory(0).start(warmup=False)
    rep.mark_unhealthy("probe timeout")
    assert rep.state == READY and not rep.routable
    router = ClusterRouter([rep, factory(1)], warmup=False)
    for r in mk_requests(4, seed=3):
        router.submit(r)
    done = router.run()
    assert len(done) == 4
    assert rep.n_routed == 0               # the router skipped the sick one
    assert router.replicas[1].n_routed == 4


# ---------------------------------------------------------------------------
# Policy registry + routing policies
# ---------------------------------------------------------------------------

def test_policy_registry():
    assert set(POLICIES) <= set(route_policy_names())
    assert route_policy_names() == RCL.route_policy_names()
    with pytest.raises(ClusterConfigError):
        make_policy("no-such-policy")
    with pytest.raises(TypeError):
        make_policy(42)
    inst = LeastOutstandingPolicy()
    assert make_policy(inst) is inst       # instances pass through
    with pytest.raises(ClusterConfigError):
        LLM.load("smollm-360m-reduced", device="cpu", router="nope")
    with pytest.raises(ClusterConfigError):
        LLM.load("smollm-360m-reduced", device="cpu", dp_replicas=0)


def test_custom_policy_registration(models):
    @register_policy("always-zero")
    class AlwaysZero(RoutePolicy):
        def choose(self, replicas, req):
            return min(replicas, key=lambda r: r.rid)

    factory = _factory(models[1])
    try:
        router = ClusterRouter([factory(0), factory(1)],
                               policy="always-zero", warmup=False)
        for r in mk_requests(4, seed=4):
            router.submit(r)
        router.run()
        assert router.replicas[0].n_routed == 4
        assert router.replicas[1].n_routed == 0
    finally:
        del ROUTE_POLICIES["always-zero"]


def test_round_robin_cycles(models):
    factory = _factory(models[1])
    router = ClusterRouter([factory(r) for r in range(3)],
                           policy="round-robin", warmup=False)
    for r in mk_requests(6, seed=5, max_new=2):
        router.submit(r)
    router.route_pending()
    assert [rep.n_routed for rep in router.replicas.values()] == [2, 2, 2]


def test_least_outstanding_balances_tokens(models, streams):
    factory = _factory(models[1])
    a, b = factory(0), factory(1)
    router = ClusterRouter([a, b], policy="least-outstanding", warmup=False)
    heavy = Request(uid=50, prompt=np.arange(8, dtype=np.int64), max_new=8)
    a.enqueue(heavy)                       # preload replica 0
    assert a.outstanding_tokens == 8 + 8
    light = Request(uid=51, prompt=np.arange(4, dtype=np.int64), max_new=2)
    router.submit(light)
    assert router.outstanding_tokens() == 16 + 4 + 2
    router.route_pending()
    assert b.n_routed == 1                 # the lighter replica won
    done = router.run()
    assert set(done) == {50, 51}


# ---------------------------------------------------------------------------
# Router surface
# ---------------------------------------------------------------------------

def test_router_validate_and_cancel(models, streams):
    factory = _factory(models[1])
    router = ClusterRouter([factory(0), factory(1)], warmup=False)
    with pytest.raises(InvalidRequestError):
        router.submit(Request(uid=0, prompt=np.zeros(30, np.int64),
                              max_new=20))
    reqs = mk_requests(6, seed=6)
    for r in reqs:
        router.submit(r)
    router.step()
    router.cancel(reqs[:3])
    done = router.run()
    assert set(done) == {r.uid for r in reqs[3:]}
    want = streams(6, 6)
    for r in reqs[3:]:
        assert r.out == want[r.uid]


def test_router_duplicate_rid_rejected(models):
    factory = _factory(models[1])
    router = ClusterRouter([factory(0)], warmup=False)
    with pytest.raises(ClusterConfigError):
        router.add_replica(factory(0))
    router.drain_replica(0)                # idle -> retires at once
    assert 0 in router.retired
    with pytest.raises(ClusterConfigError):
        router.add_replica(factory(0))     # retired rids stay reserved


# ---------------------------------------------------------------------------
# Elastic scaling
# ---------------------------------------------------------------------------

def test_elastic_config_validation():
    with pytest.raises(ClusterConfigError):
        ElasticConfig(min_replicas=0)
    with pytest.raises(ClusterConfigError):
        ElasticConfig(min_replicas=3, max_replicas=2)


def _elastic_run(llm, mod_cluster, mod_obs, req_cls):
    """20 requests through a 1-replica router with a scaler (max 3,
    backlog 20, idle 3, cooldown 1), then 12 idle rounds: (router, scaler,
    recorder, {uid: rid})."""
    obs = mod_obs.Recorder(mod_obs.MetricsRegistry(),
                           mod_obs.Tracer(clock=mod_obs.VirtualClock(
                               tick=1e-3)))
    factory = _factory(llm)
    router = mod_cluster.ClusterRouter([factory(0)], warmup=False, obs=obs)
    sc = mod_cluster.ElasticScaler(
        router, factory,
        mod_cluster.ElasticConfig(max_replicas=3, scale_up_backlog=20,
                                  scale_down_idle=3, cooldown=1),
        warmup=False)
    for r in mk_requests(20, seed=9, max_new=6, cls=req_cls):
        router.submit(r)
    while router.has_work():
        router.step()
        sc.observe()
    for _ in range(12):
        router.step()
        sc.observe()
    where = {u: rid for rid, rep in {**router.retired,
                                     **router.replicas}.items()
             for u in rep.sched.completed}
    return router, sc, obs, where


def test_elastic_scale_up_and_down_equals_reference(models, streams):
    """Backlog grows the fleet, idle rounds shrink it newest-first; the
    scale events, the routing, the tokens and the cluster-track instants
    equal the reference's."""
    ref, port = models
    router, sc, obs, where = _elastic_run(port, CL, O, Request)
    rrouter, rsc, robs, rwhere = _elastic_run(ref, RCL, RO, RRequest)
    ups = [e for e in sc.events if e.action == "up"]
    downs = [e for e in sc.events if e.action == "down"]
    assert ups and downs and router.n_replicas == 1
    assert [e.rid for e in downs] == sorted((e.rid for e in downs),
                                            reverse=True)
    assert [vars(e) for e in sc.events] == [vars(e) for e in rsc.events]
    assert where == rwhere and len(router.completed) == 20
    assert {u: r.out for u, r in router.completed.items()} == \
        {u: r.out for u, r in rrouter.completed.items()} == \
        streams(20, 9, 6)
    marks = [e for e in obs.tracer.events
             if e["ph"] == "i" and e["name"].startswith("scale_")]
    assert len(marks) == len(sc.events)
    for m, ev in zip(marks, sc.events):
        assert m["name"] == f"scale_{ev.action}"
        assert m["args"]["rid"] == ev.rid
        assert m["args"]["reason"] == ev.reason
        assert m["args"]["n_replicas"] == ev.n_replicas
        assert m["args"]["backlog"] == round(ev.backlog, 2)
    assert [(e["ph"], e["name"], e.get("args")) for e in obs.tracer.events
            if e["tid"] == 1] == \
        [(e["ph"], e["name"], e.get("args")) for e in robs.tracer.events
         if e["tid"] == 1]                  # the cluster track
    snap = obs.snapshot()
    assert snap['cluster_scale_ops_total{action="up"}'] == len(ups)
    assert snap['cluster_scale_ops_total{action="down"}'] == len(downs)
    assert snap == robs.snapshot()


def test_elastic_device_budget_caps_replicas(models):
    factory = _factory(models[1])
    router = ClusterRouter([factory(0)], warmup=False)
    sc = ElasticScaler(router, factory,
                       ElasticConfig(max_replicas=8, scale_up_backlog=1,
                                     cooldown=0),
                       n_devices=4, tp=2, warmup=False)
    assert sc.cfg.max_replicas == 2        # choose_mesh_shape(4, 2) -> dp 2
    for r in mk_requests(12, seed=10, max_new=4):
        router.submit(r)
    while router.has_work():
        router.step()
        sc.observe()
    assert router.n_replicas == 2
    with pytest.raises(ClusterConfigError):
        ElasticScaler(router, factory, ElasticConfig(min_replicas=4),
                      n_devices=4, tp=2)


# ---------------------------------------------------------------------------
# Against the reference: routing, stats and tokens under each policy
# ---------------------------------------------------------------------------

def _shared_prefix_requests(cls, vocab=512, seed=11):
    """Six requests over two 10-token prefixes (one full page each) and
    two short prompts: prefix-affinity has something to route by."""
    rng = np.random.default_rng(seed)
    pre = [rng.integers(0, vocab, 10) for _ in range(2)]
    prompts = [np.concatenate([pre[i % 2], rng.integers(0, vocab, 3 + i)])
               for i in range(4)]
    prompts += [rng.integers(0, vocab, 4), rng.integers(0, vocab, 6)]
    return [cls(uid=i, prompt=p.astype(np.int64), max_new=4)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("policy", POLICIES)
def test_router_routing_and_stats_equal_reference(models, policy):
    """The same requests through each package's ClusterRouter over two
    warmed replicas: the replica of each request, the tokens and stats()
    are equal; the tokens are a lone scheduler's."""
    ref, port = models
    router = ClusterRouter([_factory(port)(r) for r in range(2)],
                           policy=policy)
    rrouter = RCL.ClusterRouter([_factory(ref)(r) for r in range(2)],
                                policy=policy)
    for r in _shared_prefix_requests(Request):
        router.submit(r)
    for r in _shared_prefix_requests(RRequest):
        rrouter.submit(r)
    done, rdone = router.run(), rrouter.run()
    assert {u: r.out for u, r in done.items()} == \
        {u: r.out for u, r in rdone.items()}
    where = {u: rid for rid, rep in router.replicas.items()
             for u in rep.sched.completed}
    rwhere = {u: rid for rid, rep in rrouter.replicas.items()
              for u in rep.sched.completed}
    assert where == rwhere and len(set(where.values())) == 2
    assert router.stats() == rrouter.stats()
    lone = port.serve(**CC)
    for r in _shared_prefix_requests(Request):
        lone.submit(r)
    assert {u: r.out for u, r in lone.run().items()} == \
        {u: r.out for u, r in done.items()}


@pytest.fixture(scope="module")
def ref_cluster(models):
    """The reference's facade at dp_replicas=2, loaded once: each policy
    below gets a fresh cluster on its compiled engine."""
    ref, _ = models
    return RLLM.load(ref.cfg, tp=2, plan=ref.plan, params=ref.canonical,
                     dp_replicas=2, **CC)


@pytest.mark.parametrize("policy", POLICIES)
def test_llm_dp_replicas_tokens_equal_one_replica(models, ref_cluster,
                                                  policy):
    """LLM.load(dp_replicas=2, router=policy) serves one replica's greedy
    tokens; its router's stats() after generate equal the reference's
    facade's (the warm-up request on each replica included)."""
    _, port = models
    prompts = [r.prompt for r in _shared_prefix_requests(Request)]
    cl = LLM.load(port.cfg, tp=2, plan=port.plan, device="cpu",
                  params=port.canonical, dp_replicas=2, router=policy, **CC)
    rcl = ref_cluster
    rcl.router_policy, rcl._sched = policy, None   # a fresh cluster
    got = cl.generate(prompts, SamplingParams(max_new=5))
    want = port.generate(prompts, SamplingParams(max_new=5))
    rgot = rcl.generate(prompts, RSP(max_new=5))
    assert [o.token_ids for o in got] == [o.token_ids for o in want] == \
        [o.token_ids for o in rgot]
    assert isinstance(cl.serve(), ClusterRouter)
    assert cl.serve().policy.name == policy
    assert cl.serve().stats() == rcl.serve().stats()
    assert sorted(cl.serve(dp_replicas=3).replicas) == [0, 1, 2]
