"""PyTorch port's paged serving on the CPU (reduced SmolLM, tp=2, fp32),
against the live JAX reference on the same canonical parameters: the
fused paged forward (`paged_step`: decode C=1 and suffix prefill C=8,
spd off and on, attn_backend "xla" and "pallas") and the pages it writes,
the comm ledger of a paged step, paged == dense decode inside the port,
and the paged scheduler's token streams, preemptions and prefix-cache
hits.  Then the facade's paged surface and the later-slice refusals."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api.scheduler import (CacheConfig as RCacheConfig,  # noqa: E402
                                 Request as RRequest, Scheduler as RScheduler)
from repro.config.base import (CommPolicy as RComm,  # noqa: E402
                               SPDPlanConfig as RPlan, replace as rreplace)
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM, simtp as RS  # noqa: E402
from repro.parallel.collectives import (  # noqa: E402
    collective_ledger as rledger)
from repro.runtime.engines import SimEngine as RSimEngine  # noqa: E402
from repro.runtime.paging import PagePool  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.api.scheduler import (CacheConfig, Request,  # noqa: E402
                                       Scheduler)
from repro_torch.config.base import (CommPolicy, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TP, CACHE, PS, NPG = 2, 64, 8, 16
# fp32 end to end through 4 blocks + the tied head; summation orders of
# XLA and torch differ, everything else is the same arithmetic
LOGIT_ATOL = 1e-4
# port paged vs port dense: the same math over a longer masked key axis
# (the reference's own paged == dense bound, tests/test_paging.py)
PAGED_DENSE_ATOL = 2e-4

_SETUPS = {}


def _setup(spd_k, backend, comm=None):
    """(reference cfg, split params, SimEngine, port LLM) on the same
    canonical parameters; built once per configuration."""
    key = (spd_k, backend, comm)
    if key not in _SETUPS:
        rcfg = rreplace(rget("smollm-360m", reduced=True), dtype="float32",
                        attn_backend=backend)
        cfg = replace(get_config("smollm-360m-reduced"), dtype="float32",
                      attn_backend=backend)
        drop = SPDPlanConfig.first_k(cfg.n_layers, spd_k).drop_mask
        rplan, plan = RPlan(drop), SPDPlanConfig(drop)
        if comm is not None:
            rplan = RPlan(drop, RComm((comm,) * 4, logits_mode="quant8"))
            plan = SPDPlanConfig(drop, CommPolicy((comm,) * 4,
                                                  logits_mode="quant8"))
        canon = RM.init_model(jax.random.PRNGKey(0), rcfg)
        split = RS.prepare_params(canon, rcfg, rplan, TP)
        reng = RSimEngine(rcfg, rplan, TP, q_chunk=64)
        port = LLM.load(cfg, tp=TP, plan=plan, device="cpu", cache_len=CACHE,
                        q_chunk=64, params=from_reference(
                            jax.tree.map(np.asarray, canon), cfg))
        _SETUPS[key] = (rcfg, split, reng, port)
    return _SETUPS[key]


def _prompts(vocab, lens=(12, 5, 27), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _fill_both(rcfg, split, reng, port, c, n_slots=4):
    """Prefill 3 prompts with each package and insert them into fresh
    paged pools through one shared PagePool (slot 3 stays inactive).
    Returns (pool, reference pools, port pools, pos)."""
    pool = PagePool(num_pages=NPG, page_size=PS, max_slots=n_slots,
                    pages_per_slot=CACHE // PS)
    rpc = reng.blank_paged_caches(n_slots, CACHE, page_size=PS,
                                  num_pages=NPG)
    ppc = port.engine.blank_paged_caches(n_slots, CACHE, page_size=PS,
                                         num_pages=NPG)
    pos = np.zeros(n_slots, np.int64)
    for b, p in enumerate(_prompts(rcfg.vocab_size)):
        s = len(p)
        toks = np.zeros((1, 32), np.int32)
        toks[0, :s] = p
        ln = np.asarray([s], np.int32)
        _, c1 = reng.prefill(split, jnp.asarray(toks), cache_len=CACHE,
                             lengths=jnp.asarray(ln))
        _, pc1 = port.engine.prefill(port.params, toks.astype(np.int64),
                                     cache_len=CACHE,
                                     lengths=ln.astype(np.int64))
        assert pool.grow(b, s + c)
        rpc = reng.insert_paged(rpc, c1, b, pool.table[b])
        ppc = port.engine.insert_paged(ppc, pc1, b, pool.table[b])
        pos[b] = s
    return pool, rpc, ppc, pos


@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("spd_k", [0, 1])
def test_paged_step_matches_reference(spd_k, backend, c):
    """One fused paged step after real prefills: decode with logits
    (C=1) or the multi-token suffix step (C=8), full-vocab logits within
    LOGIT_ATOL of the reference's M.paged_step through its SimEngine, and
    the live pages written in place equal the reference's pools."""
    rcfg, split, reng, port = _setup(spd_k, backend)
    pool, rpc, ppc, pos = _fill_both(rcfg, split, reng, port, c)
    toks = np.random.default_rng(c).integers(
        0, rcfg.vocab_size, (4, c)).astype(np.int64)
    table = pool.table.astype(np.int64)
    if c == 1:
        _, rl, rpc = reng.decode_paged_with_logits(
            split, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(pool.table), rpc)
        _, pl, ppc = port.engine.decode_paged_with_logits(
            port.params, toks, pos, table, ppc)
        assert tuple(pl.shape) == (4, rcfg.vocab_size)
    else:
        rl, rpc = reng.verify_paged(
            split, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(pool.table), rpc)
        pl, ppc = port.engine.verify_paged(port.params, toks, pos, table,
                                           ppc)
        assert tuple(pl.shape) == (4, c, rcfg.vocab_size)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_ATOL,
                               rtol=0)
    for rseg, pseg in zip(rpc, ppc):
        for name in ("k", "v"):
            # (tp, layers, P+1, ps, HkvL, dh); the trash page is don't-care
            np.testing.assert_allclose(pseg[name][:, :, :-1].numpy(),
                                       np.asarray(rseg[name])[:, :, :-1],
                                       atol=1e-5, rtol=0)


def test_copy_paged_pages_matches_reference():
    """The COW device copy (physical page src[i] -> dst[i] on every
    leaf, in place) equals the reference's copy_paged_pages."""
    rcfg, split, reng, port = _setup(0, "xla")
    rng = np.random.default_rng(4)
    rpc = reng.blank_paged_caches(4, CACHE, page_size=PS, num_pages=NPG)
    rpc = [{k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
            for k, v in seg.items()} for seg in rpc]
    ppc = [{k: torch.from_numpy(np.asarray(v).copy()) for k, v in seg.items()}
           for seg in rpc]
    leaf = ppc[0]["k"]
    src, dst = [1, 3, 7], [5, 0, 2]
    rpc = reng.copy_paged_pages(rpc, src, dst)
    out = port.engine.copy_paged_pages(ppc, src, dst)
    assert out[0]["k"] is leaf
    for rseg, pseg in zip(rpc, out):
        for name in ("k", "v"):
            np.testing.assert_array_equal(pseg[name].numpy(),
                                          np.asarray(rseg[name]))


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_paged_step_ledger_matches_reference(comm):
    """A paged decode (C=1) and a suffix step (C=8) log the same (op,
    axis, bytes, overlappable, block, phase) entries in both packages;
    both steps log under phase "decode", as the reference does."""
    rcfg, split, _, port = _setup(1, "xla", None if comm == "exact"
                                  else comm)
    reng = RSimEngine(rcfg, port_plan_to_ref(port), TP, q_chunk=64)
    table = np.full((4, 2), -1, np.int32)
    table[0] = [0, 1]
    rpc = reng.blank_paged_caches(4, CACHE, page_size=PS, num_pages=NPG)
    ppc = port.engine.blank_paged_caches(4, CACHE, page_size=PS,
                                         num_pages=NPG)
    pos = np.asarray([3, 0, 0, 0])
    with rledger() as rled:
        _, rpc = reng.decode_paged(split, jnp.zeros((4, 1), jnp.int32),
                          jnp.asarray(pos, jnp.int32), jnp.asarray(table),
                          rpc)
        reng.verify_paged(split, jnp.zeros((4, 8), jnp.int32),
                          jnp.asarray(pos, jnp.int32), jnp.asarray(table),
                          rpc)
    with collective_ledger() as led:
        _, ppc = port.engine.decode_paged(
            port.params, np.zeros((4, 1), np.int64),
            pos, table.astype(np.int64), ppc)
        port.engine.verify_paged(port.params, np.zeros((4, 8), np.int64),
                                 pos, table.astype(np.int64), ppc)

    def key(e):
        return (e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)

    assert [key(e) for e in led] == [key(e) for e in rled]
    assert len(led) > 0
    assert {e.phase for e in led if e.block >= 0} == {"decode"}


def port_plan_to_ref(port):
    comm = port.plan.comm
    if comm is None:
        return RPlan(port.plan.drop_mask)
    return RPlan(port.plan.drop_mask,
                 RComm(comm.block_modes, logits_mode=comm.logits_mode))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("spd_k", [0, 2])
def test_port_paged_equals_dense(spd_k, backend):
    """Inside the port: prefill 3 prompts into dense and paged caches,
    co-decode 3 steps, equal greedy tokens and logits within
    PAGED_DENSE_ATOL (tests/test_paging.py:420-467 in the reference)."""
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32",
                  attn_backend=backend)
    llm = LLM.load(cfg, tp=TP, spd=spd_k / cfg.n_layers, device="cpu",
                   cache_len=CACHE, q_chunk=64, seed=1)
    eng, params = llm.engine, llm.params
    dense = eng.blank_caches(4, CACHE)
    pool = PagePool(num_pages=10, page_size=16, max_slots=4,
                    pages_per_slot=CACHE // 16)
    pc = eng.blank_paged_caches(4, CACHE, page_size=16, num_pages=10)
    pos = np.zeros(4, np.int64)
    cur = np.zeros((4, 1), np.int64)
    for b, p in enumerate(_prompts(cfg.vocab_size)):
        s = len(p)
        toks = np.zeros((1, 32), np.int64)
        toks[0, :s] = p
        lg, c1 = eng.prefill(params, toks, cache_len=CACHE,
                             lengths=np.asarray([s]))
        dense = eng.insert_slot(dense, c1, b)
        assert pool.grow(b, s + 1)
        pc = eng.insert_paged(pc, c1, b, pool.table[b])
        pos[b] = s
        cur[b, 0] = int(lg[0].argmax())
    for _ in range(3):
        for b in range(3):
            assert pool.grow(b, int(pos[b]) + 1)
        n1, l1, dense = eng.decode_with_logits(params, cur, pos, dense)
        n2, l2, pc = eng.decode_paged_with_logits(
            params, cur, pos, pool.table.astype(np.int64), pc)
        np.testing.assert_array_equal(n1[:3].numpy(), n2[:3].numpy())
        np.testing.assert_allclose(l1[:3].numpy(), l2[:3].numpy(),
                                   atol=PAGED_DENSE_ATOL, rtol=0)
        pos[:3] += 1
        cur = n1.numpy()
    pool.check()


def _reqs(vocab, cls, n=6, seed=1, max_new=6):
    rng = np.random.default_rng(seed)
    return [cls(uid=uid, prompt=rng.integers(0, vocab, 4 + 5 * uid)
                .astype(np.int32), max_new=max_new) for uid in range(n)]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_scheduler_matches_reference_with_preemption(backend):
    """6 requests of up to 35 tokens on a 6-page pool of 8 tokens (no
    chunked prefill): both schedulers preempt, finish every request and
    return every page, with equal token streams, preemption counts and
    prefix-cache counters."""
    rcfg, split, reng, port = _setup(2, backend)
    cc = dict(cache_len=CACHE, max_batch=4, page_size=PS, num_pages=6)
    ref = RScheduler(reng, split, RCacheConfig(**cc))
    for r in _reqs(rcfg.vocab_size, RRequest):
        ref.submit(r)
    rdone = ref.run()
    sched = port.serve(**cc)
    for r in _reqs(rcfg.vocab_size, Request):
        sched.submit(r)
    done = sched.run()
    assert sorted(done) == sorted(rdone) == list(range(6))
    assert {u: r.out for u, r in done.items()} == \
        {u: r.out for u, r in rdone.items()}
    assert {u: r.n_preempted for u, r in done.items()} == \
        {u: r.n_preempted for u, r in rdone.items()}
    assert sched.n_preemptions == ref.n_preemptions > 0
    assert (sched.kv.prefix_queries, sched.kv.prefix_hits) == \
        (ref.kv.prefix_queries, ref.kv.prefix_hits)
    sched.pool.check()
    assert sched.pool.num_free == sched.pool.num_pages
    assert np.array_equal(sched.pool.table, ref.pool.table)


def test_prefix_cache_warm_equals_cold_equals_dense():
    """A prompt sharing a page-aligned prefix with an earlier one admits
    warm (shared pages + suffix-only prefill through the paged step) and
    gives the same stream as a cold pool, the dense scheduler and the
    reference's warm scheduler (tests/test_paging.py:632-669)."""
    rcfg, split, reng, port = _setup(2, "xla")
    cc = CacheConfig(cache_len=CACHE, max_batch=2, page_size=8,
                     num_pages=12)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, rcfg.vocab_size, 19).astype(np.int32)
    pa = shared                                        # 2 full pages + 3
    pb = np.concatenate(
        [shared, rng.integers(0, rcfg.vocab_size, 4).astype(np.int32)])

    def run_one(srv, uid, p, cls=Request):
        srv.submit(cls(uid=uid, prompt=p, max_new=5))
        return srv.run()[uid].out

    cold = [run_one(Scheduler(port.engine, port.params, cc), 0, p)
            for p in (pa, pb)]
    dsrv = Scheduler(port.engine, port.params,
                     CacheConfig(cache_len=CACHE, max_batch=2))
    dense = [run_one(dsrv, i, p) for i, p in enumerate((pa, pb))]
    srv = Scheduler(port.engine, port.params, cc)
    assert srv.kv.prefix_cache
    o1 = run_one(srv, 0, pa)
    assert srv.kv.prefix_hits == 0
    o2 = run_one(srv, 1, pb)
    assert srv.kv.prefix_hits == 1
    assert srv.kv.prefix_tokens_reused == 16           # 2 pages x 8 tokens
    assert [o1, o2] == cold == dense
    srv.pool.check()
    o3 = run_one(srv, 2, pb)
    assert o3 == o2 and srv.kv.prefix_hits == 2
    rsrv = RScheduler(reng, split, RCacheConfig(
        cache_len=CACHE, max_batch=2, page_size=8, num_pages=12))
    assert [run_one(rsrv, i, p, RRequest)
            for i, p in enumerate((pa, pb))] == [o1, o2]
    assert rsrv.kv.prefix_hits == 1


def test_facade_paged_surface_and_later_slice_refusals():
    """LLM.load(page_size=, num_pages=) serves paged (greedy and sampled
    streams equal the dense ones, n_preempted reported); serve(**cache
    fields) builds a fresh scheduler; chunked prefill, tree verify and
    cluster serving (serve(dp_replicas=)) are ported, and an int8 KV cache
    pages through the gather -> dense -> scatter fallback."""
    cfg = replace(get_config("smollm-360m-reduced"), dtype="float32")
    kw = dict(tp=TP, spd=0.25, device="cpu", cache_len=48, max_batch=3)
    dense = LLM.load(cfg, **kw)
    paged = LLM.load(cfg, page_size=8, num_pages=7, params=dense.canonical,
                     **kw)
    prompts = [[3, 1, 4, 1, 5], list(range(7, 27)), [9, 2, 6, 5, 3, 5]]
    for sp in (SamplingParams(max_new=10),
               SamplingParams(max_new=10, temperature=0.8, top_k=40,
                              seed=3)):
        d = [o.token_ids for o in dense.generate(prompts, sp)]
        n0 = paged.serve().n_preemptions
        p = paged.generate(prompts, sp)
        assert [o.token_ids for o in p] == d
        assert sum(o.n_preempted for o in p) == \
            paged.serve().n_preemptions - n0 > 0
    assert paged.serve().pool.num_free == 7
    fresh = paged.serve(num_pages=16)
    assert fresh is not paged.serve() and fresh.pool.num_pages == 16
    assert not dense.serve(page_size=8, num_pages=6).kv.prefix_hits
    # paged pools: (tp, layers, P+1, ps, HkvL, dh), kv heads split on axis 3
    lay = M._gqa_layout(cfg, TP)
    leaf = fresh.pcaches[0]["k"]
    assert tuple(leaf.shape[2:]) == (17, 8, lay.kv_local, cfg.d_head)
    assert leaf.shape[0] == TP
    # chunked prefill is ported: a paged scheduler takes prefill_chunk
    assert paged.serve(prefill_chunk=8).prefill_chunk == 8
    # cluster serving is ported: serve(dp_replicas=) is a ClusterRouter of
    # paged replicas, and an unknown router policy is refused
    from repro_torch.cluster import ClusterConfigError, ClusterRouter
    router = paged.serve(dp_replicas=2, num_pages=16)
    assert isinstance(router, ClusterRouter)
    assert [r.sched.pool.num_pages for r in router.replicas.values()] == \
        [16, 16]
    with pytest.raises(ClusterConfigError):
        paged.serve(dp_replicas=2, router="no-such-policy")
    with pytest.raises(ValueError, match="multiple"):
        paged.serve(cache_len=44)
    # tree verify is ported: a chain-shaped ancestor matrix (lower
    # triangular) is causal visibility, so the tree paged attention equals
    # the chain's on the same pages; a diagonal one sees only history and
    # the token itself
    F.paged_verify_step(cfg, paged.plan, tp=TP,
                        tree=((0, 1), ((True, False), (True, True))))
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 3, 2, 16, generator=gen)
    kp = torch.randn(3, 4, 2, 16, generator=gen)
    vp = torch.randn(3, 4, 2, 16, generator=gen)
    table, start = torch.tensor([[1, 0]]), torch.tensor([2])
    chain = A.paged_attend(q, kp, vp, table, start)
    tri = torch.tensor(np.tril(np.ones((3, 3), bool)))
    torch.testing.assert_close(
        A.paged_attend(q, kp, vp, table, start, anc=tri), chain,
        rtol=0, atol=0)
    diag = A.paged_attend(q, kp, vp, table, start,
                          anc=torch.eye(3, dtype=torch.bool))
    torch.testing.assert_close(diag[:, :1], chain[:, :1], rtol=0, atol=0)
    assert not torch.equal(diag[:, 2], chain[:, 2])
    # int8 KV: no fused paged forward, the fallback serves it (codes and
    # scales paged, no prefix cache), with dense int8's tokens
    q8 = replace(cfg, kv_dtype="int8")
    assert not M.supports_paged_attention(q8)
    d8 = LLM.load(q8, params=dense.canonical, **kw)
    p8 = LLM.load(q8, page_size=8, num_pages=7, params=dense.canonical,
                  **kw)
    sp = SamplingParams(max_new=10)
    assert [o.token_ids for o in p8.generate(prompts, sp)] == \
        [o.token_ids for o in d8.generate(prompts, sp)]
    sched = p8.serve()
    assert sched.n_preemptions > 0 and sched.pool.num_free == 7
    assert not sched.kv.prefix_cache
    seg = sched.pcaches[0]
    assert seg["k"].dtype == torch.int8
    assert tuple(seg["k_s"].shape[2:]) == (8, 8, lay.kv_local)
