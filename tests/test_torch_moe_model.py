"""PyTorch port vs JAX reference: the MoE model (qwen2-moe-a2.7b-reduced
at tp 2 with spd=0.25, fp32, the reference's perturbed parameters
carried over with convert.from_reference).

Prefill and decode logits (dense, paged, chunked prefill) within 1e-4 at
exact syncs, greedy tokens and the comm ledger at quant8.  The capacity
int(1.25 * T * k / E) counts every routed row (pad tokens, idle slots,
verify chunks), so greedy outputs depend on how the rows are batched,
in the reference as in the port: speculative greedy equals the
reference's speculative greedy, and plain greedy only when no expert
overflows."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import simtp as RS  # noqa: E402
from repro.parallel.collectives import (MODEL_AXIS,  # noqa: E402
                                        collective_ledger as rledger)
from repro.runtime import forward as RF  # noqa: E402
from repro.runtime.forward import bucketed_prefill as rprefill  # noqa: E402
from repro.runtime.paging import PagePool  # noqa: E402
from repro.spec import SpecConfig as RSpecConfig  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from repro_torch.runtime.forward import bucketed_prefill  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from torch_parity import (one_torch_thread,  # noqa: E402,F401
                          perturbed_canonical)

ARCH = "qwen2-moe-a2.7b-reduced"
TP, CACHE_LEN, MAX_NEW = 2, 64, 6
# fp32 through 3 blocks and the head; XLA and torch sum in other orders
LOGIT_ATOL = 1e-4


def _cfgs(**kw):
    return (rreplace(rget(ARCH), dtype="float32", **kw),
            replace(get_config(ARCH), dtype="float32", **kw))


# ---------------------------------------------------------------------------
# The model: qwen2-moe-a2.7b-reduced at tp 2, spd=0.25
# ---------------------------------------------------------------------------

def _pair(comm, **cache):
    rcfg, cfg = _cfgs()
    kw = dict(tp=TP, spd=0.25, cache_len=CACHE_LEN, comm=comm,
              comm_logits=comm, q_chunk=64, **cache)
    ref = RLLM.load(rcfg, params=jax.tree.map(
        jnp.asarray, perturbed_canonical(rcfg)), **kw)
    port = LLM.load(cfg, device="cpu", params=from_reference(
        jax.tree.map(np.asarray, ref.canonical), cfg), **kw)
    return ref, port


@pytest.fixture(scope="module")
def pairs():
    return {c: _pair(c) for c in ("exact", "quant8")}


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _teacher_forced(llm, prompt, stream, prefill_fn, to_np):
    """Prefill and decode logits along `stream` (batch 1)."""
    eng = llm.engine
    caches = eng.blank_caches(1, CACHE_LEN)
    lg, caches1 = prefill_fn(eng, llm.params, prompt, len(prompt), CACHE_LEN)
    caches = eng.insert_slot(caches, caches1, 0)
    out = [to_np(lg)[0]]
    for i, tok in enumerate(stream[:-1]):
        _, lg, caches = eng.decode_with_logits(
            llm.params, np.asarray([[tok]]), np.asarray([len(prompt) + i]),
            caches)
        out.append(to_np(lg)[0])
    return np.stack(out)


def test_prefill_and_decode_logits_match_reference(pairs):
    """A 12-token prompt prefills in a 16-token bucket: its 4 pad tokens
    route (and take expert slots) in both packages alike.  Exact syncs:
    under quant8 a last-ulp difference can flip a code (the tokens and
    ledger tests run quant8)."""
    ref, port = pairs["exact"]
    assert port.plan.n_dropped == 1
    prompt = _prompt(12)
    stream = ref.generate([prompt], RSP(max_new=MAX_NEW))[0].token_ids
    rl = _teacher_forced(ref, prompt, stream, rprefill, np.asarray)
    pl = _teacher_forced(port, prompt, stream, bucketed_prefill,
                         lambda t: t.numpy())
    assert pl.shape == (MAX_NEW, 512)
    np.testing.assert_allclose(pl, rl, atol=LOGIT_ATOL, rtol=0)


def test_chunked_prefill_logits_match_reference(pairs):
    """A chunked MoE prefill is held to the reference's chunked prefill
    (each chunk routes its own T)."""
    ref, port = pairs["exact"]
    toks = np.zeros((1, 24), np.int32)
    toks[0, :21] = _prompt(21, 1)
    ln = np.asarray([21], np.int32)
    rsplit = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    rl, _ = ref.engine.prefill_chunked(rsplit, jnp.asarray(toks),
                                       cache_len=CACHE_LEN, lengths=ln,
                                       chunk=8)
    pl, _ = port.engine.prefill_chunked(port.params, toks.astype(np.int64),
                                        cache_len=CACHE_LEN,
                                        lengths=ln.astype(np.int64), chunk=8)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("c", [1, 8])
def test_paged_step_logits_match_reference(pairs, c):
    """The fused paged step (decode C=1, a suffix chunk C=8) over 4 slots,
    one idle: full logits within 1e-4 of the reference's."""
    ref, port = pairs["exact"]
    ps, npg = 8, 16
    rsplit = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    pool = PagePool(num_pages=npg, page_size=ps, max_slots=4,
                    pages_per_slot=CACHE_LEN // ps)
    reng, peng = ref.engine, port.engine
    rpc = reng.blank_paged_caches(4, CACHE_LEN, page_size=ps, num_pages=npg)
    ppc = peng.blank_paged_caches(4, CACHE_LEN, page_size=ps, num_pages=npg)
    pos = np.zeros(4, np.int64)
    for b, n in enumerate((12, 5, 20)):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :n] = _prompt(n, b)
        ln = np.asarray([n], np.int32)
        _, c1 = reng.prefill(rsplit, jnp.asarray(toks), cache_len=CACHE_LEN,
                             lengths=jnp.asarray(ln))
        _, pc1 = peng.prefill(port.params, toks.astype(np.int64),
                              cache_len=CACHE_LEN, lengths=ln.astype(np.int64))
        assert pool.grow(b, n + c)
        rpc = reng.insert_paged(rpc, c1, b, pool.table[b])
        ppc = peng.insert_paged(ppc, pc1, b, pool.table[b])
        pos[b] = n
    toks = np.random.default_rng(c).integers(0, 512, (4, c))
    table = pool.table.astype(np.int64)
    if c == 1:
        _, rl, _ = reng.decode_paged_with_logits(
            rsplit, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(pool.table), rpc)
        _, pl, _ = peng.decode_paged_with_logits(port.params, toks, pos,
                                                 table, ppc)
    else:
        rl, _ = reng.verify_paged(rsplit, jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(pos, jnp.int32),
                                  jnp.asarray(pool.table), rpc)
        pl, _ = peng.verify_paged(port.params, toks, pos, table, ppc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("cache", [
    {}, {"page_size": 8, "num_pages": 12}, {"prefill_chunk": 8},
    {"page_size": 8, "num_pages": 24, "prefill_chunk": 8}],
    ids=["dense", "paged", "chunked", "paged-chunked"])
def test_greedy_tokens_match_reference(cache):
    """generate over 4 requests of 3 lengths (a 12-page pool the paged
    run outgrows): the same tokens as the reference's generate."""
    ref, port = _pair("quant8", **cache)
    prompts = [_prompt(n, i) for i, n in enumerate((12, 5, 20, 9))]
    rt = [o.token_ids for o in ref.generate(prompts, RSP(max_new=8))]
    pt = [o.token_ids for o in port.generate(prompts,
                                             SamplingParams(max_new=8))]
    assert pt == rt
    if "page_size" in cache:
        sched = port.serve()
        assert sched.pool.num_free == sched.pool.num_pages


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_comm_ledger_matches_reference(pairs, comm):
    """One prefill and one decode step log the same entries in both
    packages; the MoE combine adds no sync: a kept block logs two
    block syncs, the dropped block one."""
    ref, port = pairs[comm]
    toks = _prompt(16)[None]
    ln = np.asarray([16], np.int32)
    rparams = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    rpre, _ = RF.prefill_step(ref.cfg, ref.plan, tp=TP, q_chunk=64,
                              cache_len=CACHE_LEN)
    rdec, _ = RF.decode_step(ref.cfg, ref.plan, tp=TP)
    with rledger() as rled:
        _, rcaches = jax.vmap(rpre, in_axes=(0, None, None, None),
                              axis_name=MODEL_AXIS)(
            rparams, jnp.asarray(toks), jnp.asarray(ln), None)
        jax.vmap(rdec, in_axes=(0, None, None, 0), axis_name=MODEL_AXIS)(
            rparams, jnp.asarray([[3]], jnp.int32),
            jnp.asarray([16], jnp.int32), rcaches)
    pre, _ = F.prefill_step(port.cfg, port.plan, tp=TP, q_chunk=64,
                            cache_len=CACHE_LEN)
    dec, _ = F.decode_step(port.cfg, port.plan, tp=TP)
    with collective_ledger() as led:
        _, caches = pre(port.params, torch.from_numpy(toks).long(),
                        torch.from_numpy(ln).long())
        dec(port.params, torch.tensor([[3]]), torch.tensor([16]), caches)

    def key(e):
        return (e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)

    assert [key(e) for e in led] == [key(e) for e in rled]
    if comm == "exact":
        cfg = port.cfg
        kept = sum(e.nbytes for e in led
                   if e.overlappable and e.phase == "prefill")
        syncs = 2 * cfg.n_layers - port.plan.n_dropped
        assert kept == syncs * 16 * cfg.d_model * 4


def test_spec_greedy_matches_reference():
    """Self-speculative greedy (k=3, all-drop draft) gives the
    reference's speculative tokens, dense and paged."""
    ref, port = _pair("quant8")
    prompts = [_prompt(n, i) for i, n in enumerate((12, 5, 20))]
    rs = RLLM.load(ref.cfg, tp=TP, spd=0.25, cache_len=CACHE_LEN,
                   comm="quant8", q_chunk=64, params=ref.canonical,
                   spec=RSpecConfig(k=3))
    want = [o.token_ids for o in rs.generate(prompts, RSP(max_new=8))]
    for cache in ({}, {"page_size": 8, "num_pages": 24}):
        ps = LLM.load(port.cfg, tp=TP, spd=0.25, cache_len=CACHE_LEN,
                      comm="quant8", q_chunk=64, device="cpu",
                      params=port.canonical, spec=SpecConfig(k=3), **cache)
        got = [o.token_ids for o in ps.generate(prompts,
                                                SamplingParams(max_new=8))]
        assert got == want, cache


def test_spec_greedy_equals_plain_when_no_expert_overflows():
    """With a capacity that holds every assignment, routing is per token,
    so speculative greedy equals plain greedy (at the default capacity a
    verify chunk's T differs from a decode step's and drops differ: the
    reference's spec tokens then differ from its plain ones too)."""
    _, cfg = _cfgs()
    cfg = replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_routed)))
    kw = dict(tp=TP, spd=0.25, cache_len=CACHE_LEN, comm="quant8",
              q_chunk=64, device="cpu")
    plain = LLM.load(cfg, **kw)
    prompts = [_prompt(n, i) for i, n in enumerate((12, 5, 20))]
    want = [o.token_ids for o in plain.generate(prompts,
                                                SamplingParams(max_new=8))]
    spec = LLM.load(cfg, params=plain.canonical, spec=SpecConfig(k=3), **kw)
    assert [o.token_ids for o in spec.generate(
        prompts, SamplingParams(max_new=8))] == want


