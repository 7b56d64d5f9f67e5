"""PyTorch port vs JAX reference: the cache-extension forward (chunked
prefill and speculative verify) on the CPU, reduced SmolLM at tp=2 in
fp32 on the reference's canonical parameters.

`prefill_chunked` (ragged lengths) and `verify` (chain and tree, spd off
and on) on dense caches, and `verify_paged` (chain and tree, attention
"xla" and "pallas") on page pools: logits at every chunk position within
LOGIT_ATOL of the reference's and the written caches within CACHE_ATOL.
`copy_pos` / `copy_pos_paged` equal the reference's exactly.  A dense
verify at cache_len - 2 with k = 4 drops its writes past the buffer (the
reference's scatter drops them) and touches no other slot.  Chunked
prefill gives whole prefill's tokens through the scheduler."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM, simtp as RS  # noqa: E402
from repro.runtime.engines import SimEngine as RSimEngine  # noqa: E402
from repro.runtime.paging import PagePool  # noqa: E402
from repro.spec.verify import tree_layout  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.api.scheduler import Request  # noqa: E402
from repro_torch.config.base import SPDPlanConfig, replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


TP, CACHE, PS, NPG = 2, 64, 8, 16
# fp32 through 4 blocks and the tied head: XLA and torch sum in other
# orders, the arithmetic is the same
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5

_SETUPS = {}


def _setup(spd_k=1, backend="xla"):
    key = (spd_k, backend)
    if key not in _SETUPS:
        rcfg = rreplace(rget("smollm-360m", reduced=True), dtype="float32",
                        attn_backend=backend)
        cfg = replace(get_config("smollm-360m-reduced"), dtype="float32",
                      attn_backend=backend)
        drop = SPDPlanConfig.first_k(cfg.n_layers, spd_k).drop_mask
        canon = RM.init_model(jax.random.PRNGKey(0), rcfg)
        split = RS.prepare_params(canon, rcfg, RPlan(drop), TP)
        reng = RSimEngine(rcfg, RPlan(drop), TP, q_chunk=64)
        port = LLM.load(cfg, tp=TP, plan=SPDPlanConfig(drop), device="cpu",
                        cache_len=CACHE, q_chunk=64, params=from_reference(
                            jax.tree.map(np.asarray, canon), cfg))
        _SETUPS[key] = (rcfg, split, reng, port)
    return _SETUPS[key]


def _prompts(vocab, lens=(12, 5, 27), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _prefill_one(reng, split, port, p, bucket=64):
    s = len(p)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :s] = p
    ln = np.asarray([s], np.int32)
    _, c1 = reng.prefill(split, jnp.asarray(toks), cache_len=CACHE,
                         lengths=jnp.asarray(ln))
    _, pc1 = port.engine.prefill(port.params, toks.astype(np.int64),
                                 cache_len=CACHE, lengths=ln.astype(np.int64))
    return c1, pc1


def _fill_dense(rcfg, split, reng, port, lens=(12, 5, 27), n=4):
    """Prefill prompts of `lens` with each package into fresh dense
    caches (the remaining slots idle at position 0)."""
    rc = reng.blank_caches(n, CACHE)
    pc = port.engine.blank_caches(n, CACHE)
    pos = np.zeros(n, np.int64)
    for b, p in enumerate(_prompts(rcfg.vocab_size, lens)):
        c1, pc1 = _prefill_one(reng, split, port, p)
        rc = reng.insert_slot(rc, c1, b)
        pc = port.engine.insert_slot(pc, pc1, b)
        pos[b] = len(p)
    return rc, pc, pos


def _close_caches(pc, rc, atol=CACHE_ATOL, trash=False):
    for rseg, pseg in zip(rc, pc):
        for name in ("k", "v"):
            got, want = pseg[name].numpy(), np.asarray(rseg[name])
            if trash:                       # the trash page is don't-care
                got, want = got[:, :, :-1], want[:, :, :-1]
            np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16])
def test_prefill_chunked_matches_reference(chunk):
    """A ragged batch (12, 5, 27 tokens) in chunks: each row's last-token
    logits (taken from the chunk holding its lengths-1) and the caches
    equal the reference's; the logits also equal the port's whole
    prefill's."""
    rcfg, split, reng, port = _setup()
    prompts = _prompts(rcfg.vocab_size)
    lens = np.asarray([len(p) for p in prompts], np.int64)
    toks = np.zeros((3, int(lens.max())), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    rl, rc = reng.prefill_chunked(split, jnp.asarray(toks, jnp.int32),
                                  cache_len=CACHE, lengths=lens.astype(
                                      np.int32), chunk=chunk)
    pl, pc = port.engine.prefill_chunked(port.params, toks, cache_len=CACHE,
                                         lengths=lens, chunk=chunk)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_ATOL,
                               rtol=0)
    _close_caches(pc, rc)
    whole, _ = port.engine.prefill(port.params, np.pad(toks, ((0, 0),
                                                              (0, 5))),
                                   cache_len=CACHE, lengths=lens)
    np.testing.assert_allclose(pl.numpy(), whole.numpy(), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_prefill_gives_whole_prefill_tokens(paged):
    """Through the scheduler: ragged prompts (one longer than two chunks,
    one shorter than one), greedy, chunk 8, dense and paged (a pool the
    requests outgrow): the tokens of whole prefill."""
    _, _, _, port = _setup()
    prompts = _prompts(port.cfg.vocab_size, lens=(12, 5, 27, 19))
    sp = SamplingParams(max_new=8)
    kw = dict(page_size=PS, num_pages=9) if paged else {}
    whole = port.serve(**kw)
    chunked = port.serve(prefill_chunk=8, **kw)
    for i, p in enumerate(prompts):
        for sched in (whole, chunked):
            sched.submit(Request(uid=i, prompt=p, max_new=8, sampling=sp))
    want = {u: r.out for u, r in whole.run().items()}
    got = {u: r.out for u, r in chunked.run().items()}
    assert got == want
    if paged:
        assert chunked.n_preemptions > 0
        assert chunked.pool.num_free == chunked.pool.num_pages


# ---------------------------------------------------------------------------
# Speculative verify, dense and paged, chain and tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", [None, (3, 2)], ids=["chain", "tree"])
@pytest.mark.parametrize("spd_k", [0, 1])
def test_verify_matches_reference(spd_k, tree):
    """Dense verify of a (4, C) chunk at each slot's position (C = 4 for
    the chain, k + w = 5 for the tree): logits at every chunk position
    and the caches after it."""
    rcfg, split, reng, port = _setup(spd_k)
    rc, pc, pos = _fill_dense(rcfg, split, reng, port)
    layout = None if tree is None else tree_layout(*tree)
    c = 4 if tree is None else sum(tree)
    toks = np.random.default_rng(c).integers(0, rcfg.vocab_size, (4, c))
    rl, rc = reng.verify(split, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(pos, jnp.int32), rc, tree=layout)
    pl, pc = port.engine.verify(port.params, toks, pos, pc, tree=layout)
    assert tuple(pl.shape) == (4, c, rcfg.vocab_size)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_ATOL,
                               rtol=0)
    _close_caches(pc, rc)


def _fill_paged(rcfg, split, reng, port, c, n_slots=4):
    pool = PagePool(num_pages=NPG, page_size=PS, max_slots=n_slots,
                    pages_per_slot=CACHE // PS)
    rpc = reng.blank_paged_caches(n_slots, CACHE, page_size=PS,
                                  num_pages=NPG)
    ppc = port.engine.blank_paged_caches(n_slots, CACHE, page_size=PS,
                                         num_pages=NPG)
    pos = np.zeros(n_slots, np.int64)
    for b, p in enumerate(_prompts(rcfg.vocab_size)):
        c1, pc1 = _prefill_one(reng, split, port, p)
        assert pool.grow(b, len(p) + c)
        rpc = reng.insert_paged(rpc, c1, b, pool.table[b])
        ppc = port.engine.insert_paged(ppc, pc1, b, pool.table[b])
        pos[b] = len(p)
    return pool, rpc, ppc, pos


@pytest.mark.parametrize("tree", [None, (3, 2)], ids=["chain", "tree"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_paged_verify_matches_reference(backend, tree):
    """The paged verify chunk after real prefills: the chain through the
    paged kernel's plain version under "pallas", the tree through the
    plain paged attention with tree visibility under both (as in the
    reference); logits and the live pages."""
    rcfg, split, reng, port = _setup(1, backend)
    c = 4 if tree is None else sum(tree)
    pool, rpc, ppc, pos = _fill_paged(rcfg, split, reng, port, c)
    layout = None if tree is None else tree_layout(*tree)
    toks = np.random.default_rng(c + 1).integers(0, rcfg.vocab_size, (4, c))
    rl, rpc = reng.verify_paged(split, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(pos, jnp.int32),
                                jnp.asarray(pool.table), rpc, tree=layout)
    pl, ppc = port.engine.verify_paged(port.params, toks, pos,
                                       pool.table.astype(np.int64), ppc,
                                       tree=layout)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_ATOL,
                               rtol=0)
    _close_caches(ppc, rpc, trash=True)


def test_tree_mask_equals_reference():
    from repro.models import attention as RA
    depths, anc = tree_layout(4, 3)
    pos = np.asarray([0, 3, 9])
    kv = np.broadcast_to(np.arange(16), (3, 16))
    want = np.asarray(RA.tree_mask(jnp.asarray(pos), jnp.asarray(anc),
                                   jnp.asarray(kv)))
    got = A.tree_mask(torch.from_numpy(pos), torch.tensor(anc),
                      torch.from_numpy(np.ascontiguousarray(kv)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# copy_pos, and the writes past the buffer
# ---------------------------------------------------------------------------

def test_copy_pos_matches_reference():
    """Per-row position copies on random dense caches (one row a no-op
    0 -> 0) equal the reference's bit for bit."""
    _, _, reng, port = _setup()
    rng = np.random.default_rng(5)
    rc = [{k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
           for k, v in seg.items()} for seg in reng.blank_caches(4, CACHE)]
    pc = [{k: torch.from_numpy(np.asarray(v).copy()) for k, v in seg.items()}
          for seg in rc]
    src, dst = np.asarray([9, 0, 40, 63]), np.asarray([7, 0, 12, 62])
    rc = reng.copy_pos(rc, src, dst)
    pc = port.engine.copy_pos(pc, src, dst)
    _close_caches(pc, rc, atol=0)


def test_copy_pos_paged_matches_reference():
    """Through a page table with an unallocated page (-1) and a table
    narrower than the source page: both resolve to the trash page; the
    pools equal the reference's bit for bit."""
    _, _, reng, port = _setup()
    rng = np.random.default_rng(6)
    rpc = [{k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
            for k, v in seg.items()}
           for seg in reng.blank_paged_caches(4, CACHE, page_size=PS,
                                              num_pages=NPG)]
    ppc = [{k: torch.from_numpy(np.asarray(v).copy()) for k, v in seg.items()}
           for seg in rpc]
    table = np.asarray([[3, 5, -1], [0, 1, 2], [7, -1, -1], [9, 10, 11]])
    src, dst = np.asarray([12, 0, 3, 20]), np.asarray([9, 0, 5, 17])
    rpc = reng.copy_pos_paged(rpc, jnp.asarray(table, jnp.int32), src, dst,
                              page_size=PS)
    ppc = port.engine.copy_pos_paged(ppc, table, src, dst, page_size=PS)
    _close_caches(ppc, rpc, atol=0)


def test_verify_past_the_buffer_is_dropped():
    """Slot 0 at cache_len - 2 verifies k = 4 drafts (C = 5): its two
    in-range slots are written, the three past the buffer are dropped as
    the reference's scatter drops them -- logits and caches equal the
    reference's, and no other slot's history moves."""
    rcfg, split, reng, port = _setup()
    rc, pc, pos = _fill_dense(rcfg, split, reng, port,
                              lens=(CACHE - 2, 5, 27))
    before = [{k: v.clone() for k, v in seg.items()} for seg in pc]
    toks = np.random.default_rng(9).integers(0, rcfg.vocab_size, (4, 5))
    rl, rc = reng.verify(split, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(pos, jnp.int32), rc)
    pl, pc = port.engine.verify(port.params, toks, pos, pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=LOGIT_ATOL,
                               rtol=0)
    _close_caches(pc, rc)
    for seg0, seg1 in zip(before, pc):
        for name in ("k", "v"):
            a, b = seg0[name], seg1[name]       # (tp, layers, B, S, H, D)
            assert torch.equal(a[:, :, 0, :CACHE - 2], b[:, :, 0, :CACHE - 2])
            assert not torch.equal(a[:, :, 0, CACHE - 2:],
                                   b[:, :, 0, CACHE - 2:])
            for r in (1, 2, 3):
                p = int(pos[r])
                assert torch.equal(a[:, :, r, :p], b[:, :, r, :p])
                assert torch.equal(a[:, :, r, p + 5:], b[:, :, r, p + 5:])


def test_write_chunk_rows_wholly_past_the_buffer_write_nothing():
    """A row whose chunk starts past the buffer leaves it as it was, and
    a row ending inside it is written normally."""
    gen = torch.Generator().manual_seed(0)
    cache = torch.randn(2, 3, 8, 2, 4, generator=gen)
    vals = torch.randn(2, 3, 3, 2, 4, generator=gen)
    before = cache.clone()
    wpos = torch.tensor([[9, 10, 11], [2, 3, 4], [6, 7, 8]])
    A.write_chunk(cache, vals, wpos)
    assert torch.equal(cache[:, 0], before[:, 0])
    assert torch.equal(cache[:, 1, 2:5], vals[:, 1])
    assert torch.equal(cache[:, 2, 6:8], vals[:, 2, :2])
    assert torch.equal(cache[:, 1, :2], before[:, 1, :2])
