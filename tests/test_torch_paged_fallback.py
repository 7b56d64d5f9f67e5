"""The paged gather -> dense -> scatter fallback (port of the reference's
`kernels/ops.py` page gathers and `runtime/forward.py` fallback steps).

The page ops equal the reference's exactly (live pages; the trash page's
content is unspecified in both: colliding writes).  Served paged through
the fallback, deepseek-reduced (MLA latents), llama2-7b-reduced with an
int8 KV cache (codes and scales), hymba-reduced (its global layers' K/V
paged, the windowed K/V and SSM state dense per slot) and Mamba2-reduced
(nothing pageable) give dense serving's tokens on a pool the requests
outgrow (a preemption re-prefills the evicted request's state), every
page coming back.  Copy-on-write and insertion touch only the pageable
leaves; a dense leaf is the slot's own stripe."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import SPDPlanConfig, replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.kernels import ops as ops  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TP = 2
TABLE = np.asarray([[2, 5, -1], [0, 1, 3], [-1, -1, -1]], np.int32)
POS = np.asarray([5, 9, 0], np.int32)


def _pool(rng, tail):
    """A (tp, L, P+1, ps, *tail) pool (8 pages of 4 and the trash)."""
    return rng.standard_normal((TP, 2, 9, 4) + tail).astype(np.float32)


@pytest.mark.parametrize("tail", [(2, 16), (2,), (24,)],
                         ids=["kv", "int8-scale", "mla-latent"])
def test_gather_pages_matches_reference(tail):
    pool = _pool(np.random.default_rng(0), tail)
    got = ops.gather_pages(torch.from_numpy(pool), torch.from_numpy(TABLE))
    assert got.shape == (TP, 2, 3, 12) + tail
    for t in range(TP):
        ref = ROPS.gather_pages(jnp.asarray(pool[t]), jnp.asarray(TABLE))
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(ref))


@pytest.mark.parametrize("tail", [(2, 16), (2,), (24,)],
                         ids=["kv", "int8-scale", "mla-latent"])
@pytest.mark.parametrize("n", [1, 3])
def test_scatter_token_and_chunk_pages_match_reference(tail, n):
    """The token (n = 1) or chunk (n = 3) a dense step wrote at pos..pos+
    n-1 of each slot's view, written back in place: row 0 crosses into an
    unallocated page, row 2 has no pages."""
    rng = np.random.default_rng(n)
    pool = _pool(rng, tail)
    dense = rng.standard_normal((TP, 2, 3, 12) + tail).astype(np.float32)
    tpool = torch.from_numpy(pool.copy())
    ptr = tpool.data_ptr()
    args = (torch.from_numpy(dense), torch.from_numpy(TABLE),
            torch.from_numpy(POS))
    out = (ops.scatter_token_page(tpool, *args) if n == 1
           else ops.scatter_chunk_pages(tpool, *args, n))
    assert out is tpool and tpool.data_ptr() == ptr
    for t in range(TP):
        rargs = (jnp.asarray(pool[t]), jnp.asarray(dense[t]),
                 jnp.asarray(TABLE), jnp.asarray(POS))
        ref = (ROPS.scatter_token_page(*rargs) if n == 1
               else ROPS.scatter_chunk_pages(*rargs, n))
        np.testing.assert_array_equal(tpool[t, :, :-1].numpy(),
                                      np.asarray(ref)[:, :-1])


@pytest.mark.parametrize("tail", [(2,), (24,)],
                         ids=["int8-scale", "mla-latent"])
def test_scatter_prefill_pages_one_feature_axis(tail):
    """An int8 scale's or an MLA latent's prefill cache (one feature
    axis) into its pages, as the reference's."""
    rng = np.random.default_rng(7)
    pool = _pool(rng, tail)
    dense1 = rng.standard_normal((TP, 2, 1, 12) + tail).astype(np.float32)
    row = np.asarray([4, 0, -1], np.int32)
    tpool = torch.from_numpy(pool.copy())
    ops.scatter_prefill_pages(tpool, torch.from_numpy(dense1),
                              torch.from_numpy(row), tail=len(tail))
    for t in range(TP):
        ref = ROPS.scatter_prefill_pages(jnp.asarray(pool[t]),
                                         jnp.asarray(dense1[t]),
                                         jnp.asarray(row))
        np.testing.assert_array_equal(tpool[t, :, :-1].numpy(),
                                      np.asarray(ref)[:, :-1])


def _no_overflow(cfg):
    """A MoE config whose capacity holds every assignment: routing is then
    per token, so the tokens do not depend on how rows are batched
    (ROADMAP C7) and a preempted stream matches the dense one."""
    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_routed)))


@pytest.mark.parametrize("arch,cfg_kw,pages", [
    ("deepseek-v2-lite-16b-reduced", {}, 9),
    ("llama2-7b-reduced", {"kv_dtype": "int8"}, 9),
    ("hymba-1.5b-reduced", {}, 9),
    ("mamba2-370m-reduced", {}, 9)],
    ids=["mla", "int8-kv", "hybrid", "ssm"])
def test_paged_tokens_equal_dense(arch, cfg_kw, pages):
    """4 requests on a 9-page pool of 8-token pages (they need 12 at
    their peak): at least one preemption, every page back, and dense
    serving's greedy tokens (quant8 syncs)."""
    cfg = _no_overflow(replace(get_config(arch), dtype="float32", **cfg_kw))
    kw = dict(tp=TP, spd=0.25, device="cpu", cache_len=64, comm="quant8",
              comm_logits="quant8", q_chunk=64)
    dense = LLM.load(cfg, **kw)
    paged = LLM.load(cfg, params=dense.canonical, page_size=8,
                     num_pages=pages, **kw)
    assert not M.supports_paged_attention(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (12, 5, 20, 9)]
    sp = SamplingParams(max_new=8)
    want = [o.token_ids for o in dense.generate(prompts, sp)]
    outs = paged.generate(prompts, sp)
    assert [o.token_ids for o in outs] == want
    sched = paged.serve()
    assert sched.n_preemptions > 0 and sum(o.n_preempted for o in outs) > 0
    assert sched.pool.num_free == pages and not sched.kv.prefix_cache


def test_copy_pages_and_insert_touch_only_pageable_leaves():
    """hymba-reduced's paged tree: global layers' K/V are pools, windowed
    K/V, SSM state and conv tails per-slot.  insert writes a prefill's
    pageable leaves into the slot's pages and its dense leaves into the
    slot's stripe (other slots untouched); copy_pages copies pool pages
    and leaves every dense leaf as it was."""
    cfg = replace(get_config("hymba-1.5b-reduced"), dtype="float32")
    llm = LLM.load(cfg, tp=TP, device="cpu", cache_len=32)
    eng, plan = llm.engine, llm.plan
    flags = M.cache_pageable_tree(cfg, plan)
    pc = eng.blank_paged_caches(3, 32, page_size=8, num_pages=6)
    tree_map(lambda leaf: leaf.normal_(generator=torch.Generator()
                                       .manual_seed(1)), pc)
    before = tree_map(torch.clone, pc)
    _, c1 = eng.prefill(llm.params, np.arange(1, 33)[None],
                        cache_len=32, lengths=np.asarray([32]))
    row = np.asarray([3, 0, -1, -1])
    pc = eng.insert_paged(pc, c1, 1, row)

    def check_insert(f, new, old, one):
        if f:
            page = new[:, :, [3, 0]].reshape(one.shape[:2] + (16,)
                                             + one.shape[4:])
            torch.testing.assert_close(page, one[:, :, 0, :16], rtol=0,
                                       atol=0)
            torch.testing.assert_close(new[:, :, [1, 2, 4, 5]],
                                       old[:, :, [1, 2, 4, 5]], rtol=0,
                                       atol=0)
        else:
            torch.testing.assert_close(new[:, :, 1], one[:, :, 0], rtol=0,
                                       atol=0)
            torch.testing.assert_close(new[:, :, [0, 2]], old[:, :, [0, 2]],
                                       rtol=0, atol=0)

    tree_map(check_insert, flags, pc, before, c1)
    assert any(tree_leaves(flags)) and not all(tree_leaves(flags))
    mid = tree_map(torch.clone, pc)
    pc = eng.copy_paged_pages(pc, [3, 1], [5, 2])

    def check_copy(f, new, old):
        if f:
            torch.testing.assert_close(new[:, :, [5, 2]], old[:, :, [3, 1]],
                                       rtol=0, atol=0)
            torch.testing.assert_close(new[:, :, [0, 1, 3, 4]],
                                       old[:, :, [0, 1, 3, 4]], rtol=0,
                                       atol=0)
        else:
            torch.testing.assert_close(new, old, rtol=0, atol=0)

    tree_map(check_copy, flags, pc, mid)
    # the fallback's copy_pos acts on pool leaves only, as copy_pages
    step = F.copy_pos_paged_step(cfg, plan, page_size=8)[0]
    snap = tree_map(torch.clone, pc)
    step(pc, torch.as_tensor(np.asarray([[0, 1], [3, 0], [2, 4]])),
         torch.tensor([1, 2, 3]), torch.tensor([9, 5, 12]))
    tree_map(lambda f, new, old: None if f else torch.testing.assert_close(
        new, old, rtol=0, atol=0), flags, pc, snap)


def test_pageable_trees():
    """Which leaves page: MLA's latent and rope key, every int8 K/V leaf
    (codes and scales) of a full-causal layer, nothing of an SSM layer."""
    plan = SPDPlanConfig.none(3)
    ds = get_config("deepseek-v2-lite-16b-reduced")
    assert M.cache_pageable_tree(ds, plan) == [{"c": True, "kr": True}] * 2
    q8 = replace(get_config("qwen2-moe-a2.7b-reduced"), kv_dtype="int8")
    assert M.cache_pageable_tree(q8, plan)[0] == dict.fromkeys(
        ("k", "k_s", "v", "v_s"), True)
    shapes = [{k: v.shape for k, v in seg.items()}
              for seg in M.paged_cache_struct(q8, plan, 4, 32, TP,
                                              page_size=8, num_pages=6)]
    assert shapes[0]["k"] == (3, 7, 8, 4, 32)
    assert shapes[0]["k_s"] == (3, 7, 8, 4)
