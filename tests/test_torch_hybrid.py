"""PyTorch port vs JAX reference: the hybrid family's pieces
(hymba-1.5b-reduced, fp32): sliding-window attention (the mask, the
query-chunked path, the rolling decode buffer and its writes), the
parameter tree (`na` / `ns`, SSM heads laid out as the attention's q
heads) at tp 1/2/4, hybrid blocks (block_seq on a windowed layer past
its window and on a global layer, block_dec on a rolling buffer past
its window) under the TP and SPD wiring at tp 1/2/4, exact and quant8
(quant4 once), and the refusals (MLA, paging, speculation, training,
Algorithm 1).  The model itself: tests/test_torch_hybrid_model.py."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import MLAConfig as RMLAConfig  # noqa: E402
from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import blocks as RB, model as RM, simtp as RS  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.parallel.collectives import MODEL_AXIS  # noqa: E402
from repro.parallel.layout import make_gqa_layout as rlayout  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import (MLAConfig, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B, model as M, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.parallel.layout import make_gqa_layout  # noqa: E402
from repro_torch.parallel.tp import check_trainable  # noqa: E402
from repro_torch.spec import SpecConfig, SpecError  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_parity import (BLOCK_ATOL, assert_block_close,  # noqa: E402
                          one_torch_thread, perturbed_canonical,  # noqa: F401
                          ref_layer, ref_split_layer)

ARCH = "hymba-1.5b-reduced"
WINDOW = 32


def _cfgs(**kw):
    return (rreplace(rget(ARCH), dtype="float32", **kw),
            replace(get_config(ARCH), dtype="float32", **kw))


# ---------------------------------------------------------------------------
# Sliding-window attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,q_chunk", [(40, 64), (40, 16), (20, 64)])
def test_windowed_prefill_attention_matches_reference(s, q_chunk):
    """causal_mask and attention_any with a window (query-chunked when
    q_chunk < S) against the reference's."""
    rng = np.random.default_rng(s + q_chunk)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
    rmask = np.asarray(RA.causal_mask(jnp.asarray(pos), jnp.asarray(pos),
                                      WINDOW))
    pmask = A.causal_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                          WINDOW)
    np.testing.assert_array_equal(pmask.numpy(), rmask)
    ref = RA.attention_any(*map(jnp.asarray, (q, k, v, pos, pos)),
                           window=WINDOW, q_chunk=q_chunk)
    out = A.attention_any(*map(torch.from_numpy, (q, k, v, pos, pos)),
                          window=WINDOW, q_chunk=q_chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_rolling_decode_matches_reference():
    """cache_update writes slot pos % window; decode_attend masks the
    slots not yet filled: rows before, at and past the window."""
    rng = np.random.default_rng(5)
    b, hkv, dh = 4, 2, 16
    kc = rng.standard_normal((b, WINDOW, hkv, dh)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    kn = rng.standard_normal((b, 1, hkv, dh)).astype(np.float32)
    vn = rng.standard_normal(kn.shape).astype(np.float32)
    q = rng.standard_normal((b, 1, 4, dh)).astype(np.float32)
    pos = np.asarray([3, 31, 32, 77], np.int32)
    rk, rv = RA.cache_update(*map(jnp.asarray, (kc, vc, kn, vn, pos)),
                             window=WINDOW)
    ro = RA.decode_attend(jnp.asarray(q), rk, rv, jnp.asarray(pos),
                          window=WINDOW)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    A.cache_update(pk, pv, torch.from_numpy(kn), torch.from_numpy(vn),
                   torch.from_numpy(pos).long(), window=WINDOW)
    po = A.decode_attend(torch.from_numpy(q), pk, pv,
                         torch.from_numpy(pos).long(), window=WINDOW)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_layer_kinds_and_init_tree_match_reference():
    """Windows on every layer but the global ones; the port's seeded init
    has the reference's leaves and shapes (attn, ssm, na, ns, mlp)."""
    rcfg, cfg = _cfgs()
    assert [(k.mixer, k.ffn, k.window) for k in layer_kinds(cfg)] == \
        [(k.mixer, k.ffn, k.window) for k in rkinds(rcfg)]
    assert [k.window for k in layer_kinds(cfg)] == [0, WINDOW, WINDOW, 0]
    ref = jax.tree.map(np.asarray, RM.init_model(jax.random.PRNGKey(0), rcfg))
    port = M.init_model(cfg, seed=0)
    assert sorted(port["layers"][1]) == ["attn", "ln1", "ln2", "mlp", "na",
                                         "ns", "ssm"]
    assert [tuple(a.shape) for a in jax.tree.leaves(ref)] == \
        [tuple(b.shape) for b in tree_leaves(port)]
    assert cfg.param_count() == rcfg.param_count()


@pytest.mark.parametrize("heads", [(4, 2), (6, 2)])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_placed_params_match_reference(tp, heads):
    """pad_model + split equal the reference's prepare_params leaf for
    leaf; the SSM heads (and na / ns) follow the q-head layout: 6 heads
    over 2 kv heads pad to 8 at tp 4."""
    rcfg, cfg = _cfgs(n_heads=heads[0], n_kv_heads=heads[1])
    canon = perturbed_canonical(rcfg)
    rplan, plan = RPlan.first_k(4, 1), SPDPlanConfig.first_k(4, 1)
    ref = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg, rplan, tp)
    port = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, tp)
    rl, pl = jax.tree.leaves(ref), tree_leaves(port)
    assert len(rl) == len(pl)
    for a, b in zip(rl, pl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    lay = make_gqa_layout(heads[0], heads[1], tp)
    ns = port["segs"][0]["ns"]                      # (tp, layers, HL*dh)
    assert ns.shape[-1] == lay.q_local * cfg.d_head


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

# 6 q heads over 2 kv heads: no padding at tp 1 and 2, two zero heads at
# tp 4 (hymba-reduced's 4 heads never pad)
HEADS = dict(n_heads=6, n_kv_heads=2)


@functools.lru_cache(maxsize=None)
def _layer(tp, li):
    """Layer `li` (1 windowed, 0 global), perturbed, split by both
    packages (once per tp and layer)."""
    rcfg, cfg = _cfgs(**HEADS)
    rkind, kind = rkinds(rcfg)[li], layer_kinds(cfg)[li]
    lp = ref_layer(rcfg, rkind, seed=li)
    rsplit = ref_split_layer(lp, rcfg, rkind, tp)
    psplit = simtp.split_layer(from_reference(jax.tree.map(np.asarray, lp),
                                              cfg), cfg, kind, tp)
    return rcfg, cfg, rkind, kind, rsplit, psplit


BLOCK_CASES = [(tp, drop, comm) for tp in (1, 2, 4) for drop in (False, True)
               for comm in ("exact", "quant8")] + [(2, True, "quant4")]


def _np(t):
    return {k: (_np(v) if isinstance(v, dict) else v.numpy())
            for k, v in t.items()}


def _assert_caches(port, ref):
    rl, pl = jax.tree.leaves(ref), jax.tree.leaves(_np(port))
    assert len(rl) == len(pl) == 5              # conv bc, conv x, k, state, v
    for r, p in zip(rl, pl):
        np.testing.assert_allclose(p, np.asarray(r), atol=BLOCK_ATOL, rtol=0)


def _seq_case(tp, drop, comm, li, s):
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp, li)
    rlay = rlayout(cfg.n_heads, cfg.n_kv_heads, tp)
    rng = np.random.default_rng(tp * 10 + drop + li)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)

    def per_shard(p, xx, pp):
        out, _, cache = RB.block_seq(
            rcfg, rkind, rlay, p, xx, pp, drop=drop, tp=tp,
            shard_idx=jax.lax.axis_index(MODEL_AXIS), want_cache=True,
            q_chunk=16, comm=comm)
        return out, cache

    ref, rcache = jax.jit(jax.vmap(per_shard, in_axes=(0, None, None),
                                   axis_name=MODEL_AXIS))(
        rsplit, jnp.asarray(x), jnp.asarray(pos))
    out, cache, _ = B.block_seq(
        cfg, kind, make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp), psplit,
        torch.from_numpy(x).expand((tp,) + x.shape),
        torch.from_numpy(pos).long(), drop=drop, want_cache=True, q_chunk=16,
        comm=comm)
    out = out.numpy()
    for t in range(1, tp):
        np.testing.assert_array_equal(out[t], out[0])
    assert_block_close(out, np.asarray(ref), x[None], comm, one_token=True)
    _assert_caches(cache, rcache)
    if kind.window:
        assert cache["k"].shape[2] == min(s, kind.window)


@pytest.mark.parametrize("tp,drop,comm", BLOCK_CASES)
def test_hybrid_block_seq_matches_reference(tp, drop, comm):
    """A windowed layer at S 40 > window 32: the window mask, the
    query-chunked attention, the scan over ragged chunks and the
    rolling prefill cache."""
    _seq_case(tp, drop, comm, li=1, s=40)


@pytest.mark.parametrize("drop", [False, True])
def test_hybrid_global_block_seq_matches_reference(drop):
    _seq_case(2, drop, "quant8", li=0, s=24)


@pytest.mark.parametrize("tp,drop,comm", BLOCK_CASES)
def test_hybrid_block_dec_matches_reference(tp, drop, comm):
    """Decode on a rolling buffer: rows before, at and past the window;
    K/V, scan state and conv tails written in place."""
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp, 1)
    lay = make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
    s_cfg, b = cfg.ssm, 3
    hl = lay.q_local
    rng = np.random.default_rng(tp * 100 + drop)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([5, 31, 50], np.int32)
    f32 = np.float32
    cache = {
        "k": rng.standard_normal((tp, b, WINDOW, lay.kv_local,
                                  cfg.d_head)).astype(f32),
        "v": rng.standard_normal((tp, b, WINDOW, lay.kv_local,
                                  cfg.d_head)).astype(f32),
        "state": rng.standard_normal((tp, b, hl, s_cfg.head_dim,
                                      s_cfg.d_state)).astype(f32),
        "conv": {"x": rng.standard_normal(
            (tp, b, s_cfg.d_conv - 1, hl * s_cfg.head_dim)).astype(f32),
            "bc": np.repeat(rng.standard_normal(
                (1, b, s_cfg.d_conv - 1, 2 * s_cfg.d_state)), tp, 0).astype(
                    f32)}}

    def per_shard(p, xx, pp, c):
        return RB.block_dec(rcfg, rkind, rlayout(cfg.n_heads, cfg.n_kv_heads,
                                                 tp), p, xx, pp, c,
                            drop=drop, tp=tp,
                            shard_idx=jax.lax.axis_index(MODEL_AXIS),
                            comm=comm)

    ref, rcache = jax.jit(jax.vmap(per_shard, in_axes=(0, None, None, 0),
                                   axis_name=MODEL_AXIS))(
        rsplit, jnp.asarray(x), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, cache))
    pcache = jax.tree.map(lambda a: torch.from_numpy(a.copy()), cache)
    held = pcache["k"]
    out, new = B.block_dec(cfg, kind, lay, psplit,
                           torch.from_numpy(x).expand((tp,) + x.shape),
                           torch.from_numpy(pos).long(), pcache, drop=drop,
                           comm=comm)
    assert new["k"] is held                        # written in place
    assert_block_close(out.numpy(), np.asarray(ref), x[None], comm,
                       one_token=True)
    _assert_caches(new, rcache)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_mla_refuses():
    """MLA is ported for serving, training and Algorithm 1: its layer
    kinds and the reference's parameter count; check_trainable passes
    (no device decides a refusal any more).  What stays refused names its ROADMAP item:
    weight-only int8 on MLA (C8)."""
    mla = replace(get_config("qwen3-1.7b-reduced"), mla=MLAConfig(
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16))
    rmla = rreplace(rget("qwen3-1.7b-reduced"), mla=RMLAConfig(
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16))
    assert [k.mixer for k in layer_kinds(mla)] == \
        [k.mixer for k in rkinds(rmla)] == ["mla"] * mla.n_layers
    assert mla.param_count() == rmla.param_count()
    check_trainable(mla)
    with pytest.raises(NotImplementedError, match="C8"):
        M.pad_model(M.init_model(replace(mla, weight_dtype="int8")),
                    replace(mla, weight_dtype="int8"), 2)


def test_paging_speculation_training_and_algorithm1_refuse():
    """Paged caches serve through the gather -> dense -> scatter fallback
    (only the global layers' K/V paged; the windowed K/V, SSM state and
    conv tails dense per slot); speculation refuses and chunked prefill
    falls back to whole (the extension forward covers full-causal GQA
    stacks, as the reference's does); training and Algorithm 1 run:
    check_trainable passes (on any device) and the tiered comm policy
    is placed and served."""
    _, cfg = _cfgs()
    kw = dict(tp=2, device="cpu", cache_len=64, comm="quant8")
    flags = M.cache_pageable_tree(cfg, SPDPlanConfig.none(cfg.n_layers))
    assert [seg["k"] for seg in flags] == [True, False, True]
    assert not any(f for seg in flags for f in tree_leaves(
        {k: v for k, v in seg.items() if k not in ("k", "v")}))
    with pytest.raises(SpecError):
        LLM.load(cfg, spec=SpecConfig(k=3), **kw)
    llm = LLM.load(cfg, **kw)
    chunked = LLM.load(cfg, params=llm.canonical, prefill_chunk=8, **kw)
    prompts = [np.arange(20) % 512, np.arange(7) + 100]
    assert [o.token_ids for o in chunked.generate(
        prompts, SamplingParams(max_new=4))] == \
        [o.token_ids for o in llm.generate(prompts, SamplingParams(max_new=4))]
    assert not llm.serve(page_size=8, num_pages=8).kv.prefix_cache
    paged = LLM.load(cfg, params=llm.canonical, page_size=8, num_pages=8,
                     **kw)
    assert [o.token_ids for o in paged.generate(
        prompts, SamplingParams(max_new=4))] == \
        [o.token_ids for o in llm.generate(prompts, SamplingParams(max_new=4))]
    assert paged.serve().pool.num_free == 8
    check_trainable(cfg)
    from repro_torch.data import calibration_batches
    calib = calibration_batches(cfg.vocab_size, 2, 16, batch=2)
    res = llm.apply_comm_policy(calib, n_spd=1, tau1=-1.0, tau2=1.0)
    assert sorted(res.ranking.tolist()) == list(range(cfg.n_layers))
    assert llm.plan.n_dropped <= 1 and llm.plan.comm is not None
    assert len(llm.generate(prompts, SamplingParams(max_new=4))[0]
               .token_ids) == 4
