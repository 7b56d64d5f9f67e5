"""PyTorch port vs JAX reference: MLA blocks (deepseek-v2-lite-16b-reduced:
4 heads, kv_lora 64, nope 32 + rope 16, v 32; fp32).

The sequence block (`mla_mixer_seq`: latent, expanded keys and values,
the plain attention at scale (nope + rope)^-1/2) and the decode block
(`mla_mixer_dec`: the absorbed form in fp32 over the cached latent) at tp
1, 2 and 4, TP and SPD wiring, exact and quant8 syncs, against the
reference's block vmapped over the shards: outputs under
`torch_parity.assert_block_close`, caches within BLOCK_ATOL.  The latent
is replicated: every shard's cache equals shard 0's.  The absorbed
decode is held to the sequence form: the last token's output of one
prefill over S tokens equals a prefill over S-1 and one decode step."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import blocks as RB  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.parallel.collectives import MODEL_AXIS  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B, model as M, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.parallel.layout import REPLICATED  # noqa: E402
from torch_parity import (BLOCK_ATOL, assert_block_close,  # noqa: E402
                          one_torch_thread, ref_layer,  # noqa: F401
                          ref_split_layer)

ARCH = "deepseek-v2-lite-16b-reduced"
# the absorbed decode against the sequence form, one package, fp32: the
# same products in other association orders
ABSORBED_ATOL = 1e-5


def _cfgs():
    return (rreplace(rget(ARCH), dtype="float32"),
            replace(get_config(ARCH), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _layer(tp, li):
    """Layer `li` (0: the dense MLP layer, 1: a MoE layer), perturbed and
    split by both packages."""
    rcfg, cfg = _cfgs()
    rkind, kind = rkinds(rcfg)[li], layer_kinds(cfg)[li]
    assert kind.mixer == rkind.mixer == "mla"
    lp = ref_layer(rcfg, rkind, seed=li)
    rsplit = ref_split_layer(lp, rcfg, rkind, tp)
    psplit = simtp.split_layer(from_reference(jax.tree.map(np.asarray, lp),
                                              cfg), cfg, kind, tp)
    return rcfg, cfg, rkind, kind, rsplit, psplit


CASES = [(tp, drop, comm) for tp in (1, 2, 4) for drop in (False, True)
         for comm in ("exact", "quant8")]


def _assert_caches(port, ref, tp):
    for name in ("c", "kr"):
        p, r = port[name].numpy(), np.asarray(ref[name])
        for t in range(1, tp):                       # replicated latent
            np.testing.assert_array_equal(p[t], p[0])
        np.testing.assert_allclose(p, r, atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("tp,drop,comm", CASES)
def test_mla_block_seq_matches_reference(tp, drop, comm):
    """S 24 prefill through the dense layer (the MoE layer at tp 2)."""
    li = 1 if (tp == 2 and comm == "quant8") else 0
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp, li)
    rng = np.random.default_rng(tp * 10 + drop)
    s = 24
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)

    def per_shard(p, xx, pp):
        out, _, cache = RB.block_seq(
            rcfg, rkind, None, p, xx, pp, drop=drop, tp=tp,
            shard_idx=jax.lax.axis_index(MODEL_AXIS), want_cache=True,
            q_chunk=16, comm=comm)
        return out, cache

    ref, rcache = jax.jit(jax.vmap(per_shard, in_axes=(0, None, None),
                                   axis_name=MODEL_AXIS))(
        rsplit, jnp.asarray(x), jnp.asarray(pos))
    out, cache, _ = B.block_seq(
        cfg, kind, None, psplit, torch.from_numpy(x).expand((tp,) + x.shape),
        torch.from_numpy(pos).long(), drop=drop, want_cache=True, q_chunk=16,
        comm=comm)
    out = out.numpy()
    for t in range(1, tp):
        np.testing.assert_array_equal(out[t], out[0])
    assert_block_close(out, np.asarray(ref), x[None], comm, one_token=True)
    _assert_caches(cache, rcache, tp)


@pytest.mark.parametrize("tp,drop,comm", CASES)
def test_mla_block_dec_matches_reference(tp, drop, comm):
    """One decode token per row at positions 0, 17 and 39 of a 40-slot
    latent cache, written in place."""
    li = 1 if (tp == 2 and comm == "quant8") else 0
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp, li)
    m, b, s = cfg.mla, 3, 40
    rng = np.random.default_rng(tp * 100 + drop)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([0, 17, 39], np.int32)

    def rep(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.repeat(a[None], tp, 0)

    cache = {"c": rep(b, s, m.kv_lora_rank), "kr": rep(b, s,
                                                        m.qk_rope_head_dim)}

    def per_shard(p, xx, pp, c):
        return RB.block_dec(rcfg, rkind, None, p, xx, pp, c, drop=drop,
                            tp=tp, shard_idx=jax.lax.axis_index(MODEL_AXIS),
                            comm=comm)

    ref, rcache = jax.jit(jax.vmap(per_shard, in_axes=(0, None, None, 0),
                                   axis_name=MODEL_AXIS))(
        rsplit, jnp.asarray(x), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, cache))
    pcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    held = pcache["c"]
    out, new = B.block_dec(cfg, kind, None, psplit,
                           torch.from_numpy(x).expand((tp,) + x.shape),
                           torch.from_numpy(pos).long(), pcache, drop=drop,
                           comm=comm)
    assert new["c"] is held                        # written in place
    assert_block_close(out.numpy(), np.asarray(ref), x[None], comm,
                       one_token=True)
    _assert_caches(new, rcache, tp)


@pytest.mark.parametrize("tp,drop", [(1, False), (2, True), (4, False)])
def test_absorbed_decode_matches_sequence_form(tp, drop):
    """Each row's last token through the absorbed decode (the latent of
    the first S-1 tokens from their prefill) equals that token's output
    of one prefill over all S tokens (TP and SPD wiring)."""
    _, cfg, _, kind, _, psplit = _layer(tp, 0)
    s, b = 21, 2
    rng = np.random.default_rng(5 + tp)
    x = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model))
                         .astype(np.float32)).expand(tp, b, s, cfg.d_model)
    pos = torch.arange(s).expand(b, s)
    full, _, _ = B.block_seq(cfg, kind, None, psplit, x, pos, drop=drop)
    head, cache, _ = B.block_seq(cfg, kind, None, psplit, x[:, :, :-1].clone(),
                                 pos[:, :-1], drop=drop, want_cache=True)
    cache = {k: torch.cat([v, torch.zeros_like(v[:, :, :3])], 2)
             for k, v in cache.items()}            # room past the prompt
    last, _ = B.block_dec(cfg, kind, None, psplit, x[:, :, -1:].clone(),
                          torch.full((b,), s - 1), cache, drop=drop)
    np.testing.assert_allclose(last.numpy(), full[:, :, -1:].numpy(),
                               atol=ABSORBED_ATOL, rtol=0)
    np.testing.assert_allclose(head.numpy(), full[:, :, :-1].numpy(),
                               atol=ABSORBED_ATOL, rtol=0)


def test_mla_tree_and_caches_match_reference():
    """init_mla's leaves and their split axes are the reference's; the
    cache tree holds the latent and rope key, replicated and pageable."""
    rcfg, cfg = _cfgs()
    kind = layer_kinds(cfg)[0]
    lp = B.init_layer(torch.Generator().manual_seed(0), cfg, kind, "cpu")
    rlp = jax.eval_shape(lambda: RB.init_layer(jax.random.PRNGKey(0), rcfg,
                                               rkinds(rcfg)[0]))
    assert jax.tree.map(lambda a: tuple(a.shape), rlp) == \
        jax.tree.map(lambda a: tuple(a.shape), lp)
    assert B.layer_specs(cfg, kind) == RB.layer_specs(rcfg, rkinds(rcfg)[0])
    plan = M.SPDPlanConfig.first_k(cfg.n_layers, 1)
    structs = M.cache_struct(cfg, plan, 3, 32, 2)
    assert [{k: v.shape for k, v in seg.items()} for seg in structs] == [
        {"c": (1, 3, 32, 64), "kr": (1, 3, 32, 16)},     # the dropped layer
        {"c": (2, 3, 32, 64), "kr": (2, 3, 32, 16)}]
    assert M.cache_pageable_tree(cfg, plan)[0] == {"c": True, "kr": True}
    assert M.cache_specs_tree(cfg, plan)[0] == {"c": REPLICATED,
                                                "kr": REPLICATED}
    with pytest.raises(ValueError, match="divide"):
        B.pad_layer(lp, cfg, kind, 3)
