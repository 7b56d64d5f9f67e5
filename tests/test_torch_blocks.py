"""PyTorch port vs JAX reference at block level: block_seq / block_dec
under TP and SPD wiring (drop off/on) at tp in {2, 4} and every kept-sync
level, mirroring tests/test_blocks_spd.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import blocks as RB, simtp as RS  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.parallel.collectives import MODEL_AXIS  # noqa: E402
from repro.parallel.layout import make_gqa_layout as rlayout  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.parallel.layout import make_gqa_layout  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from torch_parity import BLOCK_ATOL as ATOL  # noqa: E402
from torch_parity import assert_block_close as _assert_close  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


def _cfgs():
    return (rreplace(rget("smollm-360m", reduced=True), dtype="float32"),
            replace(get_config("smollm-360m-reduced"), dtype="float32"))


def _layer(tp, seed=0):
    rcfg, cfg = _cfgs()
    rkind = rkinds(rcfg)[1]
    lp = RB.init_layer(jax.random.PRNGKey(seed), rcfg, rkind)
    # non-trivial norm weights, as tests/test_blocks_spd.py does
    lp = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(7), x.shape, jnp.float32), lp)
    rsplit = RS.split_layer(lp, rcfg, rkind, tp)
    psplit = tree_map(lambda a: torch.from_numpy(np.array(a)),
                      jax.tree.map(np.asarray, rsplit))
    return rcfg, cfg, rkind, layer_kinds(cfg)[1], rsplit, psplit


@pytest.mark.parametrize("comm", ["exact", "quant8", "quant4"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_block_seq_matches_reference(tp, drop, comm):
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp)
    rng = np.random.default_rng(tp * 10 + drop)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16)).astype(np.int32)

    def per_shard(p, xx, pp):
        out, _, _ = RB.block_seq(
            rcfg, rkind, rlayout(cfg.n_heads, cfg.n_kv_heads, tp), p, xx,
            pp, drop=drop, tp=tp, shard_idx=jax.lax.axis_index(MODEL_AXIS),
            q_chunk=64, comm=comm)
        return out

    ref = np.asarray(jax.vmap(per_shard, in_axes=(0, None, None),
                              axis_name=MODEL_AXIS)(rsplit, jnp.asarray(x),
                                                    jnp.asarray(pos)))
    out, _, _ = B.block_seq(
        cfg, kind, make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp), psplit,
        torch.from_numpy(x).expand((tp,) + x.shape),
        torch.from_numpy(pos).long(), drop=drop, q_chunk=64, comm=comm)
    out = out.numpy()
    # the block output is replicated: every shard holds the same value
    for t in range(1, tp):
        np.testing.assert_array_equal(out[t], out[0])
    _assert_close(out, ref, x[None], comm)


@pytest.mark.parametrize("comm", ["exact", "quant8", "quant4"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_block_dec_matches_reference(tp, drop, comm):
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp, seed=1)
    lay = make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp)
    b, s = 3, 12
    rng = np.random.default_rng(tp * 100 + drop)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([0, 5, 11], np.int32)
    kc = rng.standard_normal((tp, b, s, lay.kv_local, cfg.d_head)) \
        .astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)

    def per_shard(p, xx, pp, cache):
        return RB.block_dec(rcfg, rkind, rlayout(cfg.n_heads, cfg.n_kv_heads,
                                                 tp), p, xx, pp, cache,
                            drop=drop, tp=tp,
                            shard_idx=jax.lax.axis_index(MODEL_AXIS),
                            comm=comm)

    ref_out, ref_cache = jax.vmap(per_shard, in_axes=(0, None, None, 0),
                                  axis_name=MODEL_AXIS)(
        rsplit, jnp.asarray(x), jnp.asarray(pos),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)})
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, new_cache = B.block_dec(cfg, kind, lay, psplit,
                                 torch.from_numpy(x).expand((tp,) + x.shape),
                                 torch.from_numpy(pos).long(), cache,
                                 drop=drop, comm=comm)
    assert new_cache["k"] is cache["k"]          # written in place
    for kk in ("k", "v"):
        np.testing.assert_allclose(new_cache[kk].numpy(),
                                   np.asarray(ref_cache[kk]), atol=ATOL,
                                   rtol=0)
    _assert_close(out.numpy(), np.asarray(ref_out), x[None], comm)


@pytest.mark.parametrize("drop", [False, True])
def test_block_seq_bias_branch_matches_reference(drop):
    """Fig 3b: with q/k/v, out-proj and MLP biases the SPD block re-adds
    the out-proj bias once after the deferred sync (SmolLM has no biases,
    so this branch runs on a biased variant of the reduced config)."""
    tp = 2
    kw = dict(qkv_bias=True, o_bias=True, mlp_bias=True)
    rcfg, cfg = _cfgs()
    rcfg, cfg = rreplace(rcfg, **kw), replace(cfg, **kw)
    rkind = rkinds(rcfg)[1]
    lp = RB.init_layer(jax.random.PRNGKey(3), rcfg, rkind)
    lp = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(8), x.shape, jnp.float32), lp)
    rsplit = RS.split_layer(lp, rcfg, rkind, tp)
    psplit = tree_map(lambda a: torch.from_numpy(np.array(a)),
                      jax.tree.map(np.asarray, rsplit))
    x = np.random.default_rng(drop).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).astype(np.int32)

    def per_shard(p, xx, pp):
        return RB.block_seq(rcfg, rkind, rlayout(6, 2, tp), p, xx, pp,
                            drop=drop, tp=tp,
                            shard_idx=jax.lax.axis_index(MODEL_AXIS),
                            q_chunk=64)[0]

    ref = np.asarray(jax.vmap(per_shard, in_axes=(0, None, None),
                              axis_name=MODEL_AXIS)(rsplit, jnp.asarray(x),
                                                    jnp.asarray(pos)))
    out, _, _ = B.block_seq(
        cfg, layer_kinds(cfg)[1], make_gqa_layout(6, 2, tp), psplit,
        torch.from_numpy(x).expand((tp,) + x.shape),
        torch.from_numpy(pos).long(), drop=drop, q_chunk=64)
    assert np.abs(out.numpy() - ref).max() <= ATOL
