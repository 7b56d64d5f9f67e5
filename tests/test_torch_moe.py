"""PyTorch port vs JAX reference: the MoE family's pieces
(qwen2-moe-a2.7b-reduced, fp32).

Covers models/moe.py function by function (routing, the dispatch plans
with over-capacity drops, the local experts' combine), the parameter
tree and its expert padding at tp 1/2/4, MoE blocks (block_seq,
block_dec) under the TP and SPD wiring at tp 1/2/4, exact and quant8
(quant4 once), and the refusals (training, Algorithm 1).  The model
itself: tests/test_torch_moe_model.py."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import blocks as RB, model as RM, simtp as RS  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.parallel.collectives import MODEL_AXIS  # noqa: E402
from repro.parallel.layout import make_gqa_layout as rlayout  # noqa: E402

from repro_torch.config.base import SPDPlanConfig, replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B, model as M, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.parallel.layout import make_gqa_layout  # noqa: E402
from repro_torch.parallel.tp import check_trainable  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_parity import (assert_block_close,  # noqa: E402
                          one_torch_thread, perturbed_canonical,  # noqa: F401
                          ref_layer, ref_split_layer)

ARCH = "qwen2-moe-a2.7b-reduced"
# the router and the combine: one fp32 product each
ROUTE_ATOL = 1e-6
MOE_ATOL = 1e-5


def _cfgs(**kw):
    return (rreplace(rget(ARCH), dtype="float32", **kw),
            replace(get_config(ARCH), dtype="float32", **kw))


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

def _routed(seed, t=24, d=16, e_pad=8, n_routed=8, k=2):
    """Seeded router inputs whose top-k never ties: the k-th and the
    (k+1)-th probabilities of every row stand apart."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((d, e_pad)).astype(np.float32)
    logits = h @ w
    logits[:, n_routed:] = -np.inf
    top = -np.sort(-logits, -1)
    assert (top[:, k - 1] - top[:, k] > 1e-3).all()
    return h, w


@pytest.mark.parametrize("n_routed,e_pad", [(8, 8), (6, 8)])
def test_route_matches_reference(n_routed, e_pad):
    """Gates within 1e-6, expert ids equal, aux within 1e-6; a padding
    expert (column >= n_routed) never wins."""
    h, w = _routed(0, e_pad=e_pad, n_routed=n_routed)
    rg, ri, ra = RMOE.route(jnp.asarray(h), jnp.asarray(w), 2, n_routed)
    pg, pi, pa = MOE.route(torch.from_numpy(h), torch.from_numpy(w), 2,
                           n_routed)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    assert int(pi.max()) < n_routed
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), atol=ROUTE_ATOL,
                               rtol=0)
    assert abs(float(pa) - float(ra)) <= ROUTE_ATOL


@pytest.mark.parametrize("capacity", [2, 5, 12])
def test_dispatch_local_matches_reference(capacity):
    """slot_token and tok_slot equal the reference's exactly for every
    shard's experts, over-capacity drops included; the port's batched
    call over a shard axis (offsets e_lo = shard * E_l) equals the
    per-shard calls."""
    h, w = _routed(1, t=24)
    _, ri, _ = RMOE.route(jnp.asarray(h), jnp.asarray(w), 2, 8)
    idx = torch.from_numpy(np.array(ri)).long()
    e_l, shards = 2, 4
    plans = []
    for sh in range(shards):
        rst, rts = RMOE.dispatch_local(ri, None, sh * e_l, e_l, capacity)
        pst, pts = MOE.dispatch_local(idx, sh * e_l, e_l, capacity)
        np.testing.assert_array_equal(pst.numpy(), np.asarray(rst))
        np.testing.assert_array_equal(pts.numpy(), np.asarray(rts))
        plans.append((pst, pts))
    bst, bts = MOE.dispatch_local(idx.expand(shards, -1, -1),
                                  torch.arange(shards) * e_l, e_l, capacity)
    for sh, (pst, pts) in enumerate(plans):
        assert torch.equal(bst[sh], pst) and torch.equal(bts[sh], pts)
    kept = sum(int((pts >= 0).sum()) for _, pts in plans)
    if capacity == 2:                     # 48 assignments, 16 slots
        assert kept == shards * e_l * capacity
    if capacity == 12:                    # room for every assignment
        assert kept == idx.numel()


def test_moe_local_matches_reference():
    """The local experts' combine within 1e-5, with drops, one shard at a
    time and shard-stacked."""
    h, w = _routed(2, t=24)
    rg, ri, _ = RMOE.route(jnp.asarray(h), jnp.asarray(w), 2, 8)
    rng = np.random.default_rng(3)
    e_l, ff, d = 4, 32, h.shape[1]
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((2, e_l, d, ff), (2, e_l, d, ff), (2, e_l, ff, d))]
    outs = []
    for sh in range(2):
        rst, rts = RMOE.dispatch_local(ri, rg, sh * e_l, e_l, 5)
        ref = RMOE.moe_local(jnp.asarray(h), rg, rts, rst,
                             *[jnp.asarray(x[sh]) for x in ws], "silu", True)
        pst, pts = MOE.dispatch_local(torch.from_numpy(np.array(ri)).long(),
                                      sh * e_l, e_l, 5)
        out = MOE.moe_local(torch.from_numpy(h),
                            torch.from_numpy(np.asarray(rg)), pts, pst,
                            *[torch.from_numpy(x[sh]) for x in ws], "silu",
                            True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=MOE_ATOL, rtol=0)
        outs.append(out)
    idx = torch.from_numpy(np.array(ri)).long().expand(2, -1, -1)
    st, ts = MOE.dispatch_local(idx, torch.arange(2) * e_l, e_l, 5)
    both = MOE.moe_local(torch.from_numpy(h).expand(2, -1, -1),
                         torch.from_numpy(np.asarray(rg)).expand(2, -1, -1),
                         ts, st, *[torch.from_numpy(x) for x in ws], "silu",
                         True)
    torch.testing.assert_close(both, torch.stack(outs), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_init_tree_has_the_references_leaves():
    """The port's seeded init has the reference's leaves and shapes,
    moe.{router, wu, wg, wd, su, sg, sd} included."""
    rcfg, cfg = _cfgs()
    ref = jax.tree.map(np.asarray, RM.init_model(jax.random.PRNGKey(0), rcfg))
    port = M.init_model(cfg, seed=0)
    assert sorted(port["layers"][0]["moe"]) == \
        ["router", "sd", "sg", "su", "wd", "wg", "wu"]
    rl, pl = jax.tree.leaves(ref), tree_leaves(port)
    assert [tuple(a.shape) for a in rl] == [tuple(b.shape) for b in pl]
    e = cfg.moe.n_routed
    assert tuple(port["layers"][0]["moe"]["wd"].shape) == (
        e, cfg.moe.d_ff_expert, cfg.d_model)
    assert cfg.active_param_count() < cfg.param_count()


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_placed_params_match_reference(tp):
    """pad_model + split: every placed leaf equals the reference's
    prepare_params, the experts split on their own axis (6 pad to 8 at
    tp 4, the router's padding columns zero)."""
    rcfg, cfg = _cfgs()
    canon = perturbed_canonical(rcfg)
    rplan, plan = RPlan.first_k(3, 1), SPDPlanConfig.first_k(3, 1)
    ref = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg, rplan, tp)
    port = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, tp)
    rl, pl = jax.tree.leaves(ref), tree_leaves(port)
    assert len(rl) == len(pl)
    for a, b in zip(rl, pl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    wu = port["segs"][0]["moe"]["wu"]            # (tp, layers, E_l, d, ff)
    e_pad = -(-cfg.moe.n_routed // tp) * tp
    assert wu.shape[0] == tp and wu.shape[2] == e_pad // tp
    if e_pad > cfg.moe.n_routed:
        router = port["segs"][0]["moe"]["router"][0, 0]
        assert not router[:, cfg.moe.n_routed:].any()


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer(tp):
    """One perturbed MoE layer, split by both packages (once per tp)."""
    rcfg, cfg = _cfgs()
    rkind = rkinds(rcfg)[0]
    lp = ref_layer(rcfg, rkind)
    rsplit = ref_split_layer(lp, rcfg, rkind, tp)
    psplit = simtp.split_layer(from_reference(jax.tree.map(np.asarray, lp),
                                              cfg), cfg, layer_kinds(cfg)[0],
                               tp)
    assert layer_kinds(cfg)[0].ffn == "moe"
    return rcfg, cfg, rkind, layer_kinds(cfg)[0], rsplit, psplit


BLOCK_CASES = [(tp, drop, comm) for tp in (1, 2, 4) for drop in (False, True)
               for comm in ("exact", "quant8")] + [(2, True, "quant4")]


@pytest.mark.parametrize("tp,drop,comm", BLOCK_CASES)
def test_moe_block_seq_matches_reference(tp, drop, comm):
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp)
    rng = np.random.default_rng(tp * 10 + drop)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16)).astype(np.int32)

    def per_shard(p, xx, pp):
        return RB.block_seq(rcfg, rkind, rlayout(4, 4, tp), p, xx, pp,
                            drop=drop, tp=tp,
                            shard_idx=jax.lax.axis_index(MODEL_AXIS),
                            q_chunk=64, comm=comm)[0]

    ref = np.asarray(jax.jit(jax.vmap(
        per_shard, in_axes=(0, None, None), axis_name=MODEL_AXIS))(
        rsplit, jnp.asarray(x), jnp.asarray(pos)))
    out, _, _ = B.block_seq(cfg, kind, make_gqa_layout(4, 4, tp), psplit,
                            torch.from_numpy(x).expand((tp,) + x.shape),
                            torch.from_numpy(pos).long(), drop=drop,
                            q_chunk=64, comm=comm)
    out = out.numpy()
    for t in range(1, tp):
        np.testing.assert_array_equal(out[t], out[0])
    assert_block_close(out, ref, x[None], comm)


@pytest.mark.parametrize("tp,drop,comm", BLOCK_CASES)
def test_moe_block_dec_matches_reference(tp, drop, comm):
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(tp)
    lay = make_gqa_layout(4, 4, tp)
    b, s = 3, 12
    rng = np.random.default_rng(tp * 100 + drop)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([0, 5, 11], np.int32)
    kc = rng.standard_normal((tp, b, s, lay.kv_local, cfg.d_head)) \
        .astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)

    def per_shard(p, xx, pp, cache):
        return RB.block_dec(rcfg, rkind, rlayout(4, 4, tp), p, xx, pp, cache,
                            drop=drop, tp=tp,
                            shard_idx=jax.lax.axis_index(MODEL_AXIS),
                            comm=comm)

    ref, rcache = jax.jit(jax.vmap(per_shard, in_axes=(0, None, None, 0),
                                   axis_name=MODEL_AXIS))(
        rsplit, jnp.asarray(x), jnp.asarray(pos),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)})
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, new = B.block_dec(cfg, kind, lay, psplit,
                           torch.from_numpy(x).expand((tp,) + x.shape),
                           torch.from_numpy(pos).long(), cache, drop=drop,
                           comm=comm)
    for kk in ("k", "v"):
        np.testing.assert_allclose(new[kk].numpy(), np.asarray(rcache[kk]),
                                   atol=2e-5, rtol=0)
    assert_block_close(out.numpy(), np.asarray(ref), x[None], comm)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_training_and_algorithm1_refuse():
    """The MoE family trains and runs Algorithm 1 (its load-balance aux in
    the loss since ROADMAP A3): check_trainable passes (no device
    decides a refusal any more), the comm policy and a zero-shot apply_spd place their plans, and the
    engine serves after each."""
    _, cfg = _cfgs()
    check_trainable(cfg)
    from repro_torch.api import LLM
    llm = LLM.load(cfg, tp=2, device="cpu", cache_len=32)
    from repro_torch.data import calibration_batches
    calib = calibration_batches(cfg.vocab_size, 2, 16, batch=2)
    res = llm.apply_comm_policy(calib, n_spd=1, tau1=-1.0, tau2=1.0)
    assert sorted(res.ranking.tolist()) == list(range(cfg.n_layers))
    rep = llm.apply_spd(calib, n_spd=1, tau1=1e9, tau2=2e9)
    assert rep.categories == ["ISB"] and llm.plan.n_dropped == 1
    assert llm.engine is not None
    assert len(llm.generate([[1, 2, 3]])[0].token_ids) > 0
