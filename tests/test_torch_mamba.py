"""PyTorch port vs JAX reference: the pure-SSM Mamba2 model
(mamba2-370m-reduced, tp=2, fp32, the reference's parameters carried
over with convert.from_reference).

Covers the SSM block (prefill and decode, exact and quant8), prefill and
decode logits, the comm ledger (one kept sync per block), the untied LM
head, the facade's refusals, and ROADMAP C3: the reference right-pads an
SSM prompt to a power-of-two bucket and scans the pad tokens into the
recurrent state, so its `generate` is right only at bucket lengths; the
port prefills at the prompt's own length.  So the port's greedy tokens
equal the reference's `generate` at bucket lengths (16, 32), equal the
reference's teacher-forced greedy at the others (17, 23), and equal the
port's own teacher-forced greedy at every length."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import blocks as RB, simtp as RS  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.parallel.collectives import (MODEL_AXIS,  # noqa: E402
                                        collective_ledger as rledger)
from repro.runtime import forward as RF  # noqa: E402
from repro.runtime.forward import bucketed_prefill as rprefill  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B, model as M  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from repro_torch.runtime.forward import (bucketed_prefill,  # noqa: E402
                                         full_logits_seq)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "mamba2-370m-reduced"
TP, CACHE_LEN, MAX_NEW = 2, 64, 6
# fp32 through 4 blocks and the head; XLA and torch sum in other orders
LOGIT_ATOL = 1e-4
# one block: ~1e-6 on O(1) activations; a quantized sync may flip a code
# (one quant step, see test_torch_blocks), which none of these inputs does
BLOCK_ATOL = 2e-5


def _cfgs():
    return (rreplace(rget(ARCH), dtype="float32"),
            replace(get_config(ARCH), dtype="float32"))


def _pair(comm):
    rcfg, cfg = _cfgs()
    kw = dict(tp=TP, cache_len=CACHE_LEN, comm=comm, comm_logits=comm)
    ref = RLLM.load(rcfg, **kw)
    port = LLM.load(cfg, device="cpu", params=from_reference(
        jax.tree.map(np.asarray, ref.canonical), cfg), **kw)
    return ref, port


@pytest.fixture(scope="module")
def exact_pair():
    return _pair("exact")


@pytest.fixture(scope="module")
def quant8_pair():
    return _pair("quant8")


def _prompt(n):
    return np.random.default_rng(0).integers(0, 512, n).astype(np.int32)


# ---------------------------------------------------------------------------
# The SSM block
# ---------------------------------------------------------------------------

def _layer(seed):
    rcfg, cfg = _cfgs()
    rkind = rkinds(rcfg)[0]
    lp = RB.init_layer(jax.random.PRNGKey(seed), rcfg, rkind)
    # perturb the ones-initialised norms, skip and gate weights
    lp = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
        jax.random.PRNGKey(7), x.shape, jnp.float32), lp)
    rsplit = RS.split_layer(lp, rcfg, rkind, TP)
    psplit = tree_map(lambda a: torch.from_numpy(np.array(a)),
                      jax.tree.map(np.asarray, rsplit))
    return rcfg, cfg, rkind, layer_kinds(cfg)[0], rsplit, psplit


def _np_tree(t):
    return tree_map(lambda a: a.numpy(), t)


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_ssm_block_seq_matches_reference(comm):
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(0)
    rng = np.random.default_rng(1)
    s = 24                                   # not a multiple of the chunk
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)

    def per_shard(p, xx, pp):
        out, _, cache = RB.block_seq(
            rcfg, rkind, None, p, xx, pp, drop=False, tp=TP,
            shard_idx=jax.lax.axis_index(MODEL_AXIS), want_cache=True,
            comm=comm)
        return out, cache

    ref, rcache = jax.vmap(per_shard, in_axes=(0, None, None),
                           axis_name=MODEL_AXIS)(rsplit, jnp.asarray(x),
                                                 jnp.asarray(pos))
    out, cache, _ = B.block_seq(cfg, kind, None, psplit,
                                torch.from_numpy(x).expand((TP,) + x.shape),
                                torch.from_numpy(pos).long(), drop=False,
                                want_cache=True, comm=comm)
    for t in range(1, TP):
        np.testing.assert_array_equal(out[t].numpy(), out[0].numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BLOCK_ATOL,
                               rtol=0)
    rflat, pflat = jax.tree.leaves(rcache), jax.tree.leaves(_np_tree(cache))
    assert len(rflat) == len(pflat) == 3            # conv bc, conv x, state
    for r, p in zip(rflat, pflat):
        np.testing.assert_allclose(p, np.asarray(r), atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_ssm_block_dec_matches_reference(comm):
    rcfg, cfg, rkind, kind, rsplit, psplit = _layer(1)
    s_cfg = cfg.ssm
    hl = B.ssm_heads(cfg) // TP
    b = 3
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray([0, 5, 11], np.int32)
    cache = {
        "state": rng.standard_normal((TP, b, hl, s_cfg.head_dim,
                                      s_cfg.d_state)).astype(np.float32),
        "conv": {"x": rng.standard_normal(
            (TP, b, s_cfg.d_conv - 1, hl * s_cfg.head_dim)).astype(np.float32),
            "bc": np.repeat(rng.standard_normal(
                (1, b, s_cfg.d_conv - 1, 2 * s_cfg.d_state)), TP, 0).astype(
                    np.float32)}}

    def per_shard(p, xx, pp, c):
        return RB.block_dec(rcfg, rkind, None, p, xx, pp, c, drop=False,
                            tp=TP, shard_idx=jax.lax.axis_index(MODEL_AXIS),
                            comm=comm)

    ref, rcache = jax.vmap(per_shard, in_axes=(0, None, None, 0),
                           axis_name=MODEL_AXIS)(
        rsplit, jnp.asarray(x), jnp.asarray(pos),
        jax.tree.map(jnp.asarray, cache))
    pcache = tree_map(lambda a: torch.from_numpy(a.copy()), cache)
    held = pcache["state"]
    out, new = B.block_dec(cfg, kind, None, psplit,
                           torch.from_numpy(x).expand((TP,) + x.shape),
                           torch.from_numpy(pos).long(), pcache, drop=False,
                           comm=comm)
    assert new["state"] is held                     # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BLOCK_ATOL,
                               rtol=0)
    for r, p in zip(jax.tree.leaves(rcache), jax.tree.leaves(_np_tree(new))):
        np.testing.assert_allclose(p, np.asarray(r), atol=BLOCK_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("pair", ["exact_pair", "quant8_pair"])
def test_prefill_and_decode_logits_match_reference(request, pair):
    """At a bucket length (16) the reference's prefill has no pad tokens,
    so its serving path is right and the two must agree step by step."""
    ref, port = request.getfixturevalue(pair)
    prompt = _prompt(16)
    stream = ref.generate([prompt], RSP(max_new=MAX_NEW))[0].token_ids
    rl = _teacher_forced(ref, prompt, stream, rprefill, np.asarray)
    pl = _teacher_forced(port, prompt, stream, bucketed_prefill,
                         lambda t: t.numpy())
    assert pl.shape == (MAX_NEW, 512)
    np.testing.assert_allclose(pl, rl, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_comm_ledger_has_one_sync_per_block(exact_pair, quant8_pair, comm):
    """One prefill (16 tokens) and one decode step log the same entries
    in both packages, and the kept block syncs carry one (16, d) payload
    per block: a pure-SSM block has a single sync point."""
    ref, port = exact_pair if comm == "exact" else quant8_pair
    toks = _prompt(16)[None]
    ln = np.asarray([16], np.int32)
    # the reference logs at trace time: trace its steps afresh under vmap
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
    cfg = port.cfg
    if comm == "exact":
        kept = sum(e.nbytes for e in led
                   if e.overlappable and e.phase == "prefill")
        assert kept == cfg.n_layers * 16 * cfg.d_model * 4
    else:
        pairs = [e for e in led if e.overlappable and e.phase == "prefill"]
        assert [e.op for e in pairs] == ["reduce-scatter", "all-gather"]


def test_untied_head_is_its_own_vocab_parallel_leaf(exact_pair):
    _, port = exact_pair
    cfg = port.cfg
    head = port.params["head"]
    assert not cfg.tie_embeddings
    assert tuple(head.shape) == (TP, cfg.d_model, cfg.vocab_size // TP)
    x = torch.randn(TP, 1, 2, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    x = x[:1].expand_as(x)
    lg = M.lm_logits(port.params, cfg, x)
    full = lg.permute(1, 2, 0, 3).reshape(1, 2, -1)
    canon = port.canonical["head"]
    torch.testing.assert_close(full, x[0] @ canon, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# C3: prefill at the prompt's own length
# ---------------------------------------------------------------------------

def _port_greedy_check(port, prompt, toks):
    """The port's own teacher-forced greedy: one forward over prompt +
    generated tokens; its argmax at each position must be the next
    generated token."""
    seq = np.concatenate([prompt, toks[:-1]])[None]
    x, _, _, _ = M.forward_seq(port.cfg, port.params, port.plan,
                            torch.from_numpy(seq).long(), tp=TP)
    lg = full_logits_seq(port.cfg, M.lm_logits(port.params, port.cfg, x))
    return [int(t) for t in lg[0, len(prompt) - 1:].argmax(-1)]


def _ref_greedy_check(ref, prompt, toks):
    fn = RS.make_logits_fn(ref.cfg, ref.plan, TP)
    sp = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    seq = np.concatenate([prompt, toks[:-1]]).astype(np.int32)[None]
    lg = np.asarray(fn(sp, jnp.asarray(seq)))
    return [int(t) for t in lg[0, len(prompt) - 1:].argmax(-1)]


@pytest.mark.parametrize("n", [16, 17, 23, 32])
def test_c3_greedy_tokens(exact_pair, n):
    ref, port = exact_pair
    prompt = _prompt(n)
    toks = port.generate([prompt], SamplingParams(max_new=MAX_NEW))[0] \
        .token_ids
    assert _port_greedy_check(port, prompt, toks) == toks
    if n in (16, 32):       # no pad tokens: the reference's serving is right
        assert ref.generate([prompt], RSP(max_new=MAX_NEW))[0].token_ids \
            == toks
    else:
        assert _ref_greedy_check(ref, prompt, toks) == toks


def test_c3_prefill_runs_at_the_prompt_length(exact_pair):
    """The prefill sees exactly the prompt: no pad rows reach the model."""
    _, port = exact_pair
    seen = []
    orig = port.engine.prefill

    def spy(params, tokens, **kw):
        seen.append(np.asarray(tokens).shape)
        return orig(params, tokens, **kw)

    port.engine.prefill = spy
    try:
        port.generate([_prompt(17), _prompt(5)], SamplingParams(max_new=2))
    finally:
        port.engine.prefill = orig
    assert seen == [(1, 17), (1, 5)]


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------

def test_facade_serves_mamba_and_refuses_paging():
    cfg = replace(get_config(ARCH), dtype="float32")
    llm = LLM.load(cfg, tp=TP, spd=0.25, device="cpu", cache_len=32)
    assert llm.plan.n_dropped == 0                # SPD does not apply
    # paged serving goes through the fallback, which pages nothing here
    # (an SSM layer's state and conv tails have no sequence axis): the
    # pool only meters admission, and the tokens are dense serving's
    paged = LLM.load(cfg, tp=TP, device="cpu", cache_len=32, page_size=8,
                     num_pages=8, params=llm.canonical)
    assert not any(tree_leaves(M.cache_pageable_tree(cfg, llm.plan)))
    prompts = [_prompt(9), _prompt(3)]
    assert [o.token_ids for o in paged.generate(prompts)] == \
        [o.token_ids for o in llm.generate(prompts)]
    assert paged.serve().pool.num_free == 8
    # the overlap engine serves it unchanged: the same tokens as sim
    over = LLM.load(cfg, tp=TP, device="cpu", cache_len=32, comm="quant8",
                    engine="overlap", params=llm.canonical)
    sim = LLM.load(cfg, tp=TP, device="cpu", cache_len=32, comm="quant8",
                   params=llm.canonical)
    prompts = [_prompt(9), _prompt(3)]
    assert [o.token_ids for o in over.generate(prompts)] == \
        [o.token_ids for o in sim.generate(prompts)]
