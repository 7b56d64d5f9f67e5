"""PyTorch port vs JAX reference: the hybrid model (hymba-1.5b-reduced at
tp 2 with spd=0.25: window 32, global layers 0 and 3; fp32, the
reference's perturbed parameters carried over with
convert.from_reference).

Prefill and decode logits past the window within 1e-4 (exact syncs),
greedy tokens and the comm ledger at quant8, and ROADMAP C3: a hybrid
layer carries SSM state, so the port prefills a prompt at its own
length while the reference pads it to a power-of-two bucket and scans
the pads into the state.  At a bucket length (64, above the window) the
two agree; at another length the port's tokens equal its own
teacher-forced exact-length forward."""
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

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from repro_torch.runtime.forward import (bucketed_prefill,  # noqa: E402
                                         full_logits_seq)
from torch_parity import (one_torch_thread,  # noqa: E402,F401
                          perturbed_canonical)

ARCH = "hymba-1.5b-reduced"
TP, CACHE_LEN = 2, 128
# fp32 through 4 blocks and the head; XLA and torch sum in other orders
LOGIT_ATOL = 1e-4


def _pair(comm):
    rcfg = rreplace(rget(ARCH), dtype="float32")
    cfg = replace(get_config(ARCH), dtype="float32")
    kw = dict(tp=TP, spd=0.25, cache_len=CACHE_LEN, comm=comm,
              comm_logits=comm, q_chunk=16)
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


@pytest.mark.parametrize("n,new", [(64, 6), (16, 24)])
def test_prefill_and_decode_logits_match_reference(pairs, n, new):
    """Bucket lengths, so the reference has no pad tokens: a 64-token
    prompt (its windowed layers' rolling buffers built from the last 32)
    and a 16-token one whose decode crosses the window at position 32."""
    ref, port = pairs["exact"]
    assert port.plan.n_dropped == 1
    prompt = _prompt(n)
    stream = ref.generate([prompt], RSP(max_new=new))[0].token_ids
    rl = _teacher_forced(ref, prompt, stream, rprefill, np.asarray)
    pl = _teacher_forced(port, prompt, stream, bucketed_prefill,
                         lambda t: t.numpy())
    assert pl.shape == (new, 512)
    np.testing.assert_allclose(pl, rl, atol=LOGIT_ATOL, rtol=0)


def _port_greedy_check(port, prompt, toks):
    """The port's own teacher-forced greedy: one forward over prompt +
    generated tokens; its argmax at each position must be the next
    generated token."""
    seq = np.concatenate([prompt, toks[:-1]])[None]
    x, _, _, _ = M.forward_seq(port.cfg, port.params, port.plan,
                            torch.from_numpy(seq).long(), tp=TP, q_chunk=16)
    lg = full_logits_seq(port.cfg, M.lm_logits(port.params, port.cfg, x))
    return [int(t) for t in lg[0, len(prompt) - 1:].argmax(-1)]


@pytest.mark.parametrize("n", [64, 45])
def test_greedy_tokens(pairs, n):
    """quant8, 4 requests decoding past the window: the reference's
    tokens at the bucket length 64, the port's own teacher-forced tokens
    at every length (C3)."""
    ref, port = pairs["quant8"]
    prompts = [_prompt(n, i) for i in range(4)]
    toks = [o.token_ids for o in port.generate(
        prompts, SamplingParams(max_new=12))]
    for p, t in zip(prompts, toks):
        assert _port_greedy_check(port, p, t) == t
    if n == 64:
        assert [o.token_ids for o in ref.generate(
            prompts, RSP(max_new=12))] == toks


def test_prefill_runs_at_the_prompt_length(pairs):
    """No pad rows reach a hybrid model's prefill."""
    _, port = pairs["exact"]
    seen = []
    orig = port.engine.prefill

    def spy(params, tokens, **kw):
        seen.append(np.asarray(tokens).shape)
        return orig(params, tokens, **kw)

    port.engine.prefill = spy
    try:
        port.generate([_prompt(45), _prompt(5)], SamplingParams(max_new=2))
    finally:
        port.engine.prefill = orig
    assert seen == [(1, 45), (1, 5)]


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_comm_ledger_matches_reference(pairs, comm):
    """One prefill (64 tokens) and one decode step log the same entries
    in both packages: two block syncs a kept block, one a dropped one."""
    ref, port = pairs[comm]
    toks = _prompt(64)[None]
    ln = np.asarray([64], np.int32)
    rparams = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    rpre, _ = RF.prefill_step(ref.cfg, ref.plan, tp=TP, q_chunk=16,
                              cache_len=CACHE_LEN)
    rdec, _ = RF.decode_step(ref.cfg, ref.plan, tp=TP)
    with rledger() as rled:
        _, rcaches = jax.vmap(rpre, in_axes=(0, None, None, None),
                              axis_name=MODEL_AXIS)(
            rparams, jnp.asarray(toks), jnp.asarray(ln), None)
        jax.vmap(rdec, in_axes=(0, None, None, 0), axis_name=MODEL_AXIS)(
            rparams, jnp.asarray([[3]], jnp.int32),
            jnp.asarray([64], jnp.int32), rcaches)
    pre, _ = F.prefill_step(port.cfg, port.plan, tp=TP, q_chunk=16,
                            cache_len=CACHE_LEN)
    dec, _ = F.decode_step(port.cfg, port.plan, tp=TP)
    with collective_ledger() as led:
        _, caches = pre(port.params, torch.from_numpy(toks).long(),
                        torch.from_numpy(ln).long())
        dec(port.params, torch.tensor([[3]]), torch.tensor([64]), caches)

    def key(e):
        return (e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)

    assert [key(e) for e in led] == [key(e) for e in rled]
    cfg = port.cfg
    if comm == "exact":
        kept = sum(e.nbytes for e in led
                   if e.overlappable and e.phase == "prefill")
        syncs = 2 * cfg.n_layers - port.plan.n_dropped
        assert kept == syncs * 64 * cfg.d_model * 4
    # the decode caches: rolling K/V of min(window, cache_len) slots on
    # windowed layers, the whole buffer on global ones, state beside
    kv = [seg["k"].shape[3] for seg in caches]
    wins = [kind.window or CACHE_LEN for (_, _, kind, _) in
            M.plan_segments(cfg, port.plan.drop_mask, port.plan.qmodes)]
    assert kv == wins and all("state" in seg for seg in caches)


def test_overlap_engine_serves_hymba(pairs):
    """The overlap backend gives the sim backend's tokens."""
    _, port = pairs["quant8"]
    over = LLM.load(port.cfg, tp=TP, spd=0.25, device="cpu",
                    cache_len=CACHE_LEN, comm="quant8", engine="overlap",
                    q_chunk=16, params=port.canonical)
    prompts = [_prompt(40, 1), _prompt(9, 2)]
    assert [o.token_ids for o in over.generate(prompts)] == \
        [o.token_ids for o in port.generate(prompts)]
