"""PyTorch port vs JAX reference: the MLA model (deepseek-v2-lite-16b-reduced
at tp 2 with spd=0.25: a dense first layer, then MoE layers; fp32, the
reference's perturbed parameters carried over with
convert.from_reference).

Prefill and absorbed-decode logits within 1e-4 (exact syncs), greedy
tokens (dense, and paged through the gather -> dense -> scatter
fallback with a preemption) and the comm ledger entry for entry, at
exact and quant8.  Chunked prefill falls back to whole and self-speculation
refuses, as the reference's do."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import SamplingParams as RSP  # noqa: E402
from repro.core import simtp as RS  # noqa: E402
from repro.parallel.collectives import (MODEL_AXIS,  # noqa: E402
                                        collective_ledger as rledger)
from repro.runtime import forward as RF  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.core import model as M  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from repro_torch.spec import SpecConfig, SpecError  # noqa: E402
from torch_parity import (model_pair, one_torch_thread,  # noqa: E402,F401
                          teacher_forced_logits)

ARCH = "deepseek-v2-lite-16b-reduced"
TP, CACHE_LEN, MAX_NEW = 2, 64, 6
# fp32 through 3 blocks and the head; XLA and torch sum in other orders
LOGIT_ATOL = 1e-4


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


@pytest.fixture(scope="module")
def pairs():
    return {c: model_pair(ARCH, comm=c, cache_len=CACHE_LEN)
            for c in ("exact", "quant8")}


def test_prefill_and_decode_logits_match_reference(pairs):
    """A 12-token prompt in a 16-token bucket (its pads route in both
    packages alike) and 6 absorbed decode steps."""
    ref, port = pairs["exact"]
    assert port.plan.n_dropped == 1
    assert [k.mixer for k in M.layer_kinds(port.cfg)] == ["mla"] * 3
    prompt, stream = _prompt(12), _prompt(MAX_NEW, 1)
    rl, rc = teacher_forced_logits(ref, prompt, stream, CACHE_LEN)
    pl, pc = teacher_forced_logits(port, prompt, stream, CACHE_LEN)
    assert pl.shape == (MAX_NEW, 512)
    np.testing.assert_allclose(pl, rl, atol=LOGIT_ATOL, rtol=0)
    for seg, rseg in zip(pc, rc):              # the latent caches
        for name in ("c", "kr"):
            np.testing.assert_allclose(seg[name].numpy(),
                                       np.asarray(rseg[name]), atol=1e-5,
                                       rtol=0)


PROMPT_LENS = (12, 5, 20, 9)


@pytest.fixture(scope="module")
def ref_tokens(pairs):
    """The reference's greedy tokens (quant8, dense caches)."""
    ref, _ = pairs["quant8"]
    prompts = [_prompt(n, i) for i, n in enumerate(PROMPT_LENS)]
    return [o.token_ids for o in ref.generate(prompts, RSP(max_new=8))]


@pytest.mark.parametrize("cache", [{}, {"page_size": 8, "num_pages": 10}],
                         ids=["dense", "paged"])
def test_greedy_tokens_match_reference(pairs, ref_tokens, cache):
    """generate over 4 requests: the reference's tokens.  Paged: a
    10-page pool the requests outgrow, so both packages preempt the same
    request at the same step (MoE routing counts every row of a step,
    ROADMAP C7, so the tokens are held to the reference's paged run);
    every page comes back."""
    ref, port = pairs["quant8"]
    want = ref_tokens
    prompts = [_prompt(n, i) for i, n in enumerate(PROMPT_LENS)]
    if cache:
        ref, port = model_pair(ARCH, comm="quant8", cache_len=CACHE_LEN,
                               **cache)
        want = [o.token_ids for o in ref.generate(prompts, RSP(max_new=8))]
    assert [o.token_ids for o in port.generate(
        prompts, SamplingParams(max_new=8))] == want
    if "page_size" in cache:
        sched, rsched = port.serve(), ref.serve()
        assert sched.n_preemptions == rsched.n_preemptions > 0
        assert sched.pool.num_free == sched.pool.num_pages
        assert not sched.kv.prefix_cache


def test_chunked_prefill_falls_back_to_whole(pairs):
    """MLA has no cache-extension forward: a chunked prefill asked for
    prefills whole at the prompt's own length (no bucket pads route), as
    the reference's engine does."""
    _, port = pairs["quant8"]
    toks = _prompt(21, 4)[None].astype(np.int64)
    ln = np.asarray([21])
    lc, cc = port.engine.prefill_chunked(port.params, toks,
                                         cache_len=CACHE_LEN, lengths=ln,
                                         chunk=8)
    lw, cw = port.engine.prefill(port.params, toks, cache_len=CACHE_LEN,
                                 lengths=ln)
    torch.testing.assert_close(lc, lw, rtol=0, atol=0)
    torch.testing.assert_close(cc[1]["c"], cw[1]["c"], rtol=0, atol=0)


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_comm_ledger_matches_reference(pairs, comm):
    """One prefill and one decode step log the same entries in both
    packages: a kept block two block syncs, the dropped block one, the
    MoE combine none of its own."""
    ref, port = pairs[comm]
    toks = _prompt(16)[None]
    ln = np.asarray([16], np.int32)
    rparams = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    rpre, _ = RF.prefill_step(ref.cfg, ref.plan, tp=TP, q_chunk=64,
                              cache_len=CACHE_LEN)
    rdec, _ = RF.decode_step(ref.cfg, ref.plan, tp=TP)
    with rledger() as rled:                # logged as the steps trace
        _, rcaches = jax.eval_shape(jax.vmap(
            rpre, in_axes=(0, None, None, None), axis_name=MODEL_AXIS),
            rparams, jnp.asarray(toks), jnp.asarray(ln), None)
        jax.eval_shape(jax.vmap(rdec, in_axes=(0, None, None, 0),
                                axis_name=MODEL_AXIS),
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


def test_speculation_refuses(pairs):
    """MLA has no cache-extension forward (the reference's neither):
    self-speculation raises SpecError naming the covered stacks."""
    _, port = pairs["exact"]
    assert not M.supports_chunked_prefill(port.cfg)
    with pytest.raises(SpecError, match="full-causal GQA"):
        LLM.load(port.cfg, tp=TP, device="cpu", cache_len=CACHE_LEN,
                 params=port.canonical, spec=SpecConfig(k=3))
