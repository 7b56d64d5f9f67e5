"""PyTorch port vs JAX reference, whole model: on the golden serving
setup (reduced SmolLM, tp=2, spd=0.25, fp32, cache_len=48, the 4 golden
prompts) the port's prefill and decode logits, teacher-forced along the
reference's own greedy token streams, agree within LOGIT_ATOL, and the
greedy `generate` tokens are equal.  The reference runs live: the golden
file is stale under this JAX (ROADMAP C1).  Run at attn_backend="xla"
(the port's plain attention) and "pallas" (the reference's Pallas kernel
in interpret mode against the port's flash wrapper, whose CPU path is
its plain version)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.runtime.forward import bucketed_prefill as rprefill  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.runtime.forward import bucketed_prefill  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "results", "golden",
                      "smollm-360m-reduced_greedy.json")
# fp32 end to end through 4 blocks + the tied head; summation orders of
# XLA and torch differ, everything else is the same arithmetic
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _load_both(golden, backend):
    kw = dict(tp=golden["tp"], spd=golden["spd"],
              cache_len=golden["cache_len"])
    rcfg = rreplace(rget(golden["arch"]), dtype=golden["dtype"],
                    attn_backend=backend)
    ref = RLLM.load(rcfg, seed=golden["seed"], **kw)
    cfg = replace(get_config(golden["arch"]), dtype=golden["dtype"],
                  attn_backend=backend)
    port = LLM.load(cfg, device="cpu", params=from_reference(
        jax.tree.map(np.asarray, ref.canonical), cfg), **kw)
    return ref, port


def _teacher_forced(llm, prompt, stream, cache_len, prefill_fn, to_np):
    """Full-vocab logits of the prefill and of every decode step, feeding
    `stream` (batch 1) whatever the model would have picked."""
    eng = llm.engine
    caches = eng.blank_caches(1, cache_len)
    lg, caches1 = prefill_fn(eng, llm.params, prompt, len(prompt), cache_len)
    caches = eng.insert_slot(caches, caches1, 0)
    out = [to_np(lg)[0]]
    for i, tok in enumerate(stream[:-1]):
        _, lg, caches = eng.decode_with_logits(
            llm.params, np.asarray([[tok]]), np.asarray([len(prompt) + i]),
            caches)
        out.append(to_np(lg)[0])
    return np.stack(out)


def _check_streams(ref_toks, port_toks, ref_logits):
    """Equal tokens; a divergence is only excused where the reference's
    own top-2 margin at that step is under the logit tolerance."""
    for r, p, lg in zip(ref_toks, port_toks, ref_logits):
        for step, (a, b) in enumerate(zip(r, p)):
            if a != b:
                top2 = np.sort(lg[step])[-2:]
                assert top2[1] - top2[0] < LOGIT_ATOL, (step, a, b, top2)
                break
        else:
            assert len(r) == len(p)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_logits_and_tokens_match_reference(golden, backend):
    ref, port = _load_both(golden, backend)
    prompts = [np.asarray(p, np.int32) for p in golden["prompts"]]
    max_new = golden["max_new"]
    ref_toks = [o.token_ids for o in ref.generate(prompts, RSP(max_new=max_new))]
    port_toks = [o.token_ids
                 for o in port.generate(prompts, SamplingParams(max_new=max_new))]
    ref_logits = []
    for prompt, stream in zip(prompts, ref_toks):
        rl = _teacher_forced(ref, prompt, stream, golden["cache_len"],
                             rprefill, np.asarray)
        pl = _teacher_forced(port, prompt, stream, golden["cache_len"],
                             bucketed_prefill, lambda t: t.numpy())
        assert rl.shape == pl.shape == (max_new, ref.cfg.vocab_size)
        np.testing.assert_allclose(pl, rl, atol=LOGIT_ATOL, rtol=0)
        ref_logits.append(rl)
    _check_streams(ref_toks, port_toks, ref_logits)


def test_quantized_policy_logits_match_reference(golden):
    """Prefill logits under uniform quant8 kept syncs and a quant8 logits
    gather.  A code flip (see test_torch_blocks) moves a logit by at most
    a few quant steps; on these prompts none occurs, so the tolerance is
    the exact one."""
    kw = dict(tp=2, spd=0.25, cache_len=48, comm="quant8",
              comm_logits="quant8")
    ref = RLLM.load(rreplace(rget(golden["arch"]), dtype="float32"), **kw)
    cfg = replace(get_config(golden["arch"]), dtype="float32")
    port = LLM.load(cfg, device="cpu", params=from_reference(
        jax.tree.map(np.asarray, ref.canonical), cfg), **kw)
    for p in golden["prompts"]:
        p = np.asarray(p, np.int32)
        rl, _ = rprefill(ref.engine, ref.params, p, len(p), 48)
        pl, _ = bucketed_prefill(port.engine, port.params, p, len(p), 48)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl),
                                   atol=LOGIT_ATOL, rtol=0)
