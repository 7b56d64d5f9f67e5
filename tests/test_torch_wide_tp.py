"""Quantized kept syncs past 8 shards (ROADMAP C17), on the CPU.

The fused kept sync (`quantized_psum_absmax`) and the shard sync's send
and receive (`quantize_message_absmax`, `reduce_messages_absmax`) take
any number of shards: their kernels stream the rows in groups of
`qpsum_group(tp)` and add them one at a time in row order, which is the
plain versions' order.  Here, at the widths the production meshes use:

(a) the plain fused sync and the plain send -> receive at tp 9, 12 and
    16, L 127 and 7, fp32 and bf16 payloads with a ragged n, against the
    reference's oracle chain (`repro.kernels.ref`: qdq or quantize per
    shard, the shards added in order from 0, qdq, one cast; run eagerly,
    so no multiply-add is contracted) and against the reference's
    `quantized_psum` under `jax.vmap` with tp named shards, with its
    ledger entries.  Equal values: +0 and -0 are one value, as in
    test_torch_qpsum.py (the reference's straight-through x + (y - x)
    may turn a -0 into +0).
(b) Reduced SmolLM-360M served at tp 16 with quant8 kept syncs and
    logits gather, against the reference's `LLM.load` at tp 16 on the
    same parameters: greedy tokens equal; the prefill's and one decode
    step's logits within 1e-4 and the comm ledger of each step equal.
(c) The same at quant4, on one prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.parallel import compression as RC
from repro.parallel.collectives import MODEL_AXIS
from repro.parallel.collectives import collective_ledger as rledger
from repro.runtime.forward import bucketed_prefill as r_prefill

from repro_torch.kernels import quant_collectives as QC
from repro_torch.parallel import compression as C
from repro_torch.parallel.collectives import collective_ledger
from repro_torch.runtime.forward import bucketed_prefill
from torch_parity import ledger_tuples, model_pair
from torch_parity import one_torch_thread  # noqa: F401

TPS = (9, 12, 16)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
N = 1001                         # ragged: 7 full chunks and 105, n % 4 != 0
LOGITS_ATOL = 1e-4
PROMPTS = ([5, 9, 17, 3, 11, 2, 8], [301, 42, 7, 5, 9])


def _partials(tp, n, seed, dtype):
    """(tp, n) partials at scales a decade apart, exact zeros of both
    signs and an all-zero chunk (the 1e-12 floor)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tp, n)) * np.logspace(0, 1, tp)[:, None]
    x = x.astype(np.float32)
    x[:, 3] = 0.0
    x[0, 5] = x[1, 5] = -0.0
    x[:, 128:256] = -0.0
    return torch.from_numpy(x).to(dtype)


def _oracle_fused(xs, levels):
    acc = jnp.zeros(xs.shape[1], jnp.float32)
    for r in range(xs.shape[0]):
        acc = acc + R.qdq_absmax_ref(xs[r], levels=levels)
    return R.qdq_absmax_ref(acc, levels=levels)


def _oracle_send_receive(xs, levels):
    acc = jnp.zeros(xs.shape[1], jnp.float32)
    for r in range(xs.shape[0]):
        q, s = R.quantize_absmax_ref(xs[r], levels=levels)
        acc = R.dequant_accum_ref(q, s, acc)
    return R.qdq_absmax_ref(acc, levels=levels)


# ---------------------------------------------------------------------------
# (a) the plain syncs at tp 9, 12, 16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tp", TPS)
def test_wide_syncs_equal_the_reference(tp, dtype):
    for levels, bits in ((127, 8), (7, 4)):
        x = _partials(tp, N, seed=tp * 10 + bits, dtype=DTYPES[dtype])
        xs = jnp.asarray(x.float().numpy()).astype(dtype)
        fused = QC.quantized_psum_absmax_plain(x, levels=levels)
        assert fused.shape == x.shape and fused.dtype == x.dtype
        oracle = np.asarray(_oracle_fused(xs, levels).astype(dtype)
                            .astype(jnp.float32))
        np.testing.assert_array_equal(
            fused.float().numpy(), np.broadcast_to(oracle, (tp, N)))

        msg = QC.quantize_message_absmax_plain(x, levels=levels)
        got = QC.reduce_messages_absmax_plain(msg, N, levels=levels,
                                              dtype=x.dtype)
        assert got.shape == (1, N) and got.dtype == x.dtype
        np.testing.assert_array_equal(
            got.float().numpy()[0],
            np.asarray(_oracle_send_receive(xs, levels).astype(dtype)
                       .astype(jnp.float32)))
        # the two transports give the same bits, zero signs included
        np.testing.assert_array_equal(
            got.view(torch.int16 if dtype == "bfloat16" else torch.int32),
            fused[:1].view(torch.int16 if dtype == "bfloat16"
                           else torch.int32))

        with rledger() as rled:
            ref = jax.vmap(lambda a: RC.quantized_psum(
                a, MODEL_AXIS, bits=bits, kernel=False),
                axis_name=MODEL_AXIS)(xs.reshape(tp, 1, N))
        with collective_ledger() as led:
            port = C.quantized_psum(x.reshape(tp, 1, N), MODEL_AXIS,
                                    bits=bits)
        np.testing.assert_array_equal(port.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
        assert ledger_tuples(led) == ledger_tuples(rled)


# ---------------------------------------------------------------------------
# (b), (c) a model at tp 16
# ---------------------------------------------------------------------------


def _steps(llm, prompt, tok, torch_side):
    """(prefill logits, one decode step's logits with `tok` forced in,
    the ledger of each) through either package's engine, batch 1.  The
    reference logs a step as it traces it: its first call of a shape."""
    eng = llm.engine
    led = collective_ledger if torch_side else rledger
    to_np = (lambda t: t.numpy()) if torch_side else np.asarray
    with led() as pre_led:
        lg, c1 = (bucketed_prefill if torch_side else r_prefill)(
            eng, llm.params, np.asarray(prompt), len(prompt), 64)
    caches = eng.insert_slot(eng.blank_caches(1, 64), c1, 0)
    with led() as dec_led:
        _, lg2, _ = eng.decode_with_logits(
            llm.params, np.asarray([[tok]]), np.asarray([len(prompt)]),
            caches)
    return (to_np(lg)[0], to_np(lg2)[0], ledger_tuples(pre_led),
            ledger_tuples(dec_led))


@pytest.mark.parametrize("comm", ["quant8", "quant4"])
def test_tp16_quantized_model_equals_the_reference(comm):
    """quant8: two prompts' prefill and decode-step logits, the first's
    ledgers (a traced forward of each step), greedy tokens; quant4: one
    prefill's logits and ledger."""
    ref, port = model_pair("smollm-360m-reduced", comm=comm, tp=16,
                           cache_len=64, max_batch=2)
    assert port.engine.backend.tp == 16
    prompts = PROMPTS if comm == "quant8" else PROMPTS[:1]
    for i, p in enumerate(prompts):
        want = _steps(ref, p, 7, False)
        got = _steps(port, p, 7, True)
        steps = 2 if comm == "quant8" else 1
        for k in range(steps):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=LOGITS_ATOL)
        if i == 0:
            for k in range(2, 2 + steps):
                assert got[k] == want[k]
                assert ("reduce-scatter", "model") in {e[:2] for e in got[k]}
    if comm != "quant8":
        return
    from repro.api import SamplingParams as RSP
    from repro_torch.api import SamplingParams
    want = [o.token_ids for o in ref.generate(
        [list(p) for p in PROMPTS], RSP(max_new=6))]
    got = [o.token_ids for o in port.generate(
        [list(p) for p in PROMPTS], SamplingParams(max_new=6))]
    assert got == want
