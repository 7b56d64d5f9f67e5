"""PyTorch port vs JAX reference: int8 KV caches and weight-only int8.

`kv_quantize` and `quantize_leaf` give the reference's codes and scales
bit for bit (round half to even, true division by 127).  On
llama2-7b-reduced and hymba-1.5b-reduced at tp 2 (spd=0.25, fp32, the
reference's perturbed parameters carried over), teacher-forced logits
with kv_dtype="int8" -- dense caches, hymba's rolling window past its
32-token window, chunked prefill -- and with weight_dtype="int8" are
within 1e-4 of the reference's (exact syncs), or, where an int8 KV code
sat on a rounding boundary and rounded the other way, within 5e-3 with
at most 1% of the codes one off (see FLIP_FRACTION).
Self-speculation on an int8 KV cache gives plain greedy's tokens, dense
and paged.  Weight-only
int8 on MLA and hybrid layers fails in the reference itself (ROADMAP C8):
the port refuses it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import blocks as RB  # noqa: E402
from repro.core import simtp as RS  # noqa: E402
from repro.models import attention as RA  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from torch_parity import (model_pair, one_torch_thread,  # noqa: E402,F401
                          teacher_forced_logits)

LLAMA, HYMBA = "llama2-7b-reduced", "hymba-1.5b-reduced"
TP, CACHE_LEN = 2, 64
# fp32 through every block and the head; XLA and torch sum in other
# orders
LOGIT_ATOL = 1e-4
# ...so an int8 KV code whose x / s sits at a rounding boundary can round
# the other way, as a quantized sync's can: that K or V entry moves by one
# step (absmax / 127), the layers after see inputs ~1e-4 apart, and a few
# more codes flip there.  Where the codes differ, each may differ by one
# and at most FLIP_FRACTION of them may; a bf16 scale by one bf16 ulp
# (its fp32 absmax moved); the logits (|logit| ~ 4) by FLIP_LOGIT_ATOL
FLIP_FRACTION = 1e-2
FLIP_LOGIT_ATOL = 5e-3


def _assert_int8_close(pl, rl, pc, rc):
    """Logits within LOGIT_ATOL while every code and scale equals the
    reference's; else the flip bounds above."""
    flips = total = 0
    for seg, rseg in zip(pc, rc):
        for name in ("k", "v"):
            got = seg[name].numpy().astype(np.int32)
            want = np.asarray(rseg[name]).astype(np.int32)
            assert got.shape == want.shape, (name, got.shape, want.shape)
            d = np.abs(got - want)
            assert d.max() <= 1, (name, d.max())
            flips += int((d > 0).sum())
            total += d.size
            sc = seg[name + "_s"].float().numpy()
            rsc = np.asarray(rseg[name + "_s"]).astype(np.float32)
            flips += int((sc != rsc).sum())
            np.testing.assert_allclose(sc, rsc, rtol=2.0 ** -7, atol=0)
    assert flips <= FLIP_FRACTION * total, (flips, total)
    np.testing.assert_allclose(pl, rl, rtol=0, atol=(
        LOGIT_ATOL if flips == 0 else FLIP_LOGIT_ATOL))


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _with_ties(rng, shape, dtype):
    """Random rows whose absmax is 127 and whose other entries include
    exact halves (x / s = k + 0.5: round half to even decides them), and
    one all-zero row (the 1e-12 floor)."""
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[..., 0] = 127.0
    x[..., 1] = 2.5
    x[..., 2] = -0.5
    x[0] = 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_equal(dtype):
    x = _with_ties(np.random.default_rng(0), (3, 5, 2, 16), np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = A.kv_quantize(xt)
    rq, rs = RA.kv_quantize(jnp.asarray(x).astype(dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(rs).astype(np.float32))
    d = A.kv_dequantize(q, s, xt.dtype)
    rd = RA.kv_dequantize(rq, rs, jnp.dtype(dtype))
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(rd).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_leaf_bit_equal(dtype):
    w = _with_ties(np.random.default_rng(1), (48, 40), np.float32).T.copy()
    got = B.quantize_leaf(torch.from_numpy(w).to(getattr(torch, dtype)))
    ref = RB.quantize_leaf(jnp.asarray(w).astype(dtype))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got["s"].float().numpy(),
                                  np.asarray(ref["s"]).astype(np.float32))


@pytest.fixture(scope="module")
def int8_pair():
    return model_pair(LLAMA, cfg_kw=dict(kv_dtype="int8",
                                         weight_dtype="int8"),
                      cache_len=CACHE_LEN)


def test_placed_int8_weights_match_reference(int8_pair):
    """The placed attention and MLP leaves are {"q" int8, "s" bf16}, split
    as the reference splits them (scales with the output columns)."""
    ref, port = int8_pair
    rsplit = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    for seg, rseg in zip(port.params["segs"], rsplit["segs"]):
        for grp, names in B.QUANT_LEAVES.items():
            for nm in names:
                if nm not in seg.get(grp, {}):
                    continue
                for part in ("q", "s"):
                    got = seg[grp][nm][part]
                    want = np.asarray(rseg[grp][nm][part]).astype(
                        np.float32)
                    assert got.dtype == (torch.int8 if part == "q"
                                         else torch.bfloat16)
                    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("which", ["kv", "kv+weights"])
def test_int8_decode_logits_match_reference(which, int8_pair):
    """12-token prompt (a 16-token bucket) and 6 decode steps on an int8
    KV cache, with and without int8 weights."""
    if which == "kv":
        ref, port = model_pair(LLAMA, cfg_kw=dict(kv_dtype="int8"),
                               cache_len=CACHE_LEN)
    else:
        ref, port = int8_pair
    prompt, stream = _prompt(12), _prompt(6, 1)
    rl, rc = teacher_forced_logits(ref, prompt, stream, CACHE_LEN)
    pl, pc = teacher_forced_logits(port, prompt, stream, CACHE_LEN)
    assert pl.shape == (6, 512)
    _assert_int8_close(pl, rl, pc, rc)


def test_int8_rolling_window_logits_match_reference():
    """hymba-reduced (window 32) on an int8 KV cache: a 64-token prompt
    (its own bucket: no pad reaches the SSM state, ROADMAP C3) leaves the
    windowed layers' rolling buffers full; 6 decode steps write codes and
    scales at pos % 32."""
    ref, port = model_pair(HYMBA, cfg_kw=dict(kv_dtype="int8"),
                           cache_len=128, q_chunk=16)
    prompt, stream = _prompt(64, 2), _prompt(6, 3)
    rl, rc = teacher_forced_logits(ref, prompt, stream, 128)
    pl, pc = teacher_forced_logits(port, prompt, stream, 128)
    _assert_int8_close(pl, rl, pc, rc)


def test_int8_chunked_prefill_logits_match_reference(int8_pair):
    """Chunks of 8 over a 21-token prompt write their codes and scales at
    absolute positions and attend over the dequantized buffer."""
    ref, port = int8_pair
    toks = np.zeros((1, 24), np.int32)
    toks[0, :21] = _prompt(21, 4)
    ln = np.asarray([21], np.int32)
    rsplit = RS.prepare_params(ref.canonical, ref.cfg, ref.plan, TP)
    rl, rc = ref.engine.prefill_chunked(rsplit, jnp.asarray(toks),
                                        cache_len=CACHE_LEN, lengths=ln,
                                        chunk=8)
    pl, pc = port.engine.prefill_chunked(port.params, toks.astype(np.int64),
                                         cache_len=CACHE_LEN,
                                         lengths=ln.astype(np.int64), chunk=8)
    _assert_int8_close(pl.numpy(), np.asarray(rl), pc, rc)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_kv_speculation_gives_plain_greedy(paged, int8_pair):
    """SpecConfig(k=3) on the int8 stack (the verify chunk writes codes
    and scales; paged, through the gather -> dense -> scatter fallback)
    gives plain greedy's tokens, and greedy equals the reference's."""
    ref, port = int8_pair
    cache = dict(page_size=8, num_pages=20) if paged else {}
    kw = dict(tp=TP, spd=0.25, device="cpu", cache_len=CACHE_LEN,
              q_chunk=64, params=port.canonical, **cache)
    plain = LLM.load(port.cfg, **kw)
    spec = LLM.load(port.cfg, spec=SpecConfig(k=3), **kw)
    prompts = [_prompt(n, i) for i, n in enumerate((12, 5, 20))]
    want = [o.token_ids for o in plain.generate(prompts,
                                                SamplingParams(max_new=8))]
    got = [o.token_ids for o in spec.generate(prompts,
                                              SamplingParams(max_new=8))]
    assert got == want
    assert spec.serve().spec_tokens_per_step > 1.0
    if paged:
        pool = spec.serve().pool
        assert pool.num_free == pool.num_pages
    else:
        from repro.api import SamplingParams as RSP
        assert want == [o.token_ids for o in ref.generate(prompts,
                                                          RSP(max_new=8))]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b-reduced", HYMBA])
def test_int8_weights_on_mla_and_hybrid_refuse(arch):
    """The reference fails to place (MLA: `mla_specs` has no int8
    leaves) or to run (hybrid: `fused @ a["wo"]`) these: ROADMAP C8."""
    cfg = replace(get_config(arch), dtype="float32", weight_dtype="int8")
    with pytest.raises(NotImplementedError, match="C8"):
        LLM.load(cfg, tp=TP, device="cpu", cache_len=CACHE_LEN)
