"""PyTorch port vs JAX reference: the quantize, dequantize and
dequant-accumulate kernels' plain versions (against the reference's
Pallas kernels in interpret mode and their oracles), the fused residual
RMSNorm's plain version, and the runnable ring collectives over the
shard axis (against the reference's under `jax.vmap(axis_name=...)`),
their ledger entries included.  The CUDA kernels themselves are held
against these plain versions on the GPU by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS, ref as REF  # noqa: E402
from repro.kernels import quant_collectives as RQC  # noqa: E402
from repro.parallel import compression as RC  # noqa: E402
from repro.parallel.collectives import (MODEL_AXIS,  # noqa: E402
                                        collective_ledger as rledger)

from repro_torch.kernels import fused_norm as FN, ops  # noqa: E402
from repro_torch.kernels import quant_collectives as QC  # noqa: E402
from repro_torch.parallel import compression as C  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from torch_parity import elsewhere, one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# B4 / B5 / B6 plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [127, 7])
@pytest.mark.parametrize("n", [256, 1111])
def test_quantize_dequantize_plain_match_kernels_and_oracles(n, levels):
    """Codes equal and scales bit-equal to the oracle; against the
    Pallas kernel in interpret mode, codes equal and scales to rtol 1e-7
    (the reference's own kernel-vs-oracle tolerance) at L=127.  At L=7
    that kernel's scale is itself 1 ulp off true division (and off its
    oracle, ROADMAP C), so there the bound is that 1 ulp; dequantized
    values to rtol 1e-7 against both."""
    x = np.random.default_rng(n + levels).standard_normal(n) \
        .astype(np.float32) * 3.0
    q, s = QC.quantize_absmax(_t(x)[None], levels=levels)
    q, s = q[0].numpy(), s[0].numpy()
    q_k, s_k = RQC.quantize_absmax(jnp.asarray(x), levels=levels,
                                   interpret=True)
    q_r, s_r = REF.quantize_absmax_ref(jnp.asarray(x), levels=levels)
    np.testing.assert_array_equal(q, np.asarray(q_r))
    np.testing.assert_array_equal(s, np.asarray(s_r))
    np.testing.assert_array_equal(q, np.asarray(q_k))
    if levels == 127:
        np.testing.assert_allclose(s, np.asarray(s_k), rtol=1e-7, atol=0)
    else:
        np.testing.assert_array_max_ulp(s, np.asarray(s_k), maxulp=1)
    assert q.dtype == np.int8 and s.shape == (-(-n // 128),)
    y = QC.dequantize_absmax(_t(q)[None], _t(s)[None])[0].numpy()
    y_k = RQC.dequantize_absmax(jnp.asarray(q), jnp.asarray(s), n=n,
                                interpret=True)
    y_r = REF.dequantize_absmax_ref(jnp.asarray(q), jnp.asarray(s), n=n)
    for yy in (y_k, y_r):
        np.testing.assert_allclose(y, np.asarray(yy), rtol=1e-7, atol=0)
    # the round trip equals the fused qdq exactly, within scale/2 of x
    np.testing.assert_array_equal(
        y, QC.qdq_absmax_plain(_t(x)[None], levels=levels)[0].numpy())
    assert np.abs(y - x).max() <= s.max() / 2 + 1e-7


@pytest.mark.parametrize("n", [256, 1111])
def test_dequant_accum_plain_matches_kernel_and_oracle(n):
    """The reference's kernel contracts the multiply-add (1 ulp off its
    oracle); the port is held to the reference's 1e-6 against both."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    acc = rng.standard_normal(n).astype(np.float32)
    q_r, s_r = RQC.quantize_absmax(jnp.asarray(x), interpret=True)
    q, s = np.asarray(q_r), np.asarray(s_r)
    port = QC.dequant_accum_absmax(_t(q)[None], _t(s)[None],
                                   _t(acc)[None])[0].numpy()
    y_k = RQC.dequant_accum_absmax(q_r, s_r, jnp.asarray(acc),
                                   interpret=True)
    y_r = REF.dequant_accum_ref(q_r, s_r, jnp.asarray(acc))
    for yy in (y_k, y_r):
        np.testing.assert_allclose(port, np.asarray(yy), atol=1e-6,
                                   rtol=1e-6)


def test_quant_plain_chunks_restart_at_each_row():
    """(tp, n) payloads: each row quantizes as the reference's per-shard
    call of its own row does."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    x[1] *= 50.0
    acc = rng.standard_normal((3, 300)).astype(np.float32)
    q, s = QC.quantize_absmax(_t(x), levels=7)
    z = QC.dequant_accum_absmax(q, s, _t(acc)).numpy()
    for row in range(3):
        q_r, s_r = REF.quantize_absmax_ref(jnp.asarray(x[row]), levels=7)
        np.testing.assert_array_equal(q[row].numpy(), np.asarray(q_r))
        np.testing.assert_allclose(s[row].numpy(), np.asarray(s_r),
                                   rtol=1e-7, atol=0)
        np.testing.assert_allclose(
            z[row], np.asarray(REF.dequant_accum_ref(
                q_r, s_r, jnp.asarray(acc[row]))), atol=1e-6, rtol=1e-6)


def test_quant_wrappers_check_arguments():
    x = torch.zeros(2, 256)
    q, s = QC.quantize_absmax(x, levels=127)
    with pytest.raises(TypeError):
        QC.quantize_absmax(x.double(), levels=127)
    with pytest.raises(ValueError, match="levels"):
        QC.quantize_absmax(x, levels=15)
    with pytest.raises(ValueError, match="chunk"):
        QC.quantize_absmax(x, levels=127, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        QC.dequant_accum_absmax(q, s, torch.zeros(256, 2).t())
    with pytest.raises(TypeError):
        QC.dequantize_absmax(q.int(), s)
    with pytest.raises(ValueError, match="scales"):
        QC.dequantize_absmax(q, s[:, :1].contiguous())
    with pytest.raises(ValueError, match="does not match"):
        QC.dequant_accum_absmax(q, s, torch.zeros(1, 256))
    other = elsewhere(torch.empty(2, 256))
    codes = elsewhere(torch.empty(2, 256, dtype=torch.int8))
    for call in (lambda: QC.quantize_absmax(other, levels=7),
                 lambda: QC.dequantize_absmax(codes, elsewhere(s)),
                 lambda: QC.dequant_accum_absmax(codes, elsewhere(s),
                                                 other)):
        with pytest.raises(ValueError, match="no .* kernel for device"):
            call()
    assert QC.quantize_absmax.launches == QC.dequantize_absmax.launches \
        == QC.dequant_accum_absmax.launches == 0   # the CPU counts nothing


# ---------------------------------------------------------------------------
# B7 plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(512, 96), (100, 64), (256, 960)])
def test_fused_norm_plain_matches_kernel_and_oracle(t, d, dtype):
    """At the tolerances of the reference's test_fused_norm_sweep."""
    rng = np.random.default_rng(t + d)
    x, r = (rng.standard_normal((t, d)).astype(np.float32) for _ in "xr")
    w = rng.standard_normal(d).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jr, jw = (jnp.asarray(a, jd) for a in (x, r, w))
    ref_k = ROPS.fused_residual_rmsnorm(jx, jr, jw, block_rows=128,
                                        interpret=True)
    ref_o = REF.fused_residual_rmsnorm_ref(jx, jr, jw)
    # identical bf16 inputs on both sides: round through the reference
    tx, tr, tw = (_t(np.asarray(a, np.float32)).to(td) for a in (jx, jr, jw))
    port = ops.fused_residual_rmsnorm(tx, tr, tw)
    assert port[0].dtype == td and port[1].dtype == td
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)
    for ref in (ref_k, ref_o):
        for a, b in zip(port, ref):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)


def test_fused_norm_wrapper_checks_and_leading_axes():
    x = torch.randn(2, 3, 64)
    y, s = ops.fused_residual_rmsnorm(x, x, torch.ones(64))
    assert y.shape == s.shape == x.shape
    np.testing.assert_allclose(s.numpy(), 2 * x.numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="one shape"):
        FN.fused_residual_rmsnorm(x[0], x[1, :2], torch.ones(64))
    with pytest.raises(ValueError, match="w"):
        FN.fused_residual_rmsnorm(x[0], x[1], torch.ones(32))
    with pytest.raises(TypeError):
        FN.fused_residual_rmsnorm(x[0].half(), x[1].half(), torch.ones(64))
    with pytest.raises(ValueError, match="contiguous"):
        FN.fused_residual_rmsnorm(x[0].t().contiguous().t(), x[1],
                                  torch.ones(64))
    other = elsewhere(torch.empty(3, 64))
    with pytest.raises(ValueError, match="no fused-norm kernel"):
        FN.fused_residual_rmsnorm(other, other, elsewhere(torch.empty(64)))


# ---------------------------------------------------------------------------
# Ring collectives over the shard axis vs the reference under vmap
# ---------------------------------------------------------------------------


def _ref_ring(fn, x):
    with rledger() as led:
        out = jax.vmap(fn, axis_name=MODEL_AXIS)(jnp.asarray(x))
    return np.asarray(out), [(e.op, e.nbytes) for e in led]


def _port_ring(fn, x):
    with collective_ledger() as led:
        out = fn(_t(x))
    return out.numpy(), [(e.op, e.nbytes) for e in led]


@pytest.mark.parametrize("tp,size", [(2, 96), (4, 130), (8, 1024)])
def test_ring_all_gather_matches_reference(tp, size):
    x = np.random.default_rng(size).standard_normal((tp, size)) \
        .astype(np.float32)
    ref, rled = _ref_ring(lambda v: RC.ring_all_gather(v, MODEL_AXIS), x)
    port, led = _port_ring(C.ring_all_gather, x)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, np.broadcast_to(x, (tp,) + x.shape))
    assert led == rled and len(led) == tp - 1


@pytest.mark.parametrize("tp,size", [(2, 64), (4, 130), (8, 1000)])
def test_ring_reduce_scatter_matches_reference(tp, size):
    x = np.random.default_rng(tp * size).standard_normal((tp, size)) \
        .astype(np.float32)
    ref, rled = _ref_ring(lambda v: RC.ring_reduce_scatter(v, MODEL_AXIS), x)
    port, led = _port_ring(C.ring_reduce_scatter, x)
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)
    total = np.zeros(-(-size // tp) * tp, np.float32)
    total[:size] = x.sum(0)
    np.testing.assert_allclose(port, total.reshape(tp, -1), atol=1e-5, rtol=0)
    assert led == rled


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tp", [2, 4])
def test_ring_quantized_psum_matches_reference(tp, bits):
    """Against the reference's kernel=False path to 1e-6 x max|x| (its
    qdq adds a straight-through x + (y - x), a rounding the port's plain
    path does not make); the reference's error bound (2n+1)/levels x
    max|x| holds, every shard holds the same sum, and the ring logs the
    same (op, bytes) entries."""
    rng = np.random.default_rng(bits + tp)
    x = (rng.standard_normal((tp, 777)) * 2.0).astype(np.float32)
    ref, rled = _ref_ring(lambda v: RC.ring_quantized_psum(
        v, MODEL_AXIS, bits=bits, kernel=False), x)
    port, led = _port_ring(lambda v: C.ring_quantized_psum(v, bits=bits), x)
    amax = np.abs(x).max()
    np.testing.assert_allclose(port, ref, atol=1e-6 * amax, rtol=0)
    for d in range(1, tp):
        np.testing.assert_array_equal(port[d], port[0])
    levels = 127 if bits == 8 else 7
    assert np.abs(port[0] - x.sum(0)).max() <= amax * (2 * tp + 1) / levels
    assert led == rled
    assert [op for op, _ in led] == ["collective-permute"] * (3 * (tp - 1))


def test_ring_quantized_psum_keeps_shape_dtype_and_single_shard():
    x = torch.randn(2, 3, 5, 64).to(torch.bfloat16)
    out = C.ring_quantized_psum(x, bits=8)
    assert out.shape == x.shape and out.dtype == x.dtype
    one = torch.randn(1, 300)
    np.testing.assert_array_equal(
        C.ring_quantized_psum(one, bits=4).numpy(),
        QC.qdq_absmax_plain(one, levels=7).numpy())
