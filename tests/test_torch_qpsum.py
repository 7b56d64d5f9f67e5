"""The fused quantized kept sync (B3's two hops in one kernel) and the
redesigned dequantize kernel (B5), on the CPU.

(a) The port's `quantized_psum` (plain route) against the reference's
    `quantized_psum(kernel=False)` under `jax.vmap(axis_name=...)`, with
    its ledger entries; and against the unfused composition it replaced.
(b) A numpy emulation of the fused kernel's plan (warp per chunk index
    over all shards, each lane's 4 elements, the tail mask, the rows
    streamed in groups of `qpsum_group(tp)` up to tp 16, the shard sum's
    order, one rounding to bf16) held bit for bit against
    `quantized_psum_absmax_plain`, which the card holds the kernel to.
(c) The same for the dequantize kernel's grid-stride plan.
(d) On the CPU the wrappers take their plain versions and count nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.parallel import compression as RC  # noqa: E402
from repro.parallel.collectives import (MODEL_AXIS,  # noqa: E402
                                        collective_ledger as rledger)

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_collectives as QC  # noqa: E402
from repro_torch.parallel import compression as C  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from torch_parity import elsewhere, one_torch_thread  # noqa: E402,F401

LANES = 32
PER_LANE = QC.CHUNK // LANES
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INTS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _bits(t):
    """The raw bits of a float32 / bf16 tensor (-0 differs from +0)."""
    return t.contiguous().view(INTS[t.dtype]).numpy()


def _payload(tp, n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tp, n)) * rng.uniform(0.1, 10.0, (tp, 1))
    x[0, :min(n, QC.CHUNK) // 2] = 0.0        # zeros: the 1e-12 floor, -0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# (a) against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [960, 3840, 77, 1001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_quantized_psum_matches_reference(tp, bits, dtype, n):
    """Equal values (assert_array_equal: +0 and -0 are one value) at every
    tp: the reference sums the shards under vmap in the same order as
    the port's left-to-right sum at tp <= 4, and its straight-through
    x + (y - x) gives y exactly (Sterbenz) except for a zero's sign.
    Same ledger entries; x's shape and dtype back."""
    x = _payload(tp, n, seed=tp * 100 + bits + n, dtype=DTYPES[dtype])
    x = x.reshape(tp, 1, n)
    with rledger() as rled:
        ref = jax.vmap(lambda a: RC.quantized_psum(a, MODEL_AXIS, bits=bits,
                                                   kernel=False),
                       axis_name=MODEL_AXIS)(
            jnp.asarray(x.float().numpy()).astype(dtype))
    with collective_ledger() as led:
        port = C.quantized_psum(x, MODEL_AXIS, bits=bits)
    assert port.shape == x.shape and port.dtype == x.dtype
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert [(e.op, e.nbytes) for e in led] == \
        [(e.op, e.nbytes) for e in rled]


def _unfused(x, bits):
    """The kept sync as the port computed it before the fused kernel:
    qdq each shard, sum(dim=0), qdq the broadcast sum, cast."""
    xq = C.qdq(x, bits=bits)
    s = xq.sum(dim=0, keepdim=True).expand_as(xq)
    return C.qdq(s, bits=bits).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_quantized_psum_bits_equal_the_unfused_composition(tp, dtype):
    """On the CPU, for tp <= 4 (every tp a port test runs a quantized
    sync at), the new plain route gives the old composition's bits, zero
    signs included: no existing result moves."""
    for bits in (8, 4):
        for n in (77, 960, 1001):
            x = _payload(tp, 2 * n, seed=tp + n, dtype=DTYPES[dtype])
            x = x.reshape(tp, 2, n)
            np.testing.assert_array_equal(
                _bits(C.quantized_psum(x, MODEL_AXIS, bits=bits)),
                _bits(_unfused(x, bits)))


# ---------------------------------------------------------------------------
# (b) the fused kernel's plan, emulated
# ---------------------------------------------------------------------------


def _bf16_round(y):
    """float32 -> bf16 round to nearest even (__float2bfloat16_rn), as
    float32 values (no NaN here)."""
    b = y.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def _qdq_lane(v, levels):
    """One warp's hop on (32, 4) lane values: absmax over the warp,
    s = max(m / L, 1e-12) by true fp32 division, clip(rint(v / s)) * s."""
    lv = np.float32(levels)
    s = np.maximum(np.abs(v).max() / lv, np.float32(1e-12))
    return (np.clip(np.rint(v / s), -lv, lv) * s).astype(np.float32)


def emulate_qpsum(x, levels, sms):
    """The fused kernel's plan over x (tp, n) float32 values: blocks of
    `warps` warps from qpsum_grid, warp -> chunk index c, lane l ->
    elements c*128 + 4l .. 4l+3 of every row, masked past n; the rows
    streamed in groups of qpsum_group(tp) (a group's loads first, then
    hop 1 and the add a row at a time, the last group's missing rows
    skipped).  Returns (y float32 values before the cast, writes per
    element, the rows added into chunk 0's sum in order)."""
    tp, n = x.shape
    blocks, warps = QC.qpsum_grid(n, sms)
    group = QC.qpsum_group(tp)
    chunks = -(-n // QC.CHUNK)
    y = np.zeros((tp, n), np.float32)
    writes = np.zeros((tp, n), np.int64)
    order = []
    idx = (np.arange(LANES)[:, None] * PER_LANE
           + np.arange(PER_LANE)[None, :])            # (32, 4) lane map
    for b in range(blocks):
        for w in range(warps):
            c = b * warps + w
            if c >= chunks:
                continue
            i = c * QC.CHUNK + idx
            live = i < n
            ic = np.where(live, i, 0)
            acc = np.zeros((LANES, PER_LANE), np.float32)   # +0
            for g0 in range(0, tp, group):
                rows = min(group, tp - g0)
                v = [np.where(live, x[g0 + r][ic], np.float32(0))
                     for r in range(rows)]
                for r in range(group):
                    if r < rows:
                        acc = (acc + _qdq_lane(v[r], levels)).astype(
                            np.float32)
                        if c == 0:
                            order.append(g0 + r)
            out = _qdq_lane(acc, levels)
            for r in range(tp):
                y[r][i[live]] = out[live]
                writes[r][i[live]] += 1
    return y, writes, order


@settings(max_examples=40, deadline=None)
@given(tp=st.integers(1, 16), n=st.integers(1, 1200),
       levels=st.sampled_from(QC.LEVELS),
       dtype=st.sampled_from(["float32", "bfloat16"]),
       sms=st.sampled_from([1, 3, 132]), seed=st.integers(0, 2 ** 16))
def test_fused_plan_emulation_equals_plain(tp, n, levels, dtype, sms, seed):
    x = _payload(tp, n, seed, DTYPES[dtype])
    y, writes, order = emulate_qpsum(x.float().numpy(), levels, sms)
    assert (writes == 1).all()                 # every element once a row
    assert order == list(range(tp))            # every row once, in order
    if dtype == "bfloat16":
        y = _bf16_round(y)
    plain = QC.quantized_psum_absmax_plain(x, levels=levels)
    want = torch.from_numpy(y).to(plain.dtype)  # exact: y is on the grid
    np.testing.assert_array_equal(_bits(plain), _bits(want))


@pytest.mark.parametrize("tp,want", [
    (1, 1), (2, 2), (3, 8), (4, 4), (5, 8), (8, 8), (9, 8), (16, 8),
    (33, 8)])
def test_qpsum_group(tp, want):
    """Rows a warp streams at a time: tp where one whole group of a
    kernel template takes it (1, 2, 4, 8), else MAX_GROUP (a lane's
    8 x 4 floats), whatever tp."""
    assert QC.qpsum_group(tp) == want


@pytest.mark.parametrize("n,sms,want", [
    (3840, 132, (30, 1)),          # decode sync: one warp a block
    (4096, 132, (32, 1)),          # mamba decode sync
    (491520, 132, (480, 8)),       # 512-token prefill sync
    (1001, 132, (8, 1)),
    (500 * 128, 132, (167, 3)),    # >= one block an SM once chunks allow
])
def test_qpsum_grid(n, sms, want):
    blocks, warps = QC.qpsum_grid(n, sms)
    chunks = -(-n // QC.CHUNK)
    assert (blocks, warps) == want
    assert 1 <= warps <= QC.WARPS and blocks * warps >= chunks
    assert (blocks - 1) * warps < chunks            # no idle block
    assert blocks >= min(chunks, sms)


def test_plain_sums_shards_left_to_right():
    """The plain version adds the hop-1 rows one after another from +0
    (the kernel's order), which sum(dim=0) does not promise: on the CPU
    at 8 rows of 5 elements it adds in another order."""
    x = torch.tensor(np.random.default_rng(3).standard_normal((8, 5)),
                     dtype=torch.float32) * 1e3
    xq = QC.qdq_absmax_plain(x, levels=127)
    ltr = torch.zeros(5)
    for r in range(8):
        ltr = ltr + xq[r]
    assert not torch.equal(xq.sum(dim=0), ltr)
    want = QC.qdq_absmax_plain(ltr[None], levels=127)[0]
    got = QC.quantized_psum_absmax_plain(x, levels=127)
    for r in range(8):
        np.testing.assert_array_equal(_bits(got[r]), _bits(want))


# ---------------------------------------------------------------------------
# (c) the dequantize kernel's plan, emulated
# ---------------------------------------------------------------------------


def emulate_dequant(q, s, sms):
    """The dequantize kernel's grid-stride plan: dequant_grid blocks of
    WARPS warps, warp gw takes chunks gw, gw + stride, ...; row and chunk
    from the chunk index, the scale once a chunk, lane l -> elements
    4l .. 4l+3 (a 4-byte load and a float4 store where rows are
    4-aligned, else 4 masked scalar lanes: the same elements)."""
    rows, n = q.shape
    cpr = -(-n // QC.CHUNK)
    total = rows * cpr
    stride = QC.dequant_grid(rows, n, sms) * QC.WARPS
    y = np.zeros((rows, n), np.float32)
    writes = np.zeros((rows, n), np.int64)
    lane = np.arange(LANES)[:, None] * PER_LANE + np.arange(PER_LANE)[None]
    for gw in range(stride):
        for w in range(gw, total, stride):
            row = w // cpr
            i = (w - row * cpr) * QC.CHUNK + lane
            i = i[i < n]
            y[row, i] = q[row, i].astype(np.float32) * s.reshape(-1)[w]
            writes[row, i] += 1
    return y, writes


@settings(max_examples=40, deadline=None)
@given(rows=st.integers(1, 4), n=st.integers(1, 1500),
       sms=st.sampled_from([1, 3, 132]),
       levels=st.sampled_from(QC.LEVELS), seed=st.integers(0, 2 ** 16))
def test_dequant_plan_emulation_equals_plain(rows, n, sms, levels, seed):
    x = _payload(rows, n, seed) * 10.0
    q, s = QC.quantize_absmax_plain(x, levels=levels)
    y, writes = emulate_dequant(q.numpy(), s.numpy(), sms)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        _bits(QC.dequantize_absmax_plain(q, s)), _bits(torch.from_numpy(y)))


@pytest.mark.parametrize("rows,n,sms,want", [
    (2, 983040, 132, 1056),        # the ring's slice: a full card, strided
    (2, 1920, 132, 4),
    (3, 77, 132, 1),
])
def test_dequant_grid(rows, n, sms, want):
    assert QC.dequant_grid(rows, n, sms) == want


def test_vector_rows_needs_aligned_rows():
    buf = torch.zeros(64)
    assert QC.vector_rows(8, buf[:16].view(2, 8))
    assert not QC.vector_rows(6, buf[:12].view(2, 6))     # n % 4 != 0
    assert not QC.vector_rows(8, buf[1:17].view(2, 8))    # base off by one
    codes = torch.zeros(64, dtype=torch.int8)
    assert QC.vector_rows(8, codes[4:20].view(2, 8))
    assert not QC.vector_rows(8, codes[2:18].view(2, 8))
    half = torch.zeros(64, dtype=torch.bfloat16)
    assert QC.vector_rows(8, half[4:20].view(2, 8))
    assert not QC.vector_rows(8, half[2:18].view(2, 8))


# ---------------------------------------------------------------------------
# (d) the CPU route and the wrapper's checks
# ---------------------------------------------------------------------------


def test_cpu_fused_sync_takes_plain_and_counts_nothing():
    before = (QC.quantized_psum_absmax.launches, QC.qdq_absmax.launches,
              QC.dequantize_absmax.launches)
    x = _payload(2, 3840, seed=1, dtype=torch.bfloat16)
    out = QC.quantized_psum_absmax(x, levels=127)
    np.testing.assert_array_equal(
        _bits(out), _bits(QC.quantized_psum_absmax_plain(x, levels=127)))
    C.quantized_psum(x.reshape(2, 4, 1, 960), MODEL_AXIS, bits=4)
    q, s = QC.quantize_absmax(x.float(), levels=7)
    QC.dequantize_absmax(q, s)
    assert (QC.quantized_psum_absmax.launches, QC.qdq_absmax.launches,
            QC.dequantize_absmax.launches) == before
    assert build._LIBS == {}


def test_fused_sync_wrapper_checks():
    x = torch.zeros(2, 256)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        QC.quantized_psum_absmax(x.half(), levels=127)
    # any number of shards; tp * n past int indexing is refused (meta:
    # nothing allocated)
    with pytest.raises(ValueError, match="int indexing"):
        QC.quantized_psum_absmax(torch.empty(16, 2 ** 27, device="meta"),
                                 levels=127)
    with pytest.raises(ValueError, match=r"\(rows, n\)"):
        QC.quantized_psum_absmax(torch.zeros(256), levels=127)
    with pytest.raises(ValueError, match="contiguous"):
        QC.quantized_psum_absmax(torch.zeros(256, 2).t(), levels=127)
    with pytest.raises(ValueError, match="levels"):
        QC.quantized_psum_absmax(x, levels=15)
    with pytest.raises(ValueError, match="chunk"):
        QC.quantized_psum_absmax(x, levels=127, chunk=64)
    with pytest.raises(ValueError, match="no quantized-psum kernel"):
        QC.quantized_psum_absmax(elsewhere(x), levels=127)
