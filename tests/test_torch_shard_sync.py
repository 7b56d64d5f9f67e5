"""The quantized kept sync across ranks as two kernels, on the CPU: the
send (`quantize_message_absmax`, a rank's partial -> its int8 wire
message) and the receive (`reduce_messages_absmax`, the gathered
messages -> the sum in rank order from +0 and hop 2).

(a) The two plain versions together equal the chain they replaced bit
    for bit, zero signs included: `quantize_absmax_plain` -> the old
    message (codes then scales) -> `dequant_accum_absmax_plain` x tp
    from +0 -> `qdq_absmax_plain` -> one cast.  tp 1-8, L 127 and 7, fp32
    and bf16 payloads, n in N_CASES (ragged and not 4-aligned included).
(b) The same against the reference's oracles (`quantize_absmax_ref`,
    `dequant_accum_ref` from a zero accumulator, `qdq_absmax_ref`),
    equal values as in test_torch_qpsum.
(c) The message layout: n codes, zeros to the next 16-byte boundary,
    one fp32 scale a chunk.
(d) numpy emulations of both kernels' plans (a warp a chunk, lane l's
    elements 4l .. 4l+3, char4 code stores that cover the pad, the tail's
    masked reads; the receive's ranks in blocks of 32 scales and groups
    of `qpsum_group(tp)`, up to tp 33) held bit for bit against the plain
    versions.
(e) On the CPU the wrappers take the plain versions and count nothing;
    their argument checks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as R  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quant_collectives as QC  # noqa: E402
from torch_parity import elsewhere, one_torch_thread  # noqa: E402,F401

LANES = 32
PER_LANE = QC.CHUNK // LANES
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INTS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
N_CASES = (3, 128, 960, 1001, 3840)
TPS = tuple(range(1, 9))


def _bits(t):
    """The raw bits of a float32 / bf16 tensor (-0 differs from +0)."""
    return t.contiguous().view(INTS[t.dtype]).numpy()


def _partials(tp, n, seed, dtype=torch.float32):
    """(tp, n) partials at scales a decade apart, with exact zeros of both
    signs and, where n allows, an all-zero chunk (the 1e-12 floor)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tp, n)) * np.logspace(0, 1, tp)[:, None]
    x = x.astype(np.float32)
    x[:, 3 % n] = 0.0
    x[0, 5 % n] = x[(1 % tp), 5 % n] = -0.0
    x[:, 128:256] = -0.0
    return torch.from_numpy(x).to(dtype)


def _old_chain(x, levels):
    """The sync as a rank ran it before: the cast, B4 on each rank's row,
    the message codes | scales, B6 once a rank from a zero accumulator,
    B3, the cast back."""
    tp, n = x.shape
    parts = []
    for r in range(tp):
        q, s = QC.quantize_absmax_plain(x[r:r + 1].float().contiguous(),
                                        levels=levels)
        parts.append(torch.cat([q.reshape(-1),
                                s.reshape(-1).view(torch.int8)]))
    got = torch.stack(parts)              # the old gather's copies
    qa = got[:, :n].clone()
    sa = got[:, n:].flatten().clone().view(torch.float32).reshape(tp, -1)
    acc = torch.zeros((1, n), dtype=torch.float32)
    for r in range(tp):
        acc = QC.dequant_accum_absmax_plain(qa[r:r + 1], sa[r:r + 1], acc)
    return QC.qdq_absmax_plain(acc, levels=levels).to(x.dtype)


def _new_sync(x, levels):
    msg = QC.quantize_message_absmax_plain(x, levels=levels)
    return QC.reduce_messages_absmax_plain(msg, x.shape[1], levels=levels,
                                           dtype=x.dtype)


CASES = pytest.mark.parametrize("n", N_CASES)
KINDS = [pytest.param(tp, lv, dt, id=f"tp{tp}-L{lv}-{dt}") for tp in TPS
         for lv in QC.LEVELS for dt in DTYPES]


# ---------------------------------------------------------------------------
# (a) against the chain it replaced, (b) against the reference's oracles
# ---------------------------------------------------------------------------


@CASES
@pytest.mark.parametrize("tp,levels,dtype", KINDS)
def test_send_receive_equal_the_old_chain(tp, levels, dtype, n):
    x = _partials(tp, n, seed=tp * 1000 + n + levels, dtype=DTYPES[dtype])
    got = _new_sync(x, levels)
    assert got.shape == (1, n) and got.dtype == x.dtype
    np.testing.assert_array_equal(_bits(got), _bits(_old_chain(x, levels)))


@CASES
@pytest.mark.parametrize("tp,levels,dtype", KINDS)
def test_send_receive_equal_the_reference_oracles(tp, levels, dtype, n):
    x = _partials(tp, n, seed=tp * 1000 + n + levels + 1,
                  dtype=DTYPES[dtype])
    xs = jnp.asarray(x.float().numpy()).astype(dtype)
    acc = jnp.zeros((n,), jnp.float32)
    for r in range(tp):
        q, s = R.quantize_absmax_ref(xs[r], levels=levels)
        acc = R.dequant_accum_ref(q, s, acc)
    want = R.qdq_absmax_ref(acc, levels=levels).astype(dtype)
    np.testing.assert_array_equal(_new_sync(x, levels).float().numpy()[0],
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# (c) the message layout
# ---------------------------------------------------------------------------


@CASES
@pytest.mark.parametrize("levels", QC.LEVELS)
def test_message_layout(n, levels):
    """Bytes [0, n) the codes, [n, pad16(n)) zero, then the fp32 scales
    of the ceil(n/128) chunks: the layout the kernel's comment states."""
    pad, m = QC.message_layout(n)
    chunks = -(-n // QC.CHUNK)
    assert pad % 16 == 0 and n <= pad < n + 16
    assert m == pad + 4 * chunks and m % 4 == 0
    x = _partials(3, n, seed=n)
    msg = QC.quantize_message_absmax_plain(x, levels=levels)
    assert msg.shape == (3, m) and msg.dtype == torch.int8
    q, s = QC.quantize_absmax_plain(x, levels=levels)
    raw = msg.numpy()
    np.testing.assert_array_equal(raw[:, :n], q.numpy())
    assert not raw[:, n:pad].any()
    np.testing.assert_array_equal(
        np.ascontiguousarray(raw[:, pad:]).view(np.float32), s.numpy())
    mq, ms = QC.message_parts(msg, n)
    np.testing.assert_array_equal(mq.numpy(), q.numpy())
    np.testing.assert_array_equal(ms.numpy(), s.numpy())


# ---------------------------------------------------------------------------
# (d) the kernels' plans, emulated
# ---------------------------------------------------------------------------


def _bf16_round(y):
    """float32 -> bf16 round to nearest even (__float2bfloat16_rn), as
    float32 values (no NaN here)."""
    b = y.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def _scale(v, levels):
    """A warp's absmax scale over its (32, 4) values: true fp32 division."""
    return np.maximum(np.abs(v).max() / np.float32(levels),
                      np.float32(1e-12))


def _lane_map(c):
    """(32, 4) element indices of chunk c: lane l owns 4l .. 4l+3."""
    return (c * QC.CHUNK + np.arange(LANES)[:, None] * PER_LANE
            + np.arange(PER_LANE)[None, :])


def emulate_send(x, levels, sms):
    """The send kernel's plan over x (rows, n) float32 values: qpsum_grid
    blocks of warps, grid y the row, warp -> chunk c, lane l -> elements
    4l .. 4l+3 (0 past n), lane 0 the scale at pad + 4c, each lane with
    4l + 128c < pad16(n) one char4 of codes.  The message starts as
    garbage; returns it and the writes per byte."""
    rows, n = x.shape
    pad, m = QC.message_layout(n)
    blocks, warps = QC.qpsum_grid(n, sms)
    chunks = -(-n // QC.CHUNK)
    lv = np.float32(levels)
    msg = np.full((rows, m), 0x5A, np.uint8)
    writes = np.zeros((rows, m), np.int64)
    for row in range(rows):
        for c in range(blocks * warps):
            if c >= chunks:
                continue
            i = _lane_map(c)
            v = np.where(i < n, x[row][np.minimum(i, n - 1)], np.float32(0))
            s = _scale(v, levels)
            msg[row, pad + 4 * c:pad + 4 * c + 4] = np.array(
                [s], np.float32).view(np.uint8)
            writes[row, pad + 4 * c:pad + 4 * c + 4] += 1
            codes = np.clip(np.rint(v / s), -lv, lv).astype(np.int8)
            for lane in range(LANES):
                i0 = i[lane, 0]
                if i0 < pad:                # 4-byte aligned, inside codes
                    msg[row, i0:i0 + 4] = codes[lane].view(np.uint8)
                    writes[row, i0:i0 + 4] += 1
    return msg.view(np.int8), writes


def emulate_receive(msg, n, levels, sms, dtype):
    """The receive kernel's plan over messages (tp, m): warp -> chunk c,
    the ranks in blocks of 32 (lane l loads rank b0 + l's scale at pad +
    4c) and groups of qpsum_group(tp) (lane l reads each rank's char4 at
    4l + 128c where that is < n: it then ends inside the codes' pad16(n)
    bytes; codes past n as 0); then, rank by rank, the scale shuffled
    from lane g0 + r and acc = acc + q * s from +0 (each op rounded to
    fp32); hop 2, one rounding to dtype.  Returns (y float32 values,
    writes per element, the ranks added into chunk 0's sum in order)."""
    tp, m = msg.shape
    pad, _ = QC.message_layout(n)
    blocks, warps = QC.qpsum_grid(n, sms)
    group = QC.qpsum_group(tp)
    chunks = -(-n // QC.CHUNK)
    lv = np.float32(levels)
    y = np.zeros(n, np.float32)
    writes = np.zeros(n, np.int64)
    order = []
    scales = np.ascontiguousarray(msg[:, pad:]).view(np.float32)
    for c in range(blocks * warps):
        if c >= chunks:
            continue
        i = _lane_map(c)
        acc = np.zeros((LANES, PER_LANE), np.float32)
        for b0 in range(0, tp, LANES):
            nb = min(LANES, tp - b0)
            my_s = np.array([scales[b0 + lane, c] if lane < nb else 0.0
                             for lane in range(LANES)], np.float32)
            for g0 in range(0, nb, group):
                rows = min(group, nb - g0)
                q = np.zeros((rows, LANES, PER_LANE), np.float32)
                for r in range(rows):
                    for lane in range(LANES):
                        i0 = i[lane, 0]
                        if i0 < n:
                            assert i0 % 4 == 0 and i0 + 4 <= pad
                            q[r, lane] = msg[b0 + g0 + r, i0:i0 + 4]
                for r in range(group):
                    assert g0 + r < LANES       # a lane of the warp
                    s = my_s[g0 + r]
                    if r < rows:
                        qr = np.where(i < n, q[r], np.float32(0))
                        acc = (acc + (qr * s).astype(np.float32)).astype(
                            np.float32)
                        if c == 0:
                            order.append(b0 + g0 + r)
        s = _scale(acc, levels)
        out = (np.clip(np.rint(acc / s), -lv, lv) * s).astype(np.float32)
        live = i < n
        y[i[live]] = out[live]
        writes[i[live]] += 1
    y = _bf16_round(y) if dtype == torch.bfloat16 else y
    return y, writes, order


@pytest.mark.parametrize("tp,n,levels,dtype,sms", [
    (1, 3, 127, "float32", 132),
    (2, 130, 7, "bfloat16", 1),
    (3, 1001, 127, "bfloat16", 3),
    (8, 960, 7, "float32", 132),
    (4, 3840, 127, "bfloat16", 132),
    (5, 257, 127, "float32", 2),
    (9, 1001, 127, "bfloat16", 3),
    (16, 3840, 7, "float32", 132),
    (33, 130, 127, "bfloat16", 1),
])
def test_kernel_plans_equal_plain(tp, n, levels, dtype, sms):
    x = _partials(tp, n, seed=tp + n, dtype=DTYPES[dtype])
    msg, writes = emulate_send(x.float().numpy(), levels, sms)
    assert (writes == 1).all()                 # every message byte once
    plain = QC.quantize_message_absmax_plain(x, levels=levels)
    np.testing.assert_array_equal(msg, plain.numpy())
    # the receive reads no pad byte as a code: garbage there changes nothing
    pad, _ = QC.message_layout(n)
    dirty = msg.copy()
    dirty[:, n:pad] = np.int8(-7)
    y, writes, order = emulate_receive(dirty, n, levels, sms, DTYPES[dtype])
    assert (writes == 1).all()
    assert order == list(range(tp))            # every rank once, in order
    want = QC.reduce_messages_absmax_plain(plain, n, levels=levels,
                                           dtype=DTYPES[dtype])
    np.testing.assert_array_equal(
        _bits(want), _bits(torch.from_numpy(y[None]).to(want.dtype)))


# ---------------------------------------------------------------------------
# (e) the CPU route and the wrappers' checks
# ---------------------------------------------------------------------------


def test_cpu_wrappers_take_plain_and_count_nothing():
    before = (QC.quantize_message_absmax.launches,
              QC.reduce_messages_absmax.launches)
    x = _partials(2, 1001, seed=9, dtype=torch.bfloat16)
    msg = QC.quantize_message_absmax(x, levels=127)
    np.testing.assert_array_equal(
        msg.numpy(), QC.quantize_message_absmax_plain(x, levels=127).numpy())
    y = QC.reduce_messages_absmax(msg, 1001, levels=127,
                                  dtype=torch.bfloat16)
    np.testing.assert_array_equal(_bits(y), _bits(_old_chain(x, 127)))
    assert (QC.quantize_message_absmax.launches,
            QC.reduce_messages_absmax.launches) == before
    assert build._LIBS == {}


def test_send_and_receive_wrapper_checks():
    x = torch.zeros(1, 256)
    msg = QC.quantize_message_absmax(x, levels=7)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        QC.quantize_message_absmax(x.half(), levels=127)
    with pytest.raises(ValueError, match="levels"):
        QC.quantize_message_absmax(x, levels=15)
    with pytest.raises(ValueError, match="chunk"):
        QC.quantize_message_absmax(x, levels=127, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        QC.quantize_message_absmax(torch.zeros(256, 2).t(), levels=127)
    with pytest.raises(ValueError, match="no quantize-message kernel"):
        QC.quantize_message_absmax(elsewhere(x), levels=127)
    with pytest.raises(ValueError, match="bytes"):
        QC.reduce_messages_absmax(msg, 240, levels=7, dtype=torch.float32)
    # any number of messages; tp * m past int indexing is refused (meta:
    # nothing allocated)
    n = 2 ** 27
    with pytest.raises(ValueError, match="int indexing"):
        QC.reduce_messages_absmax(
            torch.empty(16, QC.message_layout(n)[1], dtype=torch.int8,
                        device="meta"), n, levels=7, dtype=torch.float32)
    with pytest.raises(TypeError, match="int8"):
        QC.reduce_messages_absmax(msg.float(), 256, levels=7,
                                  dtype=torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        QC.reduce_messages_absmax(msg, 256, levels=7, dtype=torch.float16)
    with pytest.raises(ValueError, match="no reduce-messages kernel"):
        QC.reduce_messages_absmax(elsewhere(msg), 256, levels=7,
                                  dtype=torch.float32)
    buf = torch.zeros(msg.numel() + 1, dtype=torch.int8)
    with pytest.raises(ValueError, match="4-byte boundary"):
        QC.reduce_messages_absmax(buf[1:].view(1, -1), 256, levels=7,
                                  dtype=torch.float32)
