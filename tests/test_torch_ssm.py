"""PyTorch port vs JAX reference: the Mamba2 SSD math (models/ssm.py) and
the plain version of the SSD chunked-scan kernel (kernels/ssd_scan.py),
on numpy-seeded inputs handed to both packages.

Tolerances: fp32 throughout; the port and XLA sum the chunk contractions
and cumsums in other orders (~1e-6 on O(1) outputs), hence atol 1e-5.
Against the reference's Pallas kernel in interpret mode the reference's
own tolerance (tests/test_kernels.py: atol 2e-4, rtol 2e-3 in fp32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS, ref as RREF  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402

from repro_torch.kernels import build, ops as KOPS  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from torch_parity import elsewhere, one_torch_thread  # noqa: E402,F401

ATOL = 1e-5
INTERPRET = dict(atol=2e-4, rtol=2e-3)


def _inputs(seed, b, s, h, p, n, g=1):
    """x, dt, a, bm, cm, dd as numpy fp32 (dt > 0, a < 0)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, h, p)).astype(f) * 0.5,
            rng.uniform(0.01, 0.3, (b, s, h)).astype(f),
            -rng.uniform(0.3, 2.0, h).astype(f),
            rng.standard_normal((b, s, g, n)).astype(f) * 0.3,
            rng.standard_normal((b, s, g, n)).astype(f) * 0.3,
            rng.standard_normal(h).astype(f))


def _t(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _close(port, ref, atol=ATOL, **kw):
    np.testing.assert_allclose(port.numpy() if isinstance(port, torch.Tensor)
                               else port, np.asarray(ref), atol=atol,
                               rtol=kw.get("rtol", 0))


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_reference(chunk, g):
    args = _inputs(chunk + g, 2, 32, 4, 8, 16, g)
    y, st = SSM.ssd_chunked(*_t(args), chunk=chunk)
    ry, rst = RSSM.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (2, 4, 8, 16)
    _close(y, ry)
    _close(st, rst)


@pytest.mark.parametrize("g", [1, 3])
def test_ssd_chunked_matches_sequential_oracles(g):
    """Both packages' chunked forms against both O(S) recurrences."""
    args = _inputs(7 + g, 2, 24, 3, 4, 8, g)
    y, st = SSM.ssd_chunked(*_t(args), chunk=8)
    sy, sst = SSM.ssd_reference(*_t(args))
    rsy, rsst = RSSM.ssd_reference(*map(jnp.asarray, args))
    for oy, ost in ((sy, sst), (rsy, rsst)):
        _close(y, oy if isinstance(oy, torch.Tensor) else np.asarray(oy))
        _close(st, ost if isinstance(ost, torch.Tensor) else np.asarray(ost))


def test_decode_chain_continues_the_chunked_state():
    """Prefill the first half chunked, then decode token by token from its
    state: the same outputs and final state as one chunked pass, as the
    reference (tests/test_ssm_moe.py) shows for its own."""
    x, dt, a, bm, cm, dd = _t(_inputs(3, 2, 32, 4, 8, 16))
    split = 16
    y1, st = SSM.ssd_chunked(x[:, :split], dt[:, :split], a, bm[:, :split],
                             cm[:, :split], dd, chunk=8)
    ys = [y1]
    for t in range(split, 32):
        y, st = SSM.ssd_decode_step(x[:, t:t + 1], dt[:, t:t + 1], a,
                                    bm[:, t:t + 1], cm[:, t:t + 1], dd, st)
        ys.append(y)
    y_all, st_all = SSM.ssd_chunked(x, dt, a, bm, cm, dd, chunk=8)
    _close(torch.cat(ys, 1), y_all.numpy())
    _close(st, st_all.numpy())
    # one step from an arbitrary state against the reference's step
    s0 = np.random.default_rng(9).standard_normal((2, 4, 8, 16)).astype(
        np.float32)
    args = [v[:, :1] if v.dim() > 1 else v for v in (x, dt, a, bm, cm, dd)]
    y, st = SSM.ssd_decode_step(*args, torch.from_numpy(s0))
    ry, rst = RSSM.ssd_decode_step(*[jnp.asarray(v.numpy()) for v in args],
                                   jnp.asarray(s0))
    _close(y, ry)
    _close(st, rst)


def test_per_stream_decay_equals_per_head_runs():
    """A and D given per batch row (B, H), as the model folds the shard
    axis into B, equal separate runs with each row's (H,) vectors."""
    x, dt, _, bm, cm, _ = _t(_inputs(4, 2, 16, 3, 4, 8))
    rng = np.random.default_rng(4)
    a = torch.from_numpy(-rng.uniform(0.3, 2.0, (2, 3)).astype(np.float32))
    dd = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    y, st = SSM.ssd_chunked(x, dt, a, bm, cm, dd, chunk=8)
    for r in range(2):
        yr, sr = SSM.ssd_chunked(x[r:r + 1], dt[r:r + 1], a[r], bm[r:r + 1],
                                 cm[r:r + 1], dd[r], chunk=8)
        torch.testing.assert_close(y[r:r + 1], yr, rtol=0, atol=0)
        torch.testing.assert_close(st[r:r + 1], sr, rtol=0, atol=0)


def test_causal_conv_whole_and_streaming_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    y, tail = SSM.causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    ry, rtail = RSSM.causal_conv(jnp.asarray(x), jnp.asarray(w))
    _close(y, ry, atol=1e-6)
    _close(tail, rtail, atol=0)
    # streaming from the whole-sequence tail, one token at a time
    state, rstate = tail, rtail
    x2 = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for t in range(3):
        yt, state = SSM.causal_conv(torch.from_numpy(x2[:, t:t + 1]),
                                    torch.from_numpy(w), state)
        ryt, rstate = RSSM.causal_conv(jnp.asarray(x2[:, t:t + 1]),
                                       jnp.asarray(w), rstate)
        _close(yt, ryt, atol=1e-6)
        _close(state, rstate, atol=0)
    # a prompt shorter than the kernel: the tail keeps its left zeros
    y1, tail1 = SSM.causal_conv(torch.from_numpy(x[:, :1]),
                                torch.from_numpy(w))
    assert tail1.shape == (2, 3, 6) and not tail1[:, :2].any()
    # broadcast taps (tp, 1, K, C) over (tp, B, S, C), as the blocks do
    xs = np.stack([x, 2 * x])
    ws = np.stack([w, -w])
    ys, _ = SSM.causal_conv(torch.from_numpy(xs), torch.from_numpy(ws)[:, None])
    for t in range(2):
        yt, _ = RSSM.causal_conv(jnp.asarray(xs[t]), jnp.asarray(ws[t]))
        _close(ys[t], yt, atol=1e-5)


def _per_stream(v, b):
    return torch.from_numpy(np.array(v)).expand(b, -1)


# the reference's own sweep (tests/test_kernels.py), P=8 raised to 16:
# the kernel's columns come in tiles of 16
@pytest.mark.parametrize("s,h,p,n,g,chunk", [
    (128, 2, 16, 32, 1, 32),
    (256, 4, 64, 16, 1, 64),
    (64, 3, 16, 8, 3, 16),
])
def test_ssd_scan_plain_matches_pallas_interpret(s, h, p, n, g, chunk):
    b = 2
    x, dt, a, bm, cm, dd = _inputs(s + h + n, b, s, h, p, n, g)
    ry = ROPS.ssd_scan(*map(jnp.asarray, (x, dt, a, bm, cm, dd)),
                       chunk=chunk, interpret=True)
    y, st = KOPS.ssd_scan(*_t((x, dt, a, bm, cm, dd)), chunk=chunk)
    _close(y, ry, **INTERPRET)
    # and against the single-stream oracle of the kernel's tests
    for bi, hi in ((0, 0), (b - 1, h - 1)):
        gi = hi // (h // g)
        ro = RREF.ssd_scan_ref(jnp.asarray(x[bi, :, hi]),
                               jnp.asarray(dt[bi, :, hi]), jnp.asarray(a[hi]),
                               jnp.asarray(bm[bi, :, gi]),
                               jnp.asarray(cm[bi, :, gi]),
                               jnp.asarray(dd[hi]), chunk=chunk)
        _close(y[bi, :, hi], ro)
    _, rst = RSSM.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm, dd)),
                              chunk=chunk)
    _close(st, rst)


@pytest.mark.parametrize("s", [1, 17, 23, 40])
def test_ssd_scan_ragged_length_is_exact(s):
    """S not a multiple of the chunk: the plain version's dt = 0 tail
    leaves y and the final state equal to one chunk of exactly S."""
    x, dt, a, bm, cm, dd = _t(_inputs(s, 2, s, 2, 16, 8))
    y, st = SS.ssd_scan(x, dt, _per_stream(a, 2).contiguous(), bm, cm,
                        _per_stream(dd, 2).contiguous(), chunk=16)
    ey, est = SSM.ssd_chunked(x, dt, a, bm, cm, dd, chunk=s)
    assert y.shape == x.shape and st.shape == (2, 2, 16, 8)
    _close(y, ey.numpy())
    _close(st, est.numpy())


def test_ssd_scan_reads_strided_b_and_c():
    """B and C as slices of one fused projection (the model's layout):
    accepted without a copy of either and equal to contiguous ones."""
    x, dt, a, bm, cm, dd = _t(_inputs(11, 2, 20, 2, 16, 8))
    bc = torch.cat([bm, cm], dim=-1)                    # (B, S, 1, 2N)
    y, st = KOPS.ssd_scan(x, dt, a, bc[..., :8], bc[..., 8:], dd, chunk=16)
    ey, est = KOPS.ssd_scan(x, dt, a, bm, cm, dd, chunk=16)
    torch.testing.assert_close(y, ey, rtol=0, atol=0)
    torch.testing.assert_close(st, est, rtol=0, atol=0)


def test_ssd_scan_rejects_what_the_kernel_does_not_take():
    x, dt, a, bm, cm, dd = _t(_inputs(1, 1, 8, 2, 16, 8))
    a2, d2 = _per_stream(a.numpy(), 1).contiguous(), \
        _per_stream(dd.numpy(), 1).contiguous()
    with pytest.raises(ValueError, match="multiple of 16"):
        SS.ssd_scan(x[..., :8].contiguous(), dt, a2, bm, cm, d2, chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        SS.ssd_scan(x, dt, a2, bm, cm, d2, chunk=512)
    with pytest.raises(TypeError, match="float32"):
        SS.ssd_scan(x, dt.double(), a2, bm, cm, d2, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        SS.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a2,
                    bm, cm, d2, chunk=8)
    # a device that is neither CPU nor CUDA gets no silent plain path
    with pytest.raises(ValueError, match="no ssd_scan kernel"):
        SS.ssd_scan(*[elsewhere(t) for t in (x, dt, a2, bm, cm, d2)],
                    chunk=8)
    # CPU tensors take the plain version: nothing built, nothing counted
    before = SS.ssd_scan.launches
    SS.ssd_scan(x, dt, a2, bm, cm, d2, chunk=8)
    assert SS.ssd_scan.launches == before
    assert "ssd_scan" not in build._LIBS
