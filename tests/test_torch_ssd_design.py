"""The arithmetic of the bf16 SSD scan kernels (csrc/ssd_scan.cu), on the
CPU.

In bf16 the card runs the chunked scan as three kernels: C.B^T once per
(row, group, chunk) in fp32; each chunk's own state sum_j w_j x_j B_j^T,
w_j = exp(csum_last - csum_j) dt_j, with w_j x_j split into a bf16 hi part
and a bf16 rest (two tensor-core products); then y, with the state passed
between chunks in fp32, rounded to bf16 for the exp(csum_i) C_i . state
term, and the weighted scores rounded to bf16 as the A operand of the
product with x.  `emulate` below does the same arithmetic in torch, with
the same rounding points, and is held to the card's tolerances against
the port's plain version and the reference's oracle (kernels/ref.py):
y within 2^-7 x max|y| (one bf16 step) and the final state within
2e-5 x max|state|, at the serving shape (P 64, N 128, G 1, chunk 256;
S 17, 300, 512) and off the path (P 32, N 64, G 4, chunk 100, which is no
multiple of the 64-row tile), with ragged S.  One bf16 rounding of
w_j x_j instead of the split misses the state's tolerance.  The kernels
themselves are held against the plain version on the GPU by
chip_smoke.py.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as REF  # noqa: E402

from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

Y_REL = 2.0 ** -7
STATE_REL = 2e-5
SERVING = dict(bt=2, h=16, p=64, n=128, g=1, chunk=256)
OFF_PATH = dict(bt=2, h=16, p=32, n=64, g=4, chunk=100)


def _bf16(t):
    return t.bfloat16().float()


def inputs(seed, s, sh):
    """chip_smoke's SSD inputs, from numpy: x and B/C bf16 (held here as
    the fp32 values of bf16), dt log-uniform in [1e-3, 1e-1], A = -(1..16)
    over the heads, D = 1."""
    rng = np.random.default_rng(seed)
    bt, h, p, n, g = sh["bt"], sh["h"], sh["p"], sh["n"], sh["g"]
    f = np.float32
    x = _bf16(torch.from_numpy(rng.standard_normal((bt, s, h, p)).astype(f)))
    dt = torch.from_numpy(np.exp(rng.uniform(math.log(1e-3), math.log(1e-1),
                                             (bt, s, h))).astype(f))
    a = -torch.linspace(1.0, 16.0, h).expand(bt, h).contiguous()
    silu = torch.nn.functional.silu
    bm = _bf16(silu(torch.from_numpy(
        rng.standard_normal((bt, s, g, n)).astype(f))))
    cm = _bf16(silu(torch.from_numpy(
        rng.standard_normal((bt, s, g, n)).astype(f))))
    dd = torch.ones(bt, h)
    return x, dt, a, bm, cm, dd


def emulate(x, dt, a, bm, cm, dd, *, chunk, split=True):
    """The bf16 kernels' arithmetic: x, bm, cm hold bf16 values (fp32
    tensors); returns (y rounded to bf16, final state fp32)."""
    bt, s, h, p = x.shape
    g = bm.shape[2]
    hg = h // g
    run = torch.zeros(bt, h, p, bm.shape[3])
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(s, c0 + chunk))
        xc, dtc, bc, cc = x[:, sl], dt[:, sl], bm[:, sl], cm[:, sl]
        nr = xc.shape[1]
        csum = torch.cumsum(dtc * a[:, None], dim=1)            # (bt,nr,h)
        # 1. the scores, once per (row, group, chunk), fp32
        cb = torch.einsum("bign,bjgn->bgij", cc, bc)
        cbh = cb.repeat_interleave(hg, dim=1)                   # (bt,h,i,j)
        bh_ = bc.repeat_interleave(hg, dim=2)                   # (bt,j,h,n)
        ch_ = cc.repeat_interleave(hg, dim=2)
        # 2. the chunk's own state: w x as bf16 hi + bf16 rest
        total = csum[:, -1]                                     # (bt,h)
        v = (torch.exp(total[:, None] - csum) * dtc)[..., None] * xc
        hi = _bf16(v)
        parts = (hi, _bf16(v - hi)) if split else (hi,)
        own = sum(torch.einsum("bjhp,bjhn->bhpn", t, bh_) for t in parts)
        # 3. y: the passed state (bf16 for C . state), the weighted scores
        # rounded to bf16, D x
        ci = csum.transpose(1, 2)                               # (bt,h,nr)
        diff = ci[..., :, None] - ci[..., None, :]
        causal = torch.ones(nr, nr, dtype=torch.bool).tril()
        decay = torch.where(causal, torch.exp(diff.masked_fill(~causal, 0.0)),
                            torch.zeros(()))
        sc = _bf16(cbh * decay * dtc.transpose(1, 2)[:, :, None, :])
        y = (torch.einsum("bhij,bjhp->bihp", sc, xc)
             + torch.exp(csum)[..., None]
             * torch.einsum("bihn,bhpn->bihp", ch_, _bf16(run))
             + dd[:, None, :, None] * xc)
        ys.append(y.bfloat16())
        run = torch.exp(total)[..., None, None] * run + own
    return torch.cat(ys, dim=1), run


def _errs(y, st, ry, rst):
    ey = (y.float() - ry.float()).abs().max().item()
    es = (st - rst).abs().max().item()
    return (ey, Y_REL * ry.float().abs().max().item(),
            es, STATE_REL * rst.abs().max().item())


def _plain(x, dt, a, bm, cm, dd, chunk):
    """The port's plain version on the bf16 tensors the card gets."""
    return SS.ssd_scan_plain(x.bfloat16(), dt, a, bm.bfloat16(),
                             cm.bfloat16(), dd, chunk=chunk)


@pytest.mark.parametrize("sh,s", [(SERVING, 17), (SERVING, 300),
                                  (SERVING, 512), (OFF_PATH, 300),
                                  (OFF_PATH, 233)])
def test_emulation_within_the_card_tolerances_of_the_plain_version(sh, s):
    args = inputs(s, s, sh)
    y, st = emulate(*args, chunk=sh["chunk"])
    ry, rst = _plain(*args, sh["chunk"])
    assert y.shape == ry.shape and st.shape == rst.shape
    ey, ty, es, ts = _errs(y, st, ry, rst)
    assert ey <= ty, (ey, ty)
    assert es <= ts, (es, ts)


@pytest.mark.parametrize("sh,s", [(SERVING, 512), (OFF_PATH, 200)])
def test_emulation_within_the_card_tolerances_of_the_oracle(sh, s):
    """Against kernels/ref.py::ssd_scan_ref, the TPU kernel's oracle (one
    stream at a time; S a multiple of the chunk, as it wants), on the
    first and the last stream of the last group."""
    args = inputs(s + 1, s, sh)
    x, dt, a, bm, cm, dd = args
    y, _ = emulate(*args, chunk=sh["chunk"])
    h, g = sh["h"], sh["g"]
    for b, hh in ((0, 0), (sh["bt"] - 1, h - 1)):
        gi = hh // (h // g)
        ro = REF.ssd_scan_ref(jnp.asarray(x[b, :, hh].numpy()),
                              jnp.asarray(dt[b, :, hh].numpy()),
                              jnp.asarray(a[b, hh].numpy()),
                              jnp.asarray(bm[b, :, gi].numpy()),
                              jnp.asarray(cm[b, :, gi].numpy()),
                              jnp.asarray(dd[b, hh].numpy()),
                              chunk=sh["chunk"])
        ro = torch.from_numpy(np.array(ro)).bfloat16().float()
        err = (y[b, :, hh].float() - ro).abs().max().item()
        assert err <= Y_REL * ro.abs().max().item(), err


def test_one_bf16_rounding_of_the_state_operand_misses_the_gate():
    """Why the state product takes two: bf16(w x) alone is ~2^-9 a term,
    far outside 2e-5 x max|state|; the split is inside it."""
    args = inputs(300, 300, SERVING)
    ry, rst = _plain(*args, SERVING["chunk"])
    _, st1 = emulate(*args, chunk=SERVING["chunk"], split=False)
    _, st2 = emulate(*args, chunk=SERVING["chunk"])
    tol = STATE_REL * rst.abs().max().item()
    assert (st1 - rst).abs().max().item() > 4 * tol
    assert (st2 - rst).abs().max().item() <= tol


def test_scratch_shapes_and_bf16_refusals():
    # scores over the chunk rounded up to 64 rows; one state and one
    # (cumsum, dt) pair of 256-row vectors per (stream, chunk)
    assert SS.scratch_shapes(2, 300, 16, 64, 1, 128, 256) == (
        (2, 2, 1, 256, 256), (2, 16, 2, 64, 128), (2, 16, 2, 2, 256))
    assert SS.scratch_shapes(2, 300, 16, 32, 4, 64, 100) == (
        (2, 3, 4, 128, 128), (2, 16, 3, 32, 64), (2, 16, 3, 2, 256))
    x, dt, a, bm, cm, dd = (t.bfloat16() if i in (0, 3, 4) else t
                            for i, t in enumerate(inputs(1, 8, dict(
                                SERVING, p=48, n=128))))
    with pytest.raises(ValueError, match="bf16 wants"):
        SS.ssd_scan(x, dt, a, bm, cm, dd, chunk=8)
    # the same shape in fp32 goes to the CUDA-core kernel: accepted
    SS.ssd_scan(x.float(), dt, a, bm.float(), cm.float(), dd, chunk=8)
    x, dt, a, bm, cm, dd = inputs(1, 8, dict(SERVING, n=144))
    with pytest.raises(ValueError, match="bf16 wants"):
        SS.ssd_scan(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(), dd,
                    chunk=8)
