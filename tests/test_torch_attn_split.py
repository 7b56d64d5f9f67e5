"""The arithmetic of the two redesigned attention kernels, on the CPU.

Paged decode (C = 1) runs on the card as a split kernel (each block
attends one span of DECODE_KEYS_PER_SPLIT logical keys and writes a
partial (acc, m, l)) and a combine kernel (rescales the partials by
exp(m_i - M) and divides by the rescaled l).  Here the split planning is
checked against a brute-force count, and a plain emulation of that split
+ combine arithmetic (the same partition, the same empty-split
convention, the same combine formula) is held against the port's plain
version (fp32, 2e-6) and against the reference's Pallas kernel in
interpret mode and its oracle (2e-5), on split edges, -1 holes, a row of
-1, ragged tables, g in {1, 3, 5}, D in {16, 64, 128} and the
shard-stacked strided pool view.

Flash prefill runs bf16 on the tensor cores and rounds the probabilities
P to bf16 before P V.  A CPU emulation of that rounding at the serving
shape q (18, 512, 64) shows it stays inside the card tolerance,
2^-7 x max|ref|.  The kernels themselves are held against the plain
versions on the GPU by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS, ref as REF  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

KS = FA.DECODE_KEYS_PER_SPLIT
# the emulation and the plain version differ only in the order of fp32
# sums (per split, then across splits)
PLAIN_ATOL = 2e-6
# the reference sums in its own order again (TPU kernel page by page)
REF_ATOL = 2e-5
EMPTY_M = -1e30                        # an empty partial: m, l = 0, acc 0


# ---------------------------------------------------------------------------
# Split planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ps,ks", [(32, 16, 64), (1, 16, 64), (5, 8, 64),
                                     (7, 16, 64), (3, 1, 64), (9, 16, 32),
                                     (64, 16, 64)])
def test_plan_decode_splits_matches_a_brute_force_count(n, ps, ks):
    """n_splits is the number of distinct key // ks over the table's keys,
    and the scratch holds one (acc[d], m, l) per (row, kv head, split,
    query head)."""
    spans = {key // ks for key in range(n * ps)}
    n_splits, shape = FA.plan_decode_splits(n, ps, rows=8, hkv=3, g=3, d=64,
                                            ks=ks)
    assert n_splits == len(spans) == max(spans) + 1
    assert shape == (8, 3, n_splits, 3, 66)
    if ks == KS:
        assert FA.plan_decode_splits(n, ps, rows=8, hkv=3, g=3,
                                     d=64) == (n_splits, shape)


# ---------------------------------------------------------------------------
# Split + combine, emulated
# ---------------------------------------------------------------------------

def split_combine(q, kp, vp, table, pos, *, ks=KS):
    """Plain emulation of the decode kernels' arithmetic: q (B, 1, Hq, D),
    pools (P+1, ps, Hkv, D), table (B, n) with -1 holes, pos (B,).  fp32."""
    b, c, hq, d = q.shape
    assert c == 1
    ps, hkv = kp.shape[1], kp.shape[2]
    n = table.shape[1]
    g = hq // hkv
    scale = d ** -0.5
    n_splits, shape = FA.plan_decode_splits(n, ps, rows=b, hkv=hkv, g=g, d=d,
                                            ks=ks)
    part = torch.zeros(shape)
    part[..., d] = EMPTY_M
    for r in range(b):
        for sp in range(n_splits):
            lo = sp * ks
            hi = min(lo + ks, n * ps, int(pos[r]) + 1)
            keys = [t for t in range(lo, hi) if table[r, t // ps] >= 0]
            if not keys:               # past pos, or pages all -1
                continue
            phys = torch.tensor([int(table[r, t // ps]) for t in keys])
            off = torch.tensor([t % ps for t in keys])
            for h in range(hkv):
                kk, vv = kp[phys, off, h].float(), vp[phys, off, h].float()
                s = q[r, 0, h * g:(h + 1) * g].float() @ kk.T * scale
                m = s.max(dim=-1).values
                p = torch.exp(s - m[:, None])
                part[r, h, sp, :, :d] = p @ vv
                part[r, h, sp, :, d] = m
                part[r, h, sp, :, d + 1] = p.sum(dim=-1)
    mm = part[..., d].max(dim=2, keepdim=True).values  # (B, Hkv, 1, g)
    w = torch.exp(part[..., d] - mm)
    acc = (w[..., None] * part[..., :d]).sum(dim=2)
    den = (w * part[..., d + 1]).sum(dim=2)
    out = acc / torch.clamp(den, min=1e-20)[..., None]  # (B, Hkv, g, D)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _decode_case(seed, *, b=4, hkv=2, g=3, d=64, ps=16, n=8, pos=None,
                 holes=(), empty_row=None):
    """Distinct physical pages per row up to pos, then -1; `holes` (row,
    page) and `empty_row` set to -1 as well."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(pos if pos is not None else
                     rng.integers(0, n * ps, b), np.int32)
    own = [min(n, int(p) // ps + 1) for p in pos]
    phys = sum(own) + 2
    perm = rng.permutation(phys)
    table = np.full((b, n), -1, np.int32)
    nxt = 0
    for r in range(b):
        if r != empty_row:
            table[r, :own[r]] = perm[nxt:nxt + own[r]]
            nxt += own[r]
    for r, j in holes:
        table[r, j] = -1
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((phys + 1, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((phys + 1, ps, hkv, d)).astype(np.float32)
    return q, kp, vp, table, pos


DECODE_CASES = {
    # pos on split edges (KS = 64): the last key of a split, the first of
    # the next, and one past two whole splits
    "split_edges": dict(b=4, pos=(63, 64, 127, 128)),
    # -1 holes in the middle of tables, one covering a whole split
    "holes": dict(pos=(100, 127, 40, 90), holes=((0, 2), (1, 4), (1, 5),
                                                 (1, 6), (1, 7), (3, 1))),
    "empty_row": dict(pos=(30, 127, 5, 70), empty_row=2),
    # n * ps = 5 * 16 = 80: the last split is ragged
    "ragged_table": dict(n=5, pos=(79, 64, 10, 33)),
    "ps8_ragged": dict(n=9, ps=8, pos=(71, 0, 65, 40)),
    "g1_d16": dict(g=1, d=16, hkv=4, pos=(3, 64, 120, 127)),
    "g5_d128": dict(g=5, d=128, hkv=1, pos=(127, 50, 64, 100)),
    "g3_d64_full": dict(g=3, hkv=3, n=16, pos=(255, 200, 128, 63)),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_split_combine_matches_plain_pallas_and_oracle(name):
    q, kp, vp, table, pos = _decode_case(7, **DECODE_CASES[name])
    t = [torch.from_numpy(np.asarray(a)) for a in (q, kp, vp, table, pos)]
    emu = split_combine(*t).numpy()
    plain = FA.paged_flash_attention_plain(*t).numpy()
    j = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    kern = np.asarray(ROPS.paged_attention(*j, interpret=True))
    oracle = np.asarray(REF.paged_attention_ref(*j))
    np.testing.assert_allclose(emu, plain, atol=PLAIN_ATOL, rtol=0)
    np.testing.assert_allclose(emu, oracle, atol=REF_ATOL, rtol=0)
    np.testing.assert_allclose(emu, kern, atol=REF_ATOL, rtol=0)
    empty = DECODE_CASES[name].get("empty_row")
    if empty is not None:
        assert not emu[empty].any()    # exactly 0, not NaN


def test_split_combine_on_the_shard_stacked_strided_view():
    """One layer of a (tp, layers, P+1, ps, Hkv, D) leaf, read in place:
    the emulation per shard equals the wrapper's stacked plain path."""
    q, kp, vp, table, pos = _decode_case(11, pos=(63, 64, 127, 20),
                                         holes=((2, 3),))
    rng = np.random.default_rng(12)
    tp, layers = 2, 3
    kleaf = torch.from_numpy(rng.standard_normal(
        (tp, layers) + kp.shape).astype(np.float32))
    vleaf = torch.from_numpy(rng.standard_normal(
        (tp, layers) + vp.shape).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal(
        (tp,) + q.shape).astype(np.float32))
    kv, vv = kleaf[:, 1], vleaf[:, 1]
    assert not kv.is_contiguous()
    tt, pt = torch.from_numpy(table), torch.from_numpy(pos)
    out = FA.paged_flash_attention(qs, kv, vv, tt, pt)
    for s in range(tp):
        np.testing.assert_allclose(
            split_combine(qs[s], kv[s], vv[s], tt, pt).numpy(),
            out[s].numpy(), atol=PLAIN_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Flash prefill: P rounded to bf16 before P V
# ---------------------------------------------------------------------------

def flash_bf16_emulation(q, k, v, *, tile=64):
    """The tensor-core kernel's arithmetic in plain PyTorch: 64-key tiles,
    online softmax in fp32 (base 2, the scale folded into log2 e), P
    rounded to bf16 for the P V product, l summed from the unrounded P,
    fp32 accumulation, output rounded to bf16 once."""
    bh, s, d = q.shape
    g = bh // k.shape[0]
    kf = k.repeat_interleave(g, dim=0).float()
    vf = v.repeat_interleave(g, dim=0).float()
    qf = q.float()
    scale_log2 = d ** -0.5 * 1.4426950408889634
    qi = torch.arange(s)[:, None]
    m = torch.full((bh, s), float("-inf"))
    l = torch.zeros(bh, s)
    acc = torch.zeros(bh, s, d)
    for t in range(0, s, tile):
        keys = torch.arange(t, min(t + tile, s))[None]
        x = qf @ kf[:, t:t + tile].transpose(1, 2) * scale_log2
        x = torch.where(keys <= qi, x, torch.full_like(x, float("-inf")))
        m_new = torch.maximum(m, x.max(dim=-1).values)
        m_use = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                            m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.bfloat16().float() @ vf[:, t:t + tile]
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)[..., None]).bfloat16()


def test_flash_bf16_p_rounding_stays_inside_the_card_tolerance():
    """At the serving shape q (18, 512, 64), kv (6, 512, 64), bf16: the
    kernel's bf16 P against the plain version (fp32 softmax, one bf16
    rounding of the output) stays within 2^-7 x max|ref|, the tolerance
    chip_smoke.py holds the kernel to on the card."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16() for shape in ((18, 512, 64), (6, 512, 64),
                                               (6, 512, 64)))
    ref = FA.flash_attention_plain(q, k, v).float()
    emu = flash_bf16_emulation(q, k, v).float()
    err = (emu - ref).abs().max().item()
    tol = 2.0 ** -7 * ref.abs().max().item()
    assert 0 < err <= tol, (err, tol)
    # the first query sees one key: exact in both
    np.testing.assert_array_equal(emu[:, 0].numpy(), ref[:, 0].numpy())


# ---------------------------------------------------------------------------
# Wrappers on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_and_bf16_cpu_calls_never_build_or_count(dtype):
    """CPU tensors take the plain versions: a decode step (C = 1, stacked
    or not) and a bf16 prefill build nothing and count no launch."""
    before = (FA.paged_flash_attention.launches,
              FA.flash_attention_bhsd.launches)
    q, kp, vp, table, pos = _decode_case(3, pos=(63, 64, 127, 128))
    t = [torch.from_numpy(np.asarray(a)) for a in (q, kp, vp, table, pos)]
    q, kp, vp = (x.to(dtype) for x in t[:3])
    ops.paged_attention(q, kp, vp, t[3], t[4])
    ops.paged_attention(q[None], kp[None], vp[None], t[3], t[4])
    ops.flash_attention(*(torch.randn(1, 70, 2, 16).to(dtype)
                          for _ in range(3)))
    assert (FA.paged_flash_attention.launches,
            FA.flash_attention_bhsd.launches) == before
    assert "paged_attention" not in build._LIBS
    assert "flash_attention" not in build._LIBS


def test_alignment_check_raises_on_what_16_byte_loads_cannot_read():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    FA.check_aligned(x, strides=((x, x.stride(0)),))
    with pytest.raises(ValueError, match="16-byte aligned"):
        FA.check_aligned(x.view(-1)[1:])
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        FA.check_aligned(x, strides=((x, 12),))
