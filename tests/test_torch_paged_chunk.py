"""The arithmetic of the paged chunk kernel (B2 at C > 1), on the CPU.

A bf16 chunk call runs on the card as one tensor-core kernel: a cluster
of blocks per (row, kv head, tile of CHUNK_QUERY_ROWS packed query rows),
the g*C rows that share a kv head packed as x -> (chunk row x // g, q
head h*g + x % g).  The table's key tiles (CHUNK_KEYS_PER_TILE logical
keys) are split over the cluster's blocks (`plan_chunk_splits`, which
mirrors the kernel's launch: it plans from the table's width); each
block's key loop stops at the tile's last row's position, gathers its
tiles through the page table, skips a tile whose keys are all invisible
or on -1 pages, and masks only the tiles that need it; when more than
one block has keys, every block merges a slice of the rows from all the
partials.  Here a numpy emulation of that plan is checked against a
brute-force count of what each query row sees; the plan's arithmetic
(online softmax per key tile in exp2, partials merged with exp2 weights)
is held against the port's plain version; an emulation of the kernel's
bf16 rounding of P stays inside the card tolerance; the plain version is
held against the reference's Pallas kernel in interpret mode and its
oracle at C in {2, 8, 32}, unaligned positions, -1 holes and a masked
row; and CPU calls never build a kernel or count a launch.  The kernel
itself is held against the plain version on the GPU by chip_smoke.py."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS, ref as REF  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

CQ, CK = FA.CHUNK_QUERY_ROWS, FA.CHUNK_KEYS_PER_TILE
WARP_ROWS = 16                         # packed rows per warp (mma rows)
LOG2E = 1.4426950408889634
# the emulation and the plain version differ only in the order of fp32
# sums (per key tile) and exp2(x log2 e) for exp(x)
PLAIN_ATOL = 2e-6
# the plain version against the reference's kernel (online, page by page)
# and its oracle (one-shot, the same formula): fp32 reordering only
REF_ATOL = 1e-5


def _chunk_case(seed, *, c, pos, b=4, hkv=2, g=3, d=64, ps=16, n=20,
                holes=(), masked=None, live=None):
    """q (B, C, Hq, D) and pools (P+1, ps, Hkv, D) of N(0, 1) fp32, a
    table of distinct physical pages per row up to pos + C (within the
    table's n pages), then -1; `holes` (row, page), `masked` and the rows
    outside `live` are set to -1."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(pos, np.int32)
    own = [min(n, -(-(int(p) + c) // ps)) for p in pos]
    phys = sum(own) + 2
    perm = rng.permutation(phys)
    table = np.full((b, n), -1, np.int32)
    nxt = 0
    for r in range(b):
        if r != masked and (live is None or r in live):
            table[r, :own[r]] = perm[nxt:nxt + own[r]]
            nxt += own[r]
    for r, j in holes:
        table[r, j] = -1
    q = rng.standard_normal((b, c, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((phys + 1, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((phys + 1, ps, hkv, d)).astype(np.float32)
    return q, kp, vp, table, pos


CHUNK_CASES = {
    # positions off the 16-key pages, every row live
    "c2_unaligned": dict(c=2, pos=(250, 3, 117, 37)),
    "c8_unaligned": dict(c=8, pos=(250, 3, 117, 250)),
    "c32_unaligned": dict(c=32, pos=(250, 3, 117, 250)),
    # -1 holes; pages 4-7 of row 0 are a whole 64-key tile
    "c32_holes": dict(c=32, pos=(250, 3, 117, 250),
                      holes=((2, 5), (3, 10), (0, 4), (0, 5), (0, 6),
                             (0, 7))),
    "c32_masked_row": dict(c=32, pos=(250, 3, 117, 250), masked=1),
    # the warm suffix prefill: one live row at a page multiple
    "c32_warm": dict(c=32, pos=(0, 0, 256, 0), live=(2,)),
    # a 64-page table: 16 key tiles over 8 splits, 2 each, so a split's
    # ring runs past its first tile; pages 28-31 of row 0 (tile 7, the
    # second of split 3) are -1
    "c8_wide_tps2": dict(c=8, n=64, pos=(1001, 250, 3, 700),
                         holes=((0, 28), (0, 29), (0, 30), (0, 31))),
    # rows past the table's width (320 keys) see up to its end
    "c8_past_width": dict(c=8, pos=(316, 5, 318, 100)),
    # no GQA, small pages, D 16; and g 5, pages of 5 (a key tile spans
    # part-pages), D 128
    "c8_ps8_g1_d16": dict(c=8, ps=8, g=1, hkv=4, d=16, pos=(61, 0, 77, 120)),
    "c2_ps5_g5_d128": dict(c=2, ps=5, g=5, hkv=1, d=128,
                           pos=(64, 63, 9, 90)),
}


# ---------------------------------------------------------------------------
# The tile plan, emulated
# ---------------------------------------------------------------------------

def plan_chunk_splits(n, ps):
    """The kernel's split of a bf16 chunk call's key tiles, as its
    launcher computes it: clusters of n_splits blocks per query tile,
    block s walking key tiles [s * tps, (s + 1) * tps) of the table's
    ceil(n*ps / CK), from the table's width alone."""
    tiles = -(-n * ps // CK)
    n_splits = min(FA.CHUNK_MAX_SPLITS, tiles)
    return n_splits, -(-tiles // n_splits)


def chunk_plan(c, g, pos, trow, ps):
    """The bf16 chunk kernel's plan for one (row, kv head): its query
    tiles, longest first, each with its packed rows (chunk row, head in
    the group, position; -1 for padding past g*C), the number of keys its
    loops walk, its splits (each block's key tiles, and the rows it
    merges when more than one has keys), and per key tile the visibility
    bits as the kernel publishes them (the key lies before the tile's last
    visible key and its page is not -1), whether the tile is skipped
    whole, and which warps apply the masks."""
    rows = g * c
    width = len(trow) * ps
    ns, tps = plan_chunk_splits(len(trow), ps)
    plan = []
    for qt in reversed(range(-(-rows // CQ))):
        x0 = qt * CQ
        x = np.arange(x0, x0 + CQ)
        last = min(x0 + CQ, rows) - 1
        n_keys = min(width, pos + last // g + 1)
        n_tiles = -(-n_keys // CK)
        n_active = -(-n_tiles // tps)
        rb = -(-CQ // ns)
        splits = [dict(tiles=range(s * tps, min(n_tiles, (s + 1) * tps)),
                       merges=range(s * rb, min(CQ, (s + 1) * rb)))
                  for s in range(ns)]
        tiles = []
        for t in range(n_tiles):
            keys = np.arange(t * CK, (t + 1) * CK)
            ent = np.where(keys < n_keys,
                           trow[np.minimum(keys, width - 1) // ps], -1)
            bits = (ent >= 0) & (keys < n_keys)
            need = [not bits.all()
                    or t * CK + CK - 1 > pos + (x0 + w * WARP_ROWS) // g
                    for w in range(CQ // WARP_ROWS)]
            tiles.append(dict(k0=t * CK, bits=bits, ent=ent,
                              skip=not bits.any(), need=need))
        plan.append(dict(x0=x0, live=x < rows, chunk_row=x // g,
                         head=x % g, qpos=np.where(x < rows, pos + x // g, -1),
                         n_keys=n_keys, tiles=tiles, splits=splits,
                         n_active=n_active))
    return plan


def _visible(table, pos, r, ci, ps):
    """Brute force: the logical keys chunk row ci of slot r sees."""
    width = table.shape[1] * ps
    return {k for k in range(width)
            if k <= pos[r] + ci and table[r, k // ps] >= 0}


@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_chunk_tile_plan_matches_brute_force(name):
    """Every (chunk row, q head) of a kv head is one packed row of one
    tile; a tile's loops reach every key its rows see and stop at the
    last of them; its key tiles go to the splits of its cluster (at most
    CHUNK_MAX_SPLITS) once each, the splits with keys are the first
    n_active, and each of the tile's rows is merged by one split; the
    kernel's mask (published bits and position) is exactly the oracle's
    visibility; skipped tiles are those no row sees a key of; and a warp
    that skips the masks sees every key of the tile."""
    case = CHUNK_CASES[name]
    q, kp, vp, table, pos = _chunk_case(0, **case)
    b, c, hq, _ = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    g = hq // hkv
    for r in range(b):
        plan = chunk_plan(c, g, int(pos[r]), table[r], ps)
        assert [t["x0"] for t in plan] == sorted(
            (t["x0"] for t in plan), reverse=True)     # longest first
        packed = [(int(t["chunk_row"][i]), int(t["head"][i]))
                  for t in plan for i in np.flatnonzero(t["live"])]
        assert sorted(packed) == [(ci, j) for ci in range(c)
                                  for j in range(g)]
        for tile in plan:
            live = np.flatnonzero(tile["live"])
            seen = [_visible(table, pos, r, int(tile["chunk_row"][i]), ps)
                    for i in live]
            union = set().union(*seen)
            causal_last = min(table.shape[1] * ps - 1,
                              int(pos[r]) + int(tile["chunk_row"][live[-1]]))
            assert tile["n_keys"] == causal_last + 1
            assert all(k < tile["n_keys"] for k in union)
            splits = tile["splits"]
            assert 1 <= len(splits) <= FA.CHUNK_MAX_SPLITS
            assert sorted(t for sp in splits for t in sp["tiles"]) == list(
                range(len(tile["tiles"])))
            assert [bool(sp["tiles"]) for sp in splits] == [
                s < tile["n_active"] for s in range(len(splits))]
            assert sorted(x for sp in splits for x in sp["merges"]) == list(
                range(CQ))
            walked = set()
            for kt in tile["tiles"]:
                keys = kt["k0"] + np.arange(CK)
                in_tile = {int(k) for k in keys} & union
                assert kt["skip"] == (not in_tile)
                assert {int(k) for k in keys[kt["bits"]]} == in_tile
                for i, vis in zip(live, seen):
                    mask = kt["bits"] & (keys <= tile["qpos"][i])
                    assert {int(k) for k in keys[mask]} == vis & in_tile
                    if not kt["need"][i // WARP_ROWS]:
                        assert mask.all()
                if not kt["skip"]:
                    walked |= in_tile
            assert walked == union


def chunk_emulation(q, kp, vp, table, pos, *, bf16_p=False):
    """The chunk kernel's arithmetic in plain PyTorch, following
    `chunk_plan`: per query tile and split, key tiles gathered through the
    table (zero rows for -1 pages), skipped tiles left out, online softmax
    in fp32 with exp2 and the scale folded into log2 e, P rounded to bf16
    for P V when `bf16_p` (l from the unrounded P); the splits' partials
    merged with weights exp2(m_s - max m) when more than one has keys; O
    times 1 / max(l, 1e-20), rounded to q's dtype once."""
    b, c, hq, d = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    g = hq // hkv
    scale_log2 = d ** -0.5 * LOG2E
    out = torch.zeros(b, c, hq, d)
    for r in range(b):
        for h in range(hkv):
            for tile in chunk_plan(c, g, int(pos[r]), table[r].numpy(), ps):
                live = np.flatnonzero(tile["live"])
                ci = torch.from_numpy(tile["chunk_row"][live])
                qh = torch.from_numpy(h * g + tile["head"][live])
                qpos = torch.from_numpy(tile["qpos"][live])
                qt = q[r, ci, qh].float()
                m = torch.full((len(live),), float("-inf"))
                l = torch.zeros(len(live))
                acc = torch.zeros(len(live), d)
                parts = []
                for sp in tile["splits"][:tile["n_active"]]:
                    m = torch.full((len(live),), float("-inf"))
                    l = torch.zeros(len(live))
                    acc = torch.zeros(len(live), d)
                    for t in sp["tiles"]:
                        kt = tile["tiles"][t]
                        if kt["skip"]:
                            continue
                        keys = torch.arange(kt["k0"], kt["k0"] + CK)
                        bits = torch.from_numpy(kt["bits"])
                        phys = torch.from_numpy(
                            np.maximum(kt["ent"], 0)).long()
                        kk = kp[phys, keys % ps, h].float() * bits[:, None]
                        vv = vp[phys, keys % ps, h].float() * bits[:, None]
                        x = qt @ kk.T * scale_log2
                        vis = bits[None] & (keys[None] <= qpos[:, None])
                        x = torch.where(vis, x,
                                        torch.full_like(x, float("-inf")))
                        m_new = torch.maximum(m, x.max(dim=-1).values)
                        m_use = torch.where(m_new == float("-inf"),
                                            torch.zeros_like(m_new), m_new)
                        corr = torch.exp2(m - m_use)
                        p = torch.exp2(x - m_use[:, None])
                        l = l * corr + p.sum(dim=-1)
                        pv = p.bfloat16().float() if bf16_p else p
                        acc = acc * corr[:, None] + pv @ vv
                        m = m_new
                    parts.append((m, l, acc))
                if len(parts) == 1:
                    acc, l = parts[0][2], parts[0][1]
                else:                  # the cluster's merge
                    mx = torch.stack([pm for pm, _, _ in parts]).amax(dim=0)
                    m_use = torch.where(mx == float("-inf"),
                                        torch.zeros_like(mx), mx)
                    w = [torch.exp2(pm - m_use) for pm, _, _ in parts]
                    l = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
                    acc = sum(wi[:, None] * pa
                              for wi, (_, _, pa) in zip(w, parts))
                out[r, ci, qh] = acc * (1 / torch.clamp(l, min=1e-20))[:, None]
    return out.to(q.dtype)


def _tensors(case):
    return [torch.from_numpy(np.asarray(a)) for a in case]


@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_chunk_emulation_matches_plain(name):
    """The plan's arithmetic in fp32 equals the port's plain version; a
    masked row (or a row outside a warm admission) is exactly 0."""
    q, kp, vp, table, pos = _tensors(_chunk_case(1, **CHUNK_CASES[name]))
    emu = chunk_emulation(q, kp, vp, table, pos).numpy()
    plain = FA.paged_flash_attention_plain(q, kp, vp, table, pos).numpy()
    np.testing.assert_allclose(emu, plain, atol=PLAIN_ATOL, rtol=0)
    for r in range(q.shape[0]):
        if (table[r] < 0).all():
            assert not emu[r].any() and not plain[r].any()


# ---------------------------------------------------------------------------
# P rounded to bf16 before P V
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["c32_warm", "c32_holes"])
def test_chunk_bf16_p_rounding_stays_inside_the_card_tolerance(name):
    """At the warm suffix prefill's shape (C = 32 after a 256-key prefix,
    Hq 9 / Hkv 3, D 64, bf16) and with holes at unaligned positions: the
    kernel's bf16 P against the plain version (fp32 softmax, one bf16
    rounding of the output) stays within 2^-7 x max|ref|, the tolerance
    chip_smoke.py holds the kernel to on the card."""
    case = dict(CHUNK_CASES[name], hkv=3, g=3, n=32)
    q, kp, vp, table, pos = _tensors(_chunk_case(5, **case))
    q, kp, vp = (x.bfloat16() for x in (q, kp, vp))
    ref = FA.paged_flash_attention_plain(q, kp, vp, table, pos).float()
    emu = chunk_emulation(q, kp, vp, table, pos, bf16_p=True).float()
    err = (emu - ref).abs().max().item()
    tol = 2.0 ** -7 * ref.abs().max().item()
    assert 0 < err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# The plain version against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_plain_chunk_matches_pallas_interpret_and_oracle(name):
    case = _chunk_case(2, **CHUNK_CASES[name])
    plain = FA.paged_flash_attention_plain(*_tensors(case)).numpy()
    j = [jnp.asarray(a) for a in case]
    kern = np.asarray(ROPS.paged_attention(*j, interpret=True))
    oracle = np.asarray(REF.paged_attention_ref(*j))
    np.testing.assert_allclose(plain, oracle, atol=REF_ATOL, rtol=0)
    np.testing.assert_allclose(plain, kern, atol=REF_ATOL, rtol=0)


def test_stacked_strided_chunk_matches_oracle_per_shard():
    """One layer of a (tp, layers, P+1, ps, Hkv, D) leaf, read in place by
    the wrapper's stacked form at C = 8: each shard equals the oracle."""
    q, kp, vp, table, pos = _chunk_case(3, **CHUNK_CASES["c8_unaligned"])
    rng = np.random.default_rng(4)
    tp, layers = 2, 3
    kleaf, vleaf = (rng.standard_normal((tp, layers) + kp.shape).astype(
        np.float32) for _ in range(2))
    qs = rng.standard_normal((tp,) + q.shape).astype(np.float32)
    kv, vv = torch.from_numpy(kleaf)[:, 1], torch.from_numpy(vleaf)[:, 1]
    assert not kv.is_contiguous()
    out = FA.paged_flash_attention(torch.from_numpy(qs), kv, vv,
                                   torch.from_numpy(table),
                                   torch.from_numpy(pos))
    for s in range(tp):
        oracle = np.asarray(REF.paged_attention_ref(
            jnp.asarray(qs[s]), jnp.asarray(kleaf[s, 1]),
            jnp.asarray(vleaf[s, 1]), jnp.asarray(table), jnp.asarray(pos)))
        np.testing.assert_allclose(out[s].numpy(), oracle, atol=REF_ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# Wrappers on the CPU, and the plan's constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_cpu_calls_never_build_or_count(dtype):
    """CPU tensors take the plain version: chunk calls (C > 1, stacked or
    not, through ops and the wrapper) build nothing and count nothing."""
    before = (FA.paged_flash_attention.launches,
              FA.paged_flash_attention.chunk_launches)
    q, kp, vp, table, pos = _tensors(_chunk_case(
        6, **CHUNK_CASES["c32_holes"]))
    q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
    ops.paged_attention(q, kp, vp, table, pos)
    FA.paged_flash_attention(q[None], kp[None], vp[None], table, pos)
    assert (FA.paged_flash_attention.launches,
            FA.paged_flash_attention.chunk_launches) == before
    assert "paged_attention" not in build._LIBS


def test_plan_constants_match_the_kernel_source():
    """The emulated plan's tile sizes and split bound are the CUDA
    kernel's CQ, CK and CMAX_SPLITS, and its launcher's split is
    `plan_chunk_splits`'s."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    const = dict(re.findall(r"constexpr int (CQ|CK|CMAX_SPLITS) = (\d+);",
                            src))
    assert (int(const["CQ"]), int(const["CK"]), int(const["CMAX_SPLITS"])) \
        == (CQ, CK, FA.CHUNK_MAX_SPLITS)
    assert CQ % WARP_ROWS == 0
    assert src.count("const int n_splits = min(CMAX_SPLITS, (n * ps + CK - "
                     "1) / CK);") == 1


@pytest.mark.parametrize("n,ps", [(32, 16), (20, 16), (1, 16), (20, 5),
                                  (256, 16), (3, 1)])
def test_plan_chunk_splits_covers_the_table_once(n, ps):
    """n_splits blocks of tps key tiles cover the table's key tiles, at
    most CHUNK_MAX_SPLITS of them, and no block is left without a tile of
    the table."""
    tiles = -(-n * ps // CK)
    ns, tps = plan_chunk_splits(n, ps)
    assert ns == min(FA.CHUNK_MAX_SPLITS, tiles)
    assert (ns - 1) * tps < tiles <= ns * tps
