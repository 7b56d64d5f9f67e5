"""PyTorch port's paged-cache pieces on the CPU, each against the live JAX
reference on the same numpy inputs: the PagePool bookkeeping under seeded
random operation sequences, the prefix digests, the paged attention plain
version (against the reference's Pallas kernel in interpret mode and its
oracle), the shard-stacked wrapper form on a strided pool view, the
plain gather path, the in-place page scatters, and the paged wrapper's
argument checks (which run without a card).  The CUDA kernel itself is
held against the plain version on the GPU by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS, ref as REF  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.runtime import paging as RP  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.runtime import paging as P  # noqa: E402
from torch_parity import elsewhere, one_torch_thread  # noqa: E402,F401

# fp32 online softmax (Pallas, page by page) vs one-shot softmax (plain):
# the two orders of summation agree to ~1e-6 on N(0,1) inputs
PAGED_ATOL = 2e-5


# ---------------------------------------------------------------------------
# PagePool: identical bookkeeping under identical operation sequences
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.table.tolist(), pool.owned.tolist(), pool.refs.tolist(),
            list(pool.free), list(pool.cached), dict(pool.page_hash),
            dict(pool.prefix_index), int(pool.high_water), pool.num_free)


def _apply(pool, op, args):
    """Run one operation; returns its result or the exception type."""
    try:
        if op == "share":
            slot, toks = args
            cap = (len(toks) - 1) // pool.page_size
            pages = pool.match_prefix(toks[:cap * pool.page_size])
            pool.share_prefix(slot, pages)
            return pages
        return getattr(pool, op)(*args)
    except RuntimeError as e:            # COW on a full pool
        return type(e).__name__


@pytest.mark.parametrize("seed", range(6))
def test_pool_random_ops_match_reference(seed):
    """Seeded grow / shrink / release / share / register /
    ensure_writable sequences through both pools: every return value and
    the whole state (table, owned, refs, free list, cached LRU, prefix
    index) stay identical, and both pass check()."""
    rng = np.random.default_rng(seed)
    ps, slots, pps = int(rng.choice([2, 4])), 4, 5
    num_pages = int(rng.integers(6, 14))
    ref = RP.PagePool(num_pages=num_pages, page_size=ps, max_slots=slots,
                      pages_per_slot=pps)
    port = P.PagePool(num_pages=num_pages, page_size=ps, max_slots=slots,
                      pages_per_slot=pps)
    # a few prompts that share prefixes, so matches and hits happen
    base = rng.integers(0, 50, pps * ps + 3)
    prompts = [base[:int(rng.integers(2, pps * ps + 1))] for _ in range(3)]
    prompts += [rng.integers(0, 50, int(rng.integers(2, pps * ps + 1)))
                for _ in range(2)]
    ops_seen = set()
    for _ in range(120):
        op = str(rng.choice(["grow", "grow", "shrink", "release", "share",
                             "register_prefix", "ensure_writable"]))
        slot = int(rng.integers(slots))
        own = int(ref.owned[slot])
        if op == "grow":
            args = (slot, int(rng.integers(0, pps * ps + ps)))
        elif op == "shrink":
            args = (slot, int(rng.integers(0, pps * ps)))
        elif op == "release":
            args = (slot,)
        elif op == "share":
            if own:
                continue
            args = (slot, prompts[int(rng.integers(len(prompts)))])
        elif op == "register_prefix":
            if not own:
                continue
            args = (slot, prompts[int(rng.integers(len(prompts)))])
        else:
            if not own:
                continue
            args = (slot, int(rng.integers(own)))
        ops_seen.add(op)
        assert _apply(port, op, args) == _apply(ref, op, args), (op, args)
        assert _pool_state(port) == _pool_state(ref), (op, args)
        port.check()
        ref.check()
    assert len(ops_seen) >= 5, ops_seen


@pytest.mark.parametrize("ps", [1, 4, 16])
def test_page_hashes_match_reference(ps):
    rng = np.random.default_rng(ps)
    for n in (0, ps - 1, ps, 3 * ps + 1, 200):
        toks = rng.integers(0, 49152, max(n, 0))
        assert P.page_hashes(toks, ps) == RP.page_hashes(toks, ps)
        assert P.page_hashes_chain(toks, ps) == RP.page_hashes_chain(toks, ps)
    assert P.pages_for(17, 16) == RP.pages_for(17, 16) == 2


# ---------------------------------------------------------------------------
# Paged attention: the plain version against the reference
# ---------------------------------------------------------------------------

def _paged_case(trial, dtype=np.float32):
    """The reference's geometry fuzz (tests/test_kernels.py): ragged
    per-slot lengths, -1 entries, pages aliased between rows,
    GQA/MQA/MHA, C in {1, 4, 8}; odd trials also get a fully masked row
    (all -1: an inactive slot, or another row during suffix prefill)."""
    rng = np.random.default_rng(42 + trial)
    b = int(rng.integers(1, 4))
    c = int(rng.choice([1, 1, 4, 8]))
    hq, hkv = [(4, 4), (4, 2), (8, 1)][trial % 3]
    d = int(rng.choice([16, 32, 64]))
    ps = int(rng.choice([8, 16]))
    width = int(rng.integers(2, 6))
    phys = int(rng.integers(width, 2 * width * b + 1))
    table = np.full((b, width), -1, np.int32)
    pos = np.zeros(b, np.int32)
    for r in range(b):
        own = int(rng.integers(max(1, (c + ps - 1) // ps), width + 1))
        table[r, :own] = rng.integers(0, phys, own)
        pos[r] = int(rng.integers(0, own * ps - c + 1))
    if trial % 2 and b > 1:
        table[-1] = -1
    q = rng.standard_normal((b, c, hq, d)).astype(dtype)
    kp = rng.standard_normal((phys + 1, ps, hkv, d)).astype(dtype)
    vp = rng.standard_normal((phys + 1, ps, hkv, d)).astype(dtype)
    return q, kp, vp, table, pos


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("trial", range(10))
def test_paged_plain_matches_pallas_interpret_and_oracle(trial):
    q, kp, vp, table, pos = _paged_case(trial)
    j = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    kern = np.asarray(ROPS.paged_attention(*j, interpret=True))
    oracle = np.asarray(REF.paged_attention_ref(*j))
    port = FA.paged_flash_attention_plain(*_t(q, kp, vp, table, pos)).numpy()
    np.testing.assert_allclose(port, oracle, atol=PAGED_ATOL, rtol=0)
    np.testing.assert_allclose(port, kern, atol=PAGED_ATOL, rtol=0)
    if trial % 2 and table.shape[0] > 1:
        assert not port[-1].any()        # fully masked row: 0, not NaN


@pytest.mark.parametrize("trial", [0, 3, 5])
def test_paged_attend_matches_reference(trial):
    """The attn_backend="xla" path (gather only the table's pages)."""
    q, kp, vp, table, pos = _paged_case(trial)
    ref = np.asarray(RA.paged_attend(*[jnp.asarray(a)
                                       for a in (q, kp, vp, table, pos)]))
    port = A.paged_attend(*_t(q, kp, vp, table, pos)).numpy()
    np.testing.assert_allclose(port, ref, atol=PAGED_ATOL, rtol=0)


def test_shard_axis_form_on_a_strided_pool_view():
    """q (tp, B, C, Hq, D) against one layer of a (tp, layers, P+1, ps,
    Hkv, D) segment leaf: the view is accepted as it is (no copy) and the
    result equals per-shard calls with the shared table and pos."""
    rng = np.random.default_rng(7)
    tp, layers, pn1, ps, hkv, d, b, c = 2, 3, 9, 8, 2, 16, 3, 4
    kleaf = torch.from_numpy(rng.standard_normal(
        (tp, layers, pn1, ps, hkv, d)).astype(np.float32))
    vleaf = torch.from_numpy(rng.standard_normal(
        (tp, layers, pn1, ps, hkv, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(
        (tp, b, c, 3 * hkv, d)).astype(np.float32))
    table = torch.tensor([[3, 0, -1, -1], [5, 6, 1, -1], [-1] * 4])
    pos = torch.tensor([5, 20, 0])
    kv, vv = kleaf[:, 1], vleaf[:, 1]
    assert not kv.is_contiguous()
    FA.check_paged_args(q, kv, vv, table, pos)
    out = FA.paged_flash_attention(q, kv, vv, table, pos)
    for t in range(tp):
        np.testing.assert_array_equal(
            out[t].numpy(), FA.paged_flash_attention_plain(
                q[t], kv[t], vv[t], table, pos).numpy())
    assert not out[:, 2].any()


# ---------------------------------------------------------------------------
# Page scatters: equal to the reference's, written in place
# ---------------------------------------------------------------------------

def test_scatter_tokens_pages_matches_reference_in_place():
    """C tokens per slot into their pages, with a -1 entry, a chunk that
    runs past the table width and an inactive row (all -1).  Live pages
    equal the reference's exactly; the trash page's content is
    unspecified in both (colliding writes)."""
    rng = np.random.default_rng(11)
    tp, pn1, ps, hkv, d, b, c = 2, 8, 4, 2, 16, 3, 6
    leaf = rng.standard_normal((tp, 2, pn1, ps, hkv, d)).astype(np.float32)
    vals = rng.standard_normal((tp, b, c, hkv, d)).astype(np.float32)
    table = np.asarray([[2, 5, -1], [0, 1, 3], [-1, -1, -1]], np.int32)
    pos = np.asarray([2, 9, 0], np.int32)
    tleaf = torch.from_numpy(leaf.copy())
    view = tleaf[:, 1]
    ptr = view.data_ptr()
    out = ops.scatter_tokens_pages(view, torch.from_numpy(vals),
                                   torch.from_numpy(table),
                                   torch.from_numpy(pos))
    assert out is view and view.data_ptr() == ptr
    for t in range(tp):
        ref = np.asarray(ROPS.scatter_tokens_pages(
            jnp.asarray(leaf[t, 1]), jnp.asarray(vals[t]),
            jnp.asarray(table), jnp.asarray(pos)))
        np.testing.assert_array_equal(tleaf[t, 1, :-1].numpy(), ref[:-1])
        np.testing.assert_array_equal(tleaf[t, 0].numpy(), leaf[t, 0])
    # the reference's shapes, no leading axis
    pool = torch.from_numpy(leaf[0, 0].copy())
    ops.scatter_tokens_pages(pool, torch.from_numpy(vals[0]),
                             torch.from_numpy(table), torch.from_numpy(pos))
    ref = np.asarray(ROPS.scatter_tokens_pages(
        jnp.asarray(leaf[0, 0]), jnp.asarray(vals[0]), jnp.asarray(table),
        jnp.asarray(pos)))
    np.testing.assert_array_equal(pool[:-1].numpy(), ref[:-1])


def test_scatter_prefill_pages_matches_reference_in_place():
    rng = np.random.default_rng(12)
    tp, layers, pn1, ps, hkv, d, n = 2, 3, 7, 4, 2, 16, 4
    leaf = rng.standard_normal((tp, layers, pn1, ps, hkv, d)) \
        .astype(np.float32)
    dense1 = rng.standard_normal((tp, layers, 1, n * ps, hkv, d)) \
        .astype(np.float32)
    row = np.asarray([4, 0, -1, -1], np.int32)
    tleaf = torch.from_numpy(leaf.copy())
    ptr = tleaf.data_ptr()
    ops.scatter_prefill_pages(tleaf, torch.from_numpy(dense1),
                              torch.from_numpy(row))
    assert tleaf.data_ptr() == ptr
    for t in range(tp):
        ref = np.asarray(ROPS.scatter_prefill_pages(
            jnp.asarray(leaf[t]), jnp.asarray(dense1[t]), jnp.asarray(row)))
        np.testing.assert_array_equal(tleaf[t, :, :-1].numpy(),
                                      ref[:, :-1])


# ---------------------------------------------------------------------------
# The paged wrapper without a card
# ---------------------------------------------------------------------------

def test_paged_wrapper_checks_raise_without_a_card():
    q = torch.zeros(2, 1, 6, 16)
    pool = torch.zeros(5, 4, 2, 16)
    table = torch.zeros(2, 3, dtype=torch.long)
    pos = torch.zeros(2, dtype=torch.long)
    call = FA.paged_flash_attention
    with pytest.raises(TypeError):
        call(q.half(), pool.half(), pool.half(), table, pos)
    with pytest.raises(ValueError, match="contiguous"):
        call(q, pool.transpose(0, 1).contiguous().transpose(0, 1), pool,
             table, pos)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.zeros(16, 6, 1, 2).permute(3, 2, 1, 0), pool, pool,
             table, pos)
    with pytest.raises(ValueError, match="multiple"):
        call(torch.zeros(2, 1, 5, 16), pool, pool, table, pos)
    with pytest.raises(ValueError, match="head dims"):
        call(torch.zeros(2, 1, 6, 48), torch.zeros(5, 4, 2, 48),
             torch.zeros(5, 4, 2, 48), table, pos)
    with pytest.raises(ValueError, match="page table"):
        call(q, pool, pool, table.float(), pos)
    with pytest.raises(ValueError, match="pos"):
        call(q, pool, pool, table, torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="shards"):
        call(q[None].expand(2, -1, -1, -1, -1).contiguous(), pool[None],
             pool[None], table, pos)
    with pytest.raises(ValueError, match="no paged attention kernel"):
        call(elsewhere(q), elsewhere(pool), elsewhere(pool), table, pos)


def test_paged_cpu_calls_never_build_or_count():
    before = FA.paged_flash_attention.launches
    q, kp, vp, table, pos = _paged_case(1)
    ops.paged_attention(*_t(q, kp, vp, table, pos))
    assert FA.paged_flash_attention.launches == before
    assert "paged_attention" in build.SOURCES
    assert "paged_attention" not in build._LIBS
