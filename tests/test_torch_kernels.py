"""PyTorch port's kernel modules on the CPU: each plain version against
the reference's Pallas kernel (interpret mode) and its oracle, and the
CUDA wrappers' argument checks (which run without a card).  The CUDA
kernels themselves are held against these plain versions on the GPU by
chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ROPS, ref as REF  # noqa: E402
from repro.kernels.quant_collectives import qdq_absmax as ref_qdq  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import quant_collectives as QC  # noqa: E402
from torch_parity import elsewhere, one_torch_thread  # noqa: E402,F401

# fp32 online softmax (Pallas, blockwise) vs one-shot softmax (plain):
# the two orders of summation agree to ~1e-6 on N(0,1) inputs
FLASH_ATOL = 2e-5


@pytest.mark.parametrize("s", [5, 16, 130])
@pytest.mark.parametrize("group", [1, 3])
def test_flash_plain_matches_pallas_interpret(s, group):
    rng = np.random.default_rng(s * 10 + group)
    b, hkv, d = 2, 2, 16
    hq = hkv * group
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    ref = np.asarray(ROPS.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), interpret=True))
    port = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v))
    np.testing.assert_allclose(port.numpy(), ref, atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("group", [1, 3])
def test_flash_plain_matches_oracle(group):
    rng = np.random.default_rng(group)
    bhkv, s, d = 4, 33, 32
    q = rng.standard_normal((bhkv * group, s, d)).astype(np.float32)
    k = rng.standard_normal((bhkv, s, d)).astype(np.float32)
    v = rng.standard_normal((bhkv, s, d)).astype(np.float32)
    ref = np.asarray(REF.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v)))
    port = FA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(port.numpy(), ref, atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("levels", [127, 7])
@pytest.mark.parametrize("n", [128, 1000, 96 * 16, 960 * 4])
def test_qdq_plain_bitwise_vs_oracle_and_kernel(n, levels):
    """Plain qdq equals ref.qdq_absmax_ref bit for bit (ragged and whole
    chunks).  The reference's Pallas kernel in interpret mode is itself
    a few ulp off that oracle (its lowering rounds the scale and the
    final q*s differently), so it is held to the tolerance the
    reference's own test_qdq_kernel_matches_ref uses for it."""
    x = (np.random.default_rng(n + levels).standard_normal(n) * 3.0) \
        .astype(np.float32)
    port = QC.qdq_absmax_plain(torch.from_numpy(x)[None],
                               levels=levels).numpy()[0]
    oracle = np.asarray(REF.qdq_absmax_ref(jnp.asarray(x), levels=levels))
    np.testing.assert_array_equal(port, oracle)
    kern = np.asarray(ref_qdq(jnp.asarray(x), levels=levels, interpret=True))
    np.testing.assert_allclose(port, kern, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [960, 96, 24576])
def test_qdq_rowwise_chunking_matches_per_shard_calls(n):
    """(tp, N) payload: chunking restarts at every row, as the reference's
    per-shard (vmap) calls do; a single flatten over the shard axis would
    shift chunk boundaries whenever N % 128 != 0."""
    tp = 2
    x = np.random.default_rng(n).standard_normal((tp, n)).astype(np.float32)
    x[1] *= 10.0                       # shards with different scales
    port = QC.qdq_absmax(torch.from_numpy(x), levels=127).numpy()
    for r in range(tp):
        np.testing.assert_array_equal(
            port[r], np.asarray(REF.qdq_absmax_ref(jnp.asarray(x[r]),
                                                   levels=127)))


def test_flash_wrapper_checks_raise_without_a_card():
    q = torch.zeros(6, 8, 16)
    kv = torch.zeros(2, 8, 16)
    with pytest.raises(TypeError):
        FA.flash_attention_bhsd(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_bhsd(q.transpose(1, 2).contiguous()
                                .transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention_bhsd(torch.zeros(5, 8, 16), kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_bhsd(torch.zeros(6, 8, 48), torch.zeros(2, 8, 48),
                                torch.zeros(2, 8, 48))
    with pytest.raises(ValueError, match="Sq == Sk"):
        FA.flash_attention_bhsd(q, torch.zeros(2, 9, 16),
                                torch.zeros(2, 9, 16))
    with pytest.raises(ValueError, match="kv heads"):
        ops.flash_attention(torch.zeros(1, 8, 5, 16),
                            torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 16))
    # a device that is neither CPU nor CUDA gets no silent plain path
    with pytest.raises(ValueError, match="no flash kernel"):
        FA.flash_attention_bhsd(elsewhere(q), elsewhere(kv), elsewhere(kv))


def test_qdq_wrapper_checks_raise_without_a_card():
    x = torch.zeros(2, 256)
    with pytest.raises(TypeError):
        QC.qdq_absmax(x.double(), levels=127)
    with pytest.raises(ValueError, match="contiguous"):
        QC.qdq_absmax(torch.zeros(256, 2).t(), levels=127)
    with pytest.raises(ValueError, match="rows, n"):
        QC.qdq_absmax(torch.zeros(256), levels=127)
    with pytest.raises(ValueError, match="levels"):
        QC.qdq_absmax(x, levels=15)
    with pytest.raises(ValueError, match="chunk"):
        QC.qdq_absmax(x, levels=127, chunk=64)
    with pytest.raises(ValueError, match="no qdq kernel"):
        QC.qdq_absmax(elsewhere(x), levels=127)


def test_cpu_calls_never_build_or_count():
    """CPU tensors take the plain versions: nothing is compiled, no
    launch is counted."""
    before = (FA.flash_attention_bhsd.launches, QC.qdq_absmax.launches)
    ops.flash_attention(torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16),
                        torch.randn(1, 8, 2, 16))
    QC.qdq_absmax(torch.randn(2, 300), levels=7)
    assert (FA.flash_attention_bhsd.launches, QC.qdq_absmax.launches) == \
        before
    assert build._LIBS == {}


def test_library_path_tracks_the_source():
    """Each source builds to a path keyed by its contents and the flags,
    so an edited kernel is never served from a stale library."""
    for name in build.SOURCES:
        p = build.library_path(name)
        assert (build.CSRC / f"{name}.cu").exists()
        assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}-")
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
