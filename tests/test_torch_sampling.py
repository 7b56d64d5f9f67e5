"""PyTorch port vs JAX reference: the sampler at a tiny positive
temperature.

The reference scales the logits by max(T, 1e-6)
(repro/runtime/sampling.py), so any T in (0, 1e-6] samples at 1e-6,
where the softmax of O(1) logits puts all its mass on the argmax.  The
port must clamp the same way: dividing by T itself overflows to inf at
an fp32-subnormal T, and torch.multinomial then raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.runtime import sampling as RS  # noqa: E402

from repro_torch.runtime import sampling as S  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("temp", [1e-7, 1e-40])
@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 0.9)])
def test_tiny_temperature_gives_the_argmax_in_both(temp, top_k, top_p):
    rng = np.random.default_rng(16)
    logits = (rng.standard_normal((2, 50)) * 2).astype(np.float32)
    b = logits.shape[0]
    temps = np.full(b, temp, np.float32)
    ks = np.full(b, top_k, np.int32)
    ps = np.full(b, top_p, np.float32)
    want = logits.argmax(-1)
    ref = RS.sample_core(jnp.asarray(logits), jnp.asarray(temps),
                         jnp.asarray(ks), jnp.asarray(ps),
                         RS.make_keys(jnp.arange(b, dtype=jnp.int32),
                                      jnp.zeros(b, jnp.int32)))
    got = S.sample_core(torch.from_numpy(logits),
                        torch.tensor([temp] * b, dtype=torch.float64),
                        torch.from_numpy(ks), torch.from_numpy(ps),
                        S.make_generators(range(b), [0] * b, "cpu"))
    np.testing.assert_array_equal(np.asarray(ref), want)
    np.testing.assert_array_equal(got.numpy(), want)
