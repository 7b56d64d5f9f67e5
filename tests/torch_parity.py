"""Shared by the port's tests.

`one_torch_thread`: every `test_torch_*.py` imports this autouse
fixture.  `perturbed_canonical`: the reference's canonical parameters
with every leaf it initialises to a constant (norm weights 1, biases 0,
qk-norm weights 1) moved off that constant, so that a bias or a norm
wired wrongly shows in the outputs.  Numpy leaves, for
`jax.tree.map(jnp.asarray, .)` on the reference's side and
`core.convert.from_reference` on the port's."""
import jax
import numpy as np
import pytest
import torch

from repro.core import model as RM


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a test file runs.  The suite runs several
    pytest workers at once, each with a torch thread per core, and many
    small ops then wait on one another's threads: ~50x slower than
    alone.  The values do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# leaves the reference initialises to constants (0 or 1), and OPT's
# position table
CONSTANT_LEAVES = ("b", "w", "qn", "kn", "bq", "bk", "bv", "bo", "bu",
                   "bd", "bg", "pos")


def perturb(tree, rng, key=""):
    """Numpy copy of a canonical tree, each CONSTANT_LEAVES leaf plus
    0.1 N(0, 1)."""
    if isinstance(tree, dict):
        return {k: perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturb(v, rng, key) for v in tree]
    a = np.asarray(tree, np.float32)
    if key in CONSTANT_LEAVES:
        a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
    return a


def perturbed_canonical(rcfg, seed=0):
    """The reference's init at `seed`, perturbed (numpy leaves)."""
    canon = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    return perturb(jax.tree.map(np.asarray, canon),
                   np.random.default_rng(seed + 11))


# ---------------------------------------------------------------------------
# Training parity (the train step, the trainer, checkpoints)
# ---------------------------------------------------------------------------

# fp32 loss and grad norm of one step: the same sums in other orders
STEP_RTOL = 1e-5
# params after AdamW steps from one state: within PARAM_REL of each leaf's
# largest |value|, except at most PARAM_FLIP_FRAC of the tree's elements,
# none more than 2 lr + 1e-6 away.  AdamW's first step is a sign function
# (m / c1 / (sqrt(v / c2) + eps) ~ g / (|g| + 1e-8)): an element whose
# gradient is float noise moves +lr in one package and -lr in the other.
PARAM_REL = 1e-5
PARAM_FLIP_FRAC = 1e-3
# loss trajectories over a few steps: the reference's own bound
# (tests/test_extended_coverage.py::test_fsdp_matches_zero1_trajectory)
TRAJ_RTOL = 2e-4


def assert_params_close(ref_leaves, port_leaves, lr, what=""):
    """The sign-aware bound above over two lists of numpy leaves."""
    assert len(ref_leaves) == len(port_leaves), what
    flips = total = 0
    for i, (a, b) in enumerate(zip(ref_leaves, port_leaves)):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        d = np.abs(a - b)
        far = d > PARAM_REL * max(float(np.abs(a).max()), 1e-30)
        assert d.max() <= 2 * lr + 1e-6, (what, i, float(d.max()))
        flips += int(far.sum())
        total += a.size
    assert flips <= PARAM_FLIP_FRAC * total, (what, flips, total)


def ledger_tuples(ledger):
    return [(e.op, e.axis, e.nbytes) for e in ledger]
