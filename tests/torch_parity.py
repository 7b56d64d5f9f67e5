"""Shared by the port's parity tests of the paper's configurations: the
reference's canonical parameters with every leaf it initialises to a
constant (norm weights 1, biases 0, qk-norm weights 1) moved off that
constant, so that a bias or a norm wired wrongly shows in the outputs.
Numpy leaves, for `jax.tree.map(jnp.asarray, .)` on the reference's
side and `core.convert.from_reference` on the port's."""
import jax
import numpy as np

from repro.core import model as RM

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
