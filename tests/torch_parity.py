"""Shared by the port's tests.

`one_torch_thread`: every `test_torch_*.py` imports this autouse
fixture.  `perturbed_canonical`: the reference's canonical parameters
with every leaf it initialises to a constant (norm weights 1, biases 0,
qk-norm weights 1) moved off that constant, so that a bias or a norm
wired wrongly shows in the outputs.  Numpy leaves, for
`jax.tree.map(jnp.asarray, .)` on the reference's side and
`core.convert.from_reference` on the port's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as RB, model as RM, simtp as RS


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


class _Elsewhere(torch.Tensor):
    """A tensor on a device that is neither cpu, cuda nor meta (it says
    "xpu"), with its shape, dtype and strides and no storage: what a
    kernel wrapper must refuse.  No op runs on it; `data_ptr` reads 0,
    as a meta tensor's does."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, dtype=t.dtype, strides=t.stride(), device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a tensor of no real device")

    def data_ptr(self):
        return 0


def elsewhere(t):
    """`t`'s metadata on a device the kernels do not take (_Elsewhere)."""
    return _Elsewhere(t)


# leaves the reference initialises to constants (0 or 1; MLA's latent
# norm `lnorm`), and OPT's position table
CONSTANT_LEAVES = ("b", "w", "qn", "kn", "bq", "bk", "bv", "bo", "bu",
                   "bd", "bg", "pos", "lnorm")


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


def assert_params_close(ref_leaves, port_leaves, lr, what="",
                        rel=PARAM_REL):
    """The sign-aware bound above over two lists of numpy leaves; `rel`
    replaces PARAM_REL where the two runs' losses agree only to a looser
    bound (quantized kept syncs)."""
    assert len(ref_leaves) == len(port_leaves), what
    flips = total = 0
    for i, (a, b) in enumerate(zip(ref_leaves, port_leaves)):
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        d = np.abs(a - b)
        far = d > rel * max(float(np.abs(a).max()), 1e-30)
        assert d.max() <= 2 * lr + 1e-6, (what, i, float(d.max()))
        flips += int(far.sum())
        total += a.size
    assert flips <= PARAM_FLIP_FRAC * total, (what, flips, total)


# ---------------------------------------------------------------------------
# Block parity (tests/test_torch_blocks.py and the MoE / hybrid files)
# ---------------------------------------------------------------------------

# exact / SPD wiring: fp32, the only differences are summation orders
# (XLA vs torch matmuls): ~1e-6 on O(1) activations
BLOCK_ATOL = 2e-5
# a quantized sync rounds x/s to an integer code; a last-ulp difference
# in x before `round` can flip one code, i.e. move an element by one
# quant step s = absmax/L.  Allowed: at most 1% of the elements, each by
# at most two steps (a flip before the reduction and after it) of the
# block's largest update |out - x|.
FLIP_FRACTION = 0.01
LEVELS = {"quant8": 127, "quant4": 7}


def assert_block_close(port, ref, x, comm, atol=BLOCK_ATOL,
                       one_token=False):
    """A block's output (tp, B, S, d) against the reference's under the
    bound above.  `one_token`: the elements past `atol` may instead all
    sit on one token (b, s): one flipped code in a TP block's attention
    sync moves that token's row, and the MLP spreads it over the row,
    which at d 128 and 80 tokens is 1.25% of the elements."""
    diff = np.abs(port - ref)
    if comm in LEVELS:
        step = np.abs(ref - x).max() / LEVELS[comm]
        bad = diff > atol
        tokens = int(bad.any(-1).any(0).sum())
        assert bad.mean() <= FLIP_FRACTION or (one_token and tokens <= 1), (
            bad.sum(), diff.size, tokens)
        assert diff.max() <= 2 * step + atol, (diff.max(), step)
    else:
        assert diff.max() <= atol, diff.max()


def ref_layer(rcfg, rkind, seed=0):
    """The reference's init of one layer with every leaf moved by 0.05
    N(0, 1) (norm weights, biases and skips off their constants), built
    under jit: eager JAX compiles each op on its first use."""
    def make(key):
        lp = RB.init_layer(key, rcfg, rkind)
        return jax.tree.map(lambda x: x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(7), x.shape, jnp.float32), lp)

    return jax.jit(make)(jax.random.PRNGKey(seed))


def ref_split_layer(lp, rcfg, rkind, tp):
    """The reference's split_layer, under jit."""
    return jax.jit(lambda p: RS.split_layer(p, rcfg, rkind, tp))(lp)


def ledger_tuples(ledger):
    return [(e.op, e.axis, e.nbytes) for e in ledger]


# ---------------------------------------------------------------------------
# Model parity (the MLA, int8 and paged-fallback files)
# ---------------------------------------------------------------------------

def model_pair(arch, *, comm="exact", cfg_kw=None, tp=2, **load_kw):
    """(reference LLM, port LLM) of `arch` in fp32 with `cfg_kw` replaced
    in both configs, spd=0.25, `comm` on the kept syncs and the logits
    gather: the reference on its perturbed params, the port on the same
    params carried over (convert.from_reference)."""
    from repro.api import LLM as RLLM
    from repro.config.base import replace as rreplace
    from repro.configs import get_config as rget
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.core.convert import from_reference

    cfg_kw = dict(cfg_kw or {}, dtype="float32")
    rcfg = rreplace(rget(arch), **cfg_kw)
    cfg = replace(get_config(arch), **cfg_kw)
    kw = dict(dict(tp=tp, spd=0.25, comm=comm, comm_logits=comm,
                   q_chunk=64), **load_kw)
    ref = RLLM.load(rcfg, params=jax.tree.map(
        jnp.asarray, perturbed_canonical(rcfg)), **kw)
    port = LLM.load(cfg, device="cpu", params=from_reference(
        jax.tree.map(np.asarray, ref.canonical), cfg), **kw)
    return ref, port


def teacher_forced_logits(llm, prompt, stream, cache_len):
    """Full logits (len(stream), V) of one request (batch 1) through
    either package's engine -- the prefill's, then each decode step's
    with `stream` forced in -- and the caches after."""
    if isinstance(llm.canonical["emb"], torch.Tensor):
        from repro_torch.runtime.forward import bucketed_prefill
        to_np = lambda t: t.numpy()            # noqa: E731
    else:
        from repro.runtime.forward import bucketed_prefill
        to_np = np.asarray
    eng = llm.engine
    lg, c1 = bucketed_prefill(eng, llm.params, prompt, len(prompt),
                              cache_len)
    caches = eng.insert_slot(eng.blank_caches(1, cache_len), c1, 0)
    out = [to_np(lg)[0]]
    for i, tok in enumerate(stream[:-1]):
        _, lg, caches = eng.decode_with_logits(
            llm.params, np.asarray([[tok]]), np.asarray([len(prompt) + i]),
            caches)
        out.append(to_np(lg)[0])
    return np.stack(out), caches
