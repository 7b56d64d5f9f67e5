"""PyTorch port vs JAX reference: gradients through the TP wiring.

The three custom-VJP collectives (g_psum, f_ident, shard_sum_grad) as
autograd Functions over the shard axis; block-level gradients under the
SPD and TP wirings at tp 2 and 4 against `jax.vmap(jax.grad(...),
axis_name="model")`; `make_grad_fn`'s loss and gradient tree against the
reference's, tp=2 against tp=1, and a directional finite difference
through the SPD wiring; the guard that keeps a ctypes kernel out of a
backward.  Reduced configs in fp32, the reference's parameters with
every bias / norm leaf perturbed off its constant, carried across with
`core.convert.from_reference`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import blocks as RB, model as RM, simtp as RS  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402
from repro.parallel import collectives as RC  # noqa: E402

from repro_torch.config.base import SPDPlanConfig, replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B, model as M, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.parallel.layout import REPLICATED  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

# gradients of fp32 block / model forwards: XLA and torch sum and fuse in
# other orders, so elements agree to ~1e-6 of the tree's largest value
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-5       # of the largest |gradient| of the leaf
LOSS_RTOL = 1e-5

_CFGS = {}


def _cfgs(name):
    if name not in _CFGS:
        rcfg = rreplace(rget(name, reduced=True), dtype="float32")
        cfg = replace(get_config(name, reduced=True), dtype="float32")
        _CFGS[name] = (rcfg, cfg, perturbed_canonical(rcfg))
    return _CFGS[name]


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_FRAC * scale, err_msg=what)


def _close_trees(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    for a, b, path in zip(g, w, paths):
        _close(a, b, path)


# ---------------------------------------------------------------------------
# The three collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("op", ["g_psum", "f_ident", "shard_sum_grad"])
def test_collective_vjps_match_reference(op, tp):
    """Forward and backward of each Function equal the reference's custom
    VJP taken inside the vmapped shard axis, on seeded inputs and
    cotangents (one per shard); exact up to the
    order of a tp-term fp32 sum (atol 1e-6 on O(1) values)."""
    rng = np.random.default_rng(tp)
    x = rng.standard_normal((tp, 3, 5)).astype(np.float32)
    ct = rng.standard_normal((tp, 3, 5)).astype(np.float32)
    ref_op = getattr(RC, op)

    def per_shard(xi, ci):          # the VJP taken inside the shard map
        yi, vjp = jax.vjp(lambda v: ref_op(v, "model"), xi)
        return yi, vjp(ci)[0]

    y_ref, gx_ref = jax.vmap(per_shard, axis_name="model")(
        jnp.asarray(x), jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    y = getattr(C, op)(xt)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), rtol=0,
                               atol=1e-6)
    # without autograd recording they are the plain ops, logged alike
    with torch.no_grad():
        np.testing.assert_array_equal(getattr(C, op)(xt).numpy(),
                                      y.detach().numpy())


def test_sync_output_backward_logs_nothing():
    """The ledger records the forward's all-reduce only; the backward of
    sync_output and column_entry logs no collective."""
    x = torch.randn(2, 4, 8, requires_grad=True)
    with C.collective_ledger() as led:
        y = C.sync_output(C.column_entry(x))
        n_fwd = len(led)
        (y * y).sum().backward()
    assert n_fwd == 1 and len(led) == 1
    assert led[0].op == "all-reduce"


# ---------------------------------------------------------------------------
# Block-level gradients (the probe: loss = sum of out^2 per shard)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop", [True, False], ids=["spd", "tp"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["smollm-360m", "llama2-7b", "opt-6.7b"])
def test_block_grads_match_reference(name, tp, drop):
    """Layer 1's gradient tree of sum(out^2) through block_seq equals the
    reference's vmap(grad) leaf for leaf (sharded and replicated; OPT's
    `bo` reaches the divergent path through shared_param).  Tolerance
    GRAD_RTOL / GRAD_ATOL_FRAC."""
    rcfg, cfg, canon = _cfgs(name)
    kind, rkind = layer_kinds(cfg)[1], rkinds(rcfg)[1]
    rsplit = RS.split_layer(jax.tree.map(jnp.asarray, canon["layers"][1]),
                            rcfg, rkind, tp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (2, 16))
    rlay = RM._gqa_layout_or_none(rcfg, tp)

    def per_shard(p):
        out, _, _ = RB.block_seq(rcfg, rkind, rlay, p, jnp.asarray(x),
                                 jnp.asarray(pos), drop=drop, tp=tp,
                                 shard_idx=jax.lax.axis_index("model"),
                                 axis="model", q_chunk=64)
        return jnp.sum(out ** 2)

    g_ref = jax.vmap(jax.grad(per_shard), axis_name="model")(rsplit)
    psplit = simtp.split_layer(from_reference(canon["layers"][1], cfg), cfg,
                               kind, tp)
    p, leaves = simtp.grad_leaves(psplit)
    xs = torch.from_numpy(x)[None].expand(tp, 2, 16, cfg.d_model)
    out, _, _ = B.block_seq(cfg, kind, M._gqa_layout(cfg, tp), p, xs,
                            torch.from_numpy(pos.copy()), drop=drop,
                            q_chunk=64)
    g = simtp.grads_of((out ** 2).sum(), psplit, leaves)
    _close_trees(g, g_ref)
    # every copy of a replicated leaf holds the same, full gradient
    for gl, spec in zip(tree_leaves(g), tree_leaves(B.layer_specs(cfg,
                                                                  kind))):
        if spec == REPLICATED:
            torch.testing.assert_close(gl, gl[:1].expand_as(gl), rtol=0,
                                       atol=0)


# ---------------------------------------------------------------------------
# make_grad_fn
# ---------------------------------------------------------------------------

def _batch(vocab, seq=24):
    b = RD.calibration_batches(vocab, 2, seq, batch=2)[0]
    return b, {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("plan_kind", ["none", "full"])
@pytest.mark.parametrize("name", ["llama2-7b", "opt-6.7b"])
def test_make_grad_fn_matches_reference(name, plan_kind):
    """Loss (LOSS_RTOL) and the whole gradient tree (embedding, position
    table, norms, every segment leaf) at tp=2, a vocab of 509 so the
    padded columns are masked, with remat on for the port (the values
    do not change)."""
    rcfg, cfg, canon = _cfgs(name)
    rcfg, cfg = rreplace(rcfg, vocab_size=509), replace(cfg, vocab_size=509)
    canon = dict(canon, emb=canon["emb"][:509])
    if "head" in canon:
        canon["head"] = canon["head"][:, :509]
    tp = 2
    rplan = getattr(RPlan, plan_kind)(cfg.n_layers)
    plan = getattr(SPDPlanConfig, plan_kind)(cfg.n_layers)
    b, rb = _batch(509)
    rsplit = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg, rplan,
                               tp)
    rloss, rg = RS.make_grad_fn(rcfg, rplan, tp, q_chunk=64)(rsplit, rb)
    psplit = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, tp)
    loss, g = simtp.make_grad_fn(cfg, plan, tp, q_chunk=64,
                                 remat=True)(psplit, b)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    _close_trees(g, rg)


def test_grad_fn_tp2_matches_tp1():
    """tp=2 gradients, merged, equal tp=1 autodiff (llama2-7b reduced: no
    head padding at tp 2), mirroring the reference's own tp check; the
    placement's inverse round-trips the params exactly."""
    _, cfg, canon = _cfgs("llama2-7b")
    plan = SPDPlanConfig.none(cfg.n_layers)
    b, _ = _batch(cfg.vocab_size)
    pcanon = from_reference(canon, cfg)
    out = {}
    for tp in (1, 2):
        split = simtp.prepare_params(pcanon, cfg, plan, tp)
        loss, g = simtp.make_grad_fn(cfg, plan, tp, q_chunk=64)(split, b)
        out[tp] = (float(loss), simtp.merge_stacked(g, cfg, plan, tp))
    assert abs(out[1][0] - out[2][0]) < 2e-5
    for a, c in zip(tree_leaves(out[1][1]), tree_leaves(out[2][1])):
        _close(c, a.numpy(), "tp2 vs tp1")
    # merge_stacked and unstack_segments invert the placement exactly,
    # over a plan of several segments
    mixed = SPDPlanConfig((True, False, False, True))
    back = M.unstack_segments(simtp.merge_stacked(simtp.prepare_params(
        pcanon, cfg, mixed, 2), cfg, mixed, 2), cfg, mixed)
    want = M.pad_model(pcanon, cfg, 2)
    assert len(back["layers"]) == cfg.n_layers
    for a, c in zip(tree_leaves(back), tree_leaves(want)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_spd_grad_matches_finite_difference():
    """Directional finite difference through the SPD wiring (all blocks
    dropped, tp=2): replicated leaves move all their copies together and
    count once, as in the reference's test; rtol 3e-2 as there (fp32
    central differences with a 2e-4 step)."""
    _, cfg, canon = _cfgs("smollm-360m")
    plan = SPDPlanConfig.full(cfg.n_layers)
    tp = 2
    b, _ = _batch(cfg.vocab_size, seq=16)
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, tp)
    _, g = simtp.make_grad_fn(cfg, plan, tp, q_chunk=64)(split, b)
    lfn = simtp.make_loss_fn(cfg, plan, tp, q_chunk=64)
    specs = M.stacked_specs(cfg, plan)
    gen = torch.Generator().manual_seed(42)
    dirs = []
    analytic = 0.0
    for w, gl, a in zip(tree_leaves(split), tree_leaves(g),
                        tree_leaves(specs)):
        if a == REPLICATED:
            d0 = torch.randn(w.shape[1:], generator=gen) * 2e-4
            dirs.append(d0[None].expand_as(w))
            analytic += float((gl[0] * d0).sum())
        else:
            d = torch.randn(w.shape, generator=gen) * 2e-4
            dirs.append(d)
            analytic += float((gl * d).sum())
    it = iter(dirs)
    step = tree_map(lambda w: next(it), split)
    lp, _ = lfn(tree_map(lambda w, d: w + d, split, step), b)
    lm, _ = lfn(tree_map(lambda w, d: w - d, split, step), b)
    fd = (float(lp) - float(lm)) / 2.0
    np.testing.assert_allclose(fd, analytic, rtol=3e-2, atol=1e-7)


# ---------------------------------------------------------------------------
# The guard on the ctypes kernels
# ---------------------------------------------------------------------------

def test_refuse_grad_raises_only_where_autograd_records():
    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        build.refuse_grad("kernel", torch.zeros(3), w)
    with torch.no_grad():
        build.refuse_grad("kernel", w)
    with torch.inference_mode():
        build.refuse_grad("kernel", w)
    build.refuse_grad("kernel", w.detach(), torch.ones(2))


def test_cpu_flash_path_stays_differentiable():
    """On the CPU the flash wrapper is its plain version: a gradient flows
    to q, k and v, equal to that of the dense attention."""
    from repro_torch.kernels import ops as KOPS
    from repro_torch.models import attention as A
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 12, 4, 16, generator=gen, requires_grad=True)
    k = torch.randn(2, 12, 2, 16, generator=gen, requires_grad=True)
    v = torch.randn(2, 12, 2, 16, generator=gen, requires_grad=True)
    pos = torch.arange(12).expand(2, 12)
    gk = torch.autograd.grad(KOPS.flash_attention(q, k, v).square().sum(),
                             (q, k, v))
    gp = torch.autograd.grad(A.attention_any(q, k, v, pos, pos)
                             .square().sum(), (q, k, v))
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
