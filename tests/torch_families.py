"""Shared by the family training and Algorithm 1 tests
(`test_torch_train_{moe,mla,hybrid}.py`, `test_torch_spd_families.py`,
`test_torch_shard_families_train.py`): the reduced configs in fp32 with
the reference's perturbed parameters, gradient trees of `make_grad_fn`
in both packages, and one train step in both on the same numbers.

MoE routers are scaled as the reference's own gradient test scales them
(`tests/test_grads.py::_decisive_router`): top-k is discrete, so a
float-order difference between XLA and torch can flip a near-tied
routing choice and move the gradients of a few rows by O(1e-3) for a
reason unrelated to the wiring under test.  Scaled by 25, every choice
is decisive and the comparison is exact to summation order."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config.base import SPDPlanConfig as RPlan
from repro.config.base import replace as rreplace
from repro.configs import get_config as rget
from repro.core import model as RM, simtp as RS
from repro.data import synthetic as RD
from repro.launch.mesh import make_test_mesh as ref_mesh
from repro.parallel import tp as RTP
from repro_torch.config.base import SPDPlanConfig, replace
from repro_torch.configs import get_config
from repro_torch.core import simtp
from repro_torch.core.convert import from_reference
from repro_torch.data.synthetic import make_batch_iterator
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.parallel import tp as TP
from repro_torch.tree import tree_leaves
from torch_parity import perturbed_canonical

MOE, MLA, HYBRID, SSM = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                         "hymba-1.5b", "mamba2-370m")
ROUTER_SCALE = 25.0

# gradients of fp32 model forwards (tests/test_torch_grads.py's bounds):
# XLA and torch sum and fuse in other orders
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-5       # of the largest |gradient| of the leaf
LOSS_RTOL = 1e-5


def decisive(canon: dict) -> dict:
    """A numpy canonical tree with every MoE router scaled by
    ROUTER_SCALE (module doc)."""
    layers = []
    for lp in canon["layers"]:
        if "moe" in lp:
            lp = dict(lp, moe=dict(lp["moe"],
                                   router=lp["moe"]["router"] * ROUTER_SCALE))
        layers.append(lp)
    return dict(canon, layers=layers)


@functools.lru_cache(maxsize=None)
def cfgs(name):
    """(reference cfg, port cfg, perturbed numpy canonical with decisive
    routers) of `name` reduced, fp32."""
    rcfg = rreplace(rget(name, reduced=True), dtype="float32")
    cfg = replace(get_config(name, reduced=True), dtype="float32")
    return rcfg, cfg, decisive(perturbed_canonical(rcfg))


def calib(vocab, seq=24, n=2, batch=2):
    """The reference's calibration batches: numpy for the port, jnp for
    the reference."""
    bs = RD.calibration_batches(vocab, n, seq, batch=batch)
    return bs, [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]


def close(got, want, what, rtol=GRAD_RTOL, atol_frac=GRAD_ATOL_FRAC):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * scale,
                               err_msg=what)


def close_trees(got, want, **kw):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    for a, b, path in zip(g, w, paths):
        close(a, b, path, **kw)


def plans(kind, n_layers):
    """(reference plan, port plan): "none", "full", or "half" (the first
    half of the blocks dropped, the rest kept: both wirings in one
    model)."""
    if kind == "half":
        return (RPlan.first_k(n_layers, n_layers // 2),
                SPDPlanConfig.first_k(n_layers, n_layers // 2))
    return getattr(RPlan, kind)(n_layers), getattr(SPDPlanConfig, kind)(
        n_layers)


@functools.lru_cache(maxsize=None)
def ref_grads(name, plan_kind, tp, seq=24):
    """The reference's make_grad_fn at `tp`: (loss, grad tree)."""
    rcfg, _, canon = cfgs(name)
    rplan, _ = plans(plan_kind, rcfg.n_layers)
    _, rb = calib(rcfg.vocab_size, seq)
    split = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg, rplan,
                              tp)
    loss, g = RS.make_grad_fn(rcfg, rplan, tp, q_chunk=64)(split, rb[0])
    return float(loss), jax.tree.map(np.asarray, g)


def port_grads(name, plan_kind, tp, seq=24, remat=False):
    """The port's make_grad_fn on the same numbers: (loss, grad tree)."""
    _, cfg, canon = cfgs(name)
    _, plan = plans(plan_kind, cfg.n_layers)
    b, _ = calib(cfg.vocab_size, seq)
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, tp)
    loss, g = simtp.make_grad_fn(cfg, plan, tp, q_chunk=64,
                                 remat=remat)(split, b[0])
    return float(loss), g


def merged_grads(name, tp, seq=24):
    """The port's no-SPD gradient at `tp`, merged to the per-layer padded
    layout (simtp.merge_stacked): (loss, leaves)."""
    _, cfg, canon = cfgs(name)
    plan = SPDPlanConfig.none(cfg.n_layers)
    b, _ = calib(cfg.vocab_size, seq)
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, tp)
    loss, g = simtp.make_grad_fn(cfg, plan, tp, q_chunk=64)(split, b[0])
    return float(loss), tree_leaves(simtp.merge_stacked(g, cfg, plan, tp))


def train_batches(vocab, n, batch, seq, front=None):
    """`n` batches of the synthetic stream; `front` (frontend_len,
    frontend_dim): each also carries fp32 "embeds" drawn in turn from
    default_rng(99), as the trainers draw them (seed 0)."""
    it = make_batch_iterator(vocab, batch, seq, seed=0)
    rngf = np.random.default_rng(99)
    out = []
    for _ in range(n):
        b = {k: v for k, v in next(it).items() if not k.startswith("_")}
        if front is not None:
            b["embeds"] = rngf.standard_normal((batch,) + tuple(front)) \
                .astype(np.float32)
        out.append(b)
    return out


def front_of(cfg):
    """(frontend_len, frontend_dim) of a frontend config, else None."""
    return (cfg.frontend_len, cfg.frontend_dim) if cfg.frontend_dim else None


@functools.lru_cache(maxsize=None)
def ref_train(name, plan_kind, *, dp, tp, nmb, steps, batch, seq,
              remat=False, lr=1e-3, fsdp=False):
    """The reference's shard_map train step: per-step metrics and the
    global params after `steps` (cached: the port's ZeRO-1 and FSDP
    steps are held to one run)."""
    rcfg, _, canon = cfgs(name)
    rplan, _ = plans(plan_kind, rcfg.n_layers)
    mesh = ref_mesh(dp, tp)
    ts = RTP.TrainStepConfig(microbatches=nmb, remat=remat, q_chunk=32,
                             lr=lr, fsdp=fsdp)
    stacked = jax.tree.map(jnp.asarray, RM.stack_segments(
        RM.pad_model(jax.tree.map(jnp.asarray, canon), rcfg, tp), rcfg,
        rplan))
    shapes = jax.eval_shape(lambda: stacked) if fsdp else None
    step, init, specs = RTP.build_train_step(rcfg, rplan, mesh, ts,
                                             stacked_shapes=shapes)
    gp = jax.device_put(stacked, RTP.named(mesh, specs["params"]))
    opt = init(gp)
    mets = []
    for b in train_batches(rcfg.vocab_size, steps, batch, seq,
                           front_of(rcfg)):
        gp, opt, met = step(gp, opt, jax.device_put(
            b, RTP.named(mesh, specs["batch"])))
        mets.append({k: float(v) for k, v in met.items()})
    return mets, [np.asarray(x) for x in jax.tree.leaves(gp)]


def port_train(name, plan_kind, *, dp, tp, nmb, steps, batch, seq,
               remat=False, lr=1e-3, fsdp=False):
    """The port's sim train step on the same numbers: per-step metrics and
    the params merged to the global stacked tree."""
    _, cfg, canon = cfgs(name)
    _, plan = plans(plan_kind, cfg.n_layers)
    mesh = make_test_mesh(dp, tp)
    ts = TP.TrainStepConfig(microbatches=nmb, remat=remat, q_chunk=32,
                            lr=lr, fsdp=fsdp)
    step, init, _ = TP.build_train_step(cfg, plan, mesh, ts, device="cpu")
    params = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, tp)
    opt = init(params)
    mets = []
    for b in train_batches(cfg.vocab_size, steps, batch, seq,
                           front_of(cfg)):
        params, opt, met = step(params, opt, {
            k: torch.from_numpy(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in met.items()})
    return mets, [t.numpy() for t in tree_leaves(
        simtp.merge_stacked(params, cfg, plan, tp))]


def assert_fsdp_specs(name, plan_kind, dp=2, tp=2):
    """The port's fsdp_specs of the placed params equal the reference's
    of its stacked shapes, leaf for leaf."""
    from repro.parallel import fsdp as RF
    from repro_torch.parallel import fsdp as F
    rcfg, cfg, canon = cfgs(name)
    rplan, plan = plans(plan_kind, cfg.n_layers)
    stacked = RM.stack_segments(RM.pad_model(jax.tree.map(
        jnp.asarray, canon), rcfg, tp), rcfg, rplan)
    ref = RF.fsdp_specs(rcfg, rplan, dp, jax.eval_shape(lambda: stacked))
    port = F.fsdp_specs(cfg, plan, dp, simtp.prepare_params(
        from_reference(canon, cfg), cfg, plan, tp))
    assert tree_leaves(port) == jax.tree.leaves(ref)
    assert any(a >= 0 for a in tree_leaves(port))


def checkpoint_round_trip(name, tmp_path, **kw):
    """A sim Trainer of `name` reduced (tp 2 x dp 2, fp32, seeded init)
    runs 2 steps and checkpoints; a second one over a copy of its
    directory resumes there.  Returns (the first's state at step 2, the
    resumed state, the step resumed from, the first's step-3 loss, the
    resumed trainer's step-3 loss)."""
    import shutil

    from repro_torch.launch.train import make_trainer
    from repro_torch.tree import tree_map

    _, cfg, _ = cfgs(name)
    kw = dict(dict(tp=2, dp=2, batch=4, seq=16, lr=1e-3, warmup=0,
                   device="cpu"), **kw)
    tr, st = make_trainer(cfg, steps=2, ckpt_dir=str(tmp_path / "a"), **kw)
    st = tr.run(st)
    at2 = tree_map(lambda t: t.clone(), {"params": st["params"],
                                         "opt": st["opt"]})
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    tr.run(st, steps=1)
    tr2, st2 = make_trainer(cfg, steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = tree_map(lambda t: t.clone(), {"params": st2["params"],
                                             "opt": st2["opt"]})
    step = st2["step"]
    tr2.run(st2, steps=1)
    return (at2, resumed, step, tr.metrics_log[-1]["loss"],
            tr2.metrics_log[-1]["loss"])


def assert_block_grads(name, layer, tp, drop, seq=16):
    """Layer `layer`'s gradient tree of sum(out^2) through block_seq at
    `tp` equals the reference's vmap(grad) leaf for leaf (GRAD_RTOL,
    GRAD_ATOL_FRAC), and every copy of a replicated leaf holds the same,
    full gradient (tests/test_torch_grads.py's block probe)."""
    from repro.core import blocks as RB
    from repro.core.layer_kinds import layer_kinds as rkinds
    from repro_torch.core import blocks as B, model as M
    from repro_torch.core.layer_kinds import layer_kinds
    from repro_torch.parallel.layout import REPLICATED

    rcfg, cfg, canon = cfgs(name)
    kind, rkind = layer_kinds(cfg)[layer], rkinds(rcfg)[layer]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq)[None], (2, seq))
    rlay = RM._gqa_layout_or_none(rcfg, tp)
    rsplit = jax.jit(lambda p: RS.split_layer(p, rcfg, rkind, tp))(
        jax.tree.map(jnp.asarray, canon["layers"][layer]))

    def per_shard(p):
        out, _, _ = RB.block_seq(rcfg, rkind, rlay, p, jnp.asarray(x),
                                 jnp.asarray(pos), drop=drop, tp=tp,
                                 shard_idx=jax.lax.axis_index("model"),
                                 axis="model", q_chunk=64)
        return jnp.sum(out ** 2)

    g_ref = jax.jit(jax.vmap(jax.grad(per_shard), axis_name="model"))(rsplit)
    psplit = simtp.split_layer(from_reference(canon["layers"][layer], cfg),
                               cfg, kind, tp)
    p, leaves = simtp.grad_leaves(psplit)
    xs = torch.from_numpy(x)[None].expand(tp, 2, seq, cfg.d_model)
    with torch.enable_grad():
        out, _, _ = B.block_seq(cfg, kind, M._gqa_layout(cfg, tp), p, xs,
                                torch.from_numpy(pos.copy()), drop=drop,
                                q_chunk=64)
        g = simtp.grads_of((out ** 2).sum(), psplit, leaves)
    close_trees(g, g_ref)
    for gl, spec in zip(tree_leaves(g), tree_leaves(B.layer_specs(cfg,
                                                                  kind))):
        if spec == REPLICATED:
            torch.testing.assert_close(gl, gl[:1].expand_as(gl), rtol=0,
                                       atol=0)
    return kind
