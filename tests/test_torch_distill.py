"""PyTorch port vs JAX reference: Algorithm 1's recovery half.

AdamW (fp32 moments, master copies on and off, bf16 params) and the LR
schedules; the block-input capture; block-to-block distillation's
per-step losses and student params; `apply_spd` with the default
strategies ("ZS", "B2B", "HG") through the core function and the `LLM`
facade, and the greedy tokens served after it.  Reduced configs in fp32,
the reference's parameters with every bias / norm / position leaf
perturbed off its constant, carried across with
`core.convert.from_reference`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import distill as RDi, model as RM, simtp as RS  # noqa: E402
from repro.core import spd as RSPD  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402
from repro.optim import adamw as RA, schedule as RSch  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import SPDPlanConfig, replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import distill as D, model as M, simtp  # noqa: E402
from repro_torch.core import spd as SPD  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import layer_kinds  # noqa: E402
from repro_torch.optim import adamw as A, make_schedule  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TP = 2
# fp32 block forwards: XLA and torch sum in other orders
HIDDEN_ATOL = 1e-5
LOSS_RTOL = 1e-4            # per-step distillation MSE
LR = 1e-3

_SETUPS = {}


def _setup(name):
    if name not in _SETUPS:
        rcfg = rreplace(rget(name, reduced=True), dtype="float32")
        cfg = replace(get_config(name, reduced=True), dtype="float32")
        canon = perturbed_canonical(rcfg)
        calib = RD.calibration_batches(rcfg.vocab_size, 4, 32, batch=2)
        _SETUPS[name] = (rcfg, cfg, canon, calib)
    return _SETUPS[name]


def _student_bound(lr, n_steps):
    """Where a gradient element is ~0 its Adam step m/(sqrt(v)+eps) is
    ~sign(g), which float noise may flip: up to 2 lr apart per step."""
    return 2 * lr * n_steps


# ---------------------------------------------------------------------------
# AdamW and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False])
def test_adamw_matches_reference(master, dtype):
    """Three steps with weight decay and a tensor lr from the schedule:
    params (cast back to their dtype), moments and masters equal the
    reference's to 1e-6 relative in fp32; bf16 params to one bf16 ulp."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": [(7,), (2, 2, 4)]}
    p_np = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
            "b": [rng.standard_normal(s).astype(np.float32)
                  for s in shapes["b"]]}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    pp = {"a": torch.from_numpy(p_np["a"]).to(tdt),
          "b": [torch.from_numpy(a).to(tdt) for a in p_np["b"]]}
    rs, ps = RA.adamw_init(rp, master=master), A.adamw_init(pp, master=master)
    rsched = RSch.make_schedule("cosine", base_lr=1e-2, warmup=1, total=5)
    psched = make_schedule("cosine", base_lr=1e-2, warmup=1, total=5)
    for step in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), p_np)
        rg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np)
        pg = {"a": torch.from_numpy(g_np["a"]).to(tdt),
              "b": [torch.from_numpy(a).to(tdt) for a in g_np["b"]]}
        rp, rs = RA.adamw_update(rg, rs, rp, lr=rsched(step + 1),
                                 weight_decay=0.1)
        pp, ps = A.adamw_update(pg, ps, pp, lr=psched(step + 1),
                                weight_decay=0.1)
    assert ps["step"] == int(rs["step"]) == 3
    tol = dict(rtol=1e-6, atol=1e-7)
    for k in ("m", "v") + (("master",) if master else ()):
        for a, b in zip(tree_leaves(ps[k]), jax.tree.leaves(rs[k])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        assert a.dtype == tdt
        b = np.asarray(b.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7,
                                       atol=0)
        else:
            np.testing.assert_allclose(a.numpy(), b, **tol)


def test_schedules_and_clipping_match_reference():
    for kind in ("cosine", "linear", "constant"):
        r = RSch.make_schedule(kind, base_lr=3e-4, warmup=4, total=20,
                               final_frac=0.2)
        p = make_schedule(kind, base_lr=3e-4, warmup=4, total=20,
                          final_frac=0.2)
        for s in (0, 1, 3, 4, 5, 12, 20, 25):
            np.testing.assert_allclose(float(p(s)), float(r(s)), rtol=1e-6)
    g = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "y": [
        np.full((4,), -2.0, np.float32)]}
    rg, rn = RA.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.5)
    pg, pn = A.clip_by_global_norm({"x": torch.from_numpy(g["x"]), "y": [
        torch.from_numpy(g["y"][0])]}, 1.5)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    for a, b in zip(tree_leaves(pg), jax.tree.leaves(rg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    up = A.apply_updates({"x": torch.ones(2, dtype=torch.bfloat16)},
                         {"x": torch.full((2,), 0.5)})
    assert up["x"].dtype == torch.bfloat16 and up["x"].tolist() == [1.5, 1.5]


# ---------------------------------------------------------------------------
# Block-input capture
# ---------------------------------------------------------------------------

def test_capture_block_inputs_matches_reference():
    """llama2-7b (RoPE): every block input within HIDDEN_ATOL (scaled) of
    the reference's.  OPT: equal to the reference's once its learned
    position table is zero (the reference's collect function leaves the
    table out), and with the table the capture is the forward's own
    stream: entry 0 is embedding + positions, the final norm of entry L
    is forward_seq's output."""
    rcfg, cfg, canon, calib = _setup("llama2-7b")
    ref = RSPD.capture_block_inputs(
        rcfg, RM.pad_model(jax.tree.map(jnp.asarray, canon), rcfg, TP), TP,
        calib[:2], q_chunk=64)
    got = SPD.capture_block_inputs(
        cfg, M.pad_model(from_reference(canon, cfg), cfg, TP), TP,
        calib[:2], q_chunk=64)
    assert len(got) == 2
    for a, b in zip(got, ref):
        assert tuple(a.shape) == (cfg.n_layers + 1, 2, 32, cfg.d_model)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=HIDDEN_ATOL * np.abs(b).max())
    rcfg, cfg, canon, calib = _setup("opt-6.7b")
    zero = dict(canon, pos=np.zeros_like(canon["pos"]))
    ref = RSPD.capture_block_inputs(
        rcfg, RM.pad_model(jax.tree.map(jnp.asarray, zero), rcfg, TP), TP,
        calib[:1], q_chunk=64)
    got = SPD.capture_block_inputs(
        cfg, M.pad_model(from_reference(zero, cfg), cfg, TP), TP, calib[:1],
        q_chunk=64)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0,
                               atol=HIDDEN_ATOL * np.abs(ref[0]).max())
    pcanon = from_reference(canon, cfg)
    plan = SPDPlanConfig.none(cfg.n_layers)
    split = simtp.prepare_params(pcanon, cfg, plan, TP)
    h = SPD.capture_block_inputs(cfg, None, TP, calib[:1], q_chunk=64,
                                 split0=split)[0]
    tokens = torch.from_numpy(calib[0]["tokens"])
    with torch.no_grad():
        x, _, _, _ = M.forward_seq(cfg, split, plan, tokens, tp=TP, q_chunk=64)
        last = M._final_norm(split, cfg, h[-1][None].expand(TP, *h[-1].shape))
        emb = pcanon["emb"][tokens] + pcanon["pos"][:tokens.shape[1]]
    torch.testing.assert_close(last[0], x[0], rtol=0, atol=0)
    torch.testing.assert_close(h[0], emb, rtol=1e-6, atol=1e-6)
    assert not h.requires_grad and not h.is_inference()


# ---------------------------------------------------------------------------
# B2B distillation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama2-7b", "opt-6.7b"])
def test_b2b_distill_matches_reference(name):
    """Two epochs over two batches of layer 2's input at lr 1e-4 (at 1e-3
    OPT's loss oscillates in both packages): the per-step losses within
    LOSS_RTOL of the reference's, each batch's loss falls from the first
    epoch to the second, and the student params stay within
    _student_bound(lr, 4) of the reference's (near-zero gradient
    elements), most of them far closer."""
    rcfg, cfg, canon, calib = _setup(name)
    bi = 2
    rkind, kind = rkinds(rcfg)[bi], layer_kinds(cfg)[bi]
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
          for _ in range(2)]
    rteacher = RS.split_layer(jax.tree.map(jnp.asarray, canon["layers"][bi]),
                              rcfg, rkind, TP)
    lr = 1e-4
    rstudent, rlosses = RDi.b2b_distill(rcfg, rkind, TP, rteacher, xs, lr=lr,
                                        epochs=2, q_chunk=64)
    teacher = simtp.split_layer(from_reference(canon["layers"][bi], cfg),
                                cfg, kind, TP)
    student, losses = D.b2b_distill(cfg, kind, TP, teacher, xs, lr=lr,
                                    epochs=2, q_chunk=64)
    assert len(losses) == len(rlosses) == 4
    np.testing.assert_allclose(losses, rlosses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0] and losses[3] < losses[1], losses
    bound = _student_bound(lr, 4)
    off = 0
    n = 0
    for a, b in zip(tree_leaves(student), jax.tree.leaves(rstudent)):
        d = np.abs(a.numpy() - np.asarray(b))
        assert d.max() <= bound + 1e-6, d.max()
        off += int((d > 1e-5).sum())
        n += d.size
    assert off <= 0.01 * n, (off, n)
    # the teacher is left as it was
    for a, b in zip(tree_leaves(teacher), jax.tree.leaves(rteacher)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The whole pipeline
# ---------------------------------------------------------------------------

def _thresholds(sens, kind):
    """(tau1, tau2): all chosen blocks SB, or the cheaper half SB and the
    dearer ESB (halfway between sorted sensitivities)."""
    if kind == "sb":
        return -1e18, 1e18
    s = np.sort(sens)
    return -1e18, float((s[0] + s[1]) / 2)


@pytest.mark.parametrize("tiers", ["sb", "esb"])
def test_apply_spd_with_recovery_matches_reference(tiers):
    """apply_spd(("ZS", "B2B", "HG")) on llama2-7b reduced, n_spd=2, two
    epochs over two calibration batches: the plan, the categories, the
    groupings and the padded params' tree equal the reference's; the
    distill losses within LOSS_RTOL; the distilled layers within
    _student_bound(LR, 4) and every other layer bit for bit."""
    rcfg, cfg, canon, calib = _setup("llama2-7b")
    rcanon = jax.tree.map(jnp.asarray, canon)
    rres, _ = RSPD.sweep_sensitivity(rcfg, rcanon, calib[:2], TP, q_chunk=64)
    t1, t2 = _thresholds(rres.sensitivity[rres.ranking[:2]], tiers)
    kw = dict(n_spd=2, tau1=t1, tau2=t2, lr=LR, epochs=2, q_chunk=64)
    rpad, rplan, rrep = RSPD.apply_spd(rcfg, rcanon, calib[:2], TP, **kw)
    ppad, pplan, prep = SPD.apply_spd(cfg, from_reference(canon, cfg),
                                      calib[:2], TP, **kw)
    assert pplan.drop_mask == rplan.drop_mask
    assert prep.chosen == rrep.chosen
    assert prep.categories == rrep.categories
    want = {"sb": {"SB"}, "esb": {"SB", "ESB"}}[tiers]
    assert set(prep.categories) == want
    assert sorted(prep.distill_losses) == sorted(rrep.distill_losses)
    for bi, losses in rrep.distill_losses.items():
        np.testing.assert_allclose(prep.distill_losses[bi], losses,
                                   rtol=LOSS_RTOL)
    assert sorted(prep.grouping) == sorted(rrep.grouping)
    for bi, g in rrep.grouping.items():
        got = prep.grouping[bi]
        assert (got.supported, got.groups, got.assignment) == (
            g.supported, g.groups, g.assignment)
        np.testing.assert_allclose(got.score, g.score, rtol=1e-5)
    assert set(prep.seconds) == {"sweep", "capture", "grouping", "distill"}
    bound = _student_bound(LR, 4)
    for li, (a, b) in enumerate(zip(ppad["layers"], rpad["layers"])):
        for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
            y = np.asarray(y)
            if li in prep.distill_losses:
                assert np.abs(x.numpy() - y).max() <= bound + 1e-6
            else:
                np.testing.assert_array_equal(x.numpy(), y)


def test_facade_apply_spd_with_recovery_matches_reference():
    """LLM.apply_spd with the default strategies (both SB and ESB blocks
    chosen) places the distilled padded params; a greedy generate after
    it gives the reference facade's tokens."""
    rcfg, cfg, canon, calib = _setup("llama2-7b")
    ref = RLLM.load(rcfg, tp=TP, cache_len=64,
                    params=jax.tree.map(jnp.asarray, canon))
    port = LLM.load(cfg, tp=TP, cache_len=64, device="cpu",
                    params=from_reference(canon, cfg))
    rres, _ = RSPD.sweep_sensitivity(rcfg, ref.canonical, calib[:2], TP,
                                     q_chunk=64)
    t1, t2 = _thresholds(rres.sensitivity[rres.ranking[:2]], "esb")
    kw = dict(n_spd=2, tau1=t1, tau2=t2, lr=LR, epochs=2)
    rrep = ref.apply_spd(calib[:2], **kw)
    prep = port.apply_spd(calib[:2], **kw)
    assert prep.categories == rrep.categories and "ESB" in prep.categories
    assert port.plan.drop_mask == ref.plan.drop_mask
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (6, 19)]
    want = [o.token_ids for o in ref.generate(prompts, RSP(max_new=6))]
    got = [o.token_ids for o in port.generate(prompts,
                                              SamplingParams(max_new=6))]
    assert got == want
