"""PyTorch port vs JAX reference: configs, layer segmentation, GQA head
layout and the split parameter leaves (exact equality)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config.base import SPDPlanConfig as RPlan, replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM, simtp as RS  # noqa: E402
from repro.core.layer_kinds import plan_segments as rsegs  # noqa: E402
from repro.parallel import layout as RL  # noqa: E402

from repro_torch.config.base import (CommPolicy, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.layer_kinds import plan_segments  # noqa: E402
from repro_torch.parallel import layout as L  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree (works on both packages)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["smollm-360m", "smollm-360m-reduced",
                                  "mamba2-370m", "mamba2-370m-reduced"])
def test_configs_match_field_for_field(name):
    rcfg, cfg = rget(name), get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    for prop in ("attn_free", "spd_applicable", "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(rcfg, prop), prop


def test_full_width_layout_pads_heads():
    cfg = get_config("smollm-360m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size) == (32, 960, 15, 5, 64,
                                                      2560, 49152)
    lay = L.make_gqa_layout(15, 5, 2)
    assert (lay.h_pad, lay.kv_layout, lay.q_local, lay.kv_local) == \
        (18, 6, 9, 3)
    # the kernel's row // group mapping needs q_local = group * kv_local
    assert lay.q_local == (lay.h_pad // lay.kv_layout) * lay.kv_local


@pytest.mark.parametrize("h,kv,tp", [(6, 2, 1), (6, 2, 2), (6, 2, 4),
                                     (15, 5, 2), (15, 5, 4), (8, 1, 8),
                                     (12, 3, 8), (32, 8, 4)])
def test_gqa_layout_matches_reference(h, kv, tp):
    ref, port = RL.make_gqa_layout(h, kv, tp), L.make_gqa_layout(h, kv, tp)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    np.testing.assert_array_equal(L.q_head_orig(port), RL.q_head_orig(ref))
    np.testing.assert_array_equal(L.kv_head_orig(port), RL.kv_head_orig(ref))


def test_mamba_config_is_attention_free():
    cfg = get_config("mamba2-370m")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.tie_embeddings,
            cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.chunk_size) == \
        (48, 1024, 50280, False, 128, 64, 256)
    assert cfg.attn_free and cfg.sub_quadratic and not cfg.spd_applicable
    drop = (False,) * 48
    assert [(s, ln, k.mixer, k.ffn) for s, ln, k, _ in
            plan_segments(cfg, drop, ("quant8",) * 48)] == \
        [(0, 48, "ssm", "none")]
    assert [(s, ln, dataclasses.asdict(k), d) for s, ln, k, d in
            plan_segments(cfg, drop)] == \
        [(s, ln, dataclasses.asdict(k), d) for s, ln, k, d in
         rsegs(rget("mamba2-370m"), drop, None)]


def test_plan_segments_match_reference():
    """The golden plan (spd=0.25 on the reduced model = first block
    dropped) and comm-refined plans segment identically."""
    name = "smollm-360m-reduced"
    rcfg, cfg = rget(name), get_config(name)
    n = cfg.n_layers
    golden = (tuple(i < round(n * 0.25) for i in range(n)), None)
    mixed = ((True, False, False, True),
             ("quant8", "quant8", "exact", "quant4"))
    for drop, qmodes in (golden, mixed, ((False,) * n, ("quant8",) * n)):
        ref = rsegs(rcfg, drop, qmodes)
        port = plan_segments(cfg, drop, qmodes)
        assert [(s, ln, dataclasses.asdict(k), d) for s, ln, k, d in port] \
            == [(s, ln, dataclasses.asdict(k), d) for s, ln, k, d in ref]


def _cfgs(which):
    if which == "reduced":
        return (rreplace(rget("smollm-360m", reduced=True), dtype="float32"),
                replace(get_config("smollm-360m-reduced"), dtype="float32"))
    if which.startswith("ssm"):
        # "ssm6": d_in 192 / head_dim 32 = 6 SSM heads, padded to 8 at tp=4
        kw = dict(dtype="float32", **({"d_model": 96} if which == "ssm6"
                                      else {}))
        return (rreplace(rget("mamba2-370m-reduced"), **kw),
                replace(get_config("mamba2-370m-reduced"), **kw))
    # the full config's head counts (15 q / 5 kv) at a small width
    kw = dict(n_layers=2, d_model=120, d_head=8, d_ff=66, vocab_size=509,
              dtype="float32")
    return (rreplace(rget("smollm-360m"), **kw),
            replace(get_config("smollm-360m"), **kw))


@pytest.mark.parametrize("which", ["reduced", "heads15x5", "ssm", "ssm6"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_split_leaves_match_reference(which, tp):
    """Every split leaf of the port's pad -> stack -> split equals the
    reference's simtp.prepare_params bit for bit (head padding, vocab and
    d_ff padding, replication, segment stacking; for Mamba2 the SSM head
    padding, the replicated B/C projection and conv, the untied head)."""
    rcfg, cfg = _cfgs(which)
    drop = (True,) + (False,) * (cfg.n_layers - 1)
    rplan = RPlan(drop)
    plan = SPDPlanConfig(drop)
    canon = RM.init_model(jax.random.PRNGKey(0), rcfg)
    ref = _flat(RS.prepare_params(canon, rcfg, rplan, tp))
    port = _flat(simtp.prepare_params(
        from_reference(jax.tree.map(np.asarray, canon), cfg), cfg, plan, tp))
    assert sorted(port) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(_np(port[path]), _np(leaf),
                                      err_msg=path)


def test_comm_segmentation_restacks_identically():
    """A comm policy refines the segments; the split tree follows."""
    rcfg, cfg = _cfgs("reduced")
    modes = ("quant8", "exact", "exact", "quant4")
    drop = (True, True, False, False)
    canon = RM.init_model(jax.random.PRNGKey(1), rcfg)
    from repro.config.base import CommPolicy as RComm
    ref = _flat(RS.prepare_params(canon, rcfg, RPlan(drop, RComm(modes)), 2))
    port = _flat(simtp.prepare_params(
        from_reference(jax.tree.map(np.asarray, canon), cfg), cfg,
        SPDPlanConfig(drop, CommPolicy(modes)), 2))
    assert sorted(port) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(_np(port[path]), _np(leaf),
                                      err_msg=path)


def test_split_merge_roundtrip():
    w = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 48)
    for axis in (0, 1):
        s = L.split_leaf(w, axis, 4)
        assert s.shape[0] == 4 and s.is_contiguous()
        torch.testing.assert_close(L.merge_leaf(s, axis, 4), w,
                                   rtol=0, atol=0)
    r = L.split_leaf(w, L.REPLICATED, 3)
    assert r.shape == (3, 4, 48)
    torch.testing.assert_close(L.merge_leaf(r, L.REPLICATED, 3), w,
                               rtol=0, atol=0)
