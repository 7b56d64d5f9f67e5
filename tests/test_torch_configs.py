"""PyTorch port vs JAX reference on the five dense configurations the
port registers beside SmolLM: llama2-7b, opt-6.7b (biases, learned
positions, LayerNorm, ReLU MLP: the paper's Fig. 3b block), qwen2-72b
(QKV bias, GQA 8/1), qwen3-1.7b (qk-norm) and stablelm-1.6b (LayerNorm,
partial RoPE).  Configs field for field, split leaves at tp 2 and 4,
LayerNorm and qk-norm against the reference's functions, prefill logits,
and greedy dense tokens at tp=2 with spd on and off.  Reduced configs,
fp32, the reference's parameters carried across with
`core.convert.from_reference` after perturbing every bias, norm and
position leaf (the reference initialises them to 0 and 1, which would
hide a bias or norm wired wrongly)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import SPDPlanConfig as RPlan, replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.core import blocks as RB, simtp as RS  # noqa: E402
from repro.core.layer_kinds import layer_kinds as rkinds  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.parallel.layout import make_gqa_layout as rlayout  # noqa: E402
from repro.runtime.forward import bucketed_prefill as rprefill  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import SPDPlanConfig, replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import blocks as B, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.parallel.layout import make_gqa_layout  # noqa: E402
from repro_torch.runtime.forward import bucketed_prefill  # noqa: E402
from torch_parity import perturb, perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

NAMES = ("llama2-7b", "opt-6.7b", "qwen2-72b", "qwen3-1.7b",
         "stablelm-1.6b")
# fp32 end to end through 4 blocks and the head; XLA and torch sum in
# other orders, everything else is the same arithmetic
LOGIT_ATOL = 1e-4
# one fp32 normalisation of 128-wide rows: the mean and variance are
# summed in other orders
NORM_ATOL = 1e-6


def _flat(tree, prefix=""):
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


def _cfgs(name, **kw):
    kw.setdefault("dtype", "float32")
    return (rreplace(rget(name, reduced=True), **kw),
            replace(get_config(name, reduced=True), **kw))


def _load_both(name, spd, **kw):
    rcfg, cfg = _cfgs(name)
    canon = perturbed_canonical(rcfg)
    ref = RLLM.load(rcfg, tp=2, spd=spd, cache_len=64,
                    params=jax.tree.map(jnp.asarray, canon), **kw)
    port = LLM.load(cfg, tp=2, spd=spd, cache_len=64, device="cpu",
                    params=from_reference(canon, cfg), **kw)
    return ref, port


def _prompts(vocab, lens=(5, 17, 30), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_configs_match_field_for_field(name, reduced):
    rcfg, cfg = rget(name, reduced=reduced), get_config(name,
                                                        reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    for prop in ("attn_free", "spd_applicable", "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(rcfg, prop), prop


def test_paper_models_at_full_width():
    """The shapes the card serves: 32 q and 32 kv heads of 128 (group 1),
    so 16 of each a shard at tp=2; OPT's vocab splits into 25136 columns
    a shard."""
    llama, opt = get_config("llama2-7b"), get_config("opt-6.7b")
    for cfg in (llama, opt):
        lay = make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, 2)
        assert (cfg.d_model, cfg.d_head, lay.q_local, lay.kv_local) == (
            4096, 128, 16, 16)
    assert (llama.vocab_size // 2, opt.vocab_size // 2) == (16000, 25136)
    assert (opt.norm, opt.pos_emb, opt.act, opt.gated_mlp) == (
        "layernorm", "learned", "relu", False)
    assert 6.7e9 < llama.param_count() < 6.8e9


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_split_leaves_match_reference(name, tp):
    """Every split leaf (norm biases, qk-norm weights, the position table
    included) equals the reference's simtp.prepare_params bit for bit."""
    rcfg, cfg = _cfgs(name)
    lay = rlayout(rcfg.n_heads, rcfg.n_kv_heads, tp)
    assert dataclasses.asdict(lay) == dataclasses.asdict(
        make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp))
    drop = (True, False, True, False)
    canon = perturbed_canonical(rcfg)
    ref = _flat(RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg,
                                  RPlan(drop), tp))
    port = _flat(simtp.prepare_params(from_reference(canon, cfg), cfg,
                                      SPDPlanConfig(drop), tp))
    assert sorted(port) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(_np(port[path]), _np(leaf),
                                      err_msg=path)
    extra = {"opt-6.7b": ("/pos", "/lnf/b", "/segs/0/ln1/b"),
             "qwen3-1.7b": ("/segs/0/attn/qn", "/segs/0/attn/kn"),
             "stablelm-1.6b": ("/segs/0/ln2/b",)}.get(name, ())
    assert all(p in port for p in extra), extra


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32) * 3 + 0.5
    w = 1 + 0.1 * rng.standard_normal(128).astype(np.float32)
    b = 0.1 * rng.standard_normal(128).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ref = RC.layernorm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                       jnp.asarray(b, jd), 1e-5)
    out = C.layernorm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                      torch.from_numpy(b).to(td), 1e-5)
    assert out.dtype == td
    # bf16: the same fp32 normalisation, then one rounding each of y, y*w
    # and y*w+b; a flipped rounding is one bf16 step of |y*w+b| <~ 8
    tol = NORM_ATOL if dtype == "float32" else 2 ** -8 * 8
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("tp", [1, 2])
def test_qk_norm_qkv_matches_reference(tp):
    """qwen3's per-head qk RMSNorm inside `_qkv` (weights qn/kn of one
    head width, replicated over the shards) against the reference's
    `_qkv` under vmap."""
    rcfg, cfg = _cfgs("qwen3-1.7b")
    rkind = rkinds(rcfg)[0]
    lp = perturb(jax.tree.map(np.asarray, RB.init_layer(
        jax.random.PRNGKey(2), rcfg, rkind)), np.random.default_rng(5))
    rsplit = RS.split_layer(jax.tree.map(jnp.asarray, lp), rcfg, rkind, tp)
    psplit = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rsplit)
    lay = rlayout(rcfg.n_heads, rcfg.n_kv_heads, tp)
    h = np.random.default_rng(1).standard_normal((2, 9, rcfg.d_model))
    h = h.astype(np.float32)
    rq, rk, rv = jax.vmap(lambda a: RB._qkv(rcfg, a, jnp.asarray(h), lay,
                                            "model"),
                          axis_name="model")(rsplit["attn"])
    q, k, v = B._qkv(cfg, psplit["attn"],
                     torch.from_numpy(h)[None].expand(tp, -1, -1, -1),
                     make_gqa_layout(cfg.n_heads, cfg.n_kv_heads, tp))
    for a, r in ((q, rq), (k, rk), (v, rv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=NORM_ATOL,
                                   rtol=0)
    # the norm did act: unit rms per head, up to the weights
    raw = torch.einsum("tbsd,tdn->tbsn",
                       torch.from_numpy(h)[None].expand(tp, -1, -1, -1),
                       psplit["attn"]["wq"])
    assert not torch.allclose(raw.reshape(q.shape), q)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_match_reference(name):
    """Prefill logits at tp=2 with half the blocks dropped (the bias
    re-add of Fig. 3b on OPT's and qwen2's dropped blocks, learned
    positions, LayerNorm, qk-norm, partial RoPE)."""
    ref, port = _load_both(name, spd=0.5)
    for p in _prompts(ref.cfg.vocab_size):
        rl, _ = rprefill(ref.engine, ref.params, p, len(p), 64)
        pl, _ = bucketed_prefill(port.engine, port.params, p, len(p), 64)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl),
                                   atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("spd", [0.0, 0.5])
@pytest.mark.parametrize("name", NAMES)
def test_dense_greedy_tokens_match_reference(name, spd):
    """Greedy tokens of `generate` (dense caches) equal the reference's;
    decode runs 8 tokens past each prompt, so OPT reads its position
    table at decode positions."""
    ref, port = _load_both(name, spd=spd)
    prompts = _prompts(ref.cfg.vocab_size)
    want = [o.token_ids for o in ref.generate(prompts, RSP(max_new=8))]
    got = [o.token_ids for o in port.generate(prompts,
                                              SamplingParams(max_new=8))]
    assert got == want
