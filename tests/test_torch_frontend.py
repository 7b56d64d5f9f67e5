"""PyTorch port vs JAX reference on the two modality-frontend configs,
internvl2-1b (GQA 4/2, qkv biases, tied embeddings, a vision stub) and
musicgen-medium (MHA, biases everywhere, LayerNorm, GELU, an untied
head, an audio stub): configs field for field, the `front` leaf, logits
with and without precomputed embeddings, a frontend prefill and its
greedy decode through the engine, text-only serving, and the repairs
of this slice (ROADMAP C10, C12).

Reduced configs, fp32, tp 2, the first of four blocks dropped; the
reference's perturbed canonical parameters carried across with
`core.convert.from_reference`; embeddings (B, Flen, frontend_dim) drawn
with numpy from a seed, as the reference's `tests/conftest.make_batch`
draws them."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as Fn  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import SPDPlanConfig as RPlan  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget, list_archs  # noqa: E402
from repro.core import model as RM, simtp as RS  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import SPDPlanConfig, replace  # noqa: E402
from repro_torch.configs import _MODULES, get_config  # noqa: E402
from repro_torch.core import model as M, simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.models.common import act_fn  # noqa: E402
from repro_torch.parallel.layout import REPLICATED  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ("internvl2-1b", "musicgen-medium")
TP, CACHE, N_DROP = 2, 64, 1
# fp32 end to end through 4 blocks and the head (test_torch_configs.py's)
LOGIT_ATOL = 1e-4
# jax.nn.gelu (tanh form) against torch's tanh form on [-6, 6]: one
# fp32 evaluation of the same formula in other orders
GELU_ATOL = 1e-6
# the erf form's distance from the tanh form (ROADMAP C10: 4.74e-4)
GELU_ERF_GAP = 1e-4
# rows of the engine cases: ragged lengths behind a prefix
LENS = (12, 9)
DECODE_STEPS = 6


def _cfgs(arch):
    return (rreplace(rget(arch, reduced=True), dtype="float32"),
            replace(get_config(arch, reduced=True), dtype="float32"))


_PAIRS = {}


def _pair(arch):
    """(reference LLM, port LLM) of `arch` at tp 2, the first block
    dropped, exact syncs, on the same perturbed parameters."""
    if arch not in _PAIRS:
        rcfg, cfg = _cfgs(arch)
        canon = perturbed_canonical(rcfg)
        kw = dict(tp=TP, spd=N_DROP / rcfg.n_layers, cache_len=CACHE,
                  q_chunk=64)
        ref = RLLM.load(rcfg, params=jax.tree.map(jnp.asarray, canon), **kw)
        port = LLM.load(cfg, device="cpu", params=from_reference(canon, cfg),
                        **kw)
        _PAIRS[arch] = ref, port
    return _PAIRS[arch]


def _inputs(cfg, lens=LENS, seed=5):
    """Right-padded tokens (B, max(lens)), lengths and embeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (len(lens), max(lens)))
    emb = rng.standard_normal((len(lens), cfg.frontend_len,
                               cfg.frontend_dim)).astype(np.float32)
    return toks, np.asarray(lens, np.int64), emb


def _drive(llm, toks, lens, emb, lengths, steps=DECODE_STEPS):
    """A frontend prefill through the engine (`lengths` as passed to it),
    then `steps` greedy decode steps at Flen + lens: the tokens (B,
    steps + 1) and the full logits (B, steps + 1, V), numpy."""
    eng, ref = llm.engine, not isinstance(llm.canonical["emb"],
                                          torch.Tensor)
    conv = jnp.asarray if ref else (lambda a: a)
    lg, caches = eng.prefill(llm.params, conv(toks), cache_len=CACHE,
                             lengths=conv(lengths), embeds=conv(emb))
    pos = llm.cfg.frontend_len + lens
    rows = [np.asarray(lg)]
    for _ in range(steps):
        cur = rows[-1].argmax(-1)[:, None]
        _, lg, caches = eng.decode_with_logits(llm.params, conv(cur),
                                               conv(pos), caches)
        rows.append(np.asarray(lg))
        pos = pos + 1
    lgs = np.stack(rows, 1)
    return lgs.argmax(-1), lgs


def test_gelu_is_the_references_tanh_form():
    """C10: act_fn("gelu") is jax.nn.gelu (approximate=True by default)
    within GELU_ATOL on 200001 points of [-6, 6]; F.gelu's default erf
    form, what the port mapped before, is not."""
    x = np.linspace(-6, 6, 200001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = act_fn("gelu")(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= GELU_ATOL
    assert np.abs(Fn.gelu(torch.from_numpy(x)).numpy() - want).max() > \
        GELU_ERF_GAP


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_for_field(arch, reduced):
    rcfg, cfg = rget(arch, reduced=reduced), get_config(arch,
                                                        reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    for prop in ("attn_free", "spd_applicable", "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(rcfg, prop), prop


def test_registry_holds_every_reference_config_in_its_order():
    assert list(_MODULES) == list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_front_leaf_is_replicated_and_split_as_the_reference(arch):
    """`front` (frontend_dim, d) in the canonical tree and the specs
    (REPLICATED); after padding and splitting at tp 2 every shard holds
    the reference's whole leaf, bit for bit."""
    rcfg, cfg = _cfgs(arch)
    canon = perturbed_canonical(rcfg)
    assert canon["front"].shape == (cfg.frontend_dim, cfg.d_model)
    ours = M.init_model(cfg)
    assert tuple(ours["front"].shape) == canon["front"].shape
    assert sorted(ours) == sorted(canon)
    assert M.model_specs(cfg)["front"] == REPLICATED
    plan = SPDPlanConfig.first_k(cfg.n_layers, N_DROP)
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, TP)
    rsplit = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg,
                               RPlan.first_k(rcfg.n_layers, N_DROP), TP)
    np.testing.assert_array_equal(split["front"].numpy(),
                                  np.asarray(rsplit["front"]))
    for t in range(TP):
        np.testing.assert_array_equal(split["front"][t].numpy(),
                                      canon["front"])


@pytest.mark.parametrize("with_embeds", [False, True],
                         ids=["tokens", "embeds"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch, with_embeds):
    """simtp.make_logits_fn(split, tokens, embeds): the token positions'
    logits, the prefix cut, within LOGIT_ATOL of the reference's."""
    rcfg, cfg = _cfgs(arch)
    canon = perturbed_canonical(rcfg)
    toks, _, emb = _inputs(cfg)
    emb = emb if with_embeds else None
    rsplit = RS.prepare_params(jax.tree.map(jnp.asarray, canon), rcfg,
                               RPlan.first_k(rcfg.n_layers, N_DROP), TP)
    want = np.asarray(RS.make_logits_fn(
        rcfg, RPlan.first_k(rcfg.n_layers, N_DROP), TP, q_chunk=64)(
        rsplit, jnp.asarray(toks), None if emb is None else jnp.asarray(emb)))
    plan = SPDPlanConfig.first_k(cfg.n_layers, N_DROP)
    split = simtp.prepare_params(from_reference(canon, cfg), cfg, plan, TP)
    got = simtp.make_logits_fn(cfg, plan, TP, q_chunk=64)(split, toks, emb)
    assert got.shape == want.shape == toks.shape + (cfg.vocab_size,)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_prefill_and_decode_match_reference(arch):
    """Engine.prefill(tokens, lengths=L, embeds=e) and six greedy decode
    steps at Flen + L: the same tokens as the reference's engine called
    with lengths=Flen + L (where it reads the last real token), every
    logits row within LOGIT_ATOL; the caches hold Flen + L positions."""
    ref, port = _pair(arch)
    toks, lens, emb = _inputs(port.cfg)
    flen = port.cfg.frontend_len
    rtoks, rlg = _drive(ref, toks, lens, emb, lens + flen)
    ptoks, plg = _drive(port, toks, lens, emb, lens)
    assert ptoks.tolist() == rtoks.tolist()
    np.testing.assert_allclose(plg, rlg, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_c12_reference_reads_lengths_inside_the_prefix(arch):
    """C12: the reference's prefill(lengths=L, embeds=e) takes the logits
    at L - 1 of the combined stream, inside the prefix: they differ
    from the port's, which equal the reference's at lengths=L + Flen and
    the last position of an unpadded row."""
    ref, port = _pair(arch)
    toks, lens, emb = _inputs(port.cfg, lens=(12, 12))
    flen = port.cfg.frontend_len
    got, _ = port.engine.prefill(port.params, toks, cache_len=CACHE,
                                 lengths=lens, embeds=emb)
    plain, _ = port.engine.prefill(port.params, toks, cache_len=CACHE,
                                   embeds=emb)
    right, _ = ref.engine.prefill(ref.params, jnp.asarray(toks),
                                  cache_len=CACHE,
                                  lengths=jnp.asarray(lens + flen),
                                  embeds=jnp.asarray(emb))
    wrong, _ = ref.engine.prefill(ref.params, jnp.asarray(toks),
                                  cache_len=CACHE, lengths=jnp.asarray(lens),
                                  embeds=jnp.asarray(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(right),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert np.abs(np.asarray(wrong) - np.asarray(right)).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_text_only_generate_matches_reference(arch):
    """LLM.generate passes no embeds (neither package's takes any): the
    greedy tokens of three prompts equal the reference's."""
    ref, port = _pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, port.cfg.vocab_size, n) for n in (5, 17, 30)]
    want = ref.generate([p.astype(np.int32) for p in prompts],
                        RSP(max_new=8))
    got = port.generate(prompts, SamplingParams(max_new=8))
    assert [o.token_ids for o in got] == [o.token_ids for o in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_frontends_page_through_the_fallback(arch):
    """A frontend config declines chunked prefill, speculation and the
    fused paged forward, as the reference's (model.py:532-539, :588-593,
    :659-665): paged text-only serving gathers, runs the dense step and
    scatters, with the dense run's tokens and every page back."""
    _, cfg = _cfgs(arch)
    assert not (M.supports_chunked_prefill(cfg)
                or M.supports_spec_decode(cfg)
                or M.supports_paged_attention(cfg))
    _, port = _pair(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 22)]
    dense = port.generate(prompts, SamplingParams(max_new=6))
    paged = LLM.load(cfg, tp=TP, spd=N_DROP / cfg.n_layers,
                     cache_len=CACHE, q_chunk=64, device="cpu",
                     params=port.canonical, page_size=8, num_pages=12)
    got = paged.generate(prompts, SamplingParams(max_new=6))
    assert [o.token_ids for o in got] == [o.token_ids for o in dense]
    assert paged.serve().pool.num_free == 12
