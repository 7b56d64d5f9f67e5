"""Speculative decoding and chunked prefill on the shard engine (one
process per TP shard over gloo) against the port's `sim` engine, its
own plain decoding and the JAX reference's `engine="shard"`.

Reduced SmolLM-360M and LLaMA2-7B, fp32, spd 0.25, on the reference's
parameters with every bias, norm and position leaf moved off its
constant, carried over with `convert.from_reference`.  One spawn per
layout (tp 2 dp 1, tp 2 dp 2) runs every case of it (`torch_dist.py`);
both start at the first test that reads one and run beside the sim and
reference runs of this process.

  * greedy chain (all-drop, k 3) and adaptive-tree speculation, dense
    and paged, and chain speculation over chunked prefill: tokens equal
    plain greedy on the same ranks, sim's speculation (with its round
    and acceptance counters) and, on the paths of `REF_PATHS`, the
    reference's shard engine with the same SpecConfig;
  * sampled speculation equals sim's at dp 1 and dp 2: at dp 2 each data
    rank draws its own rows with their own generators;
  * chunked prefill (chunk 8), dense and paged: tokens equal whole
    prefill's and sim's; chunk, verify and paged-verify logits within
    2e-5 of sim's;
  * rank 0's ledger, the draft forwards' and the target forwards'
    entries, equals sim's entry for entry at dp 1;
  * the calibrated search and the tiered plan reach sim's policy on
    every rank (at dp 2 the preset's candidates reach one policy on
    every rank and serve plain greedy's tokens; the drop-only search
    reaches sim's);
  * every rank returns the same values, and each rank checked at every
    admission, decode step and speculative round that the others took
    the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.spec import SpecConfig as RSpec  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
import torch_dist as TD  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ("smollm-360m", "llama2-7b")
LAYOUTS = ((2, 1), (2, 2))
LENS = (5, 9, 17, 3)
PAGED = dict(page_size=8, num_pages=24)
CHAIN = dict(k=3, draft="all-drop")
TREE = dict(k=3, draft="all-drop", adaptive=True, k_max=5, tree_width=2)
# each path: (SpecConfig fields or None, other load arguments)
PATHS = {"plain": (None, {}),
         "chain": (CHAIN, {}),
         "chain paged": (CHAIN, PAGED),
         "tree": (TREE, {}),
         "tree paged": (TREE, PAGED),
         "chain chunk": (CHAIN, dict(prefill_chunk=8)),
         "chunk": (None, dict(prefill_chunk=8)),
         "chunk paged": (None, dict(PAGED, prefill_chunk=8))}
SPEC_PATHS = ("chain", "chain paged", "tree", "tree paged", "chain chunk")
SAMPLED_PATHS = ("chain", "chain paged")
# the paths also served by the reference's shard engine: every path
# kind on each arch and layout, one reference run each (a run compiles
# its prefill, decode, draft and verify programs: ~10 s on the CPU)
REF_PATHS = {((2, 1), "smollm-360m"): ("chain", "chunk"),
             ((2, 1), "llama2-7b"): ("tree paged",),
             ((2, 2), "smollm-360m"): ("tree paged",),
             ((2, 2), "llama2-7b"): ("chain", "chunk paged")}
# a prompt of 13 prefilled in chunks of 8, then a verify chunk of 4
LOGITS_CASE = dict(len=13, chunk=8, verify=[11, 7, 301, 42])
# fp32 logits, shard against sim: the reference's own sim-vs-shard bound
# (tests/test_engines.py), as in test_torch_shard.py
LOGITS_ATOL = 2e-5


def _cfg(arch):
    return replace(get_config(arch, reduced=True), dtype="float32")


def _rcfg(arch):
    return rreplace(rget(arch, reduced=True), dtype="float32")


def _load_kw(path):
    spec, kw = PATHS[path]
    return dict(kw, spec=SpecConfig(**spec)) if spec else dict(kw)


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    """{arch: (reference numpy tree, port tree)} and the ranks' file."""
    trees = {a: perturbed_canonical(_rcfg(a)) for a in ARCHS}
    port = {a: from_reference(t, _cfg(a)) for a, t in trees.items()}
    path = tmp_path_factory.mktemp("shard_spec") / "canon.pt"
    torch.save(port, path)
    return trees, port, str(path)


def _cases(tp, dp):
    cases = []
    for a in ARCHS:
        cfg = _cfg(a)
        for path in PATHS:
            cases.append(dict(kind="serve", name=f"{a} {path}", arch=a,
                              cfg=cfg, lens=LENS,
                              sampled=path in SAMPLED_PATHS,
                              load=_load_kw(path)))
        cases.append(dict(LOGITS_CASE, kind="spec_logits",
                          name=f"{a} logits", arch=a, cfg=cfg))
    # LLaMA's sweep and search; a bar no candidate reaches walks every
    # candidate and keeps the best-measuring one.  At dp 2 a data rank's
    # products run on its own rows and part from sim's by ulps, which an
    # int4 code can turn into another draft token (ROADMAP C9): there
    # the preset's candidates are held to every rank's agreement and to
    # plain greedy, and a search over drop-only candidates, whose
    # acceptances are sim's exactly, to sim's
    policy = dict(kind="draft_policy", arch="llama2-7b",
                  cfg=_cfg("llama2-7b"), lens=LENS[:2], target=1.01)
    cases.append(dict(policy, name="policy", sim=dp == 1))
    if dp > 1:
        cases.append(dict(policy, name="policy drops", drops_only=True))
    return cases


@pytest.fixture(scope="module")
def runs(canon):
    """runs(tp, dp) -> (the ranks' results, the sim engine's results):
    one spawn per layout, both started at the first use and run beside
    this process's own work (sim, the reference)."""
    _, port, path = canon
    jobs = {lay: dict(tp=lay[0], dp=lay[1], params=path,
                      cases=_cases(*lay)) for lay in LAYOUTS}
    waits = {lay: TD.start(job, deadline_s=300, timeout_s=60)
             for lay, job in jobs.items()}
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            job = jobs[(tp, dp)]
            sim = {}
            for case in job["cases"]:
                if not case.get("sim", True):
                    continue
                llm = TD.load(case["cfg"], port[case["arch"]], "sim", tp,
                              **case.get("load", {}))
                sim[case["name"]] = TD.LLM_CASES[case["kind"]](llm, case)
            done[(tp, dp)] = waits[(tp, dp)](), sim
        return done[(tp, dp)]

    return get


@pytest.fixture(scope="module")
def reference(canon):
    """reference(tp, dp, arch, path) -> the reference shard engine's
    greedy tokens on LENS, made once."""
    trees = canon[0]
    done = {}

    def get(tp, dp, arch, path):
        key = (tp, dp, arch, path)
        if key not in done:
            spec, kw = PATHS[path]
            if spec:
                kw = dict(kw, spec=RSpec(**spec))
            rcfg = _rcfg(arch)
            ref = RLLM.load(rcfg, tp=tp, dp=dp, engine="shard", spd=0.25,
                            cache_len=64, max_batch=4, q_chunk=64,
                            params=jax.tree.map(jnp.asarray, trees[arch]),
                            **kw)
            done[key] = [o.token_ids for o in ref.generate(
                TD.prompts(rcfg.vocab_size, LENS), RSP(max_new=6))]
        return done[key]

    return get


def _same_on_every_rank(ranks, name, key):
    for r in ranks[1:]:
        assert r[name][key] == ranks[0][name][key], (name, key)


def _grid(paths, layouts=LAYOUTS):
    return [(lay, a, p) for lay in layouts for a in ARCHS for p in paths]


def _ids(case):
    (tp, dp), a, p = case
    return f"tp{tp}dp{dp}-{a}-{p.replace(' ', '_')}"


@pytest.mark.parametrize("case", _grid(SPEC_PATHS), ids=_ids)
def test_greedy_spec_tokens(runs, reference, case):
    """Speculation commits plain decoding's tokens, as sim's does, with
    sim's rounds, drafts, acceptances and adoptions; the reference's
    shard engine gives the same tokens on REF_PATHS."""
    (tp, dp), arch, path = case
    ranks, sim = runs(tp, dp)
    name = f"{arch} {path}"
    _same_on_every_rank(ranks, name, "greedy")
    _same_on_every_rank(ranks, name, "spec")
    got = ranks[0][name]
    assert got["greedy"] == ranks[0][f"{arch} plain"]["greedy"]
    assert got["greedy"] == sim[name]["greedy"]
    assert got["spec"] == sim[name]["spec"]
    assert got["spec"]["rounds"] > 0 and got["spec"]["accepted"] > 0
    if path in REF_PATHS.get(((tp, dp), arch), ()):
        assert got["greedy"] == reference(tp, dp, arch, path)


@pytest.mark.parametrize("case", _grid(SAMPLED_PATHS), ids=_ids)
def test_sampled_spec_tokens_equal_sim(runs, case):
    """Rejection-sampled speculation: the drafts are drawn on the device
    with each row's generators (at dp 2 a data rank's own rows' only),
    acceptance on every rank's host with the same seeds."""
    (tp, dp), arch, path = case
    ranks, sim = runs(tp, dp)
    name = f"{arch} {path}"
    _same_on_every_rank(ranks, name, "sampled")
    assert ranks[0][name]["sampled"] == sim[name]["sampled"]


@pytest.mark.parametrize("case", _grid(("chunk", "chunk paged")),
                         ids=_ids)
def test_chunked_prefill_tokens(runs, reference, case):
    """Prompts prefilled in chunks of 8 (the caches of a chunked prefill
    hold every row on each data rank, and the slot insert picks the
    right one) decode whole prefill's tokens, as sim's do."""
    (tp, dp), arch, path = case
    ranks, sim = runs(tp, dp)
    name = f"{arch} {path}"
    _same_on_every_rank(ranks, name, "greedy")
    got = ranks[0][name]["greedy"]
    assert got == ranks[0][f"{arch} plain"]["greedy"]
    assert got == sim[name]["greedy"]
    if path in REF_PATHS.get(((tp, dp), arch), ()):
        assert got == reference(tp, dp, arch, path)


@pytest.mark.parametrize("case", _grid(("logits",)), ids=_ids)
def test_chunk_and_verify_logits(runs, case):
    (tp, dp), arch, _ = case
    ranks, sim = runs(tp, dp)
    name = f"{arch} logits"
    for r in ranks:
        for key in ("chunk", "verify", "verify_paged"):
            np.testing.assert_allclose(r[name][key], sim[name][key],
                                       rtol=0, atol=LOGITS_ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("case", _grid(SPEC_PATHS, [(2, 1)]), ids=_ids)
def test_rank0_ledger_equals_sim(runs, case):
    """Entry for entry (op, axis, bytes, overlappable, block, phase): the
    draft forwards log the all-drop plan's kept syncs, the verify
    forwards the target's, on the shard engine as on sim."""
    lay, arch, path = case
    ranks, sim = runs(*lay)
    name = f"{arch} {path}"
    got = ranks[0][name]["ledger"]
    assert got and got == sim[name]["ledger"]


# (layout, the case held to sim): the preset's candidates at dp 1, the
# drop-only search at dp 2
POLICY_SIM = (((2, 1), "policy"), ((2, 2), "policy drops"))


@pytest.mark.parametrize("case", POLICY_SIM,
                         ids=lambda v: f"tp{v[0][0]}dp{v[0][1]}")
def test_draft_policy_equals_sim(runs, case):
    """Every rank runs the same sweep and the same search: the calibrated
    winner, each candidate's measured acceptance and tokens a step, and
    the tiered plan are sim's; the calibrated draft serves plain
    greedy's tokens."""
    layout, name = case
    ranks, sim = runs(*layout)
    want = sim[name]
    for r in ranks:
        got = r[name]
        assert got["calibrated"] == want["calibrated"]
        assert got["tiered"] == want["tiered"]
        assert got["greedy"] == want["greedy"]
    plain = ranks[0]["llama2-7b plain"]["greedy"][:2]
    assert ranks[0][name]["greedy"] == plain


def test_preset_draft_policy_agrees_across_ranks_at_dp2(runs):
    """At dp 2 the preset's own candidates (int4 and int8 tier mixes
    among them): every rank reaches the same winner, the same trials
    and the same plan, and the calibrated draft serves plain greedy's
    tokens.  Their acceptances are not sim's (ROADMAP C9)."""
    ranks, _ = runs(2, 2)
    got = ranks[0]["policy"]
    assert got["calibrated"][1], "the search measured no candidate"
    for r in ranks[1:]:
        assert r["policy"] == got
    plain = ranks[0]["llama2-7b plain"]["greedy"][:2]
    assert got["greedy"] == plain
