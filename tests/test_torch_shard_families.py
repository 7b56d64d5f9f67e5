"""The model families and int8 formats on the shard engine (one process
per TP shard over gloo) against the port's `sim` engine and the JAX
reference's `engine="shard"`.

Reduced qwen2-moe-a2.7b (MoE), deepseek-v2-lite-16b (MLA + MoE),
mamba2-370m (SSM), hymba-1.5b (hybrid attention + SSM heads, windowed
and global layers), and llama2-7b with an int8 KV cache and with int8
KV + weight-only int8; fp32, spd 0.25, on the reference's parameters
with every bias, norm and position leaf moved off its constant, carried
over with `convert.from_reference`.  One spawn per layout (tp 2 dp 1,
tp 2 dp 2) runs every case of it (`torch_dist.py`); both start at the
first test that reads one and run beside this process's sim and
reference runs.

  * greedy tokens, dense and paged (the paged fallback: pageable leaves
    gathered, the dense step, the written token scattered back; the
    SSM's state stays per slot), equal sim's on every rank, and the
    reference's shard engine on `REF_RUNS`;
  * sampled and quant8 tokens (kept syncs and the logits gather) equal
    sim's; teacher-forced logits within 2e-5 of sim's; rank 0's ledger
    equals sim's entry for entry;
  * MoE at dp 2 (C7): capacity counts a data rank's rows, so a token's
    output may change with its data rank's batch, as in the reference
    (tests/test_engines.py): the dense run is held to the reference's
    shard engine at dp 2, not to sim.  The paged steps run the whole
    batch on every data rank, so the paged run is held to sim;
  * the SSM and hybrid prompts are bucket lengths (16, 32): the
    reference scans its bucket's pad tokens into the recurrent state
    (C3; tests/test_torch_mamba.py), the port prefills at the prompt's
    own length, so the two agree at bucket lengths only.
The refusals that stay (weight-only int8 on MLA and hybrid layers, C8;
the frontends, A4) are asserted inside a rank by
test_torch_shard_paged.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
import torch_dist as TD  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

# family -> (arch, config fields)
FAMILIES = {"qwen2-moe": ("qwen2-moe-a2.7b", {}),
            "deepseek": ("deepseek-v2-lite-16b", {}),
            "mamba2": ("mamba2-370m", {}),
            "hymba": ("hymba-1.5b", {}),
            "int8-kv": ("llama2-7b", dict(kv_dtype="int8")),
            "int8-kv-w": ("llama2-7b", dict(kv_dtype="int8",
                                            weight_dtype="int8"))}
ARCHS = sorted({a for a, _ in FAMILIES.values()})
RECURRENT = ("mamba2", "hymba")
LENS = (5, 9, 17, 3)
BUCKET_LENS = (16, 32, 16, 16)
PAGED = dict(page_size=8, num_pages=24)
Q8 = dict(comm="quant8", comm_logits="quant8")
STREAM = [11, 7, 301, 42, 5]
# the families each layout serves: all at tp 2 dp 1, MoE at dp 2 (C7)
LAYOUT_FAMILIES = {(2, 1): tuple(FAMILIES), (2, 2): ("qwen2-moe",)}
# the runs also served by the reference's shard engine: each family
# once, dense or paged, and MoE's dense run at dp 2 (one reference run
# compiles its prefill and decode programs: ~8 s on the CPU)
REF_RUNS = (((2, 1), "qwen2-moe", "dense"), ((2, 1), "deepseek", "paged"),
            ((2, 1), "mamba2", "dense"), ((2, 1), "hymba", "paged"),
            ((2, 1), "int8-kv", "paged"), ((2, 1), "int8-kv-w", "dense"),
            ((2, 2), "qwen2-moe", "dense"))
# fp32 logits, shard against sim: the reference's own sim-vs-shard bound
# (tests/test_engines.py), as in test_torch_shard.py
LOGITS_ATOL = 2e-5


def _cfg(fam):
    arch, kw = FAMILIES[fam]
    return replace(get_config(arch, reduced=True), dtype="float32", **kw)


def _rcfg(fam):
    arch, kw = FAMILIES[fam]
    return rreplace(rget(arch, reduced=True), dtype="float32", **kw)


def _lens(fam):
    return BUCKET_LENS if fam in RECURRENT else LENS


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    """{arch: (reference numpy tree, port tree)} and the ranks' file; the
    int8 families share LLaMA's float tree (the placement quantizes)."""
    trees = {a: perturbed_canonical(rreplace(rget(a, reduced=True),
                                             dtype="float32"))
             for a in ARCHS}
    port = {a: from_reference(t, replace(get_config(a, reduced=True),
                                         dtype="float32"))
            for a, t in trees.items()}
    path = tmp_path_factory.mktemp("shard_families") / "canon.pt"
    torch.save(port, path)
    return trees, port, str(path)


def _cases(tp, dp):
    cases = []
    for fam in LAYOUT_FAMILIES[(tp, dp)]:
        arch, cfg, lens = FAMILIES[fam][0], _cfg(fam), _lens(fam)
        cases += [dict(kind="serve", name=f"{fam} dense", arch=arch,
                       cfg=cfg, lens=lens, sampled=dp == 1),
                  dict(kind="serve", name=f"{fam} paged", arch=arch,
                       cfg=cfg, lens=lens, load=PAGED)]
        if dp == 1:
            cases += [dict(kind="serve", name=f"{fam} quant8", arch=arch,
                           cfg=cfg, lens=lens, load=Q8),
                      dict(kind="logits", name=f"{fam} logits", arch=arch,
                           cfg=cfg, len=13, stream=STREAM)]
    return cases


@pytest.fixture(scope="module")
def runs(canon):
    """runs(tp, dp) -> (the ranks' results, the sim engine's results):
    one spawn per layout, both started at the first use."""
    _, port, path = canon
    jobs = {lay: dict(tp=lay[0], dp=lay[1], params=path,
                      cases=_cases(*lay)) for lay in LAYOUT_FAMILIES}
    waits = {lay: TD.start(job, deadline_s=300, timeout_s=60)
             for lay, job in jobs.items()}
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            sim = {}
            for case in jobs[(tp, dp)]["cases"]:
                llm = TD.load(case["cfg"], port[case["arch"]], "sim", tp,
                              **case.get("load", {}))
                sim[case["name"]] = TD.LLM_CASES[case["kind"]](llm, case)
            done[(tp, dp)] = waits[(tp, dp)](), sim
        return done[(tp, dp)]

    return get


def _same_on_every_rank(ranks, name, key):
    for r in ranks[1:]:
        assert r[name][key] == ranks[0][name][key], (name, key)


def _ids(case):
    (tp, dp), fam, *rest = case
    return "-".join([f"tp{tp}dp{dp}", fam] + list(rest))


# every served run held to sim: all but MoE's dense run at dp 2 (C7)
SIM_RUNS = [(lay, fam, cache) for lay, fams in LAYOUT_FAMILIES.items()
            for fam in fams for cache in ("dense", "paged")
            if (lay, fam, cache) != ((2, 2), "qwen2-moe", "dense")]
DP1 = [((2, 1), fam) for fam in FAMILIES]


@pytest.mark.parametrize("case", SIM_RUNS, ids=_ids)
def test_greedy_tokens_equal_sim(runs, case):
    lay, fam, cache = case
    ranks, sim = runs(*lay)
    name = f"{fam} {cache}"
    _same_on_every_rank(ranks, name, "greedy")
    assert ranks[0][name]["greedy"] == sim[name]["greedy"]
    if cache == "paged":
        assert ranks[0][name]["free_pages"] == PAGED["num_pages"]


@pytest.mark.parametrize("case", REF_RUNS, ids=_ids)
def test_greedy_tokens_equal_reference_shard(runs, canon, case):
    (tp, dp), fam, cache = case
    ranks, _ = runs(tp, dp)
    name = f"{fam} {cache}"
    _same_on_every_rank(ranks, name, "greedy")
    rcfg = _rcfg(fam)
    ref = RLLM.load(rcfg, tp=tp, dp=dp, engine="shard", spd=0.25,
                    cache_len=64, max_batch=4, q_chunk=64,
                    params=jax.tree.map(jnp.asarray,
                                        canon[0][FAMILIES[fam][0]]),
                    **(PAGED if cache == "paged" else {}))
    want = ref.generate(TD.prompts(rcfg.vocab_size, _lens(fam)),
                        RSP(max_new=6))
    assert ranks[0][name]["greedy"] == [o.token_ids for o in want]


@pytest.mark.parametrize("case", DP1, ids=_ids)
def test_sampled_tokens_equal_sim(runs, case):
    lay, fam = case
    ranks, sim = runs(*lay)
    name = f"{fam} dense"
    _same_on_every_rank(ranks, name, "sampled")
    assert ranks[0][name]["sampled"] == sim[name]["sampled"]


@pytest.mark.parametrize("case", DP1, ids=_ids)
def test_quant8_tokens_equal_sim(runs, case):
    """Kept syncs and the logits gather at quant8: the send -> all-gather
    -> receive transport across ranks gives sim's fused sync's values."""
    lay, fam = case
    ranks, sim = runs(*lay)
    name = f"{fam} quant8"
    _same_on_every_rank(ranks, name, "greedy")
    assert ranks[0][name]["greedy"] == sim[name]["greedy"]


@pytest.mark.parametrize("case", DP1, ids=_ids)
def test_teacher_forced_logits(runs, case):
    lay, fam = case
    ranks, sim = runs(*lay)
    name = f"{fam} logits"
    for r in ranks:
        np.testing.assert_allclose(r[name], sim[name], rtol=0,
                                   atol=LOGITS_ATOL)


@pytest.mark.parametrize("case", DP1, ids=_ids)
def test_rank0_ledger_equals_sim(runs, case):
    """Entry for entry (op, axis, bytes, overlappable, block, phase),
    exact and quant8."""
    lay, fam = case
    ranks, sim = runs(*lay)
    for mode in ("dense", "quant8"):
        name = f"{fam} {mode}"
        assert ranks[0][name]["ledger"] == sim[name]["ledger"], mode
        assert ranks[0][name]["ledger"]
