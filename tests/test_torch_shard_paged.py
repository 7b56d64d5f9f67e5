"""The shard engine over gloo, paged caches, the kept sync's transport
across ranks, the collectives under a model group, and the refusals.

  * paged serving on a pool the requests outgrow (a preemption and its
    re-admission) and a warm admission through the prefix cache (its
    suffix prefills through the paged step at C > 1): greedy tokens
    equal the reference's shard engine (exact syncs, tp 2) and the
    port's sim engine (exact and quant8), the same preemptions, every
    page back; reduced SmolLM-360M, LLaMA2-7B and OPT-6.7B at tp 2 dp 1,
    SmolLM and OPT at tp 2 dp 2 (the paged steps run the batch on every
    data rank), SmolLM at tp 4;
  * the quantized kept sync across ranks (the send kernel -> all-gather
    of the int8 messages -> the receive kernel: rank order from +0, then
    hop 2) equals sim's fused sync bit for bit, zero signs included, at
    tp 2 and 4, int8 and int4, fp32 and bf16, with the same ledger;
  * pmax, psum, ppermute (ring and pairs), the shard gather, the axis
    size and the shard ids under the model group;
  * what the shard engine still refuses raises NotImplementedError
    naming its ROADMAP item, inside a rank (training and Algorithm 1 run
    there: test_torch_shard_train.py, test_torch_shard_trainer.py,
    test_torch_shard_spd.py; the overlap engine, the rings and the pod
    axis too: test_torch_shard_overlap.py, test_torch_shard_pod.py).
Spawns: one per layout, each running all of its cases (torch_dist.py).
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
from repro_torch.launch.dist import spawn  # noqa: E402
from repro_torch.parallel import compression as C  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
import torch_dist as TD  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ("smollm-360m", "llama2-7b", "opt-6.7b")
PAGED = dict(page_size=8, num_pages=9)
PREEMPT_LENS = (20, 22, 17, 25)
PREFIX = dict(page_size=8, num_pages=16)
Q8 = dict(comm="quant8", comm_logits="quant8")
# (payload elements, seed, bits): a decode sync of d 960, a ragged int4
# payload, a prefill-bucket one of whole chunks, a payload shorter than
# one code word of 4 and one just past a chunk (neither 4-aligned)
PAYLOADS = ((960, 0, 8), (1001, 1, 4), (16 * 128, 2, 8), (3, 3, 4),
            (130, 4, 8))
LAYOUTS = {(2, 1): ARCHS, (2, 2): ("smollm-360m", "opt-6.7b"),
           (4, 1): ("smollm-360m",)}
# each refusal and the ROADMAP item its message names: weight-only int8
# on MLA and hybrid layers (as on sim: the reference fails there too)
REFUSED = {"int8_weights_mla": "C8", "int8_weights_hybrid": "C8"}
# a modality-frontend config served on the ranks: a frontend prefill of
# three rows (padded to four at dp 2) and four greedy decode steps
FRONT_ARCH = "musicgen-medium"
FRONT_CASE = dict(kind="frontend", name="frontend", arch=FRONT_ARCH,
                  lens=(12, 9, 11), steps=4, load=dict(spd=0.5))
# the ranks' logits against sim's: per-shard products on the CPU
# (test_torch_shard.py's bound)
FRONT_LOGITS_ATOL = 2e-5


def _cfg(arch):
    return replace(get_config(arch, reduced=True), dtype="float32")


def _rcfg(arch):
    return rreplace(rget(arch, reduced=True), dtype="float32")


def _prefix_prompts(vocab):
    shared = TD.prompts(vocab, (19,), seed=6)[0]
    return shared, np.concatenate([shared, TD.prompts(vocab, (6,), 8)[0]])


def _cases(tp, dp):
    cases = []
    for a in LAYOUTS[(tp, dp)]:
        cfg = _cfg(a)
        shared, pb = _prefix_prompts(cfg.vocab_size)
        cases += [
            dict(kind="serve", name=f"{a} preempt", arch=a, cfg=cfg,
                 lens=PREEMPT_LENS, seed=4, max_new=12,
                 load=dict(PAGED, spd=0.5)),
            dict(kind="serve", name=f"{a} preempt quant8", arch=a, cfg=cfg,
                 lens=PREEMPT_LENS, seed=4, max_new=12,
                 load=dict(PAGED, spd=0.5, **Q8)),
            dict(kind="serve", name=f"{a} prefix", arch=a, cfg=cfg,
                 lens=(19,), seed=6, max_new=5, then=[pb],
                 load=dict(PREFIX, **Q8))]
    if tp == 2:
        cases.append(dict(FRONT_CASE, cfg=_cfg(FRONT_ARCH)))
    if dp == 1:
        cases += [dict(kind="quantized_sync", name="hop1",
                       payloads=PAYLOADS),
                  dict(kind="collectives", name="collectives")]
    if (tp, dp) == (2, 1):
        cases += [dict(kind="refusals", name="refusals"),
                  dict(kind="agreement", name="agreement")]
    return cases


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    trees = {a: perturbed_canonical(_rcfg(a)) for a in ARCHS + (FRONT_ARCH,)}
    port = {a: from_reference(t, _cfg(a)) for a, t in trees.items()}
    path = tmp_path_factory.mktemp("shard_paged") / "canon.pt"
    torch.save(port, path)
    return trees, port, str(path)


@pytest.fixture(scope="module")
def runs(canon):
    """runs(tp, dp) -> (the ranks' results, sim's results of the served
    cases), one spawn per layout at its first use."""
    _, port, path = canon
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            job = dict(tp=tp, dp=dp, params=path, cases=_cases(tp, dp))
            ranks = spawn(TD.run, tp * dp, backend="gloo", device="cpu",
                          args=(job,), deadline_s=240, timeout_s=60)
            sim = {c["name"]: TD.LLM_CASES[c["kind"]](TD.load(
                c["cfg"], port[c["arch"]], "sim", tp, **c["load"]), c)
                for c in job["cases"] if c["kind"] in ("serve", "frontend")}
            for c in job["cases"]:
                if c["name"].endswith("preempt"):
                    # the same requests on dense caches
                    kw = {k: v for k, v in c["load"].items()
                          if k not in PAGED}
                    sim[c["name"] + " dense"] = TD.serve(TD.load(
                        c["cfg"], port[c["arch"]], "sim", tp, **kw), c)
            done[(tp, dp)] = ranks, sim
        return done[(tp, dp)]

    return get


CASES = [(lay, a) for lay, archs in LAYOUTS.items() for a in archs]


def _ids(case):
    (tp, dp), a = case
    return f"tp{tp}dp{dp}-{a}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_paged_preemption_tokens(runs, canon, case):
    """A pool of 9 pages the four requests outgrow: the same tokens and
    preemptions as sim's paged run (exact and quant8) on every rank, with
    exact syncs the tokens of sim's dense run (at quant8 a re-admitted
    request decodes in another slot, and a row of d 96 then starts at
    another offset of its sync's 128-element chunks), the reference's
    shard engine at tp 2 dp 1 (exact), every page back."""
    (tp, dp), arch = case
    ranks, sim = runs(tp, dp)
    name = f"{arch} preempt"
    assert sim[name]["greedy"] == sim[name + " dense"]["greedy"]
    for name in (f"{arch} preempt", f"{arch} preempt quant8"):
        for r in ranks:
            assert r[name]["greedy"] == sim[name]["greedy"], name
            assert r[name]["n_preempted"] == sim[name]["n_preempted"]
            assert r[name]["free_pages"] == PAGED["num_pages"]
        assert ranks[0][name]["preemptions"] >= 1
    if (tp, dp) == (2, 1):
        rcfg = _rcfg(arch)
        ref = RLLM.load(rcfg, tp=2, engine="shard", spd=0.5, cache_len=64,
                        max_batch=4, q_chunk=64,
                        params=jax.tree.map(jnp.asarray, canon[0][arch]),
                        **PAGED)
        want = ref.generate(TD.prompts(rcfg.vocab_size, PREEMPT_LENS, 4),
                            RSP(max_new=12))
        got = ranks[0][f"{arch} preempt"]
        assert got["greedy"] == [o.token_ids for o in want]
        assert got["n_preempted"] == [o.n_preempted for o in want]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_warm_prefix_admission(runs, case):
    """A prompt sharing two whole pages with an earlier one admits warm
    (a prefix hit): its suffix prefills through the paged step; tokens
    equal sim's at quant8 on every rank."""
    (tp, dp), arch = case
    ranks, sim = runs(tp, dp)
    name = f"{arch} prefix"
    for r in ranks:
        assert r[name]["greedy"] == sim[name]["greedy"]
        assert r[name]["then"] == sim[name]["then"]
        assert r[name]["prefix_hits"] == sim[name]["prefix_hits"] >= 1
        if dp == 1:
            assert r[name]["ledger"] == sim[name]["ledger"]


@pytest.mark.parametrize("tp", (2, 4))
def test_quantized_sync_across_ranks_equals_fused_sim(runs, tp):
    """Each rank's result of the send -> all-gather -> receive (rank
    order from +0, then hop 2) transport equals its row of sim's fused
    sync bit for bit, zero signs included; the ledger entries are
    sim's."""
    ranks, _ = runs(tp, 1)
    i = 0
    for n, seed, bits in PAYLOADS:
        x = torch.from_numpy(TD.hop_payloads(tp, n, seed))
        for dt in (torch.float32, torch.bfloat16):
            with collective_ledger() as led:
                want = C.quantized_psum(x.to(dt), "model", bits=bits)
            want = want.float().numpy()
            for r, res in enumerate(ranks):
                got, got_led = res["hop1"][i]
                np.testing.assert_array_equal(got[0], want[r])
                np.testing.assert_array_equal(np.signbit(got[0]),
                                              np.signbit(want[r]))
                assert got_led == TD.ledger_tuples(led)
            i += 1


@pytest.mark.parametrize("tp", (2, 4))
def test_collectives_under_the_model_group(runs, tp):
    ranks, _ = runs(tp, 1)
    x = np.random.default_rng(2).standard_normal((tp, 3, 5)).astype(
        np.float32)
    for r, res in enumerate(ranks):
        got = res["collectives"]
        np.testing.assert_array_equal(got["pmax"][0], x.max(0))
        np.testing.assert_allclose(got["psum"][0], x.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(got["ring"][0], x[(r - 1) % tp])
        want = {0: x[1], 1: x[0]}.get(r, np.zeros_like(x[0]))
        np.testing.assert_array_equal(got["pairs"][0], want)
        np.testing.assert_array_equal(got["gather"], x)
        assert got["size"] == tp and got["ids"] == [r]


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)],
                         ids=["tp2dp1", "tp2dp2"])
def test_frontend_prefill_on_the_ranks_equals_sim(runs, layout):
    """musicgen-reduced (a modality frontend, ROADMAP A4) on the shard
    engine: `Engine.prefill(embeds=)` with the embeds split over the
    data ranks like the tokens (three rows padded to four at dp 2), then
    greedy decode at Flen + lens: every rank's tokens are sim's, its
    logits within FRONT_LOGITS_ATOL of sim's."""
    ranks, sim = runs(*layout)
    want = sim["frontend"]
    assert want["tokens"].shape == (3, FRONT_CASE["steps"] + 1)
    for r in ranks:
        got = r["frontend"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=FRONT_LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refusals_name_their_roadmap_item(runs, what):
    ranks, _ = runs(2, 1)
    for res in ranks:
        kind, msg = res["refusals"][what]
        assert kind == "NotImplementedError", (what, msg)
        assert f"ROADMAP {REFUSED[what]}" in msg, (what, msg)


@pytest.mark.parametrize("what", ("values", "count"))
def test_agreement_catches_a_rank_that_took_other_tokens(runs, what):
    """With `check_agreement` on, a rank whose host took other tokens, or
    another count of them, raises naming rank 0's; rank 0 and ranks that
    agree go on."""
    ranks, _ = runs(2, 1)
    assert [r["agreement"]["same"] for r in ranks] == ["agreed"] * 2
    assert ranks[0]["agreement"][what] == "agreed"
    assert "differ from rank 0's [5, 7]" in ranks[1]["agreement"][what]


def test_a_world_that_is_not_tp_x_dp_raises(runs):
    ranks, _ = runs(2, 1)
    for res in ranks:
        kind, msg = res["refusals"]["world"]
        assert kind == "ValueError" and "tp" in msg
