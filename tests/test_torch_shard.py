"""The shard engine (one process per TP shard over gloo) against the JAX
reference's `engine="shard"` and the port's `sim` engine, dense caches.

Reduced SmolLM-360M, LLaMA2-7B and OPT-6.7B (Fig. 3b's bias re-add in
the dropped blocks), fp32, spd 0.25, on the reference's parameters with
every bias, norm and position leaf moved off its constant, carried over
with `convert.from_reference` and saved for the ranks.  One spawn per
layout (tp 2 dp 1 and tp 2 dp 2 on the three, tp 4 dp 1 on SmolLM)
runs every case of it (`torch_dist.py`) at the first test that reads
it.

  * greedy tokens equal the reference's shard engine and the port's sim
    engine, with exact syncs and with kept syncs and the logits gather
    at quant8 (see test_quant8_greedy_tokens for dp 2);
  * sampled tokens equal sim's (the port's generators are torch's, the
    reference's JAX keys: the packages' streams differ by design);
  * rank 0's ledger equals sim's entry for entry at dp 1; at dp 2 it
    logs one data rank's payload;
  * teacher-forced fp32 logits within 2e-5 of sim's (the reference's own
    sim-vs-shard bound, tests/test_engines.py; see LOGITS_ATOL);
  * every rank returns the same values, and each rank checked at every
    step that the others took the same tokens;
  * a vocab-sharded prefill ("logits_shard", gather_logits=False) leaves
    each rank sim's stacked slice at its model rank, of its own data
    rank's rows, within the same bound; sim's stacked (tp, B, Vl) equals
    the reference's sim backend on the same step within it too, at a
    vocab that tp 2 pads (255 -> 256).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import replace as rreplace  # noqa: E402
from repro.configs import get_config as rget  # noqa: E402
from repro.runtime import forward as RF  # noqa: E402

from repro_torch.config.base import replace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.launch.dist import spawn  # noqa: E402
import torch_dist as TD  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ("smollm-360m", "llama2-7b", "opt-6.7b")
# the archs each layout serves: all three at tp 2, SmolLM alone at tp 4
# (four ranks a case cost the most)
LAYOUT_ARCHS = {(2, 1): ARCHS, (2, 2): ARCHS, (4, 1): ("smollm-360m",)}
CASES = [(lay, a) for lay, archs in LAYOUT_ARCHS.items() for a in archs]
LENS = (5, 9, 17, 3)
STREAM = [11, 7, 301, 42, 5]
# fp32 logits, shard against sim: the reference's own sim-vs-shard bound
# (tests/test_engines.py).  At tp 4 gloo adds the partials in its own
# order; at tp 2 the sum of two terms is exact, yet on the CPU the
# per-shard products of LLaMA's and OPT's reduced widths differ by up to
# 1.3e-6 between one shard a process and two stacked (SmolLM's agree
# bit for bit), so the bound is the same at both
LOGITS_ATOL = 2e-5
# the vocab-sharded prefill's model: reduced SmolLM with a vocab of 255,
# which tp 2 pads to 256 (shard 1's last column is padding)
LS_ARCH, LS_VOCAB, LS_LEN, LS_ROWS = "smollm-360m v255", 255, 9, 4


def _cfg(arch):
    if arch == LS_ARCH:
        return replace(_cfg("smollm-360m"), vocab_size=LS_VOCAB)
    return replace(get_config(arch, reduced=True), dtype="float32")


def _rcfg(arch):
    if arch == LS_ARCH:
        return rreplace(_rcfg("smollm-360m"), vocab_size=LS_VOCAB)
    return rreplace(rget(arch, reduced=True), dtype="float32")


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    """{arch: (reference numpy tree, port tree)} and the ranks' file."""
    trees = {a: perturbed_canonical(_rcfg(a)) for a in ARCHS + (LS_ARCH,)}
    port = {a: from_reference(t, _cfg(a)) for a, t in trees.items()}
    path = tmp_path_factory.mktemp("shard") / "canon.pt"
    torch.save(port, path)
    return trees, port, str(path)


def _cases(tp, dp):
    cases = []
    for a in LAYOUT_ARCHS[(tp, dp)]:
        cfg = _cfg(a)
        cases += [
            dict(kind="serve", name=f"{a} exact", arch=a, cfg=cfg, lens=LENS,
                 sampled=True),
            dict(kind="serve", name=f"{a} quant8", arch=a, cfg=cfg,
                 lens=LENS, load=dict(comm="quant8", comm_logits="quant8")),
            dict(kind="logits", name=f"{a} logits", arch=a, cfg=cfg, len=13,
                 stream=STREAM)]
    if tp == 2:
        cases.append(dict(kind="logits_shard", name="logits_shard",
                          arch=LS_ARCH, cfg=_cfg(LS_ARCH), len=LS_LEN,
                          rows=LS_ROWS))
    if dp > 1:
        # one request on two data ranks: the prefill pads to two rows
        cases.append(dict(kind="serve", name="single", arch="llama2-7b",
                          cfg=_cfg("llama2-7b"), lens=(11,),
                          load=dict(comm="quant8", comm_logits="quant8")))
    return cases


@pytest.fixture(scope="module")
def runs(canon):
    """runs(tp, dp) -> (the ranks' results, the sim engine's results),
    one spawn per layout, made at its first use."""
    _, port, path = canon
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            job = dict(tp=tp, dp=dp, params=path, cases=_cases(tp, dp))
            ranks = spawn(TD.run, tp * dp, backend="gloo", device="cpu",
                          args=(job,), deadline_s=240, timeout_s=60)
            sim = {}
            for case in job["cases"]:
                llm = TD.load(case["cfg"], port[case["arch"]], "sim", tp,
                              **case.get("load", {}))
                sim[case["name"]] = TD.LLM_CASES[case["kind"]](llm, case)
            done[(tp, dp)] = ranks, sim
        return done[(tp, dp)]

    return get


def _ids(case):
    (tp, dp), a = case
    return f"tp{tp}dp{dp}-{a}"


def _reference_greedy(trees, arch, tp, dp, lens, comm="exact"):
    rcfg = _rcfg(arch)
    ref = RLLM.load(rcfg, tp=tp, dp=dp, engine="shard", spd=0.25,
                    cache_len=64, max_batch=4, q_chunk=64, comm=comm,
                    comm_logits=comm,
                    params=jax.tree.map(jnp.asarray, trees[arch]))
    ps = TD.prompts(rcfg.vocab_size, lens)
    return [o.token_ids for o in ref.generate(ps, RSP(max_new=6))]


def _same_on_every_rank(ranks, name, key):
    for r in ranks[1:]:
        np.testing.assert_equal(r[name][key], ranks[0][name][key])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_greedy_tokens_equal_reference_shard_and_sim(runs, canon, case):
    (tp, dp), arch = case
    ranks, sim = runs(tp, dp)
    got = ranks[0][f"{arch} exact"]["greedy"]
    _same_on_every_rank(ranks, f"{arch} exact", "greedy")
    assert got == sim[f"{arch} exact"]["greedy"]
    assert got == _reference_greedy(canon[0], arch, tp, dp, LENS)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sampled_tokens_equal_sim(runs, case):
    lay, arch = case
    ranks, sim = runs(*lay)
    _same_on_every_rank(ranks, f"{arch} exact", "sampled")
    assert ranks[0][f"{arch} exact"]["sampled"] == sim[f"{arch} exact"][
        "sampled"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_quant8_greedy_tokens(runs, canon, case):
    """Kept syncs and the logits gather at quant8.  A rank quantizes its
    own payload, chunked from its element 0, as the reference's shard
    engine does: at dp 2 a decode row of d 96 (SmolLM) starts mid-chunk
    on sim and at a chunk on its data rank, so sim's tokens are the
    check where rows are whole chunks (dp 1, or d a multiple of 128)
    and the reference's shard engine elsewhere."""
    (tp, dp), arch = case
    ranks, sim = runs(tp, dp)
    name = f"{arch} quant8"
    _same_on_every_rank(ranks, name, "greedy")
    got = ranks[0][name]["greedy"]
    if dp == 1 or _cfg(arch).d_model % 128 == 0:
        assert got == sim[name]["greedy"]
    else:
        assert got == _reference_greedy(canon[0], arch, tp, dp, LENS,
                                        comm="quant8")


@pytest.mark.parametrize("case", [c for c in CASES if c[0][1] == 1],
                         ids=_ids)
def test_rank0_ledger_equals_sim(runs, case):
    """Entry for entry (op, axis, bytes, overlappable, block, phase),
    exact and quant8: the shard engine logs what sim logs."""
    lay, arch = case
    ranks, sim = runs(*lay)
    for mode in ("exact", "quant8"):
        name = f"{arch} {mode}"
        assert ranks[0][name]["ledger"] == sim[name]["ledger"], mode
        assert ranks[0][name]["ledger"]


@pytest.mark.parametrize("arch", ARCHS)
def test_dp2_ledger_logs_each_data_rank_payload(runs, arch):
    """tp 2 dp 2: sim's entries in order (op, axis, overlappable, block,
    phase) with a data rank's payload bytes: never more than sim's, and
    equal on the two data ranks of a model rank."""
    ranks, sim = runs(2, 2)
    for mode in ("exact", "quant8"):
        name = f"{arch} {mode}"
        got, want = ranks[0][name]["ledger"], sim[name]["ledger"]
        assert [e[:2] + e[3:] for e in got] == [e[:2] + e[3:] for e in want]
        assert all(g[2] <= w[2] for g, w in zip(got, want))
        assert any(g[2] < w[2] for g, w in zip(got, want))
        assert ranks[2][name]["ledger"] == got


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_teacher_forced_logits(runs, case):
    lay, arch = case
    ranks, sim = runs(*lay)
    name = f"{arch} logits"
    for r in ranks:
        np.testing.assert_allclose(r[name], sim[name], rtol=0,
                                   atol=LOGITS_ATOL)


@pytest.mark.parametrize("dp", [1, 2], ids=["tp2dp1", "tp2dp2"])
def test_shard_backend_keeps_each_ranks_vocab_sharded_logits(runs, dp):
    """The "logits_shard" kind on `shard` (the reference's P(dpx,
    MODEL_AXIS)): rank (m, d) holds sim's (tp, B, Vl) at [m], rows d*B/dp
    .. (d+1)*B/dp, and every (m, d) is held by one rank."""
    ranks, sim = runs(2, dp)
    want = sim["logits_shard"]["logits"]
    tp, b, vl = want.shape
    k = b // dp
    seen = []
    for r in ranks:
        got = r["logits_shard"]
        m, d = got["at"]
        seen.append((m, d))
        assert got["logits"].shape == (1, k, vl)
        np.testing.assert_allclose(got["logits"],
                                   want[m:m + 1, d * k:(d + 1) * k],
                                   rtol=0, atol=LOGITS_ATOL)
    assert sorted(seen) == [(m, d) for m in range(tp) for d in range(dp)]


def test_sims_vocab_sharded_logits_equal_the_references(canon, runs):
    """The other half of the chain above: sim's stacked (tp, B, Vl) of
    the vocab-sharded prefill equals the reference's sim backend
    (`prefill_step(gather_logits=False)` wrapped by its VmapSimBackend,
    which stacks "logits_shard" the same way) on the same params and
    prompts, within LOGITS_ATOL, the padded vocab column included."""
    trees, _, _ = canon
    want = runs(2, 1)[1]["logits_shard"]["logits"]
    ref = RLLM.load(_rcfg(LS_ARCH), tp=2, engine="sim", spd=0.25,
                    cache_len=64, max_batch=4, q_chunk=64,
                    params=jax.tree.map(jnp.asarray, trees[LS_ARCH]))
    step = ref.engine.backend.wrap(*RF.prefill_step(
        ref.cfg, ref.plan, tp=2, q_chunk=64, cache_len=0,
        gather_logits=False))
    toks = np.stack(TD.prompts(LS_VOCAB, (LS_LEN,) * LS_ROWS, 11))
    got = np.asarray(step(ref.params, jnp.asarray(toks), None, None)[0])
    assert want.shape == got.shape == (2, LS_ROWS, (LS_VOCAB + 1) // 2)
    np.testing.assert_allclose(want, got, rtol=0, atol=LOGITS_ATOL)


def test_single_request_pads_over_data_ranks(runs):
    """dp 2: one request's prefill runs padded to two rows, the pad row
    dropped after; tokens equal sim's."""
    ranks, sim = runs(2, 2)
    got = ranks[0]["single"]["greedy"]
    _same_on_every_rank(ranks, "single", "greedy")
    assert got == sim["single"]["greedy"]
    assert len(got) == 1 and len(got[0]) == 6


@pytest.mark.parametrize("backend", ("gloo", "nccl"))
def test_a_rank_defaults_to_its_card_and_raises_without_one(monkeypatch,
                                                           backend):
    """cuda:LOCAL_RANK under either backend; with no CUDA device a rank
    raises unless the CPU is asked for (gloo only): no silent CPU."""
    from repro_torch.launch.dist import rank_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device(backend, None, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device(backend, "cuda", 1)
    if backend == "gloo":
        assert rank_device(backend, "cpu", 1) == torch.device("cpu")
    else:
        with pytest.raises(ValueError, match="CUDA"):
            rank_device(backend, "cpu", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert rank_device(backend, None, 1) == torch.device("cuda", 1)
    assert rank_device(backend, "cuda:0", 1) == torch.device("cuda", 0)


def test_spawn_without_a_card_raises_before_starting_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spawn(TD.run, 2, backend="gloo", args=({},))


def test_without_groups_the_shard_engine_raises(canon):
    """No process group, no engine: there is no single-process stand-in."""
    from repro_torch.api import LLM
    with pytest.raises(NotImplementedError, match="init_tp"):
        LLM.load(_cfg("smollm-360m"), tp=2, engine="shard", device="cpu",
                 params=canon[1]["smollm-360m"])
