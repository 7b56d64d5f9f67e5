"""The overlap engine and the ring collectives on the shard engine's
ranks (one process per TP shard over gloo) against the port's `sim`
overlap engine, the port's `shard` engine on the same ranks, the port's
stacked rings and the JAX reference.

Reduced SmolLM-360M, fp32, on the reference's parameters with every
bias, norm and position leaf moved off its constant.  One spawn per
layout, tp 2 at dp 1 and dp 2, runs every case of it
(`torch_dist.py`), started beside this process's sim and reference
work:

  * inside a world of ranks `engine="overlap"` is the shard backend
    plus the overlap seams (`ShardOverlapBackend`, overlaps_comm);
  * its greedy tokens, dense and paged (a pool the requests outgrow:
    preemptions), with exact, quant8 and quant4 kept syncs and logits
    gather, equal the shard engine's on the same ranks and the port's
    sim overlap engine's.  At dp 2 a dense quantized row of d 96 starts
    mid-chunk on sim and at a chunk on its data rank (test_torch_shard.
    py::test_quant8_greedy_tokens): there the quant8 tokens are held to
    the reference's overlap engine on 8 virtual CPU devices instead, and
    the quant4 tokens to the shard engine's alone (XLA's and torch's
    partials differ by ulps, and an int4 code at a rounding boundary
    then flips a token, as test_torch_grads_quant.py states);
  * rank 0's serving ledger at dp 1 equals sim overlap's entry for
    entry, with ring-step collective-permutes under quantized syncs;
  * one prefill and one decode step through the backend, priced under
    `collective_ledger(latency=, tp=)`, log on rank 0 what the
    reference's overlap backend logs when it traces the same steps
    (test_torch_overlap.py's rule: the entries equal, est_us and
    fixed_us to rel 1e-9);
  * `decode_pipelined` equals serial decode on every rank, and sim's;
  * a speculative run (chain k 3) equals the shard engine's;
  * the three rings (`ring_quantized_psum` at bits 8 and 4,
    `ring_reduce_scatter`, `ring_all_gather`) on each rank's row equal
    the port's stacked rings' row bit for bit with the same ledger, at
    tp 2 (the model group of dp 1) and tp 4 (a ring over the four ranks
    of dp 2), and the reference's vmap rings within test_torch_ring.py's
    tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import (CommPolicy as RComm,  # noqa: E402
                               SPDPlanConfig as RPlan, replace as rreplace)
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM  # noqa: E402
from repro.parallel import collectives as RCOL  # noqa: E402
from repro.parallel import compression as RC  # noqa: E402
from repro.parallel.backend import make_backend as rmake  # noqa: E402
from repro.runtime import forward as RF  # noqa: E402

from repro_torch.config.base import (CommPolicy, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.parallel import compression as C  # noqa: E402
from repro_torch.parallel.collectives import collective_ledger  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
import torch_dist as TD  # noqa: E402
from torch_parity import perturbed_canonical  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ARCH = "smollm-360m"
LAYOUTS = ((2, 1), (2, 2))
COMMS = ("exact", "quant8", "quant4")
CACHES = ("dense", "paged")
LENS = (5, 9, 17, 3)
PAGED = dict(page_size=8, num_pages=9)
PREEMPT_LENS = (20, 22, 17, 25)
# (payload elements, seed) of the ring cases: a ragged payload, one
# shorter than a 128-element chunk
RING_PAYLOADS = ((777, 1), (130, 2))
RING_CALLS = ("q8", "q4", "rs", "ag")
# ring_reduce_scatter adds the shards in ring order, the reference's too
# (test_torch_ring.py): fp32 reordering of sums of n values
RS_ATOL = 1e-5
PIPE_ROWS, PIPE_GROUPS = 4, 3


def _cfg():
    return replace(get_config(ARCH, reduced=True), dtype="float32")


def _rcfg():
    return rreplace(rget(ARCH, reduced=True), dtype="float32")


def _comm(comm):
    return {} if comm == "exact" else dict(comm=comm, comm_logits=comm)


def _serve_case(engine, comm, cache):
    kw = dict(_comm(comm), spd=0.25)
    if cache == "paged":
        return dict(kind="serve", name=f"{engine} {comm} {cache}", arch=ARCH,
                    cfg=_cfg(), lens=PREEMPT_LENS, seed=4, max_new=12,
                    engine=engine, load=dict(kw, spd=0.5, **PAGED))
    return dict(kind="serve", name=f"{engine} {comm} {cache}", arch=ARCH,
                cfg=_cfg(), lens=LENS, engine=engine, load=kw)


def _plans(comm):
    """The port's and the reference's plan of the priced steps: block 0
    dropped, the others kept at `comm`, the logits gather at quant8 under
    a quantized policy (test_torch_overlap.py's)."""
    drop = (True, False, False, False)
    if comm == "exact":
        return SPDPlanConfig(drop), RPlan(drop)
    return (SPDPlanConfig(drop, CommPolicy((comm,) * 4, logits_mode="quant8")),
            RPlan(drop, RComm((comm,) * 4, logits_mode="quant8")))


def _cases(tp, dp):
    cases = [_serve_case(e, c, k) for e in ("overlap", "shard")
             for c in COMMS for k in CACHES]
    cases += [dict(kind="overlap_steps", name=f"steps {c}", arch=ARCH,
                   cfg=_cfg(), rows=dp, engine="overlap",
                   load=dict(plan=_plans(c)[0])) for c in COMMS]
    cases.append(dict(kind="pipelined", name="pipelined", arch=ARCH,
                      cfg=_cfg(), rows=PIPE_ROWS, groups=PIPE_GROUPS,
                      engine="overlap", load=dict(spd=0.25)))
    for e in ("overlap", "shard"):
        cases.append(dict(kind="serve", name=f"{e} spec", arch=ARCH,
                          cfg=_cfg(), lens=LENS, engine=e,
                          load=dict(spd=0.25, comm="quant8",
                                    spec=SpecConfig(k=3))))
    cases.append(dict(kind="rings", name="rings", payloads=RING_PAYLOADS,
                      over="model" if dp == 1 else "world"))
    return cases


@pytest.fixture(scope="module")
def canon(tmp_path_factory):
    tree = perturbed_canonical(_rcfg())
    port = from_reference(tree, _cfg())
    path = tmp_path_factory.mktemp("shard_overlap") / "canon.pt"
    torch.save({ARCH: port}, path)
    return tree, port, str(path)


@pytest.fixture(scope="module")
def runs(canon):
    """runs(tp, dp) -> the ranks' results; both spawns start at the
    first use, beside this process's work."""
    _, _, path = canon
    waits = {lay: TD.start(dict(tp=lay[0], dp=lay[1], params=path,
                                cases=_cases(*lay)),
                           deadline_s=240, timeout_s=60)
             for lay in LAYOUTS}
    done = {}

    def get(tp, dp):
        if (tp, dp) not in done:
            done[(tp, dp)] = waits[(tp, dp)]()
        return done[(tp, dp)]

    return get


@pytest.fixture(scope="module")
def sim(runs, canon):
    """The port's sim overlap engine on the served cases (tp 2), and its
    serial decode of the pipelined case's groups (`runs` has started the
    spawns)."""
    _, port, _ = canon
    out = {}
    for comm in COMMS:
        for cache in CACHES:
            c = _serve_case("overlap", comm, cache)
            out[c["name"]] = TD.serve(TD.load(c["cfg"], port, "overlap", 2,
                                              **c["load"]), c)
    c = next(c for c in _cases(2, 1) if c["kind"] == "pipelined")
    out["pipelined"] = TD.pipelined(TD.load(c["cfg"], port, "overlap", 2,
                                            **c["load"]), c)
    return out


def _same_on_every_rank(ranks, name, key):
    for r in ranks[1:]:
        np.testing.assert_equal(r[name][key], ranks[0][name][key])


def _lid(lay):
    return f"tp{lay[0]}dp{lay[1]}"


@pytest.mark.parametrize("lay", LAYOUTS, ids=_lid)
def test_overlap_on_ranks_is_shard_plus_the_seams(runs, lay):
    ranks = runs(*lay)
    for res in ranks:
        got = res["steps exact"]
        assert got["backend"] == "ShardOverlapBackend"
        assert got["overlaps_comm"] is True


def _reference_overlap_greedy(tree, dp, comm):
    """The reference's overlap engine (shard_map on the virtual CPU
    devices) on the dense serve case."""
    rcfg = _rcfg()
    ref = RLLM.load(rcfg, tp=2, dp=dp, engine="overlap", spd=0.25,
                    cache_len=64, max_batch=4, q_chunk=64,
                    params=jax.tree.map(jnp.asarray, tree), **_comm(comm))
    return [o.token_ids for o in ref.generate(
        TD.prompts(rcfg.vocab_size, LENS), RSP(max_new=6))]


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("lay", LAYOUTS, ids=_lid)
def test_overlap_tokens_equal_shard_and_sim(runs, sim, canon, lay, comm,
                                            cache):
    ranks = runs(*lay)
    name, other = f"overlap {comm} {cache}", f"shard {comm} {cache}"
    _same_on_every_rank(ranks, name, "greedy")
    got = ranks[0][name]
    assert got["greedy"] == ranks[0][other]["greedy"]
    assert got["n_preempted"] == ranks[0][other]["n_preempted"]
    if cache == "paged":
        assert got["preemptions"] >= 1
        assert got["free_pages"] == PAGED["num_pages"]
    if lay[1] == 1 or cache == "paged" or comm == "exact":
        assert got["greedy"] == sim[name]["greedy"]
        assert got["n_preempted"] == sim[name]["n_preempted"]
    elif comm == "quant8":
        assert got["greedy"] == _reference_overlap_greedy(canon[0], lay[1],
                                                          comm)


@pytest.mark.parametrize("comm", COMMS)
def test_rank0_serving_ledger_equals_sim_overlap(runs, sim, comm):
    ranks = runs(2, 1)
    for cache in CACHES:
        name = f"overlap {comm} {cache}"
        got = ranks[0][name]["ledger"]
        assert got and got == sim[name]["ledger"], name
        perms = sum(e[0] == "collective-permute" for e in got)
        assert bool(perms) == (comm != "exact"), name


def _reference_priced(tree, comm, dp, tp=2):
    """The reference's overlap backend (shard_map over make_test_mesh(dp,
    tp)) tracing one prefill and one decode step of the same inputs
    under a priced ledger: its rows with est_us and fixed_us."""
    rcfg = _rcfg()
    rplan = _plans(comm)[1]
    rb = rmake("overlap", rcfg, rplan, tp=tp, dp=dp)
    params = rb.place_params(RM.stack_segments(
        RM.pad_model(jax.tree.map(jnp.asarray, tree), rcfg, tp), rcfg,
        rplan))
    pre = rb.wrap(*RF.prefill_step(rcfg, rplan, tp=tp, q_chunk=64,
                                   cache_len=48))
    dec = rb.wrap(*RF.decode_step(rcfg, rplan, tp=tp))
    toks, lengths, nxt = TD.step_inputs(rcfg.vocab_size, dp)
    lat = RCOL.LatencyModel(link_bytes_per_s=TD.REF_LINK,
                            launch_us=TD.REF_LAUNCH)
    i32 = lambda a: jnp.asarray(a, jnp.int32)           # noqa: E731
    with RCOL.collective_ledger(latency=lat, tp=tp) as led:
        _, caches = jax.eval_shape(pre, params, i32(toks), i32(lengths),
                                   None)
        jax.eval_shape(dec, params, i32(nxt), i32(lengths), caches)
    return [(e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase,
             e.est_us, e.fixed_us) for e in led]


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("lay", LAYOUTS, ids=_lid)
def test_priced_ledger_equals_reference_overlap(runs, canon, lay, comm):
    ranks = runs(*lay)
    name = f"steps {comm}"
    _same_on_every_rank(ranks, name, "ids")
    got = ranks[0][name]["ledger"]
    want = _reference_priced(canon[0], comm, lay[1])
    assert [g[:6] for g in got] == [w[:6] for w in want]
    for g, w in zip(got, want):
        assert g[6] == pytest.approx(w[6], rel=1e-9, abs=0)
        assert g[7] == pytest.approx(w[7], rel=1e-9, abs=0)
    assert all(g[6] > 0 for g in got)
    perms = [g for g in got if g[0] == "collective-permute"]
    assert bool(perms) == (comm != "exact")
    assert all(g[3] for g in perms)


@pytest.mark.parametrize("lay", LAYOUTS, ids=_lid)
def test_decode_pipelined_equals_serial(runs, sim, lay):
    ranks = runs(*lay)
    for res in ranks:
        assert res["pipelined"]["same"]
        assert res["pipelined"]["ids"] == sim["pipelined"]["ids"]
    assert sim["pipelined"]["same"]


@pytest.mark.parametrize("lay", LAYOUTS, ids=_lid)
def test_speculation_equals_shard(runs, lay):
    ranks = runs(*lay)
    _same_on_every_rank(ranks, "overlap spec", "greedy")
    got, want = ranks[0]["overlap spec"], ranks[0]["shard spec"]
    assert got["greedy"] == want["greedy"]
    assert got["spec"] == want["spec"]
    assert got["spec"]["rounds"] > 0


def _ring_fns():
    return {"q8": lambda v: C.ring_quantized_psum(v, bits=8),
            "q4": lambda v: C.ring_quantized_psum(v, bits=4),
            "rs": C.ring_reduce_scatter, "ag": C.ring_all_gather}


def _ring_rows(ranks):
    """{(call, size): (the ranks' rows stacked in ring order, rank 0's
    ledger)}; each rank's row sits at its ring index (the model rank on
    a model-group ring, the world rank on a world ring)."""
    n = ranks[0]["rings"]["n"]
    world = n == len(ranks)
    out = {}
    for i, res in enumerate(ranks):
        assert res["rings"]["n"] == n
        idx = i if world else i % n
        for call, size, y, led in res["rings"]["rows"]:
            rows, led0 = out.setdefault((call, size), ([None] * n, led))
            assert led == led0
            if world or i < n:
                rows[idx] = y[0]
    return n, {k: (np.stack(v[0]), v[1]) for k, v in out.items()}


@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda x: f"tp{2 * x[1]}")
def test_rings_across_ranks_equal_stacked_rings(runs, lay):
    """Each rank's row of every ring call equals its row of the port's
    stacked ring bit for bit (zero signs too), with the same ledger:
    the same arithmetic, order and dtype, the ring steps over the
    wire."""
    n, rows = _ring_rows(runs(*lay))
    assert n == 2 * lay[1]
    fns = _ring_fns()
    for (call, size), (got, led) in rows.items():
        seed = dict(RING_PAYLOADS)[size]
        with collective_ledger() as want_led:
            want = fns[call](torch.from_numpy(TD.ring_input(n, size, seed)))
        np.testing.assert_array_equal(got, want.numpy(), err_msg=call)
        np.testing.assert_array_equal(np.signbit(got),
                                      np.signbit(want.numpy()))
        assert led == TD.ledger_tuples(want_led)
        assert [e[0] for e in led] == ["collective-permute"] * (
            {"q8": 3, "q4": 3}.get(call, 1) * (n - 1))


def _ref_ring(fn, x):
    with RCOL.collective_ledger() as led:
        out = jax.vmap(fn, axis_name="model")(jnp.asarray(x))
    return np.asarray(out), [(e.op, e.nbytes) for e in led]


@pytest.mark.parametrize("call", RING_CALLS)
@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda x: f"tp{2 * x[1]}")
def test_rings_across_ranks_match_reference(runs, lay, call):
    """The ranks' rows against the reference's rings under vmap (its
    kernel=False path): the quantized ring within 1e-6 x max|x| (its qdq
    adds a straight-through rounding), within its error bound of the
    exact sum; the reduce-scatter within RS_ATOL; the all-gather
    exactly; the (op, bytes) ledger entries equal."""
    n, rows = _ring_rows(runs(*lay))
    for size, seed in RING_PAYLOADS:
        x = TD.ring_input(n, size, seed)
        got, led = rows[(call, size)]
        if call in ("q8", "q4"):
            bits = int(call[1])
            ref, rled = _ref_ring(lambda v: RC.ring_quantized_psum(
                v, "model", bits=bits, kernel=False), x)
            amax = np.abs(x).max()
            np.testing.assert_allclose(got, ref, atol=1e-6 * amax, rtol=0)
            levels = 127 if bits == 8 else 7
            assert np.abs(got - x.sum(0)).max() <= \
                amax * (2 * n + 1) / levels
        elif call == "rs":
            ref, rled = _ref_ring(lambda v: RC.ring_reduce_scatter(
                v, "model"), x)
            np.testing.assert_allclose(got, ref, atol=RS_ATOL, rtol=0)
        else:
            ref, rled = _ref_ring(lambda v: RC.ring_all_gather(v, "model"),
                                  x)
            np.testing.assert_array_equal(got, ref)
        assert [(e[0], e[2]) for e in led] == rled
