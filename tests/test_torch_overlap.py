"""PyTorch port vs JAX reference: the overlap backend.  The comm ledger
of one prefill and one decode step inside the overlap region, priced by
an explicit LatencyModel (the reference's values, passed to both
packages); the LatencyModel's own invariants, run against both packages
as parametrised cases; the ring-step decomposition of a quantized sync;
and the overlap engine's greedy tokens and pipelined decode."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import LLM as RLLM, SamplingParams as RSP  # noqa: E402
from repro.config.base import (CommPolicy as RComm,  # noqa: E402
                               SPDPlanConfig as RPlan, replace as rreplace)
from repro.configs import get_config as rget  # noqa: E402
from repro.core import model as RM, simtp as RS  # noqa: E402
from repro.parallel import collectives as RCOL  # noqa: E402
from repro.parallel import compression as RC  # noqa: E402
from repro.runtime import forward as RF  # noqa: E402

from repro_torch.api import LLM, SamplingParams  # noqa: E402
from repro_torch.config.base import (CommPolicy, SPDPlanConfig,  # noqa: E402
                                     replace)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import simtp  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.parallel import collectives as COL  # noqa: E402
from repro_torch.parallel import compression as C  # noqa: E402
from repro_torch.parallel.backend import OverlapBackend  # noqa: E402
from repro_torch.runtime import forward as F  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

MODEL_AXIS = COL.MODEL_AXIS
# the reference's LatencyModel defaults, passed explicitly to both
# packages (the port's LatencyModel has no defaults for them)
REF_LINK, REF_LAUNCH = 50e9, 0.1
GOLDEN = os.path.join(os.path.dirname(__file__), "..", "results", "golden",
                      "smollm-360m-reduced_greedy.json")
REDUCED = "smollm-360m-reduced"


def _cfgs():
    return (rreplace(rget("smollm-360m", reduced=True), dtype="float32"),
            replace(get_config(REDUCED), dtype="float32"))


def _plans(comm):
    drop = (True, False, False, False)
    if comm == "exact":
        return RPlan(drop), SPDPlanConfig(drop)
    return (RPlan(drop, RComm((comm,) * 4, logits_mode="quant8")),
            SPDPlanConfig(drop, CommPolicy((comm,) * 4,
                                           logits_mode="quant8")))


# ---------------------------------------------------------------------------
# The overlap ledger, priced, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comm", ["exact", "quant8", "quant4"])
def test_overlap_ledger_matches_reference(comm):
    """One prefill and one decode step: the reference inside
    overlap_region(4), the port through OverlapBackend.wrap (which
    enters the region itself), both under collective_ledger(latency=,
    tp=2).  Entries equal on (op, axis, nbytes, overlappable, block,
    phase); est_us and fixed_us to rel 1e-9."""
    rcfg, cfg = _cfgs()
    rplan, plan = _plans(comm)
    tp, cache_len = 2, 48
    canon = RM.init_model(jax.random.PRNGKey(0), rcfg)
    rparams = RS.prepare_params(canon, rcfg, rplan, tp)
    params = simtp.prepare_params(
        from_reference(jax.tree.map(np.asarray, canon), cfg), cfg, plan, tp)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :7] = [5, 9, 2, 400, 17, 3, 8]
    ln = np.asarray([7], np.int32)

    rpre, _ = RF.prefill_step(rcfg, rplan, tp=tp, q_chunk=64,
                              cache_len=cache_len)
    rdec, _ = RF.decode_step(rcfg, rplan, tp=tp)
    rlat = RCOL.LatencyModel(link_bytes_per_s=REF_LINK, launch_us=REF_LAUNCH)
    with RCOL.collective_ledger(latency=rlat, tp=tp) as rled, \
            RCOL.overlap_region(4):
        _, rcaches = jax.vmap(rpre, in_axes=(0, None, None, None),
                              axis_name=MODEL_AXIS)(
            rparams, jnp.asarray(toks), jnp.asarray(ln), None)
        jax.vmap(rdec, in_axes=(0, None, None, 0), axis_name=MODEL_AXIS)(
            rparams, jnp.asarray([[4]], jnp.int32),
            jnp.asarray([7], jnp.int32), rcaches)

    backend = OverlapBackend.build(cfg, plan, tp=tp, device="cpu")
    pre = backend.wrap(*F.prefill_step(cfg, plan, tp=tp, q_chunk=64,
                                       cache_len=cache_len))
    dec = backend.wrap(*F.decode_step(cfg, plan, tp=tp))
    lat = COL.LatencyModel(link_bytes_per_s=REF_LINK, launch_us=REF_LAUNCH)
    with COL.collective_ledger(latency=lat, tp=tp) as led:
        _, caches = pre(params, toks.astype(np.int64), ln.astype(np.int64))
        dec(params, np.asarray([[4]]), np.asarray([7]), caches)

    def key(e):
        return (e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)

    assert [key(e) for e in led] == [key(e) for e in rled]
    for e, r in zip(led, rled):
        assert e.est_us == pytest.approx(r.est_us, rel=1e-9, abs=0)
        assert e.fixed_us == pytest.approx(r.fixed_us, rel=1e-9, abs=0)
    perms = [e for e in led if e.op == "collective-permute"]
    assert bool(perms) == (comm != "exact")
    assert all(e.est_us > 0 for e in led)
    for pol in (False, True):
        a, b = lat.summarize(led, overlap=pol), rlat.summarize(rled,
                                                              overlap=pol)
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-9, abs=1e-12)


# ---------------------------------------------------------------------------
# LatencyModel invariants, one case per package
# ---------------------------------------------------------------------------


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    return RCOL if request.param == "reference" else COL


def _lat(pkg, **kw):
    kw.setdefault("link_bytes_per_s", REF_LINK)
    kw.setdefault("launch_us", REF_LAUNCH)
    return pkg.LatencyModel(**kw)


def _entry(pkg, op, nbytes, overlappable, lat, tp, scale=1):
    est = scale * lat.collective_us(op, nbytes, tp)
    return pkg.CommEntry(op, MODEL_AXIS, nbytes * scale, overlappable, est,
                         scale * lat.launch_us)


def test_ring_wire_bytes_conventions(pkg):
    p = 1000.0
    rwb = pkg.ring_wire_bytes
    assert rwb("all-reduce", p, 4) == 2 * 3 / 4 * p
    assert rwb("reduce-scatter", p, 4) == 3 / 4 * p
    assert rwb("all-gather", p, 4) == 3 * p
    assert rwb("collective-permute", p, 4) == p
    for op in ("all-reduce", "reduce-scatter", "all-gather",
               "collective-permute"):
        assert rwb(op, p, 1) == 0.0
    with pytest.raises(ValueError):
        rwb("gossip", p, 4)


def test_split_us_invariants(pkg):
    lat = _lat(pkg)
    entries = [
        _entry(pkg, "all-reduce", 1 << 20, True, lat, 8),
        _entry(pkg, "all-reduce", 1 << 20, False, lat, 8),
        _entry(pkg, "reduce-scatter", 4096, True, lat, 4),
        _entry(pkg, "collective-permute", 65536, True, lat, 4),
        _entry(pkg, "collective-permute", 8, True, lat, 2),   # launch-bound
        _entry(pkg, "all-gather", 0, True, lat, 8),           # zero payload
        _entry(pkg, "all-reduce", 1 << 16, True, lat, 4, scale=6),
    ]
    for e in entries:
        hidden, exposed = lat.split_us(e)
        assert hidden >= 0 and exposed >= 0
        assert abs(hidden + exposed - e.est_us) < 1e-12, e
        assert exposed >= e.fixed_us - 1e-12        # launches never hide
        if not e.overlappable:
            assert hidden == 0.0
        if e.op == "collective-permute" and e.overlappable:
            assert abs(exposed - e.fixed_us) < 1e-12
    flat = _lat(pkg, ring_chunks=1)
    assert flat.split_us(entries[0]) == (0.0, entries[0].est_us)


def test_scan_scale_prices_k_launches(pkg):
    """A segment of k layers logged once at ledger_scale(k) pays k
    launches and k transfers: est_us and fixed_us both carry the scale."""
    with pkg.collective_ledger(latency=_lat(pkg), tp=4) as led:
        pkg.log_collective("all-reduce", MODEL_AXIS, 1 << 16,
                           overlappable=True)
        with pkg.ledger_scale(5):
            pkg.log_collective("all-reduce", MODEL_AXIS, 1 << 16,
                               overlappable=True)
    one, five = led
    assert five.nbytes == 5 * one.nbytes
    assert abs(five.est_us - 5 * one.est_us) < 1e-12
    assert abs(five.fixed_us - 5 * one.fixed_us) < 1e-12
    with pytest.raises(ValueError, match="tp"):
        with pkg.collective_ledger(latency=_lat(pkg)):
            pass


def test_latency_monotonic_in_bandwidth(pkg):
    fast, slow = _lat(pkg, link_bytes_per_s=50e9), \
        _lat(pkg, link_bytes_per_s=10e9)
    for op in ("all-reduce", "reduce-scatter", "all-gather"):
        assert slow.collective_us(op, 1 << 20, 8) \
            > fast.collective_us(op, 1 << 20, 8)
    sums = {}
    for lat in (fast, slow):
        with pkg.collective_ledger(latency=lat, tp=8) as led:
            for _ in range(3):
                pkg.log_collective("all-reduce", MODEL_AXIS, 1 << 18,
                                   overlappable=True)
            pkg.log_collective("all-reduce", MODEL_AXIS, 1 << 10)
        sums[lat.link_bytes_per_s] = (lat.summarize(led),
                                      lat.summarize(led, overlap=True))
    (f_ser, f_ov), (s_ser, s_ov) = sums[50e9], sums[10e9]
    assert s_ser["total_us"] > f_ser["total_us"]
    assert s_ov["exposed_us"] > f_ov["exposed_us"]
    for ser, ov in ((f_ser, f_ov), (s_ser, s_ov)):
        assert ser["hidden_us"] == 0.0
        assert abs(ser["exposed_us"] - ser["total_us"]) < 1e-9
        assert abs(ov["hidden_us"] + ov["exposed_us"] - ov["total_us"]) < 1e-9


def test_port_latency_model_states_no_link_defaults():
    """The reference's defaults describe a TPU link; the port's model
    takes the link rate and launch cost from the caller."""
    with pytest.raises(TypeError):
        COL.LatencyModel()
    lat = COL.LatencyModel(link_bytes_per_s=1e9, launch_us=1.0)
    assert lat.ring_chunks == 4
    assert lat.collective_us("all-reduce", 1000, 2) == 1.0 + 1.0


def test_overlap_decomposition_preserves_ring_bytes(pkg):
    """Inside an overlap region a quantized sync logs ring steps whose
    bytes sum to the ring wire traffic of the RS/AG pair it replaces;
    execution is unchanged; tiny payloads refuse to split below
    MIN_RING_CHUNK_BYTES."""
    tp = 4
    x = np.random.default_rng(0).standard_normal((tp, 4096)) \
        .astype(np.float32)
    if pkg is RCOL:
        def run(v):
            return np.asarray(jax.vmap(
                lambda a: RC.quantized_psum(a, MODEL_AXIS, bits=8),
                axis_name=MODEL_AXIS)(jnp.asarray(v)))
        mod = RC
    else:
        def run(v):
            return C.quantized_psum(torch.from_numpy(np.array(v)),
                                    MODEL_AXIS, bits=8).numpy()
        mod = C
    with pkg.collective_ledger() as plain:
        out_plain = run(x)
    with pkg.collective_ledger() as ringed, pkg.overlap_region(4):
        out_ring = run(x)
    np.testing.assert_array_equal(out_plain, out_ring)
    rs, ag = [e for e in plain if e.op in ("reduce-scatter", "all-gather")]
    perms = [e for e in ringed if e.op == "collective-permute"]
    assert perms and all(e.overlappable for e in perms)
    want = int(round(pkg.ring_wire_bytes("reduce-scatter", rs.nbytes, tp))) \
        + int(round(pkg.ring_wire_bytes("all-gather", ag.nbytes, tp)))
    assert sum(e.nbytes for e in perms) == want
    with pkg.collective_ledger() as tiny, pkg.overlap_region(4):
        run(x[:, :64])
    tiny_perms = [e for e in tiny if e.op == "collective-permute"]
    assert len(tiny_perms) == 2
    assert all(e.nbytes < mod.MIN_RING_CHUNK_BYTES for e in tiny_perms)
    assert pkg.overlap_chunks() == 0


def test_overlap_decomposition_entries_match_reference():
    tp = 4
    x = np.random.default_rng(1).standard_normal((tp, 180000)) \
        .astype(np.float32)
    with RCOL.collective_ledger() as rled, RCOL.overlap_region(4):
        jax.vmap(lambda a: RC.quantized_psum(a, MODEL_AXIS, bits=4),
                 axis_name=MODEL_AXIS)(jnp.asarray(x))
    with COL.collective_ledger() as led, COL.overlap_region(4):
        C.quantized_psum(torch.from_numpy(x), MODEL_AXIS, bits=4)
    assert [(e.op, e.nbytes, e.overlappable) for e in led] == \
        [(e.op, e.nbytes, e.overlappable) for e in rled]
    assert len(led) == 8                 # 4 ring steps per hop


# ---------------------------------------------------------------------------
# Per-policy traces of the port's model through the overlap backend
# ---------------------------------------------------------------------------


def _trace(plan, tp):
    _, cfg = _cfgs()
    canon = from_reference(jax.tree.map(
        np.asarray, RM.init_model(jax.random.PRNGKey(0), _cfgs()[0])), cfg)
    params = simtp.prepare_params(canon, cfg, plan, tp)
    backend = OverlapBackend.build(cfg, plan, tp=tp, device="cpu")
    pre = backend.wrap(*F.prefill_step(cfg, plan, tp=tp, q_chunk=64,
                                       cache_len=32))
    lat = COL.LatencyModel(link_bytes_per_s=REF_LINK, launch_us=REF_LAUNCH)
    with COL.collective_ledger(latency=lat, tp=tp) as led:
        pre(params, np.zeros((1, 32), np.int64), np.asarray([32]))
    return lat, led


def _plan(pol, n=4):
    if pol == "drop":
        return SPDPlanConfig((True,) * n)
    if pol == "exact":
        return SPDPlanConfig((False,) * n)
    return SPDPlanConfig((False,) * n, CommPolicy.uniform(n, pol))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("pol", ["exact", "quant8", "quant4", "drop"])
def test_policy_trace_hidden_plus_exposed_is_total(tp, pol):
    lat, led = _trace(_plan(pol), tp)
    ov = lat.summarize(led, overlap=True)
    ser = lat.summarize(led)
    assert abs(ov["hidden_us"] + ov["exposed_us"] - ov["total_us"]) < 1e-9
    assert ser["hidden_us"] == 0.0
    assert 0.0 < ov["kept_sync_us"] <= ov["total_us"] + 1e-9
    assert ov["hidden_us"] > 0.0


@pytest.mark.parametrize("tp", [2, 4])
def test_dropped_blocks_contribute_zero_entries(tp):
    """A 100%-drop plan keeps exactly half the exact plan's kept-sync
    bytes (the MLP syncs), which still hide."""
    lat, led_x = _trace(_plan("exact"), tp)
    _, led_d = _trace(_plan("drop"), tp)

    def kept(led):
        return sum(e.nbytes for e in led if e.overlappable)

    assert kept(led_d) * 2 == kept(led_x)
    ov = lat.summarize(led_d, overlap=True)
    assert 0.0 < ov["kept_sync_us"] \
        < lat.summarize(led_x, overlap=True)["kept_sync_us"]
    assert ov["hidden_us"] > 0.0


# ---------------------------------------------------------------------------
# The overlap engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("comm", ["exact", "quant8"])
def test_overlap_engine_tokens_equal_sim_and_reference(golden, comm):
    """Greedy tokens on the golden prompts: the port's overlap engine ==
    the port's sim engine == the reference's sim engine (the reference's
    own overlap engine needs a device mesh; its sweep locks it to its
    shard engine bit for bit)."""
    kw = dict(tp=2, spd=0.25, cache_len=48)
    if comm != "exact":
        kw.update(comm=comm, comm_logits=comm)
    ref = RLLM.load(rreplace(rget(REDUCED), dtype="float32"), seed=0, **kw)
    cfg = replace(get_config(REDUCED), dtype="float32")
    canon = from_reference(jax.tree.map(np.asarray, ref.canonical), cfg)
    prompts = [np.asarray(p, np.int32) for p in golden["prompts"]]
    want = [o.token_ids for o in ref.generate(prompts, RSP(max_new=6))]
    for engine in ("overlap", "sim"):
        port = LLM.load(cfg, engine=engine, device="cpu", params=canon, **kw)
        assert port.engine.backend.overlaps_comm == (engine == "overlap")
        got = [o.token_ids
               for o in port.generate(prompts, SamplingParams(max_new=6))]
        assert got == want, engine


def test_decode_pipelined_equals_serial_decode():
    llm = LLM.load(REDUCED, tp=2, engine="overlap", dtype="float32",
                   cache_len=32, max_batch=2, device="cpu")
    eng, params = llm.engine, llm.params
    toks = np.random.default_rng(0).integers(0, llm.cfg.vocab_size, (2, 1))
    pos = np.zeros((2,), np.int64)

    def groups():
        return [(toks + i, pos, eng.blank_caches(2, 32)) for i in range(3)]

    serial = [eng.decode(params, *g) for g in groups()]
    for depth in (1, 2, 4):
        piped = eng.decode_pipelined(params, groups(), depth=depth)
        assert len(piped) == 3
        for (tok_s, cs), (tok_p, cp) in zip(serial, piped):
            assert torch.equal(tok_s, tok_p)
            for seg_s, seg_p in zip(cs, cp):
                for k in seg_s:
                    assert torch.equal(seg_s[k], seg_p[k])


def test_overlap_engine_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM.load(REDUCED, tp=2, engine="overlap", dtype="float32")


@pytest.mark.parametrize("engine", ["shard", "tp_nccl"])
def test_other_engines_name_roadmap_a11(engine):
    with pytest.raises(NotImplementedError, match="A5"):
        LLM.load(REDUCED, tp=2, engine=engine, dtype="float32",
                 device="cpu")
