"""Rank workers of the shard engine's CPU tests (`test_torch_shard*.py`).

Imports only torch, numpy and repro_torch: each worker runs in a process
that `repro_torch.launch.dist.spawn` started over gloo, one torch thread
a rank.  `run(rank, job)` builds the TP groups, loads the canonical trees
the parent saved (`job["params"]`, a torch.save'd {arch: tree}) and runs
`job["cases"]` in order, each a dict with a "kind" (a function below)
and its arguments; it returns {case name: result} of plain Python and
numpy values.  A served case loads `case["engine"]` ("shard" unless
given; "overlap" is the shard engine plus the overlap seams in a world
of ranks).  Every LLM it builds checks, at each admission and decode
step, that all ranks took the same tokens (`ShardBackend.agree`).
`job["pod"]` adds a pod factor to the world (pod x dp x tp ranks).
"""
import numpy as np
import torch

from repro_torch.api import LLM, SamplingParams
from repro_torch.parallel.collectives import collective_ledger

SAMPLED = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=5,
                         max_new=5)


def prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int64) for n in lens]


def load(cfg, canon, engine, tp, dp=1, **kw):
    """The facade on the CPU at the tests' settings (spd 0.25, cache 64,
    4 slots, q_chunk 64); `kw` overrides."""
    kw = dict(dict(spd=0.25, cache_len=64, max_batch=4, q_chunk=64), **kw)
    llm = LLM.load(cfg, tp=tp, dp=dp, engine=engine, params=canon,
                   device="cpu", **kw)
    if llm.engine.backend.multi_process:
        llm.engine.backend.check_agreement = True
    return llm


def ledger_tuples(led):
    return [(e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)
            for e in led]


def serve(llm, case):
    """generate() of the case's prompts (greedy, then sampled when
    asked) under a ledger: tokens, preemptions, prefix hits, free pages
    and the ledger."""
    ps = prompts(llm.cfg.vocab_size, case["lens"], case.get("seed", 3))
    out = {}
    with collective_ledger() as led:
        got = llm.generate(ps, SamplingParams(max_new=case.get("max_new",
                                                               6)))
    out["greedy"] = [o.token_ids for o in got]
    out["n_preempted"] = [o.n_preempted for o in got]
    out["ledger"] = ledger_tuples(led)
    sched = llm.serve()
    if llm.spec is not None:
        out["spec"] = dict(rounds=sched.spec_rounds,
                           drafted=sched.spec_drafted,
                           accepted=sched.spec_accepted,
                           committed=sched.spec_committed,
                           alt_commits=sched.spec_alt_commits,
                           adoptions=sched.spec.drafter.adoptions,
                           draft_prefills=sched.spec.drafter.prefills)
    for p in case.get("then", ()):
        # a later admission of the same scheduler (the warm prefix)
        more = llm.generate([np.asarray(p, np.int64)],
                            SamplingParams(max_new=5))
        out.setdefault("then", []).append(more[0].token_ids)
    if case.get("sampled"):
        out["sampled"] = [o.token_ids for o in llm.generate(ps, SAMPLED)]
    if llm.cache.paged:
        out["preemptions"] = sched.n_preemptions
        out["prefix_hits"] = sched.kv.prefix_hits
        out["free_pages"] = sched.pool.num_free
    return out


def logits(llm, case):
    """Teacher-forced full logits of one request: the prefill's, then
    `len(stream) - 1` decode steps with the stream forced in."""
    from repro_torch.runtime.forward import bucketed_prefill
    eng = llm.engine
    prompt = prompts(llm.cfg.vocab_size, (case["len"],), 7)[0]
    stream = case["stream"]
    cl = llm.cache.cache_len
    lg, c1 = bucketed_prefill(eng, llm.params, prompt, len(prompt), cl)
    caches = eng.insert_slot(eng.blank_caches(eng.backend.dp_total, cl),
                             c1, 0)
    rows = [lg[:1].numpy()]
    for i, tok in enumerate(stream[:-1]):
        toks = np.zeros((eng.backend.dp_total, 1), np.int64)
        pos = np.zeros((eng.backend.dp_total,), np.int64)
        toks[0, 0], pos[0] = tok, len(prompt) + i
        _, lg, caches = eng.decode_with_logits(llm.params, toks, pos,
                                               caches)
        rows.append(lg[:1].numpy())
    return np.concatenate(rows)


def spec_logits(llm, case):
    """Full logits of one request's chunked prefill (`case["chunk"]`),
    then of a verify chunk `case["verify"]` scored at its end, on dense
    caches and through the page table (the prefill scattered into pages
    0, 1, ... of a pool): {"chunk" (1, V), "verify" (1, C, V),
    "verify_paged" (1, C, V)}."""
    eng, params = llm.engine, llm.params
    cl, ps = llm.cache.cache_len, 8
    n = eng.backend.dp_total
    prompt = prompts(llm.cfg.vocab_size, (case["len"],), 7)[0]
    s = len(prompt)
    lg, c1 = eng.prefill_chunked(params, prompt[None], cache_len=cl,
                                 lengths=np.asarray([s], np.int64),
                                 chunk=case["chunk"])
    ver = np.zeros((n, len(case["verify"])), np.int64)
    ver[0] = case["verify"]
    pos = np.zeros((n,), np.int64)
    pos[0] = s
    caches = eng.insert_slot(eng.blank_caches(n, cl), c1, 0)
    vlg, _ = eng.verify(params, ver, pos, caches)
    table = np.full((n, cl // ps), -1, np.int64)
    used = -(-(s + ver.shape[1]) // ps)
    table[0, :used] = np.arange(used)
    pools = eng.blank_paged_caches(n, cl, page_size=ps, num_pages=used)
    pools = eng.insert_paged(pools, c1, 0, table[0])
    plg, _ = eng.verify_paged(params, ver, pos, table, pools)
    return {"chunk": lg[:1].numpy(), "verify": vlg[:1].numpy(),
            "verify_paged": plg[:1].numpy()}


def draft_policy(llm, case):
    """The "calibrated" search on the case's prompts and the "tiered"
    plan from a sweep over two `calibration_batches`: {"calibrated":
    (winner, trials, modes), "tiered": modes, "greedy": tokens under the
    calibrated draft}.  With `case["drops_only"]` the search walks
    drop-only candidates (every kept sync exact), else the preset's own
    candidates, the sweep's tier mixes among them."""
    from repro_torch.config.base import SPDPlanConfig
    from repro_torch.data import calibration_batches
    from repro_torch.spec import SpecConfig
    from repro_torch.spec import calibrate as CAL

    calib = calibration_batches(llm.cfg.vocab_size, 2, 16, batch=1)
    ps = prompts(llm.cfg.vocab_size, case["lens"])
    n = llm.cfg.n_layers
    CAL.clear_cache()
    if case.get("drops_only"):
        CAL.calibrate_draft(llm, ps, k=3, target=case["target"],
                            candidates=[
                                ("all-drop", SPDPlanConfig.full(n)),
                                ("drop-half", SPDPlanConfig.first_k(
                                    n, n // 2)),
                                ("drop-one", SPDPlanConfig.first_k(n, 1))])
    llm.enable_spec(SpecConfig(k=3, draft="calibrated"),
                    calib_batches=calib, calib_prompts=ps,
                    calib_target=case["target"])
    cal = llm.spec_calibration
    out = {"calibrated": (cal.name, [tuple(t) for t in cal.trials],
                          llm.draft_plan.modes())}
    out["greedy"] = [o.token_ids for o in llm.generate(
        ps, SamplingParams(max_new=6))]
    llm.enable_spec(SpecConfig(k=3, draft="tiered", n_spd=2), calib)
    out["tiered"] = llm.draft_plan.modes()
    CAL.clear_cache()
    return out


#: cases that load the case's model and run on it
def frontend(llm, case):
    """A frontend prefill through `Engine.prefill(embeds=)`: right-padded
    seeded tokens of `case["lens"]` behind seeded embeds (B, Flen,
    frontend_dim), each row then inserted into its own slot of dense
    caches (on data ranks, the slot's rank keeps it) and decoded greedily
    for `case["steps"]` steps at Flen + lens.  Returns {"tokens" (B,
    steps + 1), "logits" (B, steps + 1, V)}: the prefill's and each
    decode step's."""
    from repro_torch.tree import tree_map
    eng, cfg = llm.engine, llm.cfg
    rng = np.random.default_rng(case.get("seed", 5))
    lens = np.asarray(case["lens"], np.int64)
    b, n = len(lens), llm.cache.max_batch
    toks = rng.integers(0, cfg.vocab_size, (b, int(lens.max())))
    emb = rng.standard_normal((b, cfg.frontend_len, cfg.frontend_dim))
    cl, ax = llm.cache.cache_len, eng.backend.cache_batch_axis
    lg, c1 = eng.prefill(llm.params, toks, cache_len=cl, lengths=lens,
                         embeds=emb.astype(np.float32))
    caches = eng.blank_caches(n, cl)
    for i in range(b):
        caches = eng.insert_slot(
            caches, tree_map(lambda c, i=i: c.narrow(ax, i, 1), c1), i)
    cur = np.zeros((n, 1), np.int64)
    pos = np.zeros((n,), np.int64)
    pos[:b] = cfg.frontend_len + lens
    rows = [lg.numpy()]
    for _ in range(case["steps"]):
        cur[:b, 0] = rows[-1].argmax(-1)
        _, lg, caches = eng.decode_with_logits(llm.params, cur, pos, caches)
        rows.append(lg[:b].numpy())
        pos[:b] += 1
    lgs = np.stack(rows, 1)
    return {"tokens": lgs.argmax(-1), "logits": lgs}


def logits_shard(llm, case):
    """The vocab-sharded logits of a whole-batch prefill
    (`prefill_step(gather_logits=False)`, the "logits_shard" kind,
    wrapped by the engine's backend) of `case["rows"]` prompts of
    `case["len"]` tokens: {"logits": sim's stacked (tp, B, Vl), a rank's
    (1, B / dp, Vl) slice; "at": (model rank, data rank), (0, 0) on
    sim}."""
    from repro_torch.runtime import forward as F
    be = llm.engine.backend
    step = be.wrap(*F.prefill_step(llm.cfg, llm.plan, tp=be.tp,
                                   q_chunk=64, cache_len=0,
                                   gather_logits=False))
    toks = np.stack(prompts(llm.cfg.vocab_size,
                            (case["len"],) * case["rows"], 11))
    lg, _ = step(llm.params, toks, None)
    g = getattr(be, "groups", None)
    return {"logits": lg.numpy(),
            "at": (g.model_rank, g.data_rank) if g else (0, 0)}


LLM_CASES = {"serve": serve, "logits": logits, "spec_logits": spec_logits,
             "draft_policy": draft_policy, "frontend": frontend,
             "logits_shard": logits_shard}


def start(job, **kw):
    """Spawn `job`'s ranks over gloo on the CPU from a background thread
    (so that the caller's own work overlaps them); returns a function
    that waits for them and returns their results (`spawn`'s)."""
    import threading

    from repro_torch.launch.dist import spawn

    box = {}

    def go():
        try:
            box["ranks"] = spawn(run, world(job), backend="gloo",
                                 device="cpu", args=(job,), **kw)
        except BaseException as e:                  # noqa: BLE001
            box["error"] = e

    th = threading.Thread(target=go, daemon=True)
    th.start()

    def wait():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]
    return wait


def world(job) -> int:
    """The job's world size: pod x dp x tp (no pod factor: dp x tp)."""
    return max(job.get("pod", 0), 1) * job["tp"] * job["dp"]


def run(rank, job):
    from repro_torch.launch.dist import init_tp

    torch.set_num_threads(1)
    init_tp(job["tp"], job["dp"], job.get("pod", 0), backend="gloo",
            device="cpu", timeout_s=60)
    canon = torch.load(job["params"]) if job.get("params") else {}
    out = {}
    for case in job["cases"]:
        kind = case["kind"]
        if kind in LLM_CASES:
            llm = load(case["cfg"], canon[case["arch"]],
                       case.get("engine", "shard"), job["tp"], job["dp"],
                       **case.get("load", {}))
            out[case["name"]] = LLM_CASES[kind](llm, case)
            del llm
        else:
            out[case["name"]] = CASES[kind](job, case, canon)
    return out


# ---------------------------------------------------------------------------
# Cases that are not a served model
# ---------------------------------------------------------------------------

def hop_payloads(tp, n, seed):
    """(tp, n) fp32 partials with exact zeros of both signs and one
    all-zero chunk: the zero signs the fused kernel keeps."""
    x = np.random.default_rng(seed).standard_normal((tp, n)).astype(
        np.float32)
    x[:, 3 % n] = 0.0
    x[0, 5 % n], x[1 % tp, 5 % n] = -0.0, -0.0
    x[:, 128:256] = -0.0
    return x


def quantized_sync(job, case, canon):
    """This rank's row of compression.quantized_psum over the model group
    (the send -> all-gather -> receive transport) for each payload of the
    case, in fp32 and bf16, and its ledger."""
    from repro_torch.launch.dist import current
    from repro_torch.parallel import compression as C
    from repro_torch.parallel.collectives import ModelGroup, model_group

    g = current()
    ctx = ModelGroup(g.tp, g.model_rank, g.model_group)
    out = []
    for n, seed, bits in case["payloads"]:
        x = torch.from_numpy(hop_payloads(g.tp, n, seed))
        for dt in (torch.float32, torch.bfloat16):
            mine = x[g.model_rank:g.model_rank + 1].to(dt)
            with model_group(ctx), collective_ledger() as led:
                y = C.quantized_psum(mine, "model", bits=bits)
            out.append((y.float().numpy(), ledger_tuples(led)))
    return out


def collectives(job, case, canon):
    """pmax, the ring ppermute, a pair permutation and the gathered
    logits assembly on this rank's row of a seeded (tp, 3, 5) tensor."""
    from repro_torch.launch.dist import current
    from repro_torch.parallel import collectives as COL

    g = current()
    ctx = COL.ModelGroup(g.tp, g.model_rank, g.model_group)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (g.tp, 3, 5)).astype(np.float32))
    mine = x[g.model_rank:g.model_rank + 1]
    with COL.model_group(ctx):
        return {"pmax": COL.pmax(mine).numpy(),
                "ring": COL.ppermute(mine).numpy(),
                "pairs": COL.ppermute(mine, perm=[(0, 1), (1, 0)]).numpy(),
                "psum": COL.psum(mine).numpy(),
                "gather": COL.gather_shards(mine).numpy(),
                "size": COL.axis_size(mine),
                "ids": COL.shard_ids(mine).tolist()}


def refusals(job, case, canon):
    """What the shard engine refuses inside a rank: {name: (exception
    type, message)} for each attempt, or "ran" if it did not raise."""
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    tp, dp = job["tp"], job["dp"]
    base = replace(get_config("smollm-360m", reduced=True), dtype="float32")
    kw = dict(tp=tp, dp=dp, engine="shard", device="cpu", cache_len=64)

    def reduced(name, **cfg_kw):
        return replace(get_config(name, reduced=True), dtype="float32",
                       **cfg_kw)

    attempts = {
        "int8_weights_mla": lambda: LLM.load(
            reduced("deepseek-v2-lite-16b", weight_dtype="int8"), **kw),
        "int8_weights_hybrid": lambda: LLM.load(
            reduced("hymba-1.5b", weight_dtype="int8"), **kw),
        "world": lambda: LLM.load(base, tp=2 * tp, dp=dp, engine="shard",
                                  device="cpu", cache_len=64),
    }
    out = {}
    for name, fn in attempts.items():
        try:
            fn()
            out[name] = "ran"
        except Exception as e:                      # noqa: BLE001
            out[name] = (type(e).__name__, str(e))
    return out


def agreement(job, case, canon):
    """`ShardBackend.agree` on host tokens that part between the ranks:
    {name: "agreed" or the error it raised} for the same tokens, other
    values on rank 1, and one token more on rank 1 (a speculative round
    that committed another count)."""
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.dist import current

    base = replace(get_config("smollm-360m", reduced=True), dtype="float32")
    llm = load(base, None, "shard", job["tp"], job["dp"])
    rank = current().rank
    out = {}
    for name, toks in (("same", [5, 7]),
                       ("values", [5, 7 + (rank == 1)]),
                       ("count", [5, 7] + [9] * (rank == 1))):
        try:
            llm.engine.backend.agree(toks)
            out[name] = "agreed"
        except RuntimeError as e:
            out[name] = str(e)
    return out


CASES = {"quantized_sync": quantized_sync, "collectives": collectives,
         "refusals": refusals, "agreement": agreement}


# ---------------------------------------------------------------------------
# Training and Algorithm 1 on the ranks (test_torch_shard_train.py,
# test_torch_shard_trainer.py, test_torch_shard_spd.py); the sim side of
# each test runs the same functions in its own process
# ---------------------------------------------------------------------------

def trained(tr, st, steps, leaves=True):
    """`steps` more steps of the Trainer `tr` from state `st`: each
    step's {"loss", "grad_norm", "tokens", "lr"}, the first step's
    ledger, the final step, and (with `leaves`) the global params and
    optimizer state as numpy leaves (Trainer.global_tree: every rank
    gathers; only rank 0 returns them): "params", "master" (ZeRO-1's w
    slices or FSDP's master tree), "moments" (m, then v) and "opt_step"."""
    from repro_torch.launch.dist import current
    from repro_torch.tree import tree_leaves

    step_fn, led = tr.step_fn, []

    def first(*a):
        tr.step_fn = step_fn
        with collective_ledger() as lg:
            out = step_fn(*a)
        led.extend(lg)
        return out

    tr.step_fn = first
    n0 = len(tr.metrics_log)
    st = tr.run(st, steps=steps)
    out = {"metrics": [{k: m[k] for k in ("loss", "grad_norm", "tokens",
                                          "lr")}
                       for m in tr.metrics_log[n0:]],
           "ledger": ledger_tuples(led), "step": st["step"]}
    if leaves:
        glob = tr.global_tree(st)
        g = current()
        if g is None or g.rank == 0:
            def arrays(tree):
                return [t.detach().float().cpu().numpy()
                        for t in tree_leaves(tree)]

            opt = glob["opt"]
            if "master" in opt:
                master, moments = opt["master"], [opt["m"], opt["v"]]
            else:           # per leaf {"m", "v", "w"}, in that order
                flat = tree_leaves(opt["leaves"])
                master, moments = flat[2::3], [flat[0::3], flat[1::3]]
            out.update(params=arrays(glob["params"]), master=arrays(master),
                       moments=arrays(moments), opt_step=int(opt["step"]))
    return out


def trainer(cfg, params, engine, tp, dp, **kw):
    """launch.train.make_trainer on the CPU at the tests' settings (fp32,
    batch 8 x 32 tokens in 2 microbatches, lr 1e-3 from step 0, no
    checkpoints); `kw` overrides."""
    from repro_torch.launch.train import make_trainer

    kw = dict(dict(steps=3, batch=8, seq=32, lr=1e-3, microbatches=2,
                   warmup=0, ckpt_every=0, dtype="float32"), **kw)
    return make_trainer(cfg, engine=engine, tp=tp, dp=dp, device="cpu",
                        params=params, **kw)


def train(job, case, canon):
    """The case's model trained on the ranks (`trained`)."""
    tr, st = trainer(case["cfg"], canon[case["arch"]], "shard", job["tp"],
                     job["dp"], **case["kw"])
    return trained(tr, st, case["kw"].get("steps", 3))


class Fault:
    """A fault hook that raises SimulatedFault once, at step `at`."""

    def __init__(self, at):
        self.at, self.hit = at, False

    def __call__(self, step):
        from repro_torch.runtime.trainer import SimulatedFault
        if step == self.at and not self.hit:
            self.hit = True
            raise SimulatedFault(f"fault at step {step}")


def train_ckpt(job, case, canon):
    """A Trainer on the ranks with checkpoints under `case["dir"]`
    (resumed from there when it holds one), an optional fault
    (`case["fault"]`): `trained` of `case["steps"]` more steps, the step
    it resumed from and how many restores it made."""
    kw = dict(case["kw"], ckpt_dir=case["dir"])
    fault = Fault(case["fault"]) if "fault" in case else None
    tr, st = trainer(case["cfg"], canon[case["arch"]], "shard", job["tp"],
                     job["dp"], fault_hook=fault, **kw)
    start = st["step"]
    out = trained(tr, st, case["steps"])
    out.update(resumed=start, restores=len(tr.restore_log),
               saves=[s for s, _, _ in tr.save_log])
    return out


def train_cli(job, case, canon):
    """`launch.train.main(case["argv"])` on the ranks: its standard
    output."""
    import contextlib
    import io

    from repro_torch.launch.train import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(case["argv"])
    return {"rc": rc, "stdout": buf.getvalue()}


def serve_cli(job, case, canon):
    """`launch.serve.main(case["argv"])` on the ranks (seeded weights,
    as the sim run in the parent draws them): its standard output."""
    import contextlib
    import io

    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(case["argv"])
    return {"rc": rc, "stdout": buf.getvalue()}


def spd_report(llm, rep):
    """The plan and report of an Algorithm 1 call, as plain values."""
    out = {"modes": llm.plan.modes(), "logits_mode": (llm.plan.comm.logits_mode if llm.plan.comm
                           else "exact"),
           "sensitivity": np.asarray(rep.sensitivity),
           "ppl_suffix": np.asarray(rep.ppl_suffix),
           "ranking": [int(i) for i in rep.ranking]}
    if hasattr(rep, "categories"):
        out.update(categories=list(rep.categories), chosen=list(rep.chosen),
                   distill=dict(rep.distill_losses),
                   grouping={b: (g.supported, g.groups, g.assignment)
                             for b, g in rep.grouping.items()})
    return out


def algorithm1(llm, case):
    """`apply_comm_policy` (case["policy"]), then `apply_spd`
    (case["spd"]), each on `calibration_batches` of the case, each
    followed by a greedy generate of the case's prompts: {"policy",
    "spd"} -> spd_report + "greedy"."""
    from repro_torch.data import calibration_batches

    calib = calibration_batches(llm.cfg.vocab_size, 4, 32, batch=2)
    ps = prompts(llm.cfg.vocab_size, case["lens"])
    out = {}
    for what in ("policy", "spd"):
        fn = llm.apply_comm_policy if what == "policy" else llm.apply_spd
        rep = fn(calib, **case[what])
        out[what] = spd_report(llm, rep)
        out[what]["greedy"] = [o.token_ids for o in llm.generate(
            ps, SamplingParams(max_new=6))]
    return out


def grads_off_thread(job, case, canon):
    """The gradient of a rank's shard of the training loss (plan
    first_k(L, 2), remat on, the syncs over the rank's groups), its
    backward run on this thread and on another one while this one waits
    in the groups' context, as the autograd engine runs a CUDA backward
    and a checkpoint's recomputation: {"same": the two bit for bit
    equal, "norm": the gradient's norm}."""
    import threading

    from repro_torch.config.base import SPDPlanConfig
    from repro_torch.core import model as M
    from repro_torch.core import simtp
    from repro_torch.data.synthetic import make_batch_iterator
    from repro_torch.launch.dist import current
    from repro_torch.parallel.collectives import rank_bound
    from repro_torch.parallel.tp import rank_rows

    g = current()
    cfg = case["cfg"]
    plan = SPDPlanConfig.first_k(cfg.n_layers, 2)
    params = simtp.split_padded(M.pad_model(canon[case["arch"]], cfg, g.tp),
                                cfg, plan, g.tp, rank=g.model_rank,
                                device="cpu")
    batch = rank_rows({k: torch.from_numpy(v) for k, v in next(
        make_batch_iterator(cfg.vocab_size, 4, 32, seed=0)).items()
        if not k.startswith("_")}, g)

    def grads(off):
        box = []
        with rank_bound(g):
            p, leaves = simtp.grad_leaves(params)
            with torch.enable_grad():
                _, met = M.loss_fn(cfg, p, plan, batch, tp=g.tp, q_chunk=32,
                                   remat=True)

            def back():
                box.extend(torch.autograd.grad(met["shard_ce"].sum(),
                                               leaves))
            if off:
                th = threading.Thread(target=back)
                th.start()
                th.join()
            else:
                back()
        return box

    here, there = grads(False), grads(True)
    return {"same": all(torch.equal(a, b) for a, b in zip(here, there)),
            "norm": float(sum((a.double() ** 2).sum() for a in here))}


LLM_CASES["algorithm1"] = algorithm1
CASES.update(train=train, train_ckpt=train_ckpt, train_cli=train_cli,
             serve_cli=serve_cli, grads_off_thread=grads_off_thread)


# ---------------------------------------------------------------------------
# The overlap engine and the rings on the ranks (test_torch_shard_overlap.py)
# and the groups of a (pod, data, model) world (test_torch_shard_pod.py,
# which trains there through `train` with a pod factor in its kw)
# ---------------------------------------------------------------------------

#: the reference's LatencyModel defaults, passed explicitly to both
#: packages (test_torch_overlap.py)
REF_LINK, REF_LAUNCH = 50e9, 0.1


def priced_tuples(led):
    """Ledger rows with their priced times: ledger_tuples + (est_us,
    fixed_us)."""
    return [t + (e.est_us, e.fixed_us)
            for t, e in zip(ledger_tuples(led), led)]


def step_inputs(vocab, rows, seed=0):
    """A prefill batch (rows, 16) with real lengths 7 + row, and a
    decode step's tokens after it."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (rows, 16)).astype(np.int64)
    lengths = 7 + np.arange(rows, dtype=np.int64)
    nxt = rng.integers(0, vocab, (rows, 1)).astype(np.int64)
    return toks, lengths, nxt


def overlap_steps(llm, case):
    """One prefill and one decode step through the engine's backend
    (`backend.wrap` of forward's steps: the overlap region), under a
    ledger priced at the reference's link (tp = the model group's):
    the priced rows, the backend's class and its overlaps_comm."""
    from repro_torch.parallel.collectives import LatencyModel
    from repro_torch.runtime import forward as F

    b, tp = llm.engine.backend, llm.tp
    pre = b.wrap(*F.prefill_step(llm.cfg, llm.plan, tp=tp, q_chunk=64,
                                 cache_len=48))
    dec = b.wrap(*F.decode_step(llm.cfg, llm.plan, tp=tp))
    toks, lengths, nxt = step_inputs(llm.cfg.vocab_size, case["rows"])
    lat = LatencyModel(link_bytes_per_s=REF_LINK, launch_us=REF_LAUNCH)
    with collective_ledger(latency=lat, tp=tp) as led:
        _, caches = pre(llm.params, toks, lengths)
        ids, _ = dec(llm.params, nxt, lengths, caches)
    return {"ledger": priced_tuples(led), "ids": ids.tolist(),
            "backend": type(b).__name__, "overlaps_comm": b.overlaps_comm}


def pipelined(llm, case):
    """`Engine.decode_pipelined` over `case["groups"]` decode groups of
    `case["rows"]` rows against serial `decode` of the same groups:
    {"ids": serial ids per group, "same": pipelined equal at depth 1, 2
    and 4, ids and caches}."""
    eng, params = llm.engine, llm.params
    rows = case["rows"]
    toks = np.random.default_rng(0).integers(0, llm.cfg.vocab_size,
                                             (rows, 1))
    pos = np.arange(rows, dtype=np.int64)

    def groups():
        return [(toks + i, pos, eng.blank_caches(rows, 32))
                for i in range(case["groups"])]

    serial = [eng.decode(params, *g) for g in groups()]
    same = True
    for depth in (1, 2, 4):
        piped = eng.decode_pipelined(params, groups(), depth=depth)
        for (ts, cs), (tq, cq) in zip(serial, piped):
            same = same and torch.equal(ts, tq) and all(
                torch.equal(a[k], c[k]) for a, c in zip(cs, cq) for k in a)
    return {"ids": [ts.tolist() for ts, _ in serial], "same": same}


LLM_CASES.update(overlap_steps=overlap_steps, pipelined=pipelined)


def ring_input(n, size, seed):
    """The (n, size) fp32 payload of a ring case, scaled by 2."""
    return (np.random.default_rng(seed).standard_normal((n, size))
            * 2.0).astype(np.float32)


def rings(job, case, canon):
    """The three ring collectives on this rank's row of each payload
    (`case["payloads"]`: (size, seed) pairs), the ring over the model
    group, or over the world (`case["over"] == "world"`, one ring of
    every rank): per payload and bits 8 / 4 the quantized ring's row and
    ledger, then the reduce-scatter's and the all-gather's rows and
    ledgers.  Returns {"n": the ring's length, "rows": [...]}."""
    import torch.distributed as dist

    from repro_torch.launch.dist import current
    from repro_torch.parallel import compression as C
    from repro_torch.parallel.collectives import ModelGroup, model_group

    g = current()
    if case.get("over") == "world":
        ctx = ModelGroup(g.world, g.rank, dist.group.WORLD)
    else:
        ctx = ModelGroup(g.tp, g.model_rank, g.model_group)
    out = []
    for size, seed in case["payloads"]:
        x = torch.from_numpy(ring_input(ctx.size, size, seed))
        mine = x[ctx.index:ctx.index + 1]
        calls = [(f"q{bits}", lambda v, b=bits: C.ring_quantized_psum(
            v, bits=b)) for bits in (8, 4)]
        calls += [("rs", C.ring_reduce_scatter), ("ag", C.ring_all_gather)]
        for name, fn in calls:
            with model_group(ctx), collective_ledger() as led:
                y = fn(mine)
            out.append((name, size, y.numpy(), ledger_tuples(led)))
    return {"n": ctx.size, "rows": out}


def layout(job, case, canon):
    """This rank's place in the world and the world ranks of each of its
    groups (None where it has none)."""
    import torch.distributed as dist

    from repro_torch.launch.dist import current

    g = current()

    def ranks(grp):
        return (None if grp is None else
                sorted(dist.get_process_group_ranks(grp)))

    return {"rank": g.rank, "pod_rank": g.pod_rank,
            "data_rank": g.data_rank, "model_rank": g.model_rank,
            "pod": g.pod, "model": ranks(g.model_group),
            "data": ranks(g.data_group), "pod_group": ranks(g.pod_group),
            "pod_data": ranks(g.pod_data_group),
            "replica": ranks(g.replica_group)}


CASES.update(rings=rings, layout=layout)
