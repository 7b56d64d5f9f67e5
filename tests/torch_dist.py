"""Rank workers of the shard engine's CPU tests (`test_torch_shard*.py`).

Imports only torch, numpy and repro_torch: each worker runs in a process
that `repro_torch.launch.dist.spawn` started over gloo, one torch thread
a rank.  `run(rank, job)` builds the TP groups, loads the canonical trees
the parent saved (`job["params"]`, a torch.save'd {arch: tree}) and runs
`job["cases"]` in order, each a dict with a "kind" (a function below)
and its arguments; it returns {case name: result} of plain Python and
numpy values.  Every LLM it builds checks, at each admission and decode
step, that all ranks took the same tokens (`ShardBackend.agree`).
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
    if engine == "shard":
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
    for p in case.get("then", ()):
        # a later admission of the same scheduler (the warm prefix)
        more = llm.generate([np.asarray(p, np.int64)],
                            SamplingParams(max_new=5))
        out.setdefault("then", []).append(more[0].token_ids)
    if case.get("sampled"):
        out["sampled"] = [o.token_ids for o in llm.generate(ps, SAMPLED)]
    sched = llm.serve()
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


def run(rank, job):
    from repro_torch.launch.dist import init_tp

    torch.set_num_threads(1)
    init_tp(job["tp"], job["dp"], backend="gloo", device="cpu",
            timeout_s=60)
    canon = torch.load(job["params"]) if job.get("params") else {}
    out = {}
    for case in job["cases"]:
        kind = case["kind"]
        if kind in ("serve", "logits"):
            llm = load(case["cfg"], canon[case["arch"]], "shard", job["tp"],
                       job["dp"], **case.get("load", {}))
            out[case["name"]] = (serve if kind == "serve" else logits)(
                llm, case)
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
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import compression as C
    from repro_torch.parallel import tp as TP
    from repro_torch.parallel.collectives import ModelGroup, model_group
    from repro_torch.spec import SpecConfig

    tp, dp = job["tp"], job["dp"]
    base = replace(get_config("smollm-360m", reduced=True), dtype="float32")
    kw = dict(tp=tp, dp=dp, engine="shard", device="cpu", cache_len=64)

    def reduced(name, **cfg_kw):
        return replace(get_config(name, reduced=True), dtype="float32",
                       **cfg_kw)

    def shard_ctx():
        from repro_torch.launch.dist import current
        g = current()
        return model_group(ModelGroup(g.tp, g.model_rank, g.model_group))

    def ring():
        with shard_ctx():
            C.ring_quantized_psum(torch.zeros(1, 256))

    attempts = {
        "spec": lambda: LLM.load(base, spec=SpecConfig(k=3), **kw),
        "prefill_chunk": lambda: LLM.load(base, prefill_chunk=8, **kw),
        "moe": lambda: LLM.load(reduced("qwen2-moe-a2.7b"), **kw),
        "mla": lambda: LLM.load(reduced("deepseek-v2-lite-16b"), **kw),
        "hybrid": lambda: LLM.load(reduced("hymba-1.5b"), **kw),
        "ssm": lambda: LLM.load(reduced("mamba2-370m"), **kw),
        "int8_kv": lambda: LLM.load(reduced("llama2-7b", kv_dtype="int8"),
                                    **kw),
        "overlap": lambda: LLM.load(base, tp=tp, engine="overlap",
                                    device="cpu"),
        "ring": ring,
        "train": lambda: TP.build_train_step(
            base, None, make_test_mesh(dp, tp), TP.TrainStepConfig(),
            device="cpu"),
        "world": lambda: LLM.load(base, tp=2 * tp, dp=dp, engine="shard",
                                  device="cpu", cache_len=64),
    }
    llm = LLM.load(base, **kw)
    attempts["enable_spec"] = lambda: llm.enable_spec(SpecConfig(k=3))
    attempts["apply_spd"] = lambda: llm.apply_spd([], n_spd=1, tau1=0.0,
                                                  tau2=1.0)
    attempts["apply_comm_policy"] = lambda: llm.apply_comm_policy(
        [], n_spd=1, tau1=0.0, tau2=1.0)
    attempts["prefill_chunked"] = lambda: llm.engine.prefill_chunked(
        llm.params, np.zeros((1, 8), np.int64), cache_len=64,
        lengths=np.asarray([8]), chunk=8)
    out = {}
    for name, fn in attempts.items():
        try:
            fn()
            out[name] = "ran"
        except Exception as e:                      # noqa: BLE001
            out[name] = (type(e).__name__, str(e))
    return out


CASES = {"quantized_sync": quantized_sync, "collectives": collectives,
         "refusals": refusals}
