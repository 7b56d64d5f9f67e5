"""`LLM` — the public way to load and run a model (port of
repro/api/llm.py: dense and paged serving, chunked prefill, speculative
decoding and streaming).

    from repro_torch.api import LLM, SamplingParams
    llm = LLM.load("smollm-360m", tp=2, spd=0.25, comm="quant8")
    outs = llm.generate(prompts, SamplingParams(max_new=16))
    paged = LLM.load("smollm-360m", tp=2, page_size=16, num_pages=40,
                     cache_len=512)
    overlap = LLM.load("smollm-360m", tp=2, comm="quant8", engine="overlap")
    mamba = LLM.load("mamba2-370m", tp=2, comm="quant8", cache_len=512)
    deepseek = LLM.load("deepseek-v2-lite-16b", tp=2, spd=0.25,
                        comm="quant8", page_size=16, num_pages=64)
    int8 = LLM.load(replace(get_config("llama2-7b"), kv_dtype="int8",
                            weight_dtype="int8"), tp=2, comm="quant8")
    llama = LLM.load("llama2-7b", tp=2, comm="quant8")
    calib = calibration_batches(32000, 4, 128, batch=2)
    llama.apply_comm_policy(calib, n_spd=8, tau1=t1, tau2=t2)  # tiers
    llama.apply_spd(calib, n_spd=8, tau1=t1, tau2=t2)   # Algorithm 1
    spec = LLM.load("llama2-7b", tp=2, comm="quant8", prefill_chunk=64,
                    spec=SpecConfig(k=4, draft="all-drop"))
    for ev in spec.generate_stream(prompts):   # StreamEvent per token
        ...

Runs on the CUDA device by default; with no CUDA device it raises
unless `device="cpu"` is asked for explicitly (there is no silent CPU
path).

Cluster serving and observability (cluster/, obs/):

    from repro_torch.obs import MetricsRegistry, Recorder, Tracer
    obs = Recorder(MetricsRegistry(), Tracer())
    llm = LLM.load("smollm-360m", tp=2, page_size=16, num_pages=64,
                   cache_len=512, dp_replicas=2, router="prefix-affinity",
                   obs=obs)
    llm.generate(prompts)        # routed over two replicas
    llm.serve().stats()          # the ClusterRouter's per-replica stats
    obs.snapshot(); obs.tracer.save("trace.json")

The replicas share the engine and the placed weights; each has its own
scheduler, KV pool, prefix cache and draft state.  Observability never
changes tokens.

`engine="shard"` runs one process per TP shard (tp x dp ranks; rank
d * tp + m is data rank d, model rank m).  Every rank runs the same
program after `launch.dist.init_tp`, e.g. under
`torchrun --nproc-per-node 2 app.py`:

    from repro_torch.launch.dist import init_tp
    init_tp(2, 1, backend="nccl")         # on the CPU: backend="gloo",
                                          # device="cpu"
    llm = LLM.load("llama2-7b", tp=2, spd=0.25, comm="quant8",
                   engine="shard")        # on cuda:LOCAL_RANK
    outs = llm.generate(prompts)          # the same outputs on every rank

or `launch.dist.spawn(fn, world, backend=, device=)` from one process.
Without the groups it raises.  It serves what `sim` serves: every
family (dense, MoE, MLA, SSM, hybrid), int8 caches and weights, dense
or paged caches, chunked prefill and speculative decoding, and runs
Algorithm 1 (`apply_spd`, `apply_comm_policy`) on each rank's own
shard with the syncs over its model group; every rank must reach the
same plan.  In such a world `engine="overlap"` is the shard engine plus
the overlap seams (the ring-step ledger, the hidden-comm pricing and
`Engine.decode_pipelined`; `parallel.backend.OverlapSeams`), with the
same tokens; in one process it runs on sim.

The modality-frontend configs (internvl2-1b, musicgen-medium) load and
`generate` text-only on every engine, as the reference's `LLM` does;
a prefill with precomputed embeddings goes through
`llm.engine.prefill(..., embeds=)`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.api.outputs import RequestOutput, StreamEvent
from repro_torch.api.sampling import SamplingParams
from repro_torch.api.scheduler import CacheConfig, Request, Scheduler
from repro_torch.config.base import (SYNC_LEVELS, CommPolicy, ModelConfig,
                                     SPDPlanConfig, replace)
from repro_torch.obs.recorder import NULL_RECORDER


def _resolve_comm(comm, n_layers: int,
                  logits: str = "exact") -> Optional[CommPolicy]:
    """None | CommPolicy | level string -> CommPolicy (None = all exact)."""
    if isinstance(comm, CommPolicy):
        return comm
    if comm is None:
        comm = "exact"
    if isinstance(comm, str):
        if comm not in SYNC_LEVELS:
            raise ValueError(f"comm={comm!r}: expected a CommPolicy or one "
                             f"of {SYNC_LEVELS}")
        if comm == "exact" and logits == "exact":
            return None
        return CommPolicy.uniform(n_layers, comm, logits=logits)
    raise TypeError(f"comm must be None, a str, or CommPolicy: {comm!r}")


def resolve_device(device) -> torch.device:
    """`device`, or the CUDA device when None; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' to run on the CPU on purpose")
    return torch.device("cuda")


def _rank_groups(device):
    """This rank's groups (`launch.dist.init_tp`) for a multi-process
    engine; raises without them (there is no single-process stand-in)."""
    from repro_torch.launch import dist as D
    g = D.current()
    if g is None:
        raise NotImplementedError(
            "engine='shard' runs one process per shard and has no "
            "single-process form (ROADMAP A5): call "
            "repro_torch.launch.dist.init_tp(tp, dp, backend=...) in every "
            "rank first (torchrun, or launch.dist.spawn)")
    if device is not None and torch.device(device) != g.device:
        raise ValueError(f"device {device} is not this rank's {g.device}")
    return g


def _as_prompts(prompts) -> List[np.ndarray]:
    if isinstance(prompts, np.ndarray):
        prompts = [prompts] if prompts.ndim == 1 else list(prompts)
    elif len(prompts) and isinstance(prompts[0], (int, np.integer)):
        prompts = [prompts]
    return [np.asarray(p, np.int64) for p in prompts]


def _per_request(sampling, n: int) -> List[SamplingParams]:
    if sampling is None:
        sampling = SamplingParams()
    if isinstance(sampling, SamplingParams):
        return [sampling] * n
    if len(sampling) != n:
        raise ValueError(f"got {len(sampling)} SamplingParams for "
                         f"{n} prompts")
    return list(sampling)


class LLM:
    """A loaded model + engine + placed params behind one object; build
    it with `LLM.load(...)`."""

    def __init__(self, cfg, plan, engine_kind, canonical,
                 cache: CacheConfig, *, tp: int, dp: int, q_chunk: int,
                 device, groups=None, dp_replicas: int = 1,
                 router: str = "least-outstanding", obs=None):
        self.obs = obs if obs is not None else NULL_RECORDER
        self.cfg, self.plan = cfg, plan
        self.engine_kind = engine_kind
        self.groups = groups          # launch.dist.TPGroups on `shard`
        self.canonical = canonical
        self.cache = cache
        self.tp, self.dp, self.q_chunk = tp, dp, q_chunk
        self.device = device
        # DP-over-TP cluster serving: > 1 makes serve() a ClusterRouter
        # over this many replicas sharing the engine and weights
        self.dp_replicas = dp_replicas
        self.router_policy = router
        self.engine = self.params = None
        # self-speculative decoding: the draft is these same canonical
        # weights placed under a cheaper plan
        self.spec = None              # SpecConfig or None
        self.draft_plan = None
        self.draft_engine = self.draft_params = None
        self.spec_calibration = None  # CalibrationResult ("calibrated")
        self._sched: Optional[Scheduler] = None
        self._next_uid = -1

    @classmethod
    def load(cls, arch, *, tp: int = 1, dp: int = 1, engine: str = "sim",
             spd: float = 0.0, plan: Optional[SPDPlanConfig] = None,
             comm=None, comm_logits: str = "exact", page_size=None,
             num_pages=None, prefill_chunk=None, cache_len: int = 128,
             max_batch: int = 4, dtype: Optional[str] = None, seed: int = 0,
             params=None, q_chunk: int = 64, spec=None,
             dp_replicas: int = 1, router: str = "least-outstanding",
             obs=None, device=None) -> "LLM":
        """Load `arch` (config name or ModelConfig) onto an engine.

        engine     "sim" (every shard on one device), "shard" (one
                   process per shard, see the module doc; the canonical
                   weights are drawn on the card and kept on the host,
                   so a rank's card holds its shard) or "overlap" (the
                   ring-step comm ledger and pipelined decode on sim in
                   one process, on shard in a world of ranks; the same
                   tokens).
        spd        fraction of blocks to SPD-drop (first-k plan), ignored
                   when an explicit `plan` is given; no block drops on
                   an attention-free (SSM) model, which has one sync
                   point per block.
        page_size, num_pages
                   paged KV cache (set both): a shared pool of num_pages
                   pages of page_size tokens, with preemption; cache_len
                   is then the per-slot cap.  Full-causal GQA stacks with
                   fp caches run the fused paged forward and the prefix
                   cache; the others (int8 KV, MLA, windowed, hybrid,
                   SSM) page their sequence leaves through the gather ->
                   dense -> scatter fallback, without a prefix cache.
        comm       kept-sync comm policy: a CommPolicy, or a level string
                   ("exact" | "quant8" | "quant4") for every kept sync;
                   `comm_logits` sets the logits all-gather level.
        params     canonical parameter tree (e.g. carried over from the
                   reference with core.convert.from_reference); a fresh
                   seeded `init_model` when omitted.
        device     where the shards live: CUDA by default (on "shard",
                   the rank's own: cuda:LOCAL_RANK), "cpu" only on
                   request.
        prefill_chunk
                   prefill prompts in chunks of this many tokens (either
                   cache layout); full-causal GQA models only, others
                   prefill whole.
        spec       a `repro_torch.spec.SpecConfig` turns on
                   self-speculative decoding: the draft shares these
                   weights under the preset's cheaper plan, the exact
                   model verifies k drafts a step (greedy stays token-
                   identical; sampling keeps its distribution).  The
                   "tiered" and "calibrated" presets need calibration
                   data: use `enable_spec`.
        dp_replicas
                   data parallelism over the TP groups: `serve()` and
                   `generate()` then run through a ClusterRouter over
                   this many replicas, each its own Scheduler (KV pool,
                   prefix cache, draft state) on the shared engine and
                   weights.  On "shard" every rank holds the same
                   replicas and routes alike.
        router     the cluster's routing policy when dp_replicas > 1
                   (`repro_torch.cluster.route_policy_names()`):
                   "round-robin" | "least-outstanding" |
                   "prefix-affinity".
        obs        a `repro_torch.obs.Recorder` wired through every
                   scheduler, router, page pool and drafter this LLM
                   builds (metrics and the request-lifecycle trace);
                   the default null recorder costs nothing, and
                   observability never changes tokens.
        """
        from repro_torch.cluster.router import make_policy
        from repro_torch.configs import get_config
        from repro_torch.core import model as M
        from repro_torch.parallel.backend import backend_class, backend_names

        if engine not in backend_names():
            raise NotImplementedError(
                f"engine={engine!r} is not ported (the engines are "
                f"{backend_names()}; ROADMAP A5)")
        if dp_replicas < 1:
            from repro_torch.runtime.elastic import ClusterConfigError
            raise ClusterConfigError(
                f"dp_replicas must be >= 1, got {dp_replicas}")
        make_policy(router)           # fail fast on unknown policy names
        cache = CacheConfig(cache_len=cache_len, max_batch=max_batch,
                            page_size=page_size, num_pages=num_pages,
                            prefill_chunk=prefill_chunk)
        cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
        if dtype is not None:
            cfg = replace(cfg, dtype=dtype)
        keep = groups = None
        if backend_class(engine).multi_process:
            groups = _rank_groups(device)
            dev = groups.device
            if max_batch % dp:
                raise ValueError(f"max_batch {max_batch} does not split over "
                                 f"dp {dp} data ranks")
            keep = torch.device("cpu")
        else:
            dev = resolve_device(device)
        if plan is None:
            k = int(round(cfg.n_layers * spd)) if cfg.spd_applicable else 0
            plan = SPDPlanConfig.first_k(cfg.n_layers, k)
        elif len(plan.drop_mask) != cfg.n_layers:
            raise ValueError(f"plan covers {len(plan.drop_mask)} layers, "
                             f"model has {cfg.n_layers}")
        if comm is not None or comm_logits != "exact":
            plan = plan.with_comm(_resolve_comm(comm, cfg.n_layers,
                                                comm_logits))
        canonical = (params if params is not None
                     else M.init_model(cfg, seed=seed, device=dev,
                                       keep=keep))
        llm = cls(cfg, plan, engine, canonical, cache, tp=tp, dp=dp,
                  q_chunk=q_chunk, device=dev, groups=groups,
                  dp_replicas=dp_replicas, router=router, obs=obs)
        llm._build_engine()
        if spec is not None:
            llm.enable_spec(spec)
        return llm

    def _make_engine(self, plan):
        """A fresh engine for `plan` on this LLM's backend kind."""
        from repro_torch.parallel.backend import make_backend
        from repro_torch.runtime.engines import Engine

        backend = make_backend(self.engine_kind, self.cfg, plan, tp=self.tp,
                               dp=self.dp, device=self.device,
                               groups=self.groups)
        return Engine(self.cfg, plan, backend, q_chunk=self.q_chunk)

    def _place(self, engine, padded=None):
        """`padded` params (default: the canonical params, padded) in
        `engine`'s layout; the draft engine places the same canonical
        tensors under its own plan."""
        from repro_torch.core import model as M

        if padded is None:
            padded = M.pad_model(self.canonical, self.cfg, self.tp,
                                 device=self.device)
        return engine.backend.place_params(padded)

    def _build_engine(self, padded=None):
        """(Re)build the engine for `self.plan` and place `padded` params
        (default: the canonical params, padded) into its layout; with
        speculation on, the draft's placement too."""
        self._release_engine()
        self.engine = self._make_engine(self.plan)
        self.params = self._place(self.engine, padded)
        if self.spec is not None:
            self._build_spec()

    def _release_engine(self):
        """Drop the placed params (the draft's too), the engines and the
        cached scheduler (its caches belong to the old plan), so that a
        new placement or a sensitivity sweep's does not sit beside
        them."""
        self.engine = self.params = self._sched = None
        self.draft_engine = self.draft_params = None

    # ---------------- speculative decoding ----------------

    def enable_spec(self, spec, calib_batches=None, *, sensitivity=None,
                    ranking=None, calib_prompts=None,
                    calib_target: float = 0.45,
                    force_calibration: bool = False):
        """Turn on self-speculative decoding (or change its config).

        "tiered" reuses Algorithm 1's ISB/SB/ESB tiers: pass
        `calib_batches` to run the sweep here, or a measured
        `sensitivity` / `ranking`.  "calibrated" searches draft policies
        (spec.calibrate) for the cheapest whose measured acceptance on
        held-out prompts (`calib_prompts`, or sliced from
        `calib_batches`) clears `calib_target`; cached per (arch, engine,
        tp) unless `force_calibration`; the result lands on
        `self.spec_calibration`.  Drops the cached scheduler.  Returns
        self.  On `shard` every rank runs the same sweep and search and
        reaches the same draft plan."""
        from repro_torch.spec import SpecConfig, SpecError, derive_draft_plan

        if not isinstance(spec, SpecConfig):
            raise TypeError(f"spec must be a repro_torch.spec.SpecConfig, "
                            f"got {spec!r}")
        needs_tiers = spec.draft in ("tiered", "calibrated")
        if (needs_tiers and sensitivity is None
                and calib_batches is not None):
            from repro_torch.core.spd import sweep_sensitivity
            from repro_torch.tree import tree_map
            # on `shard` the canonical tree stays on the host: every rank
            # runs the same sweep on its own device
            canon = tree_map(lambda w: w.to(self.device), self.canonical)
            res, _ = sweep_sensitivity(self.cfg, canon, calib_batches,
                                       self.tp, q_chunk=self.q_chunk)
            del canon
            sensitivity, ranking = res.sensitivity, res.ranking
        policy = None
        if spec.draft == "calibrated":
            from repro_torch.spec import calibrate_draft
            prompts = calib_prompts
            if prompts is None and calib_batches is not None:
                prompts = self._calib_prompts(calib_batches)
            if prompts is None or not len(prompts):
                raise SpecError(
                    'draft="calibrated" needs held-out prompts: pass '
                    "calib_prompts=[token seqs] or calib_batches to "
                    "enable_spec")
            cal = calibrate_draft(self, prompts, k=spec.k,
                                  target=calib_target,
                                  sensitivity=sensitivity,
                                  force=force_calibration)
            self.spec_calibration = cal
            policy = cal.policy
        self.draft_plan = derive_draft_plan(self.cfg, spec,
                                            sensitivity=sensitivity,
                                            ranking=ranking, policy=policy)
        self.spec = spec
        self._build_spec()
        return self

    def _calib_prompts(self, calib_batches, *, n: int = 3) -> list:
        """Held-out prompts for draft calibration: the first row of the
        tokens of each of the first `n` `data.calibration_batches`,
        trimmed so that prompt + the measured decode fit the cache."""
        lim = max(4, min(16, self.cache.cache_len // 4))
        return [np.asarray(b["tokens"], np.int64)[0, :lim]
                for b in calib_batches[:n]]

    def disable_spec(self):
        """Back to plain decoding (drops the cached scheduler)."""
        self.spec = None
        self.draft_plan = self.draft_engine = self.draft_params = None
        self._sched = None

    def _build_spec(self):
        """(Re)build the draft engine and place the canonical weights
        under the draft plan.  The old draft placement and the cached
        scheduler (whose drafter holds it) are dropped first, so that the
        two placements never sit side by side."""
        self.draft_engine = self.draft_params = self._sched = None
        self.draft_engine = self._make_engine(self.draft_plan)
        self.draft_params = self._place(self.draft_engine)

    def _spec_state(self, cache: CacheConfig):
        """A fresh SpecState for a scheduler (each owns its draft cache),
        or None when speculation is off."""
        if self.spec is None:
            return None
        from repro_torch.spec import Drafter, SpecState
        drafter = Drafter(self.draft_engine, self.draft_params,
                          cache.max_batch, cache.cache_len,
                          prefill_chunk=cache.prefill_chunk)
        return SpecState(k=self.spec.k, drafter=drafter,
                         adaptive=self.spec.adaptive,
                         k_min=self.spec.k_min, k_max=self.spec.k_max,
                         tree_width=self.spec.tree_width)

    def serve(self, **overrides):
        """A scheduler on this model: a `Scheduler`, or with
        `dp_replicas > 1` a `repro_torch.cluster.ClusterRouter` over that
        many replicas (the same surface: submit / step / run / cancel /
        completed).  Without overrides, the (cached) one `generate`
        drives; with overrides (any CacheConfig field, `dp_replicas`,
        `router`), a fresh one on the same engine and params."""
        if overrides:
            n = overrides.pop("dp_replicas", self.dp_replicas)
            policy = overrides.pop("router", self.router_policy)
            cc = dataclasses.replace(self.cache, **overrides)
            if n > 1:
                return self.make_cluster(n, policy=policy, cache=cc)
            return self._scheduler(cc)
        if self._sched is None:
            self._sched = (self.make_cluster() if self.dp_replicas > 1
                           else self._scheduler(self.cache))
        return self._sched

    def _scheduler(self, cache: CacheConfig) -> Scheduler:
        return Scheduler(self.engine, self.params, cache,
                         spec=self._spec_state(cache), obs=self.obs)

    # ---------------- cluster serving ----------------

    def replica_factory(self, cache: Optional[CacheConfig] = None):
        """`rid -> Replica` over this model's engine and placed params:
        what `make_cluster` builds from and what a cluster
        `ElasticScaler` scales up with.  Each replica gets its own
        `Scheduler` (KV pool, prefix cache, draft state); the engine and
        the weights on the card are shared."""
        from repro_torch.cluster import Replica

        cc = cache or self.cache

        def factory(rid: int) -> "Replica":
            return Replica(rid, self._scheduler(cc), comm=self.plan.comm)
        return factory

    def make_cluster(self, n: Optional[int] = None, *, policy=None,
                     cache: Optional[CacheConfig] = None,
                     warmup: bool = True):
        """A `ClusterRouter` over `n` replicas of this model (default:
        the `dp_replicas` / `router` this LLM was loaded with); each
        replica runs a warm-up request first unless `warmup=False`."""
        from repro_torch.cluster import ClusterConfigError, ClusterRouter

        n = n if n is not None else self.dp_replicas
        if n < 1:
            raise ClusterConfigError(f"need >= 1 replica, got {n}")
        factory = self.replica_factory(cache)
        return ClusterRouter([factory(rid) for rid in range(n)],
                             policy=policy or self.router_policy,
                             warmup=warmup, obs=self.obs)

    def _submit(self, prompts, sampling) -> List[Request]:
        """Validate the whole batch (all or nothing), then enqueue it on
        the cached scheduler."""
        prompts = _as_prompts(prompts)
        sps = _per_request(sampling, len(prompts))
        sched = self.serve()
        reqs = []
        for p, sp in zip(prompts, sps):
            reqs.append(Request(uid=self._next_uid, prompt=p,
                                max_new=sp.max_new, sampling=sp))
            self._next_uid -= 1
        for req in reqs:
            sched.validate(req)
        # a Scheduler stamps submission here; a ClusterRouter's replicas
        # stamp it at routed enqueue
        stamp = getattr(sched, "note_submit", None)
        for req in reqs:
            if stamp is not None:
                stamp(req)
            sched.queue.append(req)
        return reqs

    def generate(self, prompts, sampling: Optional[SamplingParams] = None,
                 max_steps: int = 100_000) -> List[RequestOutput]:
        """Run `prompts` to completion; results in submission order.
        `sampling` is one SamplingParams or one per prompt (default
        greedy)."""
        reqs = self._submit(prompts, sampling)
        sched = self.serve()
        steps = 0
        try:
            while any(not r.done for r in reqs) and steps < max_steps:
                if not sched.step():
                    break
                steps += 1
        finally:
            sched.cancel(reqs)
        if any(not r.done for r in reqs):
            raise RuntimeError(
                f"generate did not converge in {steps} steps "
                f"({sum(r.done for r in reqs)}/{len(reqs)} done)")
        return [RequestOutput(index=i,
                              prompt_token_ids=[int(t) for t in r.prompt],
                              token_ids=list(r.out),
                              finish_reason=r.finish_reason,
                              n_preempted=r.n_preempted)
                for i, r in enumerate(reqs)]

    def generate_stream(self, prompts,
                        sampling: Optional[SamplingParams] = None,
                        max_steps: int = 100_000) -> Iterator[StreamEvent]:
        """Like `generate`, but yields each token as it is committed (the
        admission token included; tokens recomputed after a preemption
        are not emitted again).  Abandoning the generator withdraws its
        requests from the scheduler."""
        reqs = self._submit(prompts, sampling)
        sched = self.serve()
        emitted = [0] * len(reqs)

        def drain():
            for i, r in enumerate(reqs):
                while emitted[i] < len(r.out):
                    tok = r.out[emitted[i]]
                    emitted[i] += 1
                    last = r.done and emitted[i] == len(r.out)
                    yield StreamEvent(
                        index=i, token_id=int(tok), done=last,
                        finish_reason=r.finish_reason if last else None)

        steps = 0
        try:
            while any(not r.done for r in reqs) and steps < max_steps:
                if not sched.step():
                    break
                steps += 1
                yield from drain()
            yield from drain()
            if any(not r.done for r in reqs):
                raise RuntimeError(
                    f"stream did not converge in {steps} steps")
        finally:
            # on completion AND when the caller abandons the generator:
            # unfinished requests must not keep the queue or slots
            sched.cancel(reqs)

    # ---------------- the paper's SPD pipeline ----------------

    def _rank_agree(self, plan, ranking, what: str) -> None:
        """On `shard`: every rank of the world reached the same plan
        (drop mask and comm levels) and report ranking, before the engine
        is rebuilt on it (backend.agree_across)."""
        if self.groups is None:
            return
        from repro_torch.parallel.backend import agree_across
        levels = (list(plan.comm.block_modes) + [plan.comm.logits_mode]
                  if plan.comm is not None else [])
        vals = ([int(d) for d in plan.drop_mask]
                + [SYNC_LEVELS.index(m) for m in levels]
                + [int(i) for i in ranking])
        agree_across(self.groups, vals, what)

    def apply_spd(self, calib_batches, *, n_spd: int, tau1: float,
                  tau2: float, lr: float = 5e-5, epochs: int = 10,
                  strategies=("ZS", "B2B", "HG"),
                  q_chunk: Optional[int] = None):
        """Algorithm 1 on this model's canonical params (sensitivity
        sweep -> ISB/SB/ESB tiers -> zero-shot drop for ISB, block-to-
        block distillation for SB, head grouping then distillation for
        ESB), then redeploy the result onto the engine in place: the
        padded params it returns are placed as they are (distilled SPD
        weights belong to this tp).  Returns the `SPDReport`; the plan,
        engine and placed params are replaced and the cached scheduler
        dropped.  On `shard` each rank runs its own shard (core/spd.py)
        and all must reach the same plan and ranking."""
        from repro_torch.core import spd as SPD

        self._release_engine()
        padded = None
        try:
            padded, plan, report = SPD.apply_spd(
                self.cfg, self.canonical, calib_batches, self.tp,
                n_spd=n_spd, tau1=tau1, tau2=tau2, lr=lr, epochs=epochs,
                strategies=strategies, q_chunk=q_chunk or self.q_chunk,
                groups=self.groups)
            self._rank_agree(plan, report.ranking, "apply_spd")
            self.plan = plan
        finally:
            self._build_engine(padded)
        return report

    def apply_comm_policy(self, calib_batches, *, n_spd: int, tau1: float,
                          tau2: float, sb_level: str = "quant8",
                          esb_level: str = "exact", logits: str = "exact",
                          q_chunk: Optional[int] = None):
        """Sensitivity-aware per-block comm policy: run the sensitivity
        sweep, then give each block the cheapest sync it can afford --
        ISB blocks within the `n_spd` budget DROP the attention sync, SB
        blocks keep it at `sb_level`, ESB blocks at `esb_level` -- and run
        the logits all-gather at `logits`.  Zero-shot: the canonical
        weights are re-placed under the new plan and policy.  Returns the
        SensitivityResult; `self.plan.comm` holds the policy after."""
        from repro_torch.core import spd as SPD

        self._release_engine()
        try:
            plan, res = SPD.assign_comm_policy(
                self.cfg, self.canonical, calib_batches, self.tp,
                n_spd=n_spd, tau1=tau1, tau2=tau2, sb_level=sb_level,
                esb_level=esb_level, logits=logits,
                q_chunk=q_chunk or self.q_chunk, groups=self.groups)
            self._rank_agree(plan, res.ranking, "apply_comm_policy")
            self.plan = plan
        finally:
            self._build_engine()
        return res

    def set_comm_policy(self, comm, *, logits: str = "exact"):
        """Attach a CommPolicy (or uniform level string) to the current
        plan and rebuild the engine (params re-placed: the comm-refined
        segmentation restacks them)."""
        self.plan = self.plan.with_comm(_resolve_comm(comm, self.cfg.n_layers,
                                                      logits))
        self._build_engine()
