"""Serving entry point: batched prefill + decode with continuous batching
through the facade (port of repro/launch/serve.py: the same flags and
the same JSON line).

    python -m repro_torch.launch.serve --arch smollm-360m --tp 2 \
        --spd 0.25 --comm quant8 --page-size 16 --num-pages 64 \
        --replicas 2 --router prefix-affinity --metrics-json m.json \
        --trace t.json

It runs on the card (`--device cuda`, the default) and on the CPU only
when asked (`--device cpu`); without a card it stops with an error.
`--attn-backend pallas` (the default, as the train CLI's) serves
through the hand-written flash and paged kernels on the card (their
plain versions on the CPU); `xla` through the plain attention, the
reference's config default (its CLI has no such flag).
The weights are random from `--seed`, and so are the `--requests`
prompts (4 to 23 tokens, numpy's default_rng(seed), as the
reference's).  Prints one JSON line: `completed`, `outputs` (the first 8
tokens of each request) and, where their flags ask, the `comm`, `spec`,
`paged`, `cluster` and `obs` blocks.

Paged KV cache: ``--page-size P --num-pages N`` (a small pool
preempts); ``--prefill-chunk C`` prefills in chunks of C on either
layout.  ``--comm quant8|quant4`` quantizes every kept sync,
``--comm-logits`` the logits gather.  ``--spec-k K`` turns on
self-speculative decoding (greedy outputs stay those of plain
decoding).  ``--replicas N --router POLICY`` serves through a
ClusterRouter over N replicas sharing the engine and weights (routing
picks where a request runs, never its numerics).  ``--metrics-json``
and ``--trace`` turn the observability on (obs/): the first writes the
metric snapshot (flat dict + Prometheus text), the second a
Chrome/Perfetto trace with the per-slot, scheduler, spec, cluster and
comm tracks.  Greedy outputs are the same with it on or off.

The comm track prices the run's comm ledger with a `LatencyModel` of
the link this port runs on: the H100 SXM's NVLink 4 data-sheet rate
(450 GB/s a direction) and an assumed 5 us a collective launch
(`NVLINK_BYTES_PER_S`, `LAUNCH_US`; the JSON's `obs.latency` states
them), where the reference's CLI prices its model's defaults (50 GB/s,
0.1 us).  The port's ledger logs every call,
where the reference's logs each compiled step once, at its tracing
(ROADMAP C14): the `obs.comm` totals count every forward of the run.

`--engine shard` serves as one rank of a tp x dp world, one process a
rank, as `launch/train.py` trains:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch smollm-360m --engine shard --tp 2

or `main([...])` in each rank of `launch.dist.spawn`; rank 0 alone
prints and writes the files.
"""
from __future__ import annotations

import argparse
import json
import sys

#: the H100 SXM's NVLink 4 data-sheet rate, bytes a second a direction
NVLINK_BYTES_PER_S = 450e9
#: an assumed launch cost of one collective, microseconds
LAUNCH_US = 5.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--spd", type=float, default=0.0)
    ap.add_argument("--engine", default="sim",
                    choices=("sim", "shard", "overlap"),
                    help="sim: every shard in this process; shard: this "
                         "process is one rank of tp x dp; overlap: the "
                         "ring-step ledger and pipelined decode (on the "
                         "ranks in a world of them)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--attn-backend", default="pallas",
                    choices=("pallas", "xla"),
                    help="pallas: the flash and paged kernels (their plain "
                         "versions on the CPU); xla: the plain attention "
                         "(the reference CLI's config default)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV page; with --num-pages selects "
                         "the paged cache (0 = dense)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="pages in the shared pool; small values force "
                         "preemption-by-eviction")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size, dense or paged (0 = "
                         "power-of-two buckets)")
    ap.add_argument("--comm", choices=["exact", "quant8", "quant4"],
                    default="exact",
                    help="quantization level for every kept sync point")
    ap.add_argument("--comm-logits", choices=["exact", "quant8", "quant4"],
                    default="exact",
                    help="quantization level for the logits all-gather")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: tokens drafted per "
                         "verify round (0 = off); with --spec-adaptive "
                         "each request's starting budget")
    ap.add_argument("--spec-draft",
                    choices=["all-drop", "drop+quant4", "calibrated"],
                    default="all-drop",
                    help="draft comm preset (same weights, cheaper "
                         "syncs); 'calibrated' searches drop/quant "
                         "policies for the cheapest one clearing the "
                         "acceptance target on held-out prompts")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="per-request adaptive draft budget")
    ap.add_argument("--spec-k-max", type=int, default=0,
                    help="adaptive budget ceiling (0 = --spec-k)")
    ap.add_argument("--spec-tree-width", type=int, default=1,
                    help="tree speculation: also verify the draft's "
                         "top-2..top-W first-position candidates (1 = "
                         "chain)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="DP-over-TP cluster serving: weight-shared "
                         "replicas behind the cluster router (1 = one "
                         "scheduler)")
    ap.add_argument("--router", default="least-outstanding",
                    help="cluster routing policy (round-robin | "
                         "least-outstanding | prefix-affinity)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default); > 0 samples")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics snapshot (flat dict + "
                         "Prometheus text) to this path")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run to this path")
    return ap.parse_args(argv)


def serve(args):
    """Run the CLI's workload: (the JSON line's dict, the LLM)."""
    import numpy as np

    from repro_torch.api import LLM, SamplingParams
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.spec import SpecConfig

    # observability: an isolated registry + wall-clock tracer, wired
    # through every scheduler, pool, drafter and router the facade builds;
    # obs=None keeps the null recorder
    obs = None
    if args.metrics_json or args.trace:
        from repro_torch.obs import MetricsRegistry, Recorder, Tracer
        obs = Recorder(MetricsRegistry(), Tracer())

    paged = args.page_size > 0 and args.num_pages > 0
    spec = None
    if args.spec_k > 0:
        spec = SpecConfig(
            k=args.spec_k, draft=args.spec_draft,
            adaptive=args.spec_adaptive,
            k_max=(args.spec_k_max or None) if args.spec_adaptive
            else None, tree_width=args.spec_tree_width)
    # "cuda": LLM.load's default (the card, or the rank's own), which
    # raises without one
    device = None if args.device == "cuda" else args.device
    cfg = replace(get_config(args.arch), attn_backend=args.attn_backend)
    llm = LLM.load(
        cfg, tp=args.tp, dp=args.dp, engine=args.engine,
        spd=args.spd, dtype=args.dtype, seed=args.seed,
        comm=args.comm, comm_logits=args.comm_logits,
        cache_len=args.cache_len, max_batch=args.max_batch,
        page_size=args.page_size if paged else None,
        num_pages=args.num_pages if paged else None,
        prefill_chunk=args.prefill_chunk or None, q_chunk=64,
        dp_replicas=args.replicas, router=args.router,
        spec=spec if args.spec_draft != "calibrated" else None, obs=obs,
        device=device)
    if spec is not None and args.spec_draft == "calibrated":
        # held-out prompts (a seed disjoint from the serving prompts')
        crng = np.random.default_rng(args.seed + 1_000_003)
        calib = [crng.integers(0, llm.cfg.vocab_size, 12).astype(np.int64)
                 for _ in range(3)]
        llm.enable_spec(spec, calib_prompts=calib)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, llm.cfg.vocab_size,
                            int(rng.integers(4, 24))).astype(np.int64)
               for _ in range(args.requests)]
    sampling = SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.sample_seed, max_new=args.max_new)
    if obs is not None:
        from repro_torch.parallel.collectives import (LatencyModel,
                                                      collective_ledger)
        lat = LatencyModel(link_bytes_per_s=NVLINK_BYTES_PER_S,
                           launch_us=LAUNCH_US)
        with collective_ledger(latency=lat, tp=args.tp) as comm_entries:
            outs = llm.generate(prompts, sampling)
        comm_agg = obs.record_comm(comm_entries, lat, tp=args.tp,
                                   overlap=(args.engine == "overlap"))
    else:
        outs = llm.generate(prompts, sampling)
    sched = llm.serve()
    out = {
        "completed": sum(o.finished for o in outs),
        "outputs": {o.index: o.token_ids[:8] for o in outs},
    }
    # replicas > 1: sched is a ClusterRouter; per-replica stats from its
    # stats(), aggregates from its replicas
    cluster = args.replicas > 1
    scheds = ([rep.sched for rep in sched.replicas.values()]
              if cluster else [sched])
    if args.comm != "exact" or args.comm_logits != "exact":
        out["comm"] = {"blocks": args.comm, "logits": args.comm_logits}
    if args.spec_k > 0:
        drafted = sum(s.spec_drafted for s in scheds)
        out["spec"] = {"k": args.spec_k, "draft": args.spec_draft,
                       "acceptance": round(
                           sum(s.spec_accepted for s in scheds)
                           / max(drafted, 1), 4),
                       "tokens_per_step": round(
                           sum(s.spec_committed for s in scheds)
                           / max(sum(s.spec_row_rounds
                                     for s in scheds), 1), 4)}
        if args.spec_adaptive:
            out["spec"]["adaptive"] = {"k_max": args.spec_k_max
                                       or args.spec_k}
        if args.spec_tree_width > 1:
            out["spec"]["tree"] = {
                "width": args.spec_tree_width,
                "alt_commits": sum(s.spec_alt_commits for s in scheds)}
        if llm.spec_calibration is not None:
            cal = llm.spec_calibration
            out["spec"]["calibrated"] = {
                "policy": cal.name,
                "calib_acceptance": round(cal.acceptance, 4),
                "trials": len(cal.trials)}
    if paged:
        out["paged"] = {"page_size": args.page_size,
                        "num_pages": args.num_pages,
                        "preemptions": sum(s.n_preemptions
                                           for s in scheds),
                        "free_pages": sum(s.pool.num_free
                                          for s in scheds),
                        "pool_high_water": max(s.pool.high_water
                                               for s in scheds),
                        "prefix_hits": sum(s.kv.prefix_hits
                                           for s in scheds)}
    if cluster:
        out["cluster"] = sched.stats()
    if obs is not None:
        # the SPD plan's shape as gauges, beside the comm-time counters
        plan = llm.plan
        qm = plan.qmodes or ("exact",) * len(plan.drop_mask)
        obs.gauge("spd_dropped_syncs", plan.n_dropped)
        obs.gauge("spd_quant_syncs",
                  sum(1 for d, m in zip(plan.drop_mask, qm)
                      if not d and m != "exact"))
        obs.gauge("spd_drop_ratio", plan.fraction)
        out["obs"] = {"comm": {k: round(v, 2) if isinstance(v, float)
                               else v for k, v in comm_agg.items()},
                      "latency": {"link_bytes_per_s": lat.link_bytes_per_s,
                                  "launch_us": lat.launch_us},
                      "tracks": obs.tracer.tracks()}
    return out, llm


def main(argv=None) -> int:
    args = parse_args(argv)
    lead = True
    try:
        if args.engine != "sim":
            lead = _init_rank(args)
        out, llm = serve(args)
    except (RuntimeError, NotImplementedError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    if not lead:
        return 0
    if llm.obs.enabled:
        if args.metrics_json:
            with open(args.metrics_json, "w") as f:
                json.dump({"metrics": llm.obs.snapshot(),
                           "prometheus": llm.obs.metrics.to_prometheus()},
                          f, indent=1)
            out["obs"]["metrics_json"] = args.metrics_json
        if args.trace:
            llm.obs.tracer.save(args.trace)
            out["obs"]["trace"] = args.trace
    print(json.dumps(out))
    return 0


def _init_rank(args) -> bool:
    """This process's groups for `--engine shard` / `overlap` in a world
    of ranks (made here unless a caller made them: the default group's
    backend when one is up, else nccl on cuda and gloo on the CPU).
    Returns whether this is rank 0.  `overlap` in one process (no
    launcher's environment and no groups) stays on sim."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import dist as D

    g = D.current()
    if g is None and args.engine == "overlap" and not dist.is_initialized() \
            and "WORLD_SIZE" not in os.environ:
        return True
    if g is None:
        backend = (dist.get_backend() if dist.is_initialized()
                   else "gloo" if args.device == "cpu" else "nccl")
        g = D.init_tp(args.tp, args.dp, backend=backend, device=args.device)
    return g.rank == 0


if __name__ == "__main__":
    sys.exit(main())
