"""`repro_torch.cluster` — multi-replica (DP-over-TP) cluster serving
(port of repro/cluster/).

N replicas, each one TP group running an SPD-optimized `Scheduler`,
fronted by a `ClusterRouter` with pluggable load-balancing policies and
an `ElasticScaler` that grows/shrinks the fleet under traffic.  The
facade entrypoint is `LLM.load(..., dp_replicas=N, router=...)`; the
replicas share the loaded engine and the weights on the card, each with
its own scheduler, KV pool, prefix cache and draft state.

    from repro_torch.api import LLM, SamplingParams
    llm = LLM.load("smollm-360m", tp=2, dp_replicas=2,
                   router="prefix-affinity", page_size=16, num_pages=64,
                   cache_len=512)
    outs = llm.generate(prompts, SamplingParams(max_new=8))
"""
from repro_torch.cluster.elastic import (ElasticConfig, ElasticScaler,
                                         ScaleEvent)
from repro_torch.cluster.replica import (CREATED, DRAINING, READY, STOPPED,
                                         WARMING, Replica, ReplicaStateError)
from repro_torch.cluster.router import (ClusterRouter,
                                        LeastOutstandingPolicy,
                                        PrefixAffinityPolicy,
                                        RoundRobinPolicy, RoutePolicy,
                                        make_policy, register_policy,
                                        route_policy_names)
from repro_torch.runtime.elastic import ClusterConfigError, choose_mesh_shape

__all__ = [
    "Replica", "ReplicaStateError", "ClusterRouter", "RoutePolicy",
    "RoundRobinPolicy", "LeastOutstandingPolicy", "PrefixAffinityPolicy",
    "register_policy", "make_policy", "route_policy_names",
    "ElasticScaler", "ElasticConfig", "ScaleEvent", "ClusterConfigError",
    "choose_mesh_shape",
    "CREATED", "WARMING", "READY", "DRAINING", "STOPPED",
]
