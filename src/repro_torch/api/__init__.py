"""Public facade of the port: `LLM`, `SamplingParams`, the result types,
the scheduler and its cache managers (port of repro/api/__init__.py)."""
from repro_torch.api.llm import LLM
from repro_torch.api.outputs import RequestOutput, StreamEvent
from repro_torch.api.sampling import SamplingParams
from repro_torch.api.scheduler import (CacheConfig, DenseKVCacheManager,
                                       InvalidRequestError,
                                       PagedKVCacheManager, Request,
                                       Scheduler)
from repro_torch.config.base import CommPolicy, SPDPlanConfig
from repro_torch.runtime.elastic import ClusterConfigError
from repro_torch.spec import SpecConfig

__all__ = ["LLM", "SamplingParams", "RequestOutput", "StreamEvent",
           "CacheConfig", "Scheduler", "Request", "CommPolicy",
           "SPDPlanConfig", "SpecConfig", "DenseKVCacheManager",
           "PagedKVCacheManager", "InvalidRequestError",
           "ClusterConfigError"]
