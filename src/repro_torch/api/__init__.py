"""Public facade of the port: `LLM`, `SamplingParams` and the result
types."""
from repro_torch.api.llm import LLM
from repro_torch.api.outputs import RequestOutput
from repro_torch.api.sampling import SamplingParams
from repro_torch.api.scheduler import (CacheConfig, InvalidRequestError,
                                       Request, Scheduler)

__all__ = ["LLM", "SamplingParams", "RequestOutput",
           "CacheConfig", "InvalidRequestError", "Request", "Scheduler"]
