"""Public sampling contract (port of repro/api/sampling.py).  The
sampling step itself lives in `repro_torch.runtime.sampling`."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.runtime.sampling import (greedy_tokens, make_generators,
                                          sample_core)

__all__ = ["SamplingParams", "greedy_tokens", "make_generators",
           "sample_core"]


@dataclass(frozen=True)
class SamplingParams:
    """How to turn logits into tokens, per request.

    temperature     <= 0 means greedy (the default); > 0 scales logits.
    top_k           keep only the k highest logits (0 = disabled).
    top_p           nucleus mass (1.0 = off).
    seed            per-request seed; with the number of tokens generated
                    so far it determines the sample.
    max_new         decode-token budget (the admission token counts).
    stop_token_ids  any of these ends the request (and is kept).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    max_new: int = 16
    stop_token_ids: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.max_new <= 0:
            raise ValueError(f"max_new must be positive, got {self.max_new}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not -2**31 <= self.seed < 2**31:
            raise ValueError(f"seed must fit in int32, got {self.seed}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0
