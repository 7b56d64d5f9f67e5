"""Result types returned by the `repro_torch.api` facade (port of
repro/api/outputs.py)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["RequestOutput", "StreamEvent"]


@dataclass
class RequestOutput:
    """One finished request, in submission order.

    finish_reason: "stop" (EOS / stop token) or "length" (max_new).
    """

    index: int
    prompt_token_ids: List[int]
    token_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    n_preempted: int = 0

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


@dataclass(frozen=True)
class StreamEvent:
    """One token from `LLM.generate_stream`: `index` is the request's
    submission index; `done` marks its last token, which carries the
    finish_reason."""

    index: int
    token_id: int
    done: bool
    finish_reason: Optional[str] = None
