"""Host-side request/response types for the serving engine.

The port's own copy of ``apex_tpu/serving/request.py`` (the port imports
nothing of the JAX package): :class:`SamplingParams` with ``validate``,
:class:`Request`, :class:`StreamEvent`, :class:`Completion` and the
finish reasons. A request finishes because it emitted its stop token
(``eos``), exhausted its token budget (``length``) or blew its deadline
(``timeout``). ``stop`` sequences, schema constraints, tenants other
than ``"default"`` and LoRA adapters other than 0 belong to later slices
of the port: the scheduler rejects requests that carry them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

FINISH_EOS = "eos"
FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_TIMEOUT = "timeout"
FINISH_ERROR = "error"

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls — ``gpt.generate``'s scalar
    arguments as data. ``temperature == 0`` is greedy argmax (``seed``
    unused); ``top_k``/``top_p`` use the disabled sentinels 0 / 1.0 and
    the warper order of :func:`apex_tpu_torch.serving.sampling.draw`."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def validate(self) -> None:
        if self.temperature > 0.0 and self.seed is None:
            raise ValueError("temperature > 0 needs a seed")
        if (self.top_k > 0 or self.top_p < 1.0) and self.temperature <= 0.0:
            raise ValueError("top_k/top_p filter sampled draws; set "
                             "temperature > 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


@dataclasses.dataclass
class Request:
    """One generation request. ``deadline`` is an absolute scheduler-clock
    time (``time.monotonic`` unless the scheduler was given another
    clock); ``None`` never times out. ``stop``, ``constraint``,
    ``tenant`` and ``adapter`` keep the JAX package's field names; only
    their defaults are served by this slice."""

    request_id: str
    prompt: Sequence[int]
    max_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_token_id: Optional[int] = None
    deadline: Optional[float] = None
    arrival_time: Optional[float] = None  # stamped by Scheduler.submit
    stop: Optional[Sequence[Sequence[int]]] = None
    constraint: Optional[Any] = None
    tenant: str = DEFAULT_TENANT
    adapter: int = 0


@dataclasses.dataclass
class StreamEvent:
    """One element of the response stream: a token (or, for a request
    finishing without one, just the finish flag) for ``request_id``."""

    request_id: str
    token: Optional[int]
    finished: bool
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    #: the model's log-probability of ``token`` (log-softmax of the raw
    #: logits) — None on token-less events
    logprob: Optional[float] = None


@dataclasses.dataclass
class Completion:
    """Terminal state of a request. ``ttft`` is arrival → first token on
    the host; ``latency`` is arrival → completion (scheduler-clock
    seconds; ``ttft`` is None for zero-token completions). ``logprobs``
    aligns 1:1 with ``tokens``."""

    request_id: str
    tokens: List[int]
    finish_reason: str
    ttft: Optional[float] = None
    latency: Optional[float] = None
    logprobs: Optional[List[float]] = None
