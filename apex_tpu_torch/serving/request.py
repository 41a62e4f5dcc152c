"""Host-side request/response types for the serving engine.

The port's own copy of ``apex_tpu/serving/request.py`` (the port imports
nothing of the JAX package): :class:`SamplingParams` with ``validate``,
:class:`Request`, :class:`StreamEvent`, :class:`Completion` and the
finish reasons. A request finishes because it emitted its stop token
(``eos``), exhausted its token budget (``length``), matched a stop
sequence or completed its schema-constrained value (``stop``) or blew its
deadline (``timeout``). :class:`StopMatcher` is the streaming stop-sequence
matcher the scheduler feeds token by token.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from apex_tpu_torch.serving.tenancy import DEFAULT_TENANT

FINISH_EOS = "eos"
#: a host-side finish: a stop sequence matched on the streamed tail (its
#: tokens are trimmed from the stream), or the request's schema
#: constraint reached its final state
FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_TIMEOUT = "timeout"
FINISH_ERROR = "error"

#: every finish reason, in release-path order
FINISH_REASONS = (FINISH_EOS, FINISH_STOP, FINISH_LENGTH, FINISH_TIMEOUT,
                  FINISH_ERROR)


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
    clock); ``None`` never times out.

    ``stop`` is a list of stop TOKEN sequences, matched on the host over
    the streamed tail: when one matches, the request finishes with
    :data:`FINISH_STOP` and the matched tokens are trimmed — tokens that
    could still begin a stop are held back, so a client never sees part
    of a stop sequence (the HTTP front end compiles stop strings to
    these). ``tenant`` is the key of the scheduler's weighted-fair
    queueing, rate limits and accounting
    (:mod:`apex_tpu_torch.serving.tenancy`). ``constraint`` is a
    schema-constrained-decoding automaton the scheduler drives opaquely:
    ``reset()`` at every admission, ``allowed_tokens()`` (the vocab
    whitelist, uploaded as the slot's mask row), ``advance(token)`` for
    each emitted token, and ``done`` (the scheduler then finishes the
    request with :data:`FINISH_STOP`); constrained requests need
    ``decode_chunk == 1``. ``adapter`` is the request's LoRA adapter row
    (0 = the base model; rows >= 1 from ``Scheduler.register_adapter``)."""

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


class StopMatcher:
    """Streaming stop-sequence matcher with trimmed emission.

    Feed each generated ``(token, logprob)`` through :meth:`push`; it
    returns the pairs now safe to stream and whether a stop sequence just
    completed. It holds back exactly the longest tail of the stream that
    is a proper prefix of some stop sequence, so a client never sees
    tokens that turn out to belong to a stop; on a match the stop's tokens
    are dropped, never flushed. Deterministic in the token stream."""

    __slots__ = ("stops", "pending", "matched")

    def __init__(self, stops: Sequence[Sequence[int]]):
        self.stops: List[Tuple[int, ...]] = [
            tuple(int(t) for t in s) for s in stops if len(s)]
        self.pending: List[Tuple[int, float]] = []
        self.matched = False

    def push(self, token: int, logprob: float = 0.0
             ) -> Tuple[List[Tuple[int, float]], bool]:
        """Fold one generated token; returns ``(flushed_pairs,
        matched)``. After a match the matcher is terminal (``matched``
        stays True; the scheduler releases the request)."""
        if not self.stops:
            return [(token, logprob)], False
        self.pending.append((token, logprob))
        toks = tuple(t for t, _ in self.pending)
        for s in self.stops:
            if len(toks) >= len(s) and toks[-len(s):] == s:
                flushed = self.pending[:len(self.pending) - len(s)]
                self.pending = []
                self.matched = True
                return flushed, True
        # hold back the longest suffix that is a proper prefix of some
        # stop — by induction that suffix always lies inside pending
        keep = 0
        for j in range(1, len(toks) + 1):
            suf = toks[-j:]
            if any(len(s) > j and s[:j] == suf for s in self.stops):
                keep = j
        cut = len(self.pending) - keep
        flushed, self.pending = self.pending[:cut], self.pending[cut:]
        return flushed, False

    def flush(self) -> List[Tuple[int, float]]:
        """Release every held pair (a non-stop finish — eos, length,
        deadline — streams the held tail instead of trimming it)."""
        out, self.pending = self.pending, []
        return out
