"""apex_tpu_torch.serving — the continuous-batching engine of the port.

- :mod:`~apex_tpu_torch.serving.request`   — Request / SamplingParams /
  StreamEvent / Completion and the streaming StopMatcher,
- :mod:`~apex_tpu_torch.serving.sampling`  — the one temperature/top-k/
  top-p sampler shared by ``gpt.generate`` and the engine,
- :mod:`~apex_tpu_torch.serving.pages`     — the page allocator of the
  paged KV cache (host only),
- :mod:`~apex_tpu_torch.serving.hostswap`  — the host-RAM page tier's
  store of parked conversations and the LRU adapter paging shares
  (host only),
- :mod:`~apex_tpu_torch.serving.engine`    — the device loop: slot state,
  admission (bulk prefill), plain and speculative decode chunks, retire,
  the paged pool's block tables,
- :mod:`~apex_tpu_torch.serving.scheduler` — the host loop: the queue
  (tenant-fair pops), page backpressure, deadlines, the speculation
  payoff gate, stop sequences and schema constraints, response stream,
  serving metrics,
- :mod:`~apex_tpu_torch.serving.tenancy`   — weighted-fair queueing and
  token-budget rate limits (host only),
- :mod:`~apex_tpu_torch.serving.tuner`     — the self-tuning scheduler's
  knob controller over the engine's ladders (standard library only),
- :mod:`~apex_tpu_torch.serving.api`       — the OpenAI-compatible HTTP
  front end (standard library only at import).

``engine``/``scheduler`` import :mod:`apex_tpu_torch.models.gpt`, which
imports :mod:`.sampling`; they load lazily (PEP 562) so either entry
point — model first or serving first — resolves without a cycle.
"""

from __future__ import annotations

from apex_tpu_torch.serving import (  # noqa: F401
    hostswap,
    pages,
    request,
    sampling,
    tenancy,
)
from apex_tpu_torch.serving.pages import (  # noqa: F401
    PageAllocator,
    PagesExhausted,
)
from apex_tpu_torch.serving.request import (  # noqa: F401
    Completion,
    Request,
    SamplingParams,
    StopMatcher,
    StreamEvent,
)
from apex_tpu_torch.serving.tenancy import (  # noqa: F401
    TenancyConfig,
    TenantThrottled,
)

_LAZY = {
    "Engine": "engine", "EngineConfig": "engine", "Admission": "engine",
    "AdmitResult": "engine", "StepHandle": "engine",
    "Scheduler": "scheduler", "SpecGateConfig": "scheduler",
    "QueueFull": "scheduler",
}

__all__ = ["Admission", "AdmitResult", "Completion", "Engine",
           "EngineConfig", "PageAllocator", "PagesExhausted", "QueueFull",
           "Request", "SamplingParams", "Scheduler", "SpecGateConfig",
           "StepHandle", "StopMatcher", "StreamEvent", "TenancyConfig",
           "TenantThrottled", "hostswap", "pages", "request", "sampling",
           "tenancy"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(
            f"apex_tpu_torch.serving.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
