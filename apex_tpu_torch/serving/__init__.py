"""apex_tpu_torch.serving — the continuous-batching engine of the port.

- :mod:`~apex_tpu_torch.serving.request`   — Request / SamplingParams /
  StreamEvent / Completion,
- :mod:`~apex_tpu_torch.serving.sampling`  — the one temperature/top-k/
  top-p sampler shared by ``gpt.generate`` and the engine,
- :mod:`~apex_tpu_torch.serving.pages`     — the page allocator of the
  paged KV cache (host only),
- :mod:`~apex_tpu_torch.serving.engine`    — the device loop: slot state,
  admission (bulk prefill), plain and speculative decode chunks, retire,
  the paged pool's block tables,
- :mod:`~apex_tpu_torch.serving.scheduler` — the host loop: FIFO queue,
  page backpressure, deadlines, the speculation payoff gate, response
  stream, serving metrics.

``engine``/``scheduler`` import :mod:`apex_tpu_torch.models.gpt`, which
imports :mod:`.sampling`; they load lazily (PEP 562) so either entry
point — model first or serving first — resolves without a cycle.
"""

from __future__ import annotations

from apex_tpu_torch.serving import pages, request, sampling  # noqa: F401
from apex_tpu_torch.serving.pages import (  # noqa: F401
    PageAllocator,
    PagesExhausted,
)
from apex_tpu_torch.serving.request import (  # noqa: F401
    Completion,
    Request,
    SamplingParams,
    StreamEvent,
)

_LAZY = {
    "Engine": "engine", "EngineConfig": "engine", "Admission": "engine",
    "AdmitResult": "engine", "StepHandle": "engine",
    "Scheduler": "scheduler", "SpecGateConfig": "scheduler",
}

__all__ = ["Admission", "AdmitResult", "Completion", "Engine",
           "EngineConfig", "PageAllocator", "PagesExhausted", "Request",
           "SamplingParams", "Scheduler", "SpecGateConfig", "StepHandle",
           "StreamEvent", "pages", "request", "sampling"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(
            f"apex_tpu_torch.serving.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
