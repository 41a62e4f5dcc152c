"""apex_tpu_torch.serving.api — the OpenAI-compatible HTTP front end.

Port of ``apex_tpu/serving/api``: the wire layer over the scheduler,
standard library only at import (``http.server``, ``json``,
``threading``), so ``tests/test_torch_port_api.py`` imports it with torch
and numpy blocked.

- :mod:`~apex_tpu_torch.serving.api.tokenizer` — the byte-level text
  codec (token id == UTF-8 byte; incremental decode for streaming),
- :mod:`~apex_tpu_torch.serving.api.protocol`  — request parsing and
  validation, response and SSE framing for ``/v1/chat/completions`` and
  ``/v1/completions``,
- :mod:`~apex_tpu_torch.serving.api.constrain` — JSON-schema-constrained
  decoding: a byte-level automaton whose allowed set is the draw's vocab
  mask row,
- :mod:`~apex_tpu_torch.serving.api.server`    — the threaded HTTP server
  and the one driver thread that owns the scheduler.
"""

from __future__ import annotations

from apex_tpu_torch.serving.api import (  # noqa: F401
    constrain,
    protocol,
    tokenizer,
)
from apex_tpu_torch.serving.api.constrain import (  # noqa: F401
    JsonSchemaConstraint,
)
from apex_tpu_torch.serving.api.protocol import (  # noqa: F401
    ApiError,
    render_chat_prompt,
)
from apex_tpu_torch.serving.api.server import (  # noqa: F401
    ApiServer,
    start_api_server,
)
from apex_tpu_torch.serving.api.tokenizer import (  # noqa: F401
    ByteTokenizer,
    StreamDecoder,
)

__all__ = [
    "constrain", "protocol", "server", "tokenizer",
    "ApiServer", "start_api_server", "ApiError", "ByteTokenizer",
    "StreamDecoder", "JsonSchemaConstraint", "render_chat_prompt",
]
