"""OpenAI wire types — request parsing and validation, response and
SSE framing, as plain data transforms (no I/O, no engine import).

The port's own copy of ``apex_tpu/serving/api/protocol.py``. The request
surface of ``/v1/chat/completions`` and ``/v1/completions`` that maps
onto the serving stack: ``messages`` / ``prompt`` (a string, or a list of
token ids — the legacy completions form), ``max_tokens``,
``temperature`` / ``top_p`` (and the ``top_k`` extension), ``n``,
``seed``, ``stream``, ``stop`` (strings, and the ``stop_token_ids``
extension: lists of token ids, the engine's own stop surface),
``logprobs``, and ``response_format`` (``json_object``, or
``json_schema`` compiled by :mod:`apex_tpu_torch.serving.api.constrain`).
The ``return_token_ids`` extension echoes each choice's token ids.

The OpenAI ``user`` field is the request's tenant (the server's
``X-Tenant-Id`` header wins over it), the key of the scheduler's
weighted-fair queueing and rate limits; ``model`` is echoed. Other
OpenAI fields pass through; a malformed value raises :class:`ApiError`,
a 400 with an OpenAI-shaped error body.

SSE framing: ``data: <json>\\n\\n`` a chunk, ``data: [DONE]\\n\\n`` at the
end — what the OpenAI client libraries parse. Standard library only at
import.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

#: engine finish reason → OpenAI ``finish_reason``
FINISH_REASON_MAP = {
    "eos": "stop",
    "stop": "stop",
    "length": "length",
    "timeout": "timeout",    # non-standard; honest beats lying "length"
    "error": "error",
}

SSE_DONE = b"data: [DONE]\n\n"


class ApiError(Exception):
    """Wire-mappable failure: ``status`` + an OpenAI-shaped error
    body. ``retry_after_s`` (overload) becomes a ``Retry-After``
    header."""

    def __init__(self, status: int, message: str, *,
                 err_type: str = "invalid_request_error",
                 param: Optional[str] = None, code: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.param = param
        self.code = code
        self.retry_after_s = retry_after_s

    def body(self) -> Dict[str, Any]:
        err: Dict[str, Any] = {"message": str(self),
                               "type": self.err_type}
        if self.param is not None:
            err["param"] = self.param
        if self.code is not None:
            err["code"] = self.code
        if self.retry_after_s is not None:
            err["retry_after_s"] = round(self.retry_after_s, 3)
        return {"error": err}


def _get(body: Dict[str, Any], key: str, typ, default=None,
         required: bool = False):
    if key not in body or body[key] is None:
        if required:
            raise ApiError(400, f"missing required field {key!r}",
                           param=key)
        return default
    v = body[key]
    if typ is float and isinstance(v, int) and not isinstance(v, bool):
        v = float(v)
    if not isinstance(v, typ) or isinstance(v, bool) and typ is not bool:
        raise ApiError(
            400, f"field {key!r} must be {getattr(typ, '__name__', typ)},"
            f" got {type(v).__name__}", param=key)
    return v


@dataclasses.dataclass
class ParsedRequest:
    """One validated API request, normalized across the two routes.
    ``prompt_text`` is None when the prompt arrived as token ids."""

    model: str
    prompt_text: Optional[str]
    prompt_tokens: Optional[List[int]]
    messages: Optional[List[Dict[str, str]]]
    max_tokens: Optional[int]
    temperature: float
    top_p: float
    top_k: int
    n: int
    seed: Optional[int]
    stream: bool
    stop: List[str]
    stop_token_ids: List[List[int]]
    logprobs: bool
    response_format: Optional[Dict[str, Any]]
    return_token_ids: bool
    echo: bool = False
    #: the OpenAI ``user`` field — tenant identity (the X-Tenant-Id
    #: header wins over it at the server layer); None = anonymous
    user: Optional[str] = None


def render_chat_prompt(messages: Sequence[Dict[str, str]]) -> str:
    """The (deliberately minimal, deterministic) chat template:
    ``role: content`` lines joined by newlines, closed with
    ``assistant:`` — the byte-level codec has no special tokens to
    template with, and the parity oracle needs the rendered prompt to
    be a pure function of the messages."""
    lines = [f"{m['role']}: {m['content']}" for m in messages]
    return "\n".join(lines) + "\nassistant:"


def _parse_common(body: Dict[str, Any]) -> Dict[str, Any]:
    temperature = _get(body, "temperature", float, 0.0)
    top_p = _get(body, "top_p", float, 1.0)
    top_k = _get(body, "top_k", int, 0)
    if temperature < 0.0:
        raise ApiError(400, "temperature must be >= 0",
                       param="temperature")
    if not 0.0 < top_p <= 1.0:
        raise ApiError(400, "top_p must be in (0, 1]", param="top_p")
    if top_k < 0:
        raise ApiError(400, "top_k must be >= 0", param="top_k")
    if (top_k > 0 or top_p < 1.0) and temperature == 0.0:
        raise ApiError(
            400, "top_k/top_p filter sampled draws; set temperature > 0",
            param="temperature")
    n = _get(body, "n", int, 1)
    if not 1 <= n <= 8:
        raise ApiError(400, "n must be in [1, 8]", param="n")
    stop = body.get("stop")
    if stop is None:
        stop = []
    elif isinstance(stop, str):
        stop = [stop]
    elif isinstance(stop, list) and all(
            isinstance(s, str) for s in stop):
        stop = list(stop)
    else:
        raise ApiError(400, "stop must be a string or list of strings",
                       param="stop")
    if len(stop) > 4:
        raise ApiError(400, "at most 4 stop sequences", param="stop")
    stop_ids = body.get("stop_token_ids") or []
    if not (isinstance(stop_ids, list) and all(
            isinstance(s, list) and s and all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in s) for s in stop_ids)):
        raise ApiError(
            400, "stop_token_ids must be a list of non-empty token-id "
            "lists", param="stop_token_ids")
    rf = body.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict) or rf.get("type") not in (
                "text", "json_object", "json_schema"):
            raise ApiError(
                400, "response_format.type must be one of text / "
                "json_object / json_schema", param="response_format")
        if rf.get("type") == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema")
            if not isinstance(schema, dict):
                raise ApiError(
                    400, "response_format.json_schema.schema must be an "
                    "object", param="response_format")
        bounds = rf.get("bounds")
        if bounds is not None:
            legal = {"max_string_len", "max_int_digits",
                     "max_frac_digits", "max_items", "max_keys",
                     "max_depth"}
            if not isinstance(bounds, dict) or not all(
                    k in legal and isinstance(v, int) and v >= 0
                    for k, v in bounds.items()):
                raise ApiError(
                    400, f"response_format.bounds keys must be from "
                    f"{sorted(legal)} with non-negative int values",
                    param="response_format")
        if rf.get("type") == "text":
            rf = None
    max_tokens = _get(body, "max_tokens", int)
    if max_tokens is not None and max_tokens < 1:
        raise ApiError(400, "max_tokens must be >= 1", param="max_tokens")
    return dict(
        model=_get(body, "model", str, "apex-tpu-gpt"),
        max_tokens=max_tokens,
        temperature=temperature, top_p=top_p, top_k=top_k, n=n,
        seed=_get(body, "seed", int),
        stream=_get(body, "stream", bool, False),
        stop=stop, stop_token_ids=[list(s) for s in stop_ids],
        logprobs=bool(body.get("logprobs") or 0),
        response_format=rf,
        return_token_ids=_get(body, "return_token_ids", bool, False),
        user=_get(body, "user", str),
    )


def parse_chat_request(body: Dict[str, Any]) -> ParsedRequest:
    if not isinstance(body, dict):
        raise ApiError(400, "request body must be a JSON object")
    messages = _get(body, "messages", list, required=True)
    if not messages or not all(
            isinstance(m, dict) and isinstance(m.get("role"), str)
            and isinstance(m.get("content"), str) for m in messages):
        raise ApiError(
            400, "messages must be a non-empty list of {role, content} "
            "objects with string fields", param="messages")
    common = _parse_common(body)
    return ParsedRequest(prompt_text=None, prompt_tokens=None,
                         messages=list(messages), **common)


def parse_completion_request(body: Dict[str, Any]) -> ParsedRequest:
    if not isinstance(body, dict):
        raise ApiError(400, "request body must be a JSON object")
    prompt = body.get("prompt")
    text: Optional[str] = None
    tokens: Optional[List[int]] = None
    if isinstance(prompt, str):
        text = prompt
    elif isinstance(prompt, list) and prompt and all(
            isinstance(t, int) and not isinstance(t, bool)
            for t in prompt):
        tokens = list(prompt)  # legacy token-id prompt
    else:
        raise ApiError(
            400, "prompt must be a string or a non-empty list of token "
            "ids", param="prompt")
    common = _parse_common(body)
    common["echo"] = _get(body, "echo", bool, False)
    return ParsedRequest(prompt_text=text, prompt_tokens=tokens,
                         messages=None, **common)


# -- response building --------------------------------------------------------


def _chat_logprobs(text_tokens: Sequence[Tuple[str, int, float]]
                   ) -> Dict[str, Any]:
    """Chat-format logprobs: one entry per token with its decoded text
    (may be "" inside a multi-byte sequence), byte, and logprob."""
    return {"content": [
        {"token": txt, "logprob": round(lp, 6),
         "bytes": [tok] if 0 <= tok < 256 else [],
         "top_logprobs": []}
        for txt, tok, lp in text_tokens]}


def _completion_logprobs(text_tokens: Sequence[Tuple[str, int, float]]
                         ) -> Dict[str, Any]:
    """Legacy completions-format logprobs."""
    return {
        "tokens": [txt for txt, _, _ in text_tokens],
        "token_logprobs": [round(lp, 6) for _, _, lp in text_tokens],
        "top_logprobs": None,
        "text_offset": [],
    }


def build_chat_response(*, rid: str, created: int, model: str,
                        choices: List[Dict[str, Any]],
                        usage: Dict[str, int]) -> Dict[str, Any]:
    return {"id": rid, "object": "chat.completion", "created": created,
            "model": model, "choices": choices, "usage": usage}


def build_completion_response(*, rid: str, created: int, model: str,
                              choices: List[Dict[str, Any]],
                              usage: Dict[str, int]) -> Dict[str, Any]:
    return {"id": rid, "object": "text_completion", "created": created,
            "model": model, "choices": choices, "usage": usage}


def chat_choice(index: int, text: str, finish_reason: Optional[str],
                *, logprobs: Optional[Dict[str, Any]] = None,
                token_ids: Optional[List[int]] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "index": index,
        "message": {"role": "assistant", "content": text},
        "finish_reason": finish_reason,
        "logprobs": logprobs,
    }
    if token_ids is not None:
        out["token_ids"] = token_ids
    return out


def completion_choice(index: int, text: str,
                      finish_reason: Optional[str], *,
                      logprobs: Optional[Dict[str, Any]] = None,
                      token_ids: Optional[List[int]] = None
                      ) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "index": index, "text": text,
        "finish_reason": finish_reason, "logprobs": logprobs,
    }
    if token_ids is not None:
        out["token_ids"] = token_ids
    return out


def chat_chunk(*, rid: str, created: int, model: str, index: int,
               delta: Dict[str, Any],
               finish_reason: Optional[str] = None,
               logprob: Optional[Tuple[str, int, float]] = None,
               token_ids: Optional[List[int]] = None) -> Dict[str, Any]:
    choice: Dict[str, Any] = {"index": index, "delta": delta,
                              "finish_reason": finish_reason}
    if logprob is not None:
        choice["logprobs"] = _chat_logprobs([logprob])
    if token_ids is not None:
        choice["token_ids"] = token_ids
    return {"id": rid, "object": "chat.completion.chunk",
            "created": created, "model": model, "choices": [choice]}


def completion_chunk(*, rid: str, created: int, model: str, index: int,
                     text: str, finish_reason: Optional[str] = None,
                     logprob: Optional[Tuple[str, int, float]] = None,
                     token_ids: Optional[List[int]] = None
                     ) -> Dict[str, Any]:
    choice: Dict[str, Any] = {"index": index, "text": text,
                              "finish_reason": finish_reason}
    if logprob is not None:
        choice["logprobs"] = _completion_logprobs([logprob])
    if token_ids is not None:
        choice["token_ids"] = token_ids
    return {"id": rid, "object": "text_completion", "created": created,
            "model": model, "choices": [choice]}


def sse(obj: Union[Dict[str, Any], str]) -> bytes:
    """One SSE frame: ``data: <json>\\n\\n``."""
    payload = obj if isinstance(obj, str) else json.dumps(
        obj, separators=(",", ":"))
    return f"data: {payload}\n\n".encode("utf-8")


def usage_dict(prompt_tokens: int, completion_tokens: int
               ) -> Dict[str, int]:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}
