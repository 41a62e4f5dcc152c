"""Schema-constrained decoding — a byte-level JSON pushdown automaton.

The port's own copy of ``apex_tpu/serving/api/constrain.py``. The
engine's draw takes a per-slot vocab mask
(:func:`apex_tpu_torch.serving.sampling.draw_slots`); this module is the
host half: a small automaton over the byte-level vocab
(:class:`~apex_tpu_torch.serving.api.tokenizer.ByteTokenizer`, token id
== byte) whose state gives the set of allowed next bytes. The scheduler
drives it through the :class:`apex_tpu_torch.serving.request.Request`
``constraint`` protocol — ``reset()`` at every admission,
``allowed_tokens()`` uploaded as the slot's mask row, ``advance(token)``
for each emitted token, ``done`` finishing the request (reason
``"stop"``) when the value closes — so the emitted stream is always a
parseable JSON value of the schema's shape, whatever the logits wanted.

Supported schema subset (compiled structurally, no ``$ref``):
``object`` (every declared property emitted, in declaration order, no
whitespace), ``array`` (``items`` with ``minItems``/``maxItems``),
``string`` (printable-ASCII body, ``maxLength``), ``integer`` /
``number``, ``boolean``, ``null``, and ``enum`` of JSON literals.
``schema=None`` is OpenAI's ``json_object`` mode: any JSON object,
bounded by the ``max_*`` knobs. The string, number, array and depth
bounds force closure, so a constrained value ends within a bounded
token count.

Standard library only at import; masks stay lists of token ids — the
engine turns them into device tensors.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

#: printable-ASCII string-body bytes: 0x20..0x7E minus '"' and '\'
#: (escape sequences are excluded from generation — every emitted
#: string byte is literal, which keeps the automaton regular and the
#: output trivially valid JSON)
_STR_BYTES = frozenset(b for b in range(0x20, 0x7F)
                       if b not in (0x22, 0x5C))
_DIGITS = frozenset(range(0x30, 0x3A))
_QUOTE, _COMMA, _COLON, _MINUS, _DOT = 0x22, 0x2C, 0x3A, 0x2D, 0x2E
_LBRACE, _RBRACE, _LBRACKET, _RBRACKET = 0x7B, 0x7D, 0x5B, 0x5D

#: frame.step outcomes beyond consumed(True)/cannot(False): the frame
#: restructured the stack and the byte must be retried on the new top
_RETRY = "retry"


class _Machine:
    """Frame stack. ``allowed()`` unions byte sets walking down from
    the top through frames that could end here (a complete number can
    be followed by its parent's ``,`` / ``}``); ``feed()`` pops
    completed frames until one consumes the byte."""

    __slots__ = ("stack",)

    def __init__(self, frames: List[Any]):
        self.stack = list(reversed(frames))

    def allowed(self) -> Set[int]:
        out: Set[int] = set()
        for fr in reversed(self.stack):
            out |= fr.inner_allowed(self)
            if not fr.can_end():
                break
        return out

    def feed(self, b: int) -> None:
        for _ in range(64):  # bounded restructure/pop chain
            if not self.stack:
                raise ValueError(
                    f"byte {b!r} after the constrained value closed")
            fr = self.stack[-1]
            r = fr.step(self, b)
            if r is True:
                return
            if r == _RETRY:
                continue
            if fr.can_end():
                self.stack.pop()
                continue
            raise ValueError(
                f"byte {bytes([b])!r} not allowed by the constraint "
                f"(allowed: {sorted(self.allowed())})")
        raise RuntimeError("constraint restructure chain did not land")

    def can_end_now(self) -> bool:
        """Every frame on the stack could end at this point — the
        value parsed so far is complete (a terminator/end signal would
        be legal)."""
        return all(f.can_end() for f in self.stack)

    @property
    def done(self) -> bool:
        return not self.stack or (
            not self.allowed() and self.can_end_now())


class _Lit:
    """Forced literal bytes (structure: braces, fixed keys, null)."""

    __slots__ = ("data", "i")

    def __init__(self, data: bytes):
        self.data, self.i = data, 0

    def inner_allowed(self, m) -> Set[int]:
        return {self.data[self.i]} if self.i < len(self.data) else set()

    def can_end(self) -> bool:
        return self.i >= len(self.data)

    def step(self, m, b):
        if self.i < len(self.data) and b == self.data[self.i]:
            self.i += 1
            if self.i == len(self.data):
                m.stack.pop()
            return True
        return False


class _Trie:
    """One of several literal byte strings (enums, true/false). NOT
    assumed prefix-free: after consuming a prefix that completes one
    option but could extend into another (numeric enums — ``1`` vs
    ``12``), the frame ``can_end`` (the parent's terminator, or the
    end token, closes the shorter option) while still offering the
    longer one's next byte."""

    __slots__ = ("cands", "i")

    def __init__(self, options: Sequence[bytes]):
        self.cands = [bytes(o) for o in options]
        self.i = 0

    def inner_allowed(self, m) -> Set[int]:
        return {o[self.i] for o in self.cands if len(o) > self.i}

    def can_end(self) -> bool:
        return any(len(o) == self.i for o in self.cands)

    def step(self, m, b):
        nxt = [o for o in self.cands if len(o) > self.i and o[self.i] == b]
        if not nxt:
            return False
        self.cands = nxt
        self.i += 1
        if all(len(o) == self.i for o in self.cands):
            m.stack.pop()  # no option can extend — the value is closed
        return True


class _Str:
    """String BODY + closing quote (the opening quote is a _Lit)."""

    __slots__ = ("n", "max_len")

    def __init__(self, max_len: int):
        self.n, self.max_len = 0, max_len

    def inner_allowed(self, m) -> Set[int]:
        out = {_QUOTE}
        if self.n < self.max_len:
            out |= _STR_BYTES
        return out

    def can_end(self) -> bool:
        return False

    def step(self, m, b):
        if b == _QUOTE:
            m.stack.pop()
            return True
        if self.n < self.max_len and b in _STR_BYTES:
            self.n += 1
            return True
        return False


class _Num:
    """JSON number: optional '-', int part (no leading zeros), and for
    non-integers an optional '.digits' fraction — digit counts bounded
    so the value cannot ramble to the token budget. Complete numbers
    ``can_end``: the terminator byte belongs to the parent frame."""

    __slots__ = ("integer", "max_int", "max_frac", "neg", "int_digits",
                 "int_zero", "frac", "frac_digits")

    def __init__(self, integer: bool, max_int: int, max_frac: int):
        self.integer, self.max_int, self.max_frac = \
            integer, max_int, max_frac
        self.neg = self.frac = self.int_zero = False
        self.int_digits = self.frac_digits = 0

    def inner_allowed(self, m) -> Set[int]:
        if self.frac:
            return set(_DIGITS) if self.frac_digits < self.max_frac \
                else set()
        if self.int_digits == 0:
            return set(_DIGITS) | ({_MINUS} if not self.neg else set())
        out: Set[int] = set()
        if not self.int_zero and self.int_digits < self.max_int:
            out |= _DIGITS
        if not self.integer:
            out.add(_DOT)
        return out

    def can_end(self) -> bool:
        if self.int_digits < 1:
            return False
        return not self.frac or self.frac_digits >= 1

    def step(self, m, b):
        if self.frac:
            if b in _DIGITS and self.frac_digits < self.max_frac:
                self.frac_digits += 1
                return True
            return False
        if self.int_digits == 0:
            if b == _MINUS and not self.neg:
                self.neg = True
                return True
            if b in _DIGITS:
                self.int_zero = b == 0x30
                self.int_digits = 1
                return True
            return False
        if b in _DIGITS and not self.int_zero \
                and self.int_digits < self.max_int:
            self.int_digits += 1
            return True
        if b == _DOT and not self.integer:
            self.frac = True
            return True
        return False


class _Arr:
    """Array body after '[': items from a factory, ',' between, ']'
    once ``min_items`` are in (allowed at start when ``min_items`` is
    0)."""

    __slots__ = ("item_make", "min_items", "max_items", "started",
                 "expect_item", "at_start")

    def __init__(self, item_make, min_items: int, max_items: int):
        self.item_make = item_make
        self.min_items, self.max_items = min_items, max_items
        self.started = 0
        self.expect_item = True
        self.at_start = True

    def inner_allowed(self, m) -> Set[int]:
        if self.expect_item:
            out = (set(_first(self.item_make()))
                   if self.started < self.max_items else set())
            if self.at_start and self.min_items == 0:
                out.add(_RBRACKET)
            return out
        out: Set[int] = set()
        if self.started < self.max_items:
            out.add(_COMMA)
        if self.started >= self.min_items:
            out.add(_RBRACKET)
        return out

    def can_end(self) -> bool:
        return False

    def step(self, m, b):
        if self.expect_item:
            if self.at_start and self.min_items == 0 and b == _RBRACKET:
                m.stack.pop()
                return True
            if self.started >= self.max_items:  # maxItems 0: only ']'
                return False
            self.expect_item = False
            self.at_start = False
            self.started += 1
            m.stack.extend(reversed(self.item_make()))
            return _RETRY
        if b == _COMMA and self.started < self.max_items:
            self.expect_item = True
            return True
        if b == _RBRACKET and self.started >= self.min_items:
            m.stack.pop()
            return True
        return False


class _Obj:
    """Generic object body after '{' (``json_object`` mode): free
    string keys, generic values, key count bounded."""

    __slots__ = ("opts", "depth", "state", "count")

    def __init__(self, opts: "_Options", depth: int):
        self.opts, self.depth = opts, depth
        self.state = "start"
        self.count = 0

    def inner_allowed(self, m) -> Set[int]:
        return {
            "start": {_QUOTE, _RBRACE},
            "key": {_QUOTE},
            "colon": {_COLON},
            "value": set(_first(_value_frames(self.opts, self.depth))),
            "after": ({_COMMA} if self.count < self.opts.max_keys
                      else set()) | {_RBRACE},
        }[self.state]

    def can_end(self) -> bool:
        return False

    def step(self, m, b):
        if self.state in ("start", "key"):
            if self.state == "start" and b == _RBRACE:
                m.stack.pop()
                return True
            if b == _QUOTE:
                self.count += 1
                self.state = "colon"
                m.stack.append(_Str(self.opts.max_string_len))
                return True
            return False
        if self.state == "colon":
            if b == _COLON:
                self.state = "value"
                return True
            return False
        if self.state == "value":
            self.state = "after"
            m.stack.extend(reversed(_value_frames(self.opts, self.depth)))
            return _RETRY
        # after a value: another key, or close
        if b == _COMMA and self.count < self.opts.max_keys:
            self.state = "key"
            return True
        if b == _RBRACE:
            m.stack.pop()
            return True
        return False


class _Val:
    """Generic JSON value — branch on the first byte, then replace
    self with the chosen production."""

    __slots__ = ("opts", "depth")

    def __init__(self, opts: "_Options", depth: int):
        self.opts, self.depth = opts, depth

    def inner_allowed(self, m) -> Set[int]:
        out = {_QUOTE, _MINUS, 0x74, 0x66, 0x6E} | _DIGITS  # " - t f n
        if self.depth > 0:
            out |= {_LBRACE, _LBRACKET}
        return out

    def can_end(self) -> bool:
        return False

    def step(self, m, b):
        o = self.opts
        repl: Optional[List[Any]] = None
        if b == _QUOTE:
            repl = [_Lit(b'"'), _Str(o.max_string_len)]
        elif b == _MINUS or b in _DIGITS:
            repl = [_Num(False, o.max_int_digits, o.max_frac_digits)]
        elif b in (0x74, 0x66):  # t / f
            repl = [_Trie([b"true", b"false"])]
        elif b == 0x6E:  # n
            repl = [_Lit(b"null")]
        elif b == _LBRACE and self.depth > 0:
            repl = [_Lit(b"{"), _Obj(o, self.depth - 1)]
        elif b == _LBRACKET and self.depth > 0:
            repl = [_Lit(b"["),
                    _Arr(lambda: _value_frames(o, self.depth - 1),
                         0, o.max_items)]
        if repl is None:
            return False
        m.stack.pop()
        m.stack.extend(reversed(repl))
        return _RETRY


def _value_frames(opts: "_Options", depth: int) -> List[Any]:
    return [_Val(opts, depth)]


def _first(frames: List[Any]) -> Set[int]:
    """FIRST set of a production: the allowed bytes of a scratch
    machine holding fresh frames."""
    return _Machine(list(frames)).allowed()


class _Options:
    """Generation bounds — they force closure (a finite token count)
    whatever the logits prefer."""

    __slots__ = ("max_string_len", "max_int_digits", "max_frac_digits",
                 "max_items", "max_keys", "max_depth")

    def __init__(self, max_string_len=48, max_int_digits=9,
                 max_frac_digits=6, max_items=4, max_keys=4,
                 max_depth=3):
        self.max_string_len = max_string_len
        self.max_int_digits = max_int_digits
        self.max_frac_digits = max_frac_digits
        self.max_items = max_items
        self.max_keys = max_keys
        self.max_depth = max_depth


def _compile(schema: Optional[Dict[str, Any]],
             opts: _Options) -> Callable[[], List[Any]]:
    """Schema → factory of fresh frame lists (factories because arrays
    instantiate their item production per element, and ``reset()``
    rebuilds the whole machine)."""
    if schema is None:
        # json_object mode: any JSON object
        return lambda: [_Lit(b"{"), _Obj(opts, opts.max_depth)]
    if "enum" in schema:
        lits = [json.dumps(v, separators=(",", ":")).encode("utf-8")
                for v in schema["enum"]]
        if not lits:
            raise ValueError("enum schema needs at least one value")
        return lambda: [_Trie(lits)]
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties") or {}
        if not props:
            return lambda: [_Lit(b"{}")]
        parts: List[Any] = []  # bytes literals interleaved with factories
        for i, (key, sub) in enumerate(props.items()):
            prefix = ("{" if i == 0 else ",") + json.dumps(key) + ":"
            parts.append(prefix.encode("utf-8"))
            parts.append(_compile(sub, opts))
        parts.append(b"}")

        def make() -> List[Any]:
            frames: List[Any] = []
            for p in parts:
                if isinstance(p, bytes):
                    frames.append(_Lit(p))
                else:
                    frames.extend(p())
            return frames

        return make
    if t == "array":
        item = _compile(schema.get("items"), opts)
        mn = max(0, int(schema.get("minItems", 0)))  # JSON Schema default
        mx = int(schema.get("maxItems", max(mn, opts.max_items)))
        if mx < mn:
            raise ValueError(f"maxItems {mx} < minItems {mn}")
        return lambda: [_Lit(b"["), _Arr(item, mn, mx)]
    if t == "string":
        mx = min(int(schema.get("maxLength", opts.max_string_len)),
                 opts.max_string_len)
        return lambda: [_Lit(b'"'), _Str(mx)]
    if t == "integer":
        return lambda: [_Num(True, opts.max_int_digits,
                             opts.max_frac_digits)]
    if t == "number":
        return lambda: [_Num(False, opts.max_int_digits,
                             opts.max_frac_digits)]
    if t == "boolean":
        return lambda: [_Trie([b"true", b"false"])]
    if t == "null":
        return lambda: [_Lit(b"null")]
    # unknown/omitted type: any bounded JSON value
    return lambda: [_Val(opts, opts.max_depth)]


def _value_bound(opts: _Options, depth: int) -> int:
    """Worst-case byte count of one generic JSON value at ``depth``."""
    scalar = max(2 + opts.max_string_len,                 # "…"
                 1 + opts.max_int_digits                  # -ddd…
                 + 1 + opts.max_frac_digits,              # .ddd…
                 5)                                       # false
    if depth <= 0:
        return scalar
    inner = _value_bound(opts, depth - 1)
    obj = 2 + opts.max_keys * (2 + opts.max_string_len + 1 + inner + 1)
    arr = 2 + opts.max_items * (inner + 1)
    return max(scalar, obj, arr)


def _schema_bound(schema: Optional[Dict[str, Any]],
                  opts: _Options) -> int:
    """Worst-case byte count of a value matching ``schema`` under the
    closure bounds — the token budget that guarantees the constrained
    value completes (every grammar branch is bounded by construction)."""
    if schema is None:
        # json_object mode: an object of generic values
        return 2 + opts.max_keys * (
            2 + opts.max_string_len + 1
            + _value_bound(opts, opts.max_depth) + 1)
    if "enum" in schema:
        return max((len(json.dumps(v, separators=(",", ":"))
                        .encode("utf-8")) for v in schema["enum"]),
                   default=0)
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties") or {}
        if not props:
            return 2
        total = 1  # final '}'
        for i, (key, sub) in enumerate(props.items()):
            prefix = ("{" if i == 0 else ",") + json.dumps(key) + ":"
            total += len(prefix.encode("utf-8")) + _schema_bound(sub,
                                                                 opts)
        return total
    if t == "array":
        mn = max(0, int(schema.get("minItems", 0)))
        mx = int(schema.get("maxItems", max(mn, opts.max_items)))
        return 2 + mx * (_schema_bound(schema.get("items"), opts) + 1)
    if t == "string":
        return 2 + min(int(schema.get("maxLength", opts.max_string_len)),
                       opts.max_string_len)
    if t == "integer":
        return 1 + opts.max_int_digits
    if t == "number":
        return 1 + opts.max_int_digits + 1 + opts.max_frac_digits
    if t == "boolean":
        return 5
    if t == "null":
        return 4
    return _value_bound(opts, opts.max_depth)


class JsonSchemaConstraint:
    """The ``Request.constraint`` implementation for JSON output over a
    byte-level vocab (token id == byte id).

    >>> c = JsonSchemaConstraint({"type": "object", "properties":
    ...     {"name": {"type": "string"}, "age": {"type": "integer"}}})
    >>> c.allowed_tokens()   # [ord('{')] — the object must open
    >>> c.advance(ord('{')); c.done
    False

    ``schema=None`` is ``json_object`` mode (any JSON object). The
    scheduler calls ``reset()`` at every (re-)admission — fault replay
    re-derives the byte stream, and the automaton follows it
    deterministically.

    ``end_token_id`` (a NON-byte id, >= 256 — the tokenizer's eos) is
    offered in the allowed set whenever the value parsed so far is
    already complete, so the model can CHOOSE to stop a value whose
    grammar could also continue — without it a top-level bare
    ``integer``/``number`` schema has no terminator byte and is forced
    to its digit bounds (self-closing values — objects, arrays,
    strings, enums — terminate structurally either way)."""

    def __init__(self, schema: Optional[Dict[str, Any]] = None, *,
                 max_string_len: int = 48, max_int_digits: int = 9,
                 max_frac_digits: int = 6, max_items: int = 4,
                 max_keys: int = 4, max_depth: int = 3,
                 end_token_id: Optional[int] = None):
        if end_token_id is not None and end_token_id < 256:
            raise ValueError(
                f"end_token_id must be a non-byte id (>= 256), got "
                f"{end_token_id} — a byte-range end token would alias "
                f"a JSON byte the grammar may need")
        self.schema = schema
        self.end_token_id = end_token_id
        self._opts = _Options(
            max_string_len=max_string_len, max_int_digits=max_int_digits,
            max_frac_digits=max_frac_digits, max_items=max_items,
            max_keys=max_keys, max_depth=max_depth)
        self._make = _compile(schema, self._opts)
        self._machine = _Machine(self._make())

    def reset(self) -> None:
        self._machine = _Machine(self._make())

    def token_bound(self) -> int:
        """Worst-case number of tokens (bytes) the constrained value
        can need before it closes — the ``max_tokens`` floor that
        makes the always-valid guarantee hold (the closure bounds make
        every branch finite). One extra token covers an end-token
        finish."""
        return _schema_bound(self.schema, self._opts) + (
            1 if self.end_token_id is not None else 0)

    def allowed_tokens(self) -> List[int]:
        allowed = sorted(self._machine.allowed())
        if self.end_token_id is not None and self._machine.stack \
                and self._machine.can_end_now():
            allowed.append(self.end_token_id)
        if not allowed and not self.done:
            raise RuntimeError(
                "constraint automaton stuck: no allowed bytes and not "
                "done (schema compile bug)")
        return allowed

    def advance(self, token: int) -> None:
        token = int(token)
        if self.end_token_id is not None and token == self.end_token_id:
            if not self._machine.can_end_now():
                raise ValueError(
                    "end token emitted while the constrained value is "
                    "incomplete")
            self._machine.stack.clear()
            return
        self._machine.feed(token)

    @property
    def done(self) -> bool:
        return self._machine.done
