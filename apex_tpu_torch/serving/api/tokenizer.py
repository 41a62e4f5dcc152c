"""Minimal byte-level text codec — the HTTP front end's tokenizer.

The port's own copy of ``apex_tpu/serving/api/tokenizer.py`` (the port
imports nothing of the JAX package). The serving stack takes token ids;
the OpenAI surface speaks text, and the smallest faithful mapping is
byte-level: token id ``b`` IS byte ``b`` for ids < 256 (UTF-8), ids >=
256 are specials (eos) and the model vocab's surplus. Encoding is per
byte, so ``encode(a + b) == encode(a) + encode(b)``: a stop STRING is
exactly a stop-token sequence, and the schema automaton
(:mod:`apex_tpu_torch.serving.api.constrain`) works on JSON bytes
directly.

Standard library only at import (``tests/test_torch_port_api.py``
imports it with torch and numpy blocked).
"""

from __future__ import annotations

import codecs
from typing import List, Optional, Sequence


class ByteTokenizer:
    """UTF-8 byte codec over a model vocab: ``encode`` maps text to its
    UTF-8 bytes (each byte one token id), ``decode`` maps ids < 256
    back (invalid UTF-8 → U+FFFD replacement, ids >= 256 skipped —
    they have no byte meaning). Needs ``vocab_size >= 256``."""

    def __init__(self, vocab_size: int,
                 eos_token_id: Optional[int] = None):
        if vocab_size < 256:
            raise ValueError(
                f"byte-level codec needs vocab_size >= 256 (one id per "
                f"byte), got {vocab_size}")
        if eos_token_id is not None \
                and not 0 <= eos_token_id < vocab_size:
            raise ValueError(
                f"eos_token_id {eos_token_id} outside vocab "
                f"[0, {vocab_size})")
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens: Sequence[int]) -> str:
        data = bytes(t for t in tokens if 0 <= t < 256)
        return data.decode("utf-8", errors="replace")

    def stream_decoder(self) -> "StreamDecoder":
        return StreamDecoder()


class StreamDecoder:
    """Incremental token → text decoder for SSE streaming: multi-byte
    UTF-8 sequences split across tokens are buffered until complete, so
    every emitted delta is valid text (``push`` may return ``""`` while
    a sequence is pending). ``flush`` drains the tail at end-of-stream
    (an incomplete sequence becomes U+FFFD)."""

    def __init__(self):
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def push(self, token: int) -> str:
        if not 0 <= token < 256:
            return ""  # non-byte id (eos/specials): no text
        return self._dec.decode(bytes([token]))

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)
