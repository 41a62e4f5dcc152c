"""Token sampling — the one temperature/top-k/top-p implementation.

Port of ``apex_tpu/serving/sampling.py``. :func:`draw` is the scalar
form ``gpt.generate`` uses, :func:`draw_slots` the per-slot form the
serving engine uses; a slot's token is the one a solo ``generate`` with
that slot's parameters draws. Filters compose in the warper order —
temperature first, then top-k, then nucleus mass on the renormalised
top-k distribution. :func:`filter_logits` takes Python parameters,
:func:`filter_logits_traced` per-row tensors, and the two agree for
enabled and disabled settings alike.

Randomness: the JAX package draws ``categorical(fold_in(key, t))``. The
port draws by the Gumbel-max trick with noise from a counter-based hash
of ``(key, t, row, vocab index)`` computed with integer tensor ops on
the logits' device. A draw therefore depends only on the request's key
and the position ``t`` — never on batch-mates, the batch size or the
decode chunk — and costs no host round trip. The bits differ from
``jax.random``'s (and may differ between CPU and CUDA in the last ulp
of the log); the contract is the port's own: engine streams equal solo
``generate`` streams on the same device.
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
#: salt of the key words of unseeded requests (see :func:`request_key`)
_UNSEEDED = 0x9E3779B9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 tensors holding values below
    2^32: every product stays below 2^63, so nothing overflows."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def request_key(seed: Optional[int], counter: int) -> tuple:
    """The two 32-bit key words of a request: ``(hi, lo)`` of a seeded
    request's seed (the packed-seed form of ``jax.random.PRNGKey``), or
    for an unseeded one a salted word and the engine's monotonic request
    counter, so concurrent unseeded requests never share a stream."""
    if seed is None:
        return (_UNSEEDED, counter & _M32)
    return ((seed >> 32) & _M32, seed & _M32)


def gumbel_noise(keys: torch.Tensor, t: torch.Tensor, rows: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Standard Gumbel noise ``[B, vocab]`` (fp32) from ``keys [B, 2]``,
    positions ``t [B]`` and row ids ``rows [B]`` (int64, on one
    device)."""
    dev = keys.device
    h = _mix32(keys[:, 0])
    h = _mix32(h ^ (keys[:, 1] & _M32))
    h = _mix32(h ^ (t.to(torch.int64) & _M32))
    h = _mix32(h ^ (rows.to(torch.int64) & _M32))
    idx = torch.arange(vocab, device=dev, dtype=torch.int64)
    bits = _mix32(_mix32(h[:, None] ^ idx[None, :]) + 0x5BD1E995)
    # 24 uniform bits at bin centres: u in (0, 1) strictly
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def apply_mask(logits: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The constrained-decoding vocab mask: False positions of ``mask``
    (bool, broadcastable to ``logits``) drop to the dtype minimum; None
    returns ``logits`` itself. An all-True mask gives the same values."""
    if mask is None:
        return logits
    return torch.where(mask, logits, torch.finfo(logits.dtype).min)


def filter_logits(logits: torch.Tensor, top_k: int, top_p: float,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k / nucleus filtering with Python parameters: positions
    outside the top-k (by value), or outside the smallest set whose
    softmax mass reaches ``top_p``, become the dtype minimum. 0 and
    values outside (0, 1) disable; one sort. ``mask`` (bool ``[...,
    vocab]``) removes its False positions first, so the filters act on
    the allowed distribution (:func:`apply_mask`)."""
    logits = apply_mask(logits, mask)
    vocab = logits.shape[-1]
    kk = top_k if 0 < top_k < vocab else 0
    pp = top_p if 0.0 < top_p < 1.0 else 0.0
    if not kk and not pp:
        return logits
    neg = torch.finfo(logits.dtype).min
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thresh = None
    if kk:
        # masking the sorted tail IS the top-k filter (no second sort)
        tail = torch.arange(vocab, device=logits.device) >= kk
        sorted_desc = sorted_desc.masked_fill(tail, neg)
        thresh = sorted_desc[..., kk - 1:kk]
    if pp:
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        # keep every position whose PRECEDING cumulative mass is below
        # top_p (the first is always kept)
        keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                          cum[..., :-1] < pp], dim=-1)
        pthresh = torch.where(keep, sorted_desc,
                              torch.full_like(sorted_desc, float("inf"))
                              ).amin(dim=-1, keepdim=True)
        thresh = pthresh if thresh is None else torch.maximum(thresh,
                                                              pthresh)
    return logits.masked_fill(logits < thresh, neg)


def filter_logits_traced(logits: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor) -> torch.Tensor:
    """:func:`filter_logits` with per-row tensor parameters ``top_k [B]``
    / ``top_p [B]`` (no host sync). Disabled settings map to sentinels
    that keep every position: top-k off → k = vocab, top-p off → mass
    bound +inf."""
    vocab = logits.shape[-1]
    dev = logits.device
    neg = torch.finfo(logits.dtype).min
    top_k = top_k.to(torch.int64)
    kk = torch.where((top_k > 0) & (top_k < vocab), top_k,
                     torch.full_like(top_k, vocab))
    top_p = top_p.to(torch.float32)
    pp = torch.where((top_p > 0.0) & (top_p < 1.0), top_p,
                     torch.full_like(top_p, float("inf")))
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    sorted_desc = sorted_desc.masked_fill(
        torch.arange(vocab, device=dev)[None] >= kk[:, None], neg)
    kthresh = torch.gather(sorted_desc, -1, (kk - 1)[:, None])
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] < pp[:, None]], dim=-1)
    pthresh = torch.where(keep, sorted_desc,
                          torch.full_like(sorted_desc, float("inf"))
                          ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < torch.maximum(kthresh, pthresh), neg)


def _key_tensor(seed: int, device) -> torch.Tensor:
    return torch.tensor([request_key(seed, 0)], dtype=torch.int64,
                        device=device)


def draw(logits: torch.Tensor, t, *, temperature: float = 0.0,
         top_k: int = 0, top_p: float = 1.0,
         seed: Optional[int] = None) -> torch.Tensor:
    """One token per row of ``logits [b, vocab]`` — ``gpt.generate``'s
    draw: greedy argmax (the first maximum) at ``temperature <= 0``,
    else the Gumbel-max sample of the temperature-scaled, filtered
    logits under the key of ``seed`` at position ``t`` (an int or a
    scalar tensor); row ``i`` uses row id ``i``. Returns int64 ``[b]``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if seed is None:
        raise ValueError("temperature > 0 needs a seed")
    b, vocab = logits.shape
    # divide by the temperature as a tensor of the logits' dtype, the
    # operand draw_slots divides by, so the two forms agree bit for bit
    temp = torch.tensor(temperature, dtype=logits.dtype,
                        device=logits.device)
    scaled = filter_logits(logits / temp, top_k, top_p)
    keys = _key_tensor(seed, logits.device).expand(b, 2)
    tt = torch.as_tensor(t, device=logits.device).to(torch.int64)
    noise = gumbel_noise(keys, tt.expand(b),
                         torch.arange(b, device=logits.device), vocab)
    return torch.argmax(scaled.float() + noise, dim=-1)


def draw_slots(logits: torch.Tensor, keys: torch.Tensor, t: torch.Tensor,
               temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor,
               masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot batched draw: ``logits [B, vocab]``, ``keys [B, 2]``
    int64 and ``[B]`` tensors ``t``/``temperature``/``top_k``/``top_p``,
    all on one device. Slot ``b``'s token equals ``draw(logits[b:b+1],
    t[b], ...)`` with that slot's parameters — every slot draws as row 0
    of a solo run — and greedy slots (``temperature <= 0``) take the
    argmax (their sampled lane divides by a safe 1.0 and is dropped).
    ``masks`` (bool ``[B, vocab]``, on the logits' device) is the
    per-slot constrained-decoding mask: False positions drop to the
    dtype minimum before either branch, so an all-True row draws what no
    mask draws, bit for bit. Returns int64 ``[B]``."""
    logits = apply_mask(logits, masks)
    b, vocab = logits.shape
    temp = temperature.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    safe = torch.where(temp > 0, temp, torch.ones_like(temp))
    scaled = filter_logits_traced(logits / safe[:, None].to(logits.dtype),
                                  top_k, top_p)
    noise = gumbel_noise(keys, t, torch.zeros_like(t, dtype=torch.int64),
                         vocab)
    sampled = torch.argmax(scaled.float() + noise, dim=-1)
    return torch.where(temp > 0, sampled, greedy)
