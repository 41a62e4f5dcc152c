"""Slot-based continuous-batching decode engine — the device loop.

Port of ``apex_tpu/serving/engine.py``: its core, the paged KV cache and
speculative decoding. A fixed batch of ``B`` decode *slots* shares one
KV cache — ``[L, 2, B, heads, max_seq_len, d]``, or with ``page_size >
0`` a pool of pages ``[L, 2, num_pages, heads, page_size, d]`` under a
``[B, max_pages]`` int32 block table (:mod:`.pages` allocates them);
under a quantized ``kv_cache_dtype`` the same layout as an int8/fp8
data plane beside an fp32 scale plane (:func:`gpt.init_cache`) — and
requests flow through the slots. All per-request state the device
needs — position, remaining budget, done flag, eos id, temperature /
top-k / top-p, the sampling key and, with ``spec_k > 0``, the drafter's
token-history ring — lives in ``[B]`` tensors on the device:

- :meth:`Engine.admit_many` — a group of queued requests is prefilled in
  ONE forward (``gpt.prefill_many`` over a ``[k, bucket]`` batch of
  right-padded prompts, ``bucket`` the smallest prompt bucket that fits
  the group), each row draws its first token at ``p_len - 1``, the k
  cache blocks are inserted into their slots and the k state rows are
  scattered;
- :meth:`Engine.step_async` — one ``gpt.decode_steps`` chunk of
  ``decode_chunk`` steps over every slot, or with ``spec=True`` one
  ``gpt.decode_steps_spec`` chunk of ``decode_chunk`` draft-verify waves
  (up to ``spec_k + 1`` tokens a wave), returned as a
  :class:`StepHandle`; :meth:`Engine.step` fetches a plain one;
- :meth:`Engine.retire` — force a slot done (deadline expiry);
  :meth:`Engine.free_slot` — release a paged slot's pages.

A slot's token stream is the one a solo ``gpt.generate`` of the same
request emits. PyTorch runs eagerly, so there is no compile step and no
``warmup()``. The cache and the state are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.models import gpt
from apex_tpu_torch.serving import sampling
from apex_tpu_torch.serving.pages import SINK, PageAllocator, PagesExhausted

_NO_EOS = gpt.NO_EOS


def default_prompt_buckets(max_prompt_len: int) -> Tuple[int, ...]:
    """The padded-prefill length ladder: powers of two from 8 up to (and
    always including) ``max_prompt_len``."""
    out: List[int] = []
    v = 8
    while v < max_prompt_len:
        out.append(v)
        v *= 2
    out.append(max_prompt_len)
    return tuple(out)


#: EngineConfig fields of the JAX engine that belong to later slices of
#: the port, with the value that leaves them off and the slice they
#: belong to
_LATER_FIELDS = {
    "prefix_pool_slots": (0, "the prefix pool"),
    "prefill_chunk": (0, "chunked prefill"),
    "decode_chunks": (None, "the self-tuning scheduler"),
    "spec_ks": (None, "the self-tuning scheduler's draft-width ladder"),
    "adapter_slots": (0, "multi-LoRA serving"),
    "adapter_rank": (8, "multi-LoRA serving"),
    "adapter_alpha": (16.0, "multi-LoRA serving"),
    "host_swap": (False, "the host-swap tier"),
    "host_swap_pages": (0, "the host-swap tier"),
    "resume_policy": ("auto", "the host-swap tier"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine geometry. ``max_prompt_len`` caps prompt length
    (admission pads to the smallest ``prompt_buckets`` entry that fits);
    ``max_seq_len`` is the per-slot KV horizon (prompt + generated
    tokens, ``<= cfg.seq_len``); ``decode_chunk`` is the number of
    decode steps per :meth:`Engine.step`; ``admit_batch_sizes`` is the
    ladder admission groups are cut from (None = (1, 2, 4) capped at
    ``slots``).

    ``spec_k > 0`` turns on speculative decoding: ``step_async(spec=True)``
    runs ``decode_chunk`` waves that each draft ``spec_k`` tokens from a
    ``spec_hist``-token history ring and verify them in one forward;
    emitted streams equal the plain path's. ``page_size > 0`` turns on
    the paged KV cache: a pool of ``num_pages`` pages of ``page_size``
    tokens (0 = auto: ``slots * max_pages + 1``, every slot's worst case
    plus the sink page 0) and one block-table row of ``max_pages =
    ceil(max_seq_len / page_size)`` entries per slot; a request pins
    only ``ceil((prompt + max_tokens) / page_size)`` pages, and an
    admission the pool cannot cover raises
    :class:`~apex_tpu_torch.serving.pages.PagesExhausted`. The JAX
    engine's other fields keep their names and defaults here; setting
    one raises, naming the later slice it belongs to."""

    slots: int = 4
    max_prompt_len: int = 64
    max_seq_len: int = 128
    pad_token_id: int = 0
    decode_chunk: int = 1
    prompt_buckets: Optional[Tuple[int, ...]] = None
    admit_batch_sizes: Optional[Tuple[int, ...]] = None
    spec_k: int = 0
    spec_hist: int = 32
    prefix_pool_slots: int = 0
    page_size: int = 0
    num_pages: int = 0
    prefill_chunk: int = 0
    decode_chunks: Optional[Tuple[int, ...]] = None
    spec_ks: Optional[Tuple[int, ...]] = None
    adapter_slots: int = 0
    adapter_rank: int = 8
    adapter_alpha: float = 16.0
    host_swap: bool = False
    host_swap_pages: int = 0
    resume_policy: str = "auto"

    def __post_init__(self):
        for name, (off, what) in _LATER_FIELDS.items():
            if getattr(self, name) != off:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not "
                    f"supported by apex_tpu_torch yet ({what} comes in a "
                    f"later slice of the port)")


@dataclasses.dataclass(frozen=True)
class Admission:
    """One admission request — the argument row of
    :meth:`Engine.admit_many`."""

    slot: int
    prompt: Any
    max_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None
    eos_token_id: Optional[int] = None
    #: a prefix-pool hit (``Engine.match_prefix`` in the JAX package):
    #: the prefix slice of the port; admission raises when it is set
    prefix_page: Optional[int] = None
    prefix_len: int = 0


@dataclasses.dataclass(frozen=True)
class AdmitResult:
    """Per-request outcome of :meth:`Engine.admit_many`. ``finished`` is
    True when the request is complete after its first token (eos, or a
    budget of 1); ``logprob`` is the first token's log-probability;
    ``bucket``/``batch_size``/``group`` record which admission group
    served it."""

    first_token: int
    hit_eos: bool
    finished: bool
    bucket: int
    batch_size: int
    group: int
    logprob: float = 0.0


def _pad_span(block, span: int):
    """Zero-pad a cache block ``[L, 2, k, heads, T, d]`` (or each plane of
    the quantized pair) to ``span`` columns on the horizon dim — the
    paged insert's page-alignment shim: :func:`gpt.cache_insert_pages`
    writes whole pages, and the pad columns land in the slot's own
    not-yet-decoded cells or in the sink page. Zeros, never
    ``torch.empty``: the verify read multiplies every stale column by an
    exact zero probability, and ``0 * NaN = NaN``."""
    def pad(x):
        n = span - x.shape[4]
        if n <= 0:
            return x
        shape = list(x.shape)
        shape[4] = n
        return torch.cat([x, x.new_zeros(shape)], dim=4)

    return gpt._cache_map(pad, block)


class StepHandle:
    """One dispatched decode chunk: the ``[B, n]`` token / logprob /
    finished tensors :meth:`Engine.step_async` returned, still on the
    device. :meth:`fetch` copies them to the host (the sync) and caches
    the result. Speculative chunks also carry ``valid`` (``[B, n]``
    bool, True where a real token was emitted: rejected draft lanes and
    done slots emit pad under False), None for plain chunks; ``spec_k``
    is the draft width (0 = plain) and ``ncols`` the columns a slot
    gets (``decode_chunk`` or ``decode_chunk * (spec_k + 1)``)."""

    __slots__ = ("_emit", "_logprobs", "_finished", "_valid_dev", "_out",
                 "valid", "spec_k", "ncols")

    def __init__(self, emit, logprobs, finished, *, valid=None,
                 spec_k: int = 0, ncols: int = 0):
        self._emit = emit
        self._logprobs = logprobs
        self._finished = finished
        self._valid_dev = valid
        self._out: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self.valid: Optional[np.ndarray] = None
        self.spec_k = spec_k
        self.ncols = ncols

    @property
    def spec(self) -> bool:
        """True when this handle carries a speculative chunk."""
        return self.spec_k > 0

    def fetch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for the chunk and return ``(tokens [B, n], logprobs [B,
        n], finished [B, n])`` as host arrays (``valid`` is set too)."""
        if self._out is None:
            self._out = (self._emit.cpu().numpy(),
                         self._logprobs.cpu().numpy(),
                         self._finished.cpu().numpy())
            if self._valid_dev is not None:
                self.valid = self._valid_dev.cpu().numpy()
        return self._out


class Engine:
    """The slot engine on one device (``device=None`` → CUDA; without a
    CUDA device it raises — pass ``device="cpu"`` to mean the CPU).

    ``params`` must live on that device; the engine casts the matmul
    weights to compute dtype once (:func:`gpt.cast_params`) and owns the
    cache and the slot-state tensors. Counters: ``decode_steps_taken``
    (single-token decode steps over the slot batch),
    ``spec_waves_taken`` (speculative verify waves) and
    ``admit_groups`` (admission forwards)."""

    def __init__(self, cfg: gpt.GPTConfig, params,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 **overrides):
        if engine_cfg is not None and overrides:
            raise ValueError("pass engine_cfg or field overrides, not both")
        ecfg = engine_cfg or EngineConfig(**overrides)
        self.device = resolve_device(device)
        p_dev = params["embedding"]["word"]["table"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params on {p_dev} but device is "
                             f"{self.device}")
        if ecfg.slots < 1:
            raise ValueError("need at least one slot")
        if not 1 <= ecfg.max_prompt_len <= ecfg.max_seq_len:
            raise ValueError(
                f"max_prompt_len {ecfg.max_prompt_len} must be in "
                f"[1, max_seq_len={ecfg.max_seq_len}]")
        if ecfg.max_seq_len > cfg.seq_len:
            raise ValueError(
                f"max_seq_len {ecfg.max_seq_len} exceeds the position "
                f"table (cfg.seq_len={cfg.seq_len})")
        if ecfg.decode_chunk < 1:
            raise ValueError(
                f"decode_chunk {ecfg.decode_chunk} must be >= 1")
        if ecfg.spec_k < 0:
            raise ValueError(f"spec_k {ecfg.spec_k} must be >= 0")
        self._spec = ecfg.spec_k > 0
        if self._spec and ecfg.spec_hist < 2:
            raise ValueError(
                f"spec_hist {ecfg.spec_hist} must be >= 2 with "
                f"speculation (the drafter matches a 2-token suffix)")
        if ecfg.page_size < 0 or ecfg.num_pages < 0:
            raise ValueError(
                f"page_size {ecfg.page_size} / num_pages {ecfg.num_pages} "
                f"must be >= 0")
        self._paged = ecfg.page_size > 0
        if not self._paged and ecfg.num_pages:
            raise ValueError(
                "num_pages without page_size — the pool geometry only "
                "exists in paged mode")
        self._max_pages = self._num_pages = 0
        if self._paged:
            self._max_pages = -(-ecfg.max_seq_len // ecfg.page_size)
            self._num_pages = (ecfg.num_pages
                               or ecfg.slots * self._max_pages + 1)
            if self._num_pages < self._max_pages + 1:
                raise ValueError(
                    f"num_pages {self._num_pages} cannot hold one "
                    f"worst-case request ({self._max_pages} pages) plus "
                    f"the sink page")
        gpt.check_stop_tokens(cfg, None, ecfg.pad_token_id)
        self.cfg = cfg
        self.engine_cfg = ecfg
        self._buckets = self._resolve_buckets(ecfg)
        self._batch_sizes = self._resolve_batch_sizes(ecfg)
        self._params = gpt.cast_params(cfg, params)
        #: monotonic admission counter — keys unseeded requests so
        #: concurrent sampled requests never share a stream
        self._req_counter = 0
        self.decode_steps_taken = 0
        self.spec_waves_taken = 0
        self.admit_groups = 0
        B, dev = ecfg.slots, self.device
        if self._paged:
            # the pool: the page dim rides the slot dim of the contiguous
            # layout, the horizon dim is one page (zeros: see _pad_span)
            self.cache = gpt.init_cache(cfg, self._params, self._num_pages,
                                        max_len=ecfg.page_size)
        else:
            self.cache = gpt.init_cache(cfg, self._params, B,
                                        max_len=ecfg.max_seq_len)
        self.state = {
            "tok": torch.full((B,), ecfg.pad_token_id, dtype=torch.int64,
                              device=dev),
            "pos": torch.zeros((B,), dtype=torch.int32, device=dev),
            "remaining": torch.zeros((B,), dtype=torch.int64, device=dev),
            "done": torch.ones((B,), dtype=torch.bool, device=dev),
            "temp": torch.zeros((B,), dtype=torch.float32, device=dev),
            "top_k": torch.zeros((B,), dtype=torch.int64, device=dev),
            "top_p": torch.ones((B,), dtype=torch.float32, device=dev),
            "key": torch.zeros((B, 2), dtype=torch.int64, device=dev),
            "eos": torch.full((B,), _NO_EOS, dtype=torch.int64, device=dev),
        }
        if self._spec:
            # the drafter's token-history ring, -1 = unfilled
            self.state["hist"] = torch.full((B, ecfg.spec_hist), -1,
                                            dtype=torch.int64, device=dev)
        #: paged-mode host state: the allocator, the [B, max_pages]
        #: block-table mirror (its device copy cached until a row
        #: changes) and each slot's (pages, token footprint)
        self._page_alloc: Optional[PageAllocator] = None
        self._tables: Optional[np.ndarray] = None
        self._tables_dev: Optional[torch.Tensor] = None
        self._slot_pages: Dict[int, Tuple[List[int], int]] = {}
        if self._paged:
            self._page_alloc = PageAllocator(self._num_pages,
                                             ecfg.page_size)
            self._tables = np.full((B, self._max_pages), SINK, np.int32)

    @staticmethod
    def _resolve_buckets(ecfg: EngineConfig) -> Tuple[int, ...]:
        buckets = ecfg.prompt_buckets
        if buckets is None:
            return default_prompt_buckets(ecfg.max_prompt_len)
        buckets = tuple(int(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"prompt_buckets must be strictly increasing, got {buckets}")
        if buckets[0] < 1 or buckets[-1] != ecfg.max_prompt_len:
            raise ValueError(
                f"prompt_buckets must lie in [1, max_prompt_len] and end "
                f"at max_prompt_len={ecfg.max_prompt_len}, got {buckets}")
        return buckets

    @staticmethod
    def _resolve_batch_sizes(ecfg: EngineConfig) -> Tuple[int, ...]:
        sizes = ecfg.admit_batch_sizes
        if sizes is None:
            return tuple(k for k in (1, 2, 4) if k <= ecfg.slots)
        sizes = tuple(int(k) for k in sizes)
        if not sizes or list(sizes) != sorted(set(sizes)):
            raise ValueError(
                f"admit_batch_sizes must be strictly increasing, got {sizes}")
        if sizes[0] != 1:
            raise ValueError(
                f"admit_batch_sizes must start at 1, got {sizes}")
        if sizes[-1] > ecfg.slots:
            raise ValueError(
                f"admit_batch_sizes max {sizes[-1]} exceeds slots "
                f"{ecfg.slots}")
        return sizes

    # -- geometry ----------------------------------------------------------

    @property
    def slots(self) -> int:
        return self.engine_cfg.slots

    @property
    def prompt_buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def admit_batch_sizes(self) -> Tuple[int, ...]:
        return self._batch_sizes

    def describe(self) -> Dict[str, Any]:
        """JSON-safe snapshot of the configuration (dtypes by name)."""
        model: Dict[str, Any] = {}
        for f in dataclasses.fields(self.cfg):
            v = getattr(self.cfg, f.name)
            if isinstance(v, torch.dtype):
                v = str(v).replace("torch.", "")
            elif not isinstance(v, (int, float, str, bool, type(None))):
                v = str(v)
            model[f.name] = v
        return {
            "model": model,
            "engine": dataclasses.asdict(self.engine_cfg),
            "device": str(self.device),
            "prompt_buckets": list(self._buckets),
            "admit_batch_sizes": list(self._batch_sizes),
            "decode_chunks": [self.engine_cfg.decode_chunk],
            "spec_ks": [self.engine_cfg.spec_k] if self._spec else [],
            "paged": self._paged,
            "kv_cache_kind": gpt._kv_cache_dtype(self.cfg),
            "num_pages": self._num_pages,
            "max_pages": self._max_pages,
        }

    def cache_bytes(self) -> int:
        """Device bytes of the KV cache (the page pool in paged mode);
        under a quantized ``kv_cache_dtype`` the int8/fp8 data plane plus
        the fp32 scale plane."""
        planes = (self.cache.values() if isinstance(self.cache, dict)
                  else (self.cache,))
        return sum(t.numel() * t.element_size() for t in planes)

    # -- paged KV cache (EngineConfig.page_size > 0) -----------------------

    @property
    def paged(self) -> bool:
        """True when the cache runs the paged layout."""
        return self._paged

    @property
    def page_allocator(self) -> Optional[PageAllocator]:
        """The refcounted page allocator (None in contiguous mode)."""
        return self._page_alloc

    @property
    def max_pages(self) -> int:
        """Block-table width per slot, ``ceil(max_seq_len / page_size)``
        (0 in contiguous mode)."""
        return self._max_pages

    def pages_needed(self, prompt_len: int, max_tokens: int) -> int:
        """Pages one admission pins: the request's token footprint
        (prompt + budget) in pages; 0 in contiguous mode."""
        if not self._paged:
            return 0
        return -(-(prompt_len + max_tokens) // self.engine_cfg.page_size)

    def can_admit_pages(self, prompt_len: int, max_tokens: int) -> bool:
        """Whether the pool has the pages this admission needs now
        (always True in contiguous mode)."""
        if not self._paged:
            return True
        return self._page_alloc.can_alloc(
            self.pages_needed(prompt_len, max_tokens))

    def free_slot(self, slot: int) -> None:
        """Release ``slot``'s pages and point its table row at the sink
        page (its frozen decode lane keeps writing every chunk; the sink
        absorbs that). The scheduler calls this at release; a no-op in
        contiguous mode, where the next admission overwrites the slot."""
        if self._paged:
            self._free_slot_pages(slot)

    def page_stats(self) -> Optional[Dict[str, float]]:
        """The allocator's occupancy snapshot (None in contiguous mode)."""
        if self._page_alloc is None:
            return None
        return self._page_alloc.stats()

    def _free_slot_pages(self, slot: int) -> None:
        ent = self._slot_pages.pop(slot, None)
        if ent is None:
            return
        pages, footprint = ent
        self._page_alloc.free(pages)
        self._page_alloc.used_tokens -= footprint
        self._tables[slot, :] = SINK
        self._tables_dev = None

    def _alloc_slot_pages(self, slot: int, p_len: int,
                          max_tokens: int) -> np.ndarray:
        """Map ``slot``'s table row for one admission: release its stale
        mapping, allocate its pages, sink-fill the rest of the row.
        Raises :class:`PagesExhausted` when the pool is dry. Returns the
        row."""
        self._free_slot_pages(slot)
        need = self.pages_needed(p_len, max_tokens)
        pages = self._page_alloc.alloc(need)
        row = np.full((self._max_pages,), SINK, np.int32)
        row[:need] = pages
        self._tables[slot] = row
        self._tables_dev = None
        self._page_alloc.used_tokens += p_len + max_tokens
        self._slot_pages[slot] = (pages, p_len + max_tokens)
        return row

    def _table_device(self) -> torch.Tensor:
        """The block table on the device, rebuilt only after a row
        changed. On CUDA the copy goes through pinned memory without
        blocking the host (the pinned buffer is a snapshot, so later
        edits of the host mirror cannot race it)."""
        if self._tables_dev is None:
            t = torch.from_numpy(self._tables)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.clone()
            self._tables_dev = t
        return self._tables_dev

    def bucket_for(self, prompt_len: int) -> int:
        """The smallest prefill bucket that fits ``prompt_len``."""
        for b in self._buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds max_prompt_len "
            f"{self.engine_cfg.max_prompt_len}")

    def pad_prompt(self, prompt, length: Optional[int] = None) -> np.ndarray:
        """Right-pad ``prompt`` (1-D ints) to ``length`` (default
        ``max_prompt_len``) with ``pad_token_id``."""
        length = self.engine_cfg.max_prompt_len if length is None else length
        prompt = np.asarray(prompt, np.int64)
        if prompt.ndim != 1 or not 1 <= prompt.size <= length:
            raise ValueError(
                f"prompt must be 1-D with 1..{length} tokens, got shape "
                f"{prompt.shape}")
        out = np.full((length,), self.engine_cfg.pad_token_id, np.int64)
        out[:prompt.size] = prompt
        return out

    # -- admission ---------------------------------------------------------

    def _validate_admission(self, a: Admission) -> Tuple[np.ndarray, int]:
        if not 0 <= a.slot < self.slots:
            raise ValueError(f"slot {a.slot} outside [0, {self.slots})")
        if a.prefix_page is not None or a.prefix_len:
            raise ValueError(
                "prefix-pool admission (prefix_page) is not supported by "
                "apex_tpu_torch yet (the prefix pool comes in a later "
                "slice of the port)")
        gpt.check_stop_tokens(self.cfg, a.eos_token_id, None)
        prompt = np.asarray(a.prompt, np.int64)
        if prompt.ndim != 1 or not \
                1 <= prompt.size <= self.engine_cfg.max_prompt_len:
            raise ValueError(
                f"prompt must be 1-D with 1..{self.engine_cfg.max_prompt_len}"
                f" tokens, got shape {prompt.shape}")
        if ((prompt < 0) | (prompt >= self.cfg.vocab_size)).any():
            raise ValueError(
                f"prompt token ids outside vocab [0, {self.cfg.vocab_size})")
        room = self.engine_cfg.max_seq_len - prompt.size
        if a.max_tokens < 1 or a.max_tokens > room:
            raise ValueError(
                f"max_tokens {a.max_tokens} outside [1, {room}] for a "
                f"{prompt.size}-token prompt at max_seq_len "
                f"{self.engine_cfg.max_seq_len}")
        return prompt, prompt.size

    def admit(self, slot: int, prompt, max_tokens: int, *,
              temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
              seed: Optional[int] = None,
              eos_token_id: Optional[int] = None) -> Tuple[int, bool, bool]:
        """Admit one request into ``slot`` (the k=1 lane of
        :meth:`admit_many`); returns ``(first_token, hit_eos,
        finished)``."""
        res = self.admit_many([Admission(
            slot=slot, prompt=prompt, max_tokens=max_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
            eos_token_id=eos_token_id)])[0]
        return res.first_token, res.hit_eos, res.finished

    def admit_many(self, items: Sequence[Admission]) -> List[AdmitResult]:
        """Admit requests (FIFO order, distinct slots) in groups cut
        largest-first from ``admit_batch_sizes``; each group prefills at
        the smallest bucket that fits its longest prompt in ONE forward.
        Per-row results equal single :meth:`admit` calls in the same
        order. The host reads the groups' first tokens after every group
        is launched."""
        items = list(items)
        if not items:
            return []
        validated = [self._validate_admission(a) for a in items]
        slots_used = [a.slot for a in items]
        if len(set(slots_used)) != len(slots_used):
            raise ValueError(
                f"admit_many slots must be distinct, got {slots_used}")
        if self._paged:
            # all or nothing: refuse the whole batch before any forward
            # when the pool cannot cover it
            total = sum(self.pages_needed(n, a.max_tokens)
                        for a, (_, n) in zip(items, validated))
            if not self._page_alloc.can_alloc(total):
                raise PagesExhausted(total, self._page_alloc.free_pages)
        cfg, dev, st = self.cfg, self.device, self.state
        pending = []
        i, group = 0, 0
        while i < len(items):
            k = max(s for s in self._batch_sizes if s <= len(items) - i)
            batch = items[i:i + k]
            proms = validated[i:i + k]
            bucket = self.bucket_for(max(n for _, n in proms))
            prompts = torch.as_tensor(
                np.stack([self.pad_prompt(p, bucket) for p, _ in proms]),
                device=dev)
            p_lens = torch.tensor([n for _, n in proms], dtype=torch.int64,
                                  device=dev)
            keys = torch.tensor(
                [sampling.request_key(a.seed, self._req_counter + j)
                 for j, a in enumerate(batch)], dtype=torch.int64,
                device=dev)
            self._req_counter += k
            vec = lambda vals, dt: torch.tensor(vals, dtype=dt, device=dev)
            temp = vec([a.temperature for a in batch], torch.float32)
            top_k = vec([a.top_k for a in batch], torch.int64)
            top_p = vec([a.top_p for a in batch], torch.float32)
            max_tokens = vec([a.max_tokens for a in batch], torch.int64)
            eos = vec([_NO_EOS if a.eos_token_id is None
                       else int(a.eos_token_id) for a in batch],
                      torch.int64)
            slots = [a.slot for a in batch]
            # ONE padded forward admits the group; row i's logits and K/V
            # are exactly its solo prefill_at's
            blocks, logits0 = gpt.prefill_many(
                cfg, self._params, prompts, p_lens - 1, max_len=bucket)
            first = sampling.draw_slots(logits0, keys, p_lens - 1, temp,
                                        top_k, top_p)
            first_lp = torch.log_softmax(logits0, dim=-1).gather(
                1, first[:, None])[:, 0]
            if self._paged:
                # row i's bucket columns land in its own pages (pad columns
                # in the sink or the row's not-yet-decoded cells)
                p_sz = self.engine_cfg.page_size
                n_ins = -(-bucket // p_sz)
                rows = [self._alloc_slot_pages(a.slot, n, a.max_tokens)
                        for a, (_, n) in zip(batch, proms)]
                pages = torch.as_tensor(
                    np.stack([r[:n_ins] for r in rows]), device=dev)
                gpt.cache_insert_pages(self.cache,
                                       _pad_span(blocks, n_ins * p_sz),
                                       pages, page_size=p_sz)
            else:
                gpt.cache_insert_slots(self.cache, blocks, slots)
            hit_eos = (eos >= 0) & (first == eos)
            done0 = hit_eos | (max_tokens <= 1)
            sl = torch.tensor(slots, dtype=torch.int64, device=dev)
            st["tok"][sl] = first
            st["pos"][sl] = p_lens.to(torch.int32)
            st["remaining"][sl] = max_tokens - 1
            st["done"][sl] = done0
            st["temp"][sl] = temp
            st["top_k"][sl] = top_k
            st["top_p"][sl] = top_p
            st["key"][sl] = keys
            st["eos"][sl] = eos
            if self._spec:
                # seed the drafter's ring: the prompt tail and the first
                # token drawn above
                hist0 = torch.as_tensor(
                    np.stack([self._hist_seed(p) for p, _ in proms]),
                    device=dev)
                st["hist"][sl] = torch.cat([hist0, first[:, None]], dim=1)
            pending.append(((first, first_lp, hit_eos, done0), bucket, k,
                            group))
            self.admit_groups += 1
            i += k
            group += 1
        results: List[AdmitResult] = []
        for (first, first_lp, hit_eos, done), bucket, k, group in pending:
            first, first_lp = first.tolist(), first_lp.tolist()
            hit_eos, done = hit_eos.tolist(), done.tolist()
            for j in range(k):
                results.append(AdmitResult(
                    int(first[j]), bool(hit_eos[j]), bool(done[j]),
                    bucket=bucket, batch_size=k, group=group,
                    logprob=float(first_lp[j])))
        return results

    def _hist_seed(self, prompt) -> np.ndarray:
        """The drafter ring's admission seed for one prompt: its last
        ``spec_hist - 1`` tokens, left-padded with ``-1`` (the first
        drawn token completes the ring)."""
        h = self.engine_cfg.spec_hist
        row = np.full((h - 1,), -1, np.int64)
        tail = np.asarray(prompt, np.int64)[-(h - 1):]
        if tail.size:
            row[h - 1 - tail.size:] = tail
        return row

    # -- decode ------------------------------------------------------------

    def step_async(self, *, spec: bool = False) -> StepHandle:
        """Dispatch one decode chunk over every slot and return its
        :class:`StepHandle` without waiting for the device. ``spec=False``
        runs ``decode_chunk`` plain steps (columns ``[B, decode_chunk]``;
        a spec engine also shifts the emitted tokens into each slot's
        history ring). ``spec=True`` (needs ``spec_k > 0``) runs
        ``decode_chunk`` draft-verify waves: columns ``[B, decode_chunk *
        (spec_k + 1)]`` wave-major, with ``handle.valid`` marking the
        real emissions."""
        ecfg = self.engine_cfg
        if spec and not self._spec:
            raise ValueError(
                "step_async(spec=True) needs EngineConfig.spec_k > 0")
        n = ecfg.decode_chunk
        table = self._table_device() if self._paged else None
        if spec:
            (self.cache, self.state, toks, lps, fins,
             valid) = gpt.decode_steps_spec(
                self.cfg, self._params, self.cache, self.state, n,
                spec_k=ecfg.spec_k, pad_token_id=ecfg.pad_token_id,
                table=table)
            self.spec_waves_taken += n
            return StepHandle(toks, lps, fins, valid=valid,
                              spec_k=ecfg.spec_k, ncols=n * (ecfg.spec_k + 1))
        pos0 = self.state["pos"]
        self.cache, self.state, toks, lps, fins = gpt.decode_steps(
            self.cfg, self._params, self.cache, self.state, n,
            pad_token_id=ecfg.pad_token_id, table=table)
        if self._spec:
            # keep the drafter's ring fresh across plain chunks too: each
            # row emitted pos_after - pos_before columns, a prefix
            self.state["hist"] = gpt.shift_hist(
                self.state["hist"], toks, self.state["pos"] - pos0)
        self.decode_steps_taken += n
        return StepHandle(toks, lps, fins, ncols=n)

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One plain decode chunk over every slot — ``decode_chunk``
        steps — fetched to the host. Returns ``(tokens [B, n], logprobs
        [B, n], finished [B, n])``; column ``j`` holds step ``j``'s
        emissions, ``pad_token_id`` for slots that were done entering
        it."""
        return self.step_async().fetch()

    def retire(self, slot: int) -> None:
        """Force ``slot`` done (deadline expiry): its lane keeps riding the
        decode batch emitting pad until the next admission."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        self.state["done"][slot] = True
