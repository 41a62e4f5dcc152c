"""Slot-based continuous-batching decode engine — the device loop.

Port of ``apex_tpu/serving/engine.py``: its core, the paged KV cache,
speculative decoding, the shared-prefix pool and chunked prefill. A
fixed batch of ``B`` decode *slots* shares one KV cache — ``[L, 2, B,
heads, max_seq_len, d]``, or with ``page_size > 0`` a pool of pages
``[L, 2, num_pages, heads, page_size, d]`` under a ``[B, max_pages]``
int32 block table (:mod:`.pages` allocates them); under a quantized
``kv_cache_dtype`` the same layout as an int8/fp8 data plane beside an
fp32 scale plane (:func:`gpt.init_cache`) — and requests flow through the
slots. All per-request state the device needs — position, remaining
budget, done flag, eos id, temperature / top-k / top-p, the sampling key
and, with ``spec_k > 0``, the drafter's token-history ring — lives in
``[B]`` tensors on the device:

- :meth:`Engine.admit_many` — a group of queued requests is prefilled in
  ONE forward (``gpt.prefill_many`` over a ``[k, bucket]`` batch of
  right-padded prompts, ``bucket`` the smallest prompt bucket that fits
  the group), each row draws its first token at ``p_len - 1``, the k
  cache blocks are inserted into their slots and the k state rows are
  scattered; a prefix-pool hit (:meth:`Engine.match_prefix`) admits
  alone through ``gpt.prefill_extend`` of its tail over the pooled
  prefix;
- :meth:`Engine.admit_chunked_start` / :meth:`Engine.admit_chunked_step`
  — a prompt longer than ``prefill_chunk`` admits one chunk forward at a
  time, the scheduler decoding between them;
- :meth:`Engine.step_async` — one ``gpt.decode_steps`` chunk of
  ``decode_chunk`` steps over every slot, or with ``spec=True`` one
  ``gpt.decode_steps_spec`` chunk of ``decode_chunk`` draft-verify waves
  (up to ``spec_k + 1`` tokens a wave), returned as a
  :class:`StepHandle`; :meth:`Engine.step` fetches a plain one;
- :meth:`Engine.retire` — force a slot done (deadline expiry, a host-side
  stop); :meth:`Engine.free_slot` — release a paged slot's pages;
- :meth:`Engine.set_slot_mask` — a slot's constrained-decoding vocab
  mask row: the draw drops the row's False positions. A host mirror
  ``[B, vocab]`` is uploaded only when a row changed, and only while
  some row is not all-True; otherwise the draw takes no mask and
  launches what an engine without masks launches;
- :meth:`Engine.register_adapter` — with ``adapter_slots > 0`` a LoRA
  adapter lands in a row of the adapter pool (row 0 is the pinned
  all-zero base adapter) and ``Admission.adapter`` binds a request to
  it: its prefill, its decode steps and its verify waves add the row's
  low-rank delta at every dense seam (``gpt``'s ``lora=`` bundle). The
  per-slot ``[B]`` id table is uploaded only when a row changed, and a
  forward takes the bundle only while one of its rows carries a nonzero
  id; base traffic launches what an engine without a pool launches;
- :meth:`Engine.park_slot` / :meth:`Engine.resume_slot` — with
  ``host_swap`` (paged only) a slot's private pages are gathered into
  host RAM (:func:`gpt.cache_gather_pages`) beside its full state row,
  the slot and its pages are freed, and a later resume scatters the
  payload into fresh pages of any free slot: the stream continues bit
  for bit. The host tier (:class:`~.hostswap.HostPageTier`) may be
  bounded (``host_swap_pages``); an evicted payload leaves the
  scheduler's recompute resume. Under ``host_swap`` adapter ids are
  logical: ``register_adapter`` has no cap, and a cold adapter pages
  into the pool row of the coldest adapter no live slot holds.

Fault injection (:mod:`.resilience`): ``fault_plan=`` arms a
:class:`~.resilience.FaultPlan` over the ``admit`` (:meth:`Engine.admit_many`),
``dispatch`` (:meth:`Engine.step_async`), ``fetch`` (the first
:meth:`StepHandle.fetch`) and ``retire`` seams. An error at a seam, or a
failure of a swap-in scatter or a prefix page-in, poisons the engine:
every device call raises :class:`~.resilience.EngineFault` until
:meth:`Engine.rebuild_slots` resets the cache and the slot state in place
(registered prefixes, their pages and the adapter pool survive).

A slot's token stream is the one a solo ``gpt.generate`` of the same
request emits. PyTorch runs eagerly, so there is no compile step and no
``warmup()``. The cache and the state are updated in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.kernels.decode_attention import _bytes
from apex_tpu_torch.models import gpt
from apex_tpu_torch.serving import sampling
from apex_tpu_torch.serving.hostswap import HostPageTier, LRUIndex
from apex_tpu_torch.serving.pages import SINK, PageAllocator, PagesExhausted
from apex_tpu_torch.serving.resilience import (
    KIND_ERROR,
    KIND_HANG,
    KIND_NAN,
    EngineFault,
    FaultPlan,
    FaultSpec,
    InjectedFault,
)

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
    :class:`~apex_tpu_torch.serving.pages.PagesExhausted`.

    ``prefix_pool_slots > 0`` keeps a pool of that many prefilled
    prompt prefixes (:meth:`Engine.register_prefix`, a system-prompt
    template) in compute dtype; a prompt that starts with one
    (:meth:`Engine.match_prefix`, at bucket-aligned split points)
    admits by prefilling only its tail over the pooled K/V, and with
    ``page_size`` maps the prefix's cache pages copy-on-write (the split
    must then be page-aligned). ``prefill_chunk > 0`` (a prompt bucket
    dividing ``max_prompt_len``) admits prompts longer than it one
    ``prefill_chunk``-token forward at a time. ``adapter_slots > 0``
    keeps a multi-LoRA pool of that many rows (row 0 the pinned base
    adapter) of rank ``adapter_rank``, its deltas scaled by
    ``adapter_alpha / adapter_rank``. ``host_swap`` (needs
    ``page_size``) adds the host-RAM page tier under the pool: parked
    conversations hold host buffers instead of pages, at most
    ``host_swap_pages`` pages of them (0 = unbounded), and
    ``resume_policy`` (``auto`` | ``swap`` | ``recompute``) says how the
    scheduler brings one back; it also pages adapters (logical ids, no
    cap on registrations).

    ``decode_chunks`` and ``spec_ks`` are the ladders a self-tuning
    scheduler (``Scheduler(tuner=...)``) switches among per dispatch:
    strictly increasing, ``decode_chunks`` containing ``decode_chunk``
    (None = ``(decode_chunk,)``) and ``spec_ks`` all >= 1 and containing
    ``spec_k`` when it is > 0 (None = ``(spec_k,)`` when it is > 0, else
    no speculation). ``spec_ks`` with ``spec_k == 0`` is valid: the
    engine carries the drafter's ring and dispatches plain until asked
    otherwise. The JAX engine compiles one program a rung; in the port a
    ladder is a declared contract (the decode loop takes any chunk
    length, and a ``spec_k`` rung sets the verify's T = k + 1), and
    :meth:`Engine.step_async` refuses a value off it as JAX's does."""

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
    #: the constrained-decoding whitelist of the FIRST token (the schema
    #: automaton's initial allowed set); it also seeds the slot's mask row
    #: for the decode steps (:meth:`Engine.set_slot_mask` advances it).
    #: None = unconstrained, and resets a stale row the slot carried
    allowed_tokens: Optional[Sequence[int]] = None
    #: a prefix-pool hit (:meth:`Engine.match_prefix`): ``prompt`` is
    #: still the whole prompt, but its first ``prefix_len`` tokens (which
    #: must equal those registered on pool page ``prefix_page``) come
    #: from the pool and only the tail runs a forward
    prefix_page: Optional[int] = None
    prefix_len: int = 0
    #: the request's LoRA adapter row (0 = the pinned base adapter; rows
    #: >= 1 from :meth:`Engine.register_adapter`): its prefill, decode
    #: steps and verify waves all add that row's delta
    adapter: int = 0


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


class ChunkedAdmission:
    """Host progress of one chunked-prefill admission
    (``EngineConfig.prefill_chunk``): made by
    :meth:`Engine.admit_chunked_start` (which runs chunk 0), advanced one
    chunk forward per :meth:`Engine.admit_chunked_step` call (the
    scheduler decodes between calls) and finished by the same method
    returning the :class:`AdmitResult`. ``chunks_total`` counts the
    prefill forwards."""

    __slots__ = ("admission", "prompt", "p_len", "chunks_total",
                 "next_chunk", "slot", "adapter_row", "_logits")

    def __init__(self, admission: Admission, prompt: np.ndarray,
                 p_len: int, chunks_total: int):
        self.admission = admission
        self.prompt = prompt
        self.p_len = p_len
        self.chunks_total = chunks_total
        self.next_chunk = 1          # chunk 0 ran at start
        self.slot = admission.slot
        self.adapter_row = 0         # the pool row of its adapter
        self._logits = None          # the last chunk's logits, on device

    @property
    def done_prefilling(self) -> bool:
        """True once every prefill chunk ran (the next
        :meth:`Engine.admit_chunked_step` call runs the finish)."""
        return self.next_chunk >= self.chunks_total


class StepHandle:
    """One dispatched decode chunk: the ``[B, n]`` token / logprob /
    finished tensors :meth:`Engine.step_async` returned, still on the
    device. :meth:`fetch` copies them to the host (the sync) and caches
    the result. Speculative chunks also carry ``valid`` (``[B, n]``
    bool, True where a real token was emitted: rejected draft lanes and
    done slots emit pad under False), None for plain chunks; ``spec_k``
    is the draft width (0 = plain) and ``ncols`` the columns a slot
    gets (``decode_chunk`` or ``decode_chunk * (spec_k + 1)``).

    Fault injection: a plan's ``fetch`` seam is taken on the first fetch
    only, and a ``dispatch``-seam hang rides the handle to the fetch,
    where a hung dispatch is observed. An injected ``error`` poisons the
    engine; a ``nan`` overwrites the rows of ``spec.slots`` with
    ``spec.token`` after the copy to the host."""

    __slots__ = ("_emit", "_logprobs", "_finished", "_valid_dev", "_out",
                 "_plan", "_hang", "_on_poison", "valid", "spec_k", "ncols")

    def __init__(self, emit, logprobs, finished, *, valid=None,
                 spec_k: int = 0, ncols: int = 0,
                 plan: Optional[FaultPlan] = None,
                 hang: Optional[FaultSpec] = None,
                 on_poison=None):
        self._emit = emit
        self._logprobs = logprobs
        self._finished = finished
        self._valid_dev = valid
        self._out: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._plan = plan
        self._hang = hang
        self._on_poison = on_poison
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
        if self._out is not None:
            return self._out
        spec = self._plan.take("fetch") if self._plan is not None else None
        for s in (self._hang, spec):
            if s is not None and s.kind == KIND_HANG:
                self._plan.hang_fn(s.hang_s)
        if spec is not None and spec.kind == KIND_ERROR:
            if self._on_poison is not None:
                self._on_poison()
            raise InjectedFault(
                f"injected device error at fetch: {spec.describe()}",
                point="fetch", spec=spec)
        tokens = self._emit.cpu().numpy()
        logprobs = self._logprobs.cpu().numpy()
        finished = self._finished.cpu().numpy()
        if self._valid_dev is not None:
            self.valid = self._valid_dev.cpu().numpy()
        if spec is not None and spec.kind == KIND_NAN:
            # what a NaN logit batch looks like on the host: garbage
            # token ids in the poisoned lanes
            tokens = tokens.copy()
            rows = [s for s in spec.slots if 0 <= s < tokens.shape[0]]
            tokens[rows, :] = spec.token
        self._out = (tokens, logprobs, finished)
        return self._out


class Engine:
    """The slot engine on one device (``device=None`` → CUDA; without a
    CUDA device it raises — pass ``device="cpu"`` to mean the CPU).

    ``params`` must live on that device; the engine casts the matmul
    weights to compute dtype once (:func:`gpt.cast_params`) and owns the
    cache and the slot-state tensors. Counters: ``decode_steps_taken``
    (single-token decode steps over the slot batch),
    ``spec_waves_taken`` (speculative verify waves), ``admit_groups``
    (cold admission forwards, ``gpt.prefill_many``), ``prefix_admits``
    (prefix-pool hits, each one ``gpt.prefill_extend``),
    ``chunk_prefills`` (chunked-prefill forwards: chunk 0 and the
    extends), ``mask_uploads`` (host-to-device copies of vocab mask
    rows: the decode steps' ``[B, vocab]`` copy, or an admission's
    first-token rows) and ``adapter_id_uploads`` (copies of the decode
    steps' ``[B]`` adapter-id table). ``fault_plan`` arms fault
    injection at the engine's seams (see the module docstring)."""

    def __init__(self, cfg: gpt.GPTConfig, params,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 fault_plan: Optional[FaultPlan] = None,
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
        self._chunk_ladder = self._resolve_chunk_ladder(ecfg)
        self._spec_ladder = self._resolve_spec_ladder(ecfg)
        self._spec = bool(self._spec_ladder)
        if self._spec and ecfg.spec_hist < 2:
            raise ValueError(
                f"spec_hist {ecfg.spec_hist} must be >= 2 with "
                f"speculation (the drafter matches a 2-token suffix)")
        gpt.check_stop_tokens(cfg, None, ecfg.pad_token_id)
        # the multi-LoRA geometry: pool rows and rank are static, the
        # per-slot ids are data
        if ecfg.adapter_slots < 0:
            raise ValueError(
                f"adapter_slots {ecfg.adapter_slots} must be >= 0")
        self._lora = ecfg.adapter_slots > 0
        if self._lora:
            if ecfg.adapter_rank < 1:
                raise ValueError(
                    f"adapter_rank {ecfg.adapter_rank} must be >= 1")
            if cfg.num_experts:
                raise ValueError(
                    "adapter_slots > 0 does not compose with "
                    "num_experts > 0 (the expert FFN has no per-row "
                    "dense seam to delta — see gpt.init_lora_pool)")
        self._lora_scale = (ecfg.adapter_alpha / ecfg.adapter_rank
                            if self._lora else 0.0)
        self._buckets = self._resolve_buckets(ecfg)
        self._batch_sizes = self._resolve_batch_sizes(ecfg)
        if ecfg.prefix_pool_slots > 0 and cfg.num_experts:
            raise ValueError(
                "prefix_pool_slots > 0 does not compose with "
                "num_experts > 0: MoE expert capacity depends on the "
                "routed token count, so a tail-only extend forward "
                "drops different tokens than the cold full-prompt "
                "prefill and prefix-hit streams would silently "
                "diverge (see gpt.prefill_extend)")
        self._prefix_splits, self._extend_variants = \
            self._resolve_prefix_variants(ecfg, self._buckets)
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
            if self._prefix_splits:
                # copy-on-write maps whole pages: only page-aligned
                # splits can share (the tail insert starts at the split,
                # and a mid-page split would make a shared page writable)
                splits = tuple(s for s in self._prefix_splits
                               if s % ecfg.page_size == 0)
                if not splits:
                    raise ValueError(
                        f"prefix_pool_slots={ecfg.prefix_pool_slots} "
                        f"with page_size={ecfg.page_size}: no split "
                        f"point in {self._prefix_splits} is "
                        f"page-aligned — pick a page_size dividing a "
                        f"prompt bucket")
                self._extend_variants = tuple(
                    (ps, tb) for ps, tb in self._extend_variants
                    if ps in splits)
                self._prefix_splits = splits
        if ecfg.resume_policy not in ("auto", "swap", "recompute"):
            raise ValueError(
                f"resume_policy {ecfg.resume_policy!r} must be one of "
                f"'auto' | 'swap' | 'recompute'")
        if ecfg.host_swap_pages < 0:
            raise ValueError(
                f"host_swap_pages {ecfg.host_swap_pages} must be >= 0")
        self._host_swap = bool(ecfg.host_swap)
        if self._host_swap and not self._paged:
            raise ValueError(
                "host_swap requires the paged KV cache (page_size > 0) "
                "— the swap tier moves pages, not contiguous stripes")
        if ecfg.host_swap_pages and not self._host_swap:
            raise ValueError(
                "host_swap_pages without host_swap — the host tier "
                "only exists with host_swap=True")
        if ecfg.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk {ecfg.prefill_chunk} must be >= 0")
        self._chunk_size = ecfg.prefill_chunk
        if self._chunk_size:
            if cfg.num_experts:
                raise ValueError(
                    "prefill_chunk > 0 does not compose with "
                    "num_experts > 0 (chunked admission rides "
                    "gpt.prefill_extend, which MoE expert capacity "
                    "breaks — see its docstring)")
            if self._chunk_size not in self._buckets:
                raise ValueError(
                    f"prefill_chunk {self._chunk_size} must be one of "
                    f"the prompt buckets {self._buckets} (chunk 0 is a "
                    f"bucket-sized cold prefill)")
            if self._chunk_size >= ecfg.max_prompt_len \
                    or ecfg.max_prompt_len % self._chunk_size:
                raise ValueError(
                    f"prefill_chunk {self._chunk_size} must divide and "
                    f"be smaller than max_prompt_len "
                    f"{ecfg.max_prompt_len} (the chunk ladder is "
                    f"static)")
        self.cfg = cfg
        self.engine_cfg = ecfg
        self._params = gpt.cast_params(cfg, params)
        self.fault_plan = fault_plan
        #: True after a fault invalidated the cache and state: every
        #: device call refuses until rebuild_slots()
        self._poisoned = False
        #: monotonic admission counter — keys unseeded requests so
        #: concurrent sampled requests never share a stream
        self._req_counter = 0
        self.decode_steps_taken = 0
        self.spec_waves_taken = 0
        self.admit_groups = 0
        self.prefix_admits = 0
        self.chunk_prefills = 0
        self.mask_uploads = 0
        self.adapter_id_uploads = 0
        B, dev = ecfg.slots, self.device
        #: per-slot constrained-decoding vocab masks, host mirror (all-True
        #: = unconstrained), the slots whose row is not all-True, and the
        #: device copy, cached until a row changes
        self._masks = np.ones((B, cfg.vocab_size), bool)
        self._masked_slots: set = set()
        self._masks_dev: Optional[torch.Tensor] = None
        if self._paged:
            # the pool: the page dim rides the slot dim of the contiguous
            # layout, the horizon dim is one page (zeros: see _pad_span)
            self.cache = gpt.init_cache(cfg, self._params, self._num_pages,
                                        max_len=ecfg.page_size)
        else:
            self.cache = gpt.init_cache(cfg, self._params, B,
                                        max_len=ecfg.max_seq_len)
        self.state = {
            k: torch.full(shape, fill, dtype=dt, device=dev)
            for k, (shape, dt, fill) in self._state_spec().items()}
        #: paged-mode host state: the allocator, the [B, max_pages]
        #: block-table mirror (its device copy cached until a row
        #: changes), each slot's (private pages, shared prefix pages,
        #: token footprint) and each registered prefix's pinned pages
        self._page_alloc: Optional[PageAllocator] = None
        self._tables: Optional[np.ndarray] = None
        self._tables_dev: Optional[torch.Tensor] = None
        self._slot_pages: Dict[int, Tuple[List[int], List[int], int]] = {}
        self._prefix_pages: Dict[int, List[int]] = {}
        if self._paged:
            self._page_alloc = PageAllocator(self._num_pages,
                                             ecfg.page_size)
            self._tables = np.full((B, self._max_pages), SINK, np.int32)
        # the prefix pool and the chunked scratch hold COMPUTE-dtype K/V
        # even under a quantized cache: a tail extend, or a later chunk,
        # attends over the exact prefix values a cold prefill of the
        # whole prompt would see, and the quantizer runs once, at the
        # slot insert, where a cold admission runs it
        self._cfg_compute = dataclasses.replace(cfg, kv_cache_dtype="bf16")
        #: prefix-pool host registry: bucket-aligned key (exact token
        #: tuple) → (page, split), and each page's registered tokens
        self._prefix_index: Dict[Tuple[int, ...], Tuple[int, int]] = {}
        self._prefix_tokens: Dict[int, Tuple[int, ...]] = {}
        self._prefix_used = 0
        self.pool: Optional[torch.Tensor] = None
        if self._prefix_splits:
            self.pool = self._pool_init()
        #: the one chunked admission in progress (the scratch holds one
        #: prompt) and its scratch
        self._chunked: Optional[ChunkedAdmission] = None
        self._chunk_scratch: Optional[torch.Tensor] = None
        if self._chunk_size:
            self._chunk_scratch = gpt.init_cache(
                self._cfg_compute, self._params, 1,
                max_len=ecfg.max_prompt_len)
        #: multi-LoRA: the pool (zeros: row 0 IS the pinned base adapter),
        #: the per-slot adapter-id table's host mirror and its device copy
        #: (cached until a row changes), and the registry (name → row,
        #: row → metadata)
        self.adapters: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        if self._lora:
            self.adapters = gpt.init_lora_pool(cfg, self._params,
                                               ecfg.adapter_slots,
                                               ecfg.adapter_rank)
        self._adapter_ids = np.zeros((B,), np.int64)
        self._aids_dev: Optional[torch.Tensor] = None
        self._adapter_names: Dict[str, int] = {}
        self._adapter_meta: Dict[int, Dict[str, Any]] = {}
        self._adapter_used = 1 if self._lora else 0   # row 0 pinned
        #: host-swap tier: the parked-conversation store (payloads: the
        #: private pages in storage form, the slot's state row, its
        #: shared pages, mask row and adapter) and the measured per-page
        #: swap-in cost the scheduler's auto resume policy prices from
        self._host_tier: Optional[HostPageTier] = None
        self._swap_in_ewma_s = 0.0
        if self._host_swap:
            self._host_tier = HostPageTier(ecfg.host_swap_pages)
        #: adapter paging (host_swap engines): each registration's host
        #: weight rows (logical id -> numpy rows), the logical <->
        #: physical residency maps and the LRU over resident pool rows.
        #: Without host_swap they stay empty and ids are pool rows
        self._adapter_rows_host: Dict[int, Any] = {}
        self._adapter_phys: Dict[int, int] = {}
        self._adapter_virt: Dict[int, int] = {}
        self._adapter_lru = LRUIndex()
        self._adapter_free_rows: List[int] = (
            list(range(ecfg.adapter_slots - 1, 0, -1))
            if self._lora and self._host_swap else [])
        self._adapter_spills = 0
        self._adapter_pageins = 0

    def _state_spec(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype,
                                             Any]]:
        """Every slot-state tensor's ``(shape, dtype, free value)``: all
        slots done, pad tokens, position 0, no budget, greedy, no eos
        and, speculating, the drafter's token-history ring unfilled
        (-1). :meth:`rebuild_slots` writes these values back in place."""
        ecfg, B = self.engine_cfg, self.engine_cfg.slots
        spec = {
            "tok": ((B,), torch.int64, ecfg.pad_token_id),
            "pos": ((B,), torch.int32, 0),
            "remaining": ((B,), torch.int64, 0),
            "done": ((B,), torch.bool, True),
            "temp": ((B,), torch.float32, 0.0),
            "top_k": ((B,), torch.int64, 0),
            "top_p": ((B,), torch.float32, 1.0),
            "key": ((B, 2), torch.int64, 0),
            "eos": ((B,), torch.int64, _NO_EOS),
        }
        if self._spec:
            spec["hist"] = ((B, ecfg.spec_hist), torch.int64, -1)
        return spec

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

    @staticmethod
    def _resolve_chunk_ladder(ecfg: EngineConfig) -> Tuple[int, ...]:
        chunks = ecfg.decode_chunks
        if chunks is None:
            return (ecfg.decode_chunk,)
        chunks = tuple(int(c) for c in chunks)
        if not chunks or list(chunks) != sorted(set(chunks)) \
                or chunks[0] < 1:
            raise ValueError(
                f"decode_chunks must be a strictly increasing ladder of "
                f"values >= 1, got {chunks}")
        if ecfg.decode_chunk not in chunks:
            raise ValueError(
                f"decode_chunks {chunks} must contain decode_chunk "
                f"{ecfg.decode_chunk} — the base operating point must "
                f"be a compiled variant")
        return chunks

    @staticmethod
    def _resolve_spec_ladder(ecfg: EngineConfig) -> Tuple[int, ...]:
        ks = ecfg.spec_ks
        if ks is None:
            return (ecfg.spec_k,) if ecfg.spec_k > 0 else ()
        ks = tuple(int(k) for k in ks)
        if not ks or list(ks) != sorted(set(ks)) or ks[0] < 1:
            raise ValueError(
                f"spec_ks must be a strictly increasing ladder of "
                f"values >= 1 (0 — the plain variant — is a tuner "
                f"rung, not a compiled spec program), got {ks}")
        if ecfg.spec_k > 0 and ecfg.spec_k not in ks:
            raise ValueError(
                f"spec_ks {ks} must contain spec_k {ecfg.spec_k} — the "
                f"base operating point must be a compiled variant")
        return ks

    @staticmethod
    def _resolve_prefix_variants(ecfg: EngineConfig,
                                 buckets: Tuple[int, ...]):
        """The prefix pool's usable SPLIT points (bucket values that
        leave >= 1 tail token) and its (split, tail bucket) variants — a
        tail bucket counts only where ``split + tail_bucket`` fits the
        slot horizon, since the tail block is written at offset
        ``split``. The JAX engine compiles one program a variant; the
        port keeps the set so :meth:`match_prefix` reports a hit only
        where the JAX engine would."""
        if ecfg.prefix_pool_slots < 0:
            raise ValueError(
                f"prefix_pool_slots {ecfg.prefix_pool_slots} must be "
                f">= 0")
        if ecfg.prefix_pool_slots == 0:
            return (), ()
        mpl = ecfg.max_prompt_len
        splits: List[int] = []
        variants: List[Tuple[int, int]] = []
        for ps in buckets:
            if ps > mpl - 1:
                continue
            tbs = sorted({min(b for b in buckets if b >= tl)
                          for tl in range(1, mpl - ps + 1)})
            tbs = [tb for tb in tbs if ps + tb <= ecfg.max_seq_len]
            if not tbs:
                continue
            splits.append(ps)
            variants.extend((ps, tb) for tb in tbs)
        if not splits:
            raise ValueError(
                f"prefix_pool_slots={ecfg.prefix_pool_slots} but no "
                f"usable split point: no prompt bucket b satisfies "
                f"b <= max_prompt_len-1 with a tail bucket fitting "
                f"max_seq_len (buckets {buckets}, max_prompt_len "
                f"{mpl}, max_seq_len {ecfg.max_seq_len})")
        return tuple(splits), tuple(variants)

    def _pool_init(self) -> torch.Tensor:
        """The empty prefix pool: ``prefix_pool_slots`` rows of the
        largest split's horizon, compute dtype."""
        return gpt.init_cache(self._cfg_compute, self._params,
                              self.engine_cfg.prefix_pool_slots,
                              max_len=max(self._prefix_splits))

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

    @property
    def decode_chunks(self) -> Tuple[int, ...]:
        """The resolved decode-chunk ladder (ascending; always contains
        the base ``decode_chunk``): every rung is a chunk length a tuner
        may dispatch."""
        return self._chunk_ladder

    @property
    def spec_ks(self) -> Tuple[int, ...]:
        """The resolved speculative draft-width ladder (ascending; empty
        = no speculation): every rung crosses with every decode-chunk
        rung."""
        return self._spec_ladder

    @property
    def prefix_pool_enabled(self) -> bool:
        """True when ``EngineConfig.prefix_pool_slots > 0`` resolved to
        at least one usable split point."""
        return bool(self._prefix_splits)

    @property
    def prefix_splits(self) -> Tuple[int, ...]:
        """Bucket-aligned split points the prefix pool can reuse at
        (ascending; empty when the pool is disabled)."""
        return self._prefix_splits

    @property
    def chunked_prefill_enabled(self) -> bool:
        """True when ``EngineConfig.prefill_chunk > 0``."""
        return self._chunk_size > 0

    def chunked_for(self, prompt_len: int) -> bool:
        """Whether a prompt of this length admits through chunked
        prefill (longer than one chunk) instead of :meth:`admit_many`."""
        return self._chunk_size > 0 and prompt_len > self._chunk_size

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
            "decode_chunks": list(self._chunk_ladder),
            "spec_ks": list(self._spec_ladder),
            "paged": self._paged,
            "kv_cache_kind": gpt._kv_cache_dtype(self.cfg),
            "num_pages": self._num_pages,
            "max_pages": self._max_pages,
            "prefix_templates": [list(self._prefix_tokens[p])
                                 for p in sorted(self._prefix_tokens)],
            "adapters": [dict(self._adapter_meta[i])
                         for i in sorted(self._adapter_meta)],
            "poisoned": self._poisoned,
        }

    def cache_bytes(self) -> int:
        """Device bytes of the KV cache (the page pool in paged mode);
        under a quantized ``kv_cache_dtype`` the int8/fp8 data plane plus
        the fp32 scale plane."""
        planes = (self.cache.values() if isinstance(self.cache, dict)
                  else (self.cache,))
        return sum(t.numel() * t.element_size() for t in planes)

    def pool_bytes(self) -> int:
        """Device bytes of the shared-prefix pool (0 when disabled)."""
        if self.pool is None:
            return 0
        return self.pool.numel() * self.pool.element_size()

    # -- batched multi-LoRA (EngineConfig.adapter_slots > 0) ---------------

    @property
    def adapter_pool_enabled(self) -> bool:
        """True when ``EngineConfig.adapter_slots > 0``."""
        return self._lora

    @property
    def adapter_names(self) -> Dict[str, int]:
        """Registered adapter name → id (a copy; the pinned base row 0 is
        not in it; the pool row itself, or with ``host_swap`` the logical
        id): the source of ``/v1/models``' adapter rows."""
        return dict(self._adapter_names)

    @property
    def adapters_registered(self) -> int:
        """Registered adapters, the pinned base row not counted."""
        return max(self._adapter_used - 1, 0)

    def adapter_bytes(self) -> int:
        """Device bytes of the adapter pool (0 when disabled)."""
        if self.adapters is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for parts in self.adapters.values()
                   for t in parts.values())

    def _lora_expected_shapes(self) -> Dict[str, Dict[str, Tuple[int, ...]]]:
        cfg, r = self.cfg, self.engine_cfg.adapter_rank
        L, h, f = cfg.num_layers, cfg.hidden_size, cfg.ffn
        return {
            "qkv": {"a": (L, r, h), "b": (L, r, 3, h)},
            "proj": {"a": (L, r, h), "b": (L, r, h)},
            "fc1": {"a": (L, r, h), "b": (L, r, f)},
            "fc2": {"a": (L, r, f), "b": (L, r, h)},
        }

    def register_adapter(self, weights=None, *, name: Optional[str] = None,
                         seed: Optional[int] = None) -> int:
        """Register one LoRA adapter into the next free pool row and
        return its id (what ``Admission.adapter`` / ``Request.adapter``
        carry). Pass either ``weights`` — per site ``{"qkv"/"proj"/"fc1"/
        "fc2": {"a", "b"}}`` arrays in :func:`gpt.init_lora_weights`'
        layout — or ``seed``, for the deterministic synthetic adapter that
        seed names. A name already registered returns its id. The shapes
        are checked before the capacity. With ``host_swap`` the id is
        logical and there is no cap: the rows stay in host memory and
        page into the pool (at once while a pool row is free, else at
        the admission that needs them). The JAX engine also refuses a
        registration before its ``warmup()``, which compiles the set
        program; the port compiles nothing and has no ``warmup()``, so it
        registers at any time."""
        if not self._lora:
            raise ValueError(
                "adapter pool disabled (EngineConfig.adapter_slots "
                "== 0)")
        if (weights is None) == (seed is None):
            raise ValueError("pass exactly one of weights= or seed=")
        if name is None:
            name = (f"adapter-seed-{seed}" if seed is not None
                    else f"adapter-{self._adapter_used}")
        hit = self._adapter_names.get(name)
        if hit is not None:
            return hit
        if seed is not None:
            weights = gpt.init_lora_weights(
                self.cfg, self.engine_cfg.adapter_rank, seed)
        # a malformed adapter fails as malformed, full pool or not
        row: Dict[str, Dict[str, np.ndarray]] = {}
        for site, parts in self._lora_expected_shapes().items():
            if site not in weights:
                raise ValueError(f"adapter weights missing site {site!r}")
            row[site] = {}
            for part, shape in parts.items():
                arr = np.asarray(weights[site][part], np.float32)
                if arr.shape != shape:
                    raise ValueError(
                        f"adapter {site}.{part} shape {arr.shape} != "
                        f"expected {shape} (rank/layers/hidden are "
                        f"compile-time static — ADAPTER-STATIC)")
                row[site][part] = arr
        if self._host_swap:
            idx = self._adapter_used
            self._adapter_rows_host[idx] = row
            self._adapter_used += 1
            if self._adapter_free_rows:
                try:
                    self._adapter_physical(idx)
                except Exception:
                    self._adapter_rows_host.pop(idx, None)
                    self._adapter_used -= 1
                    raise
            self._adapter_names[name] = idx
            self._adapter_meta[idx] = {
                "id": idx, "name": name, "seed": seed,
                "rank": self.engine_cfg.adapter_rank}
            return idx
        if self._adapter_used >= self.engine_cfg.adapter_slots:
            raise ValueError(
                f"adapter pool full ({self.engine_cfg.adapter_slots} "
                f"rows incl. the pinned base row 0)")
        idx = self._adapter_used
        gpt.lora_set_row(self.adapters, row, idx)
        self._adapter_used += 1
        self._adapter_names[name] = idx
        self._adapter_meta[idx] = {"id": idx, "name": name, "seed": seed,
                                   "rank": self.engine_cfg.adapter_rank}
        return idx

    def _set_slot_adapter(self, slot: int, adapter: int) -> None:
        """Point ``slot``'s adapter-id table entry at ``adapter``; the
        device copy is dropped only when the entry changes."""
        if self._adapter_ids[slot] == adapter:
            return
        self._adapter_ids[slot] = adapter
        self._aids_dev = None

    def _pinned_adapter_rows(self) -> set:
        """The pool rows a live slot's id-table entry, or the chunked
        admission in progress, holds: paging must not evict them (that
        would swap weights under a decoding stream)."""
        rows = {int(r) for r in self._adapter_ids if r}
        if self._chunked is not None and self._chunked.adapter_row:
            rows.add(self._chunked.adapter_row)
        return rows

    def _adapter_physical(self, adapter: int, pinned=()) -> int:
        """Resolve a logical adapter id to its resident pool row, paging
        the row in from the host registry when cold (``host_swap``
        engines; the identity elsewhere, where ids are rows). A cold id
        takes a free row, else the row of the coldest adapter that no
        pinned row holds (:meth:`_pinned_adapter_rows`, plus ``pinned``:
        the rows an admission batch resolved before this one). Raises
        ``ValueError`` when every row is pinned."""
        if not (self._host_swap and self._lora) or adapter == 0:
            return adapter
        phys = self._adapter_phys.get(adapter)
        if phys is not None:
            self._adapter_lru.touch(phys)
            return phys
        if self._adapter_free_rows:
            phys = self._adapter_free_rows.pop()
        else:
            phys = self._adapter_lru.pop_coldest(
                self._pinned_adapter_rows() | set(pinned))
            if phys is None:
                raise ValueError(
                    f"adapter pool thrash: every resident row "
                    f"(adapter_slots={self.engine_cfg.adapter_slots}) "
                    f"is bound to a live slot — raise adapter_slots")
            stale = self._adapter_virt.pop(phys)
            self._adapter_phys.pop(stale, None)
            self._adapter_spills += 1
        gpt.lora_set_row(self.adapters, self._adapter_rows_host[adapter],
                         phys)
        self._adapter_phys[adapter] = phys
        self._adapter_virt[phys] = adapter
        self._adapter_lru.touch(phys)
        self._adapter_pageins += 1
        return phys

    def _resolve_adapters(self, ids: Sequence[int]) -> List[int]:
        """The pool rows of one admission batch's logical ids, each row
        pinned against the paging of the rows after it. (JAX's engine
        resolves a batch's ids before it binds any: with more cold
        adapters in one batch than unpinned rows, a row paged in for one
        request can be evicted for a later one of the same batch, which
        then reads the wrong weights.)"""
        out: List[int] = []
        for a in ids:
            out.append(self._adapter_physical(a, pinned=out))
        return out

    def _adapter_virtual(self, phys: int) -> int:
        """Inverse of :meth:`_adapter_physical` for a bound row: the
        logical id a park payload stores, so a resume resolves it again
        (the row may have been spilled meanwhile)."""
        if not (self._host_swap and self._lora) or phys == 0:
            return phys
        return self._adapter_virt.get(phys, 0)

    def adapters_fit(self, ids: Sequence[int]) -> bool:
        """Whether the logical adapters ``ids`` can be resident at once
        beside the rows the live slots and the chunked admission hold —
        what an admission batch (or a resume) needs to resolve without a
        thrash. Always True without adapter paging."""
        if not (self._host_swap and self._lora):
            return True
        need = {int(a) for a in ids if a}
        held = {self._adapter_phys[a] for a in need
                if a in self._adapter_phys}
        others = self._pinned_adapter_rows() - held
        return len(others) + len(need) <= self.engine_cfg.adapter_slots - 1

    def adapter_paging_stats(self) -> Optional[Dict[str, float]]:
        """Adapter-paging snapshot (None unless ``host_swap`` with an
        adapter pool): logical registrations, resident rows, usable
        rows, spill and page-in totals."""
        if not (self._host_swap and self._lora):
            return None
        return {
            "registered": float(self.adapters_registered),
            "resident": float(len(self._adapter_virt)),
            "rows": float(self.engine_cfg.adapter_slots - 1),
            "spills_total": float(self._adapter_spills),
            "pageins_total": float(self._adapter_pageins),
        }

    def _lora_for(self, ids: Sequence[int]):
        """The ``lora=`` bundle of an admission forward whose rows carry
        pool rows ``ids``, or None while every one is the base adapter (row
        0's delta is an exact zero: None gives the same bits and launches
        nothing for it)."""
        if not any(ids):
            return None
        return (self.adapters,
                torch.tensor(list(ids), dtype=torch.int64,
                             device=self.device), self._lora_scale)

    def _lora_decode(self):
        """The decode chunk's bundle over the slot id table (uploaded
        again only after an entry changed), or None while every slot
        carries the base adapter."""
        if not self._adapter_ids.any():
            return None
        if self._aids_dev is None:
            self._aids_dev = self._upload(self._adapter_ids)
            self.adapter_id_uploads += 1
        return (self.adapters, self._aids_dev, self._lora_scale)

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

    def pages_needed(self, prompt_len: int, max_tokens: int,
                     prefix_len: int = 0) -> int:
        """Private pages one admission pins: the request's token
        footprint (prompt + budget) in pages, less the pages of a shared
        prefix of ``prefix_len`` tokens; 0 in contiguous mode."""
        if not self._paged:
            return 0
        p = self.engine_cfg.page_size
        return -(-(prompt_len + max_tokens) // p) - prefix_len // p

    def can_admit_pages(self, prompt_len: int, max_tokens: int,
                        prefix_len: int = 0) -> bool:
        """Whether the pool has the private pages this admission needs
        now (always True in contiguous mode)."""
        if not self._paged:
            return True
        return self._page_alloc.can_alloc(
            self.pages_needed(prompt_len, max_tokens, prefix_len))

    def free_slot(self, slot: int) -> None:
        """Release ``slot``'s private pages, drop its pin on shared
        prefix pages and point its table row at the sink page (its frozen
        decode lane keeps writing every chunk; the sink absorbs that).
        The scheduler calls this at release; a no-op in contiguous mode,
        where the next admission overwrites the slot. The slot's mask row
        goes back to all-True and its adapter id to 0: a done lane's draw
        is dropped, and a stale row would keep the masked draw, or the
        adapter delta, on for everyone."""
        if self._paged:
            self._free_slot_pages(slot)
        self.set_slot_mask(slot, None)
        self._set_slot_adapter(slot, 0)

    def page_stats(self) -> Optional[Dict[str, float]]:
        """The allocator's occupancy snapshot (None in contiguous mode)."""
        if self._page_alloc is None:
            return None
        return self._page_alloc.stats()

    def _free_slot_pages(self, slot: int) -> None:
        ent = self._slot_pages.pop(slot, None)
        if ent is None:
            return
        priv, shared, footprint = ent
        self._page_alloc.free(priv)
        self._page_alloc.free(shared)
        self._page_alloc.used_tokens -= footprint
        self._tables[slot, :] = SINK
        self._tables_dev = None

    def _alloc_slot_pages(self, slot: int, p_len: int, max_tokens: int,
                          prefix_page: Optional[int] = None,
                          prefix_len: int = 0) -> np.ndarray:
        """Map ``slot``'s table row for one admission: release its stale
        mapping, pin the shared prefix pages (copy-on-write: a refcount,
        no bytes move), allocate the private tail and decode pages,
        sink-fill the rest. Raises :class:`PagesExhausted` when the pool
        is dry. Returns the row."""
        self._free_slot_pages(slot)
        p = self.engine_cfg.page_size
        shared: List[int] = []
        if prefix_page is not None:
            shared = list(self._prefix_pages[prefix_page][:prefix_len // p])
        need = self.pages_needed(p_len, max_tokens, prefix_len)
        priv = self._page_alloc.alloc(need)
        self._page_alloc.share(shared)
        row = np.full((self._max_pages,), SINK, np.int32)
        row[:len(shared)] = shared
        row[len(shared):len(shared) + need] = priv
        self._tables[slot] = row
        self._tables_dev = None
        footprint = p_len + max_tokens - prefix_len
        self._page_alloc.used_tokens += footprint
        self._slot_pages[slot] = (priv, shared, footprint)
        return row

    # -- host-swap tier (EngineConfig.host_swap) ---------------------------

    @property
    def host_swap_enabled(self) -> bool:
        """True when ``EngineConfig.host_swap`` is on."""
        return self._host_swap

    def host_parked(self, key: Any) -> bool:
        """Whether ``key``'s swap payload is still in the host tier (False
        after a capacity eviction: the recompute-resume signal)."""
        return self._host_tier is not None and key in self._host_tier

    def swap_in_cost_s(self, n_pages: int) -> Optional[float]:
        """The measured swap-in wall cost of ``n_pages`` (the per-page
        EWMA the auto resume policy prices against replay); None before
        the first resume."""
        if self._swap_in_ewma_s <= 0.0:
            return None
        return self._swap_in_ewma_s * max(n_pages, 1)

    def host_tier_stats(self) -> Optional[Dict[str, float]]:
        """The host tier's occupancy snapshot (None without host_swap)."""
        if self._host_tier is None:
            return None
        return self._host_tier.stats()

    def _parked_entry(self, key: Any):
        if self._host_tier is None:
            return None
        return self._host_tier._entries.get(key)

    def parked_pages(self, key: Any) -> int:
        """Private pages ``key``'s parked payload holds (0 when not
        swap-parked): what a swap-resume must allocate."""
        ent = self._parked_entry(key)
        return 0 if ent is None else ent.n_pages

    def parked_bytes(self, key: Any) -> int:
        """Host bytes of ``key``'s parked page blocks (0 when not
        swap-parked)."""
        ent = self._parked_entry(key)
        return 0 if ent is None else ent.nbytes

    def slot_page_count(self, slot: int) -> int:
        """PRIVATE pages ``slot``'s live mapping holds (0 when unmapped,
        or in contiguous mode): what preempting the slot frees."""
        ent = self._slot_pages.get(slot)
        return 0 if ent is None else len(ent[0])

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of a device tensor. On CUDA it lands in pinned
        memory without blocking the host: later work on the same stream
        (a decode chunk writing the freed pages, a resume's copy back)
        runs after the copy has read its source."""
        if self.device.type != "cuda":
            return t.clone()
        src = _bytes(t)
        h = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        h.copy_(src, non_blocking=True)
        return h.view(t.dtype)

    def _to_device(self, h: torch.Tensor) -> torch.Tensor:
        return _bytes(h).to(self.device, non_blocking=True).view(h.dtype)

    def park_slot(self, slot: int, key: Any) -> List[Any]:
        """Swap ``slot`` out to the host tier under ``key``: gather its
        PRIVATE pages (storage form, bit-exact round trip) and its full
        state row (sampling key and, speculating, the drafter's ring
        included) into a host payload, retire the lane, free its pages,
        and park the payload. Shared copy-on-write prefix pages do not
        move: the slot drops its pin here and takes it again at resume
        (the registration's pin keeps them alive). The slot's mask row
        and adapter entry go back to the base, as at a release (JAX's
        engine leaves them until the slot is reused).

        Returns the keys the tier evicted to stay under
        ``host_swap_pages`` (possibly ``key`` itself): the caller resumes
        those by recompute. The caller must collect every chunk in
        flight first: a dispatched block table still maps the pages
        freed here."""
        self._check_poisoned()
        if not self._host_swap:
            raise ValueError(
                "park_slot without host_swap (EngineConfig.host_swap "
                "== False)")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        ent = self._slot_pages.get(slot)
        if ent is None:
            raise ValueError(
                f"slot {slot} has no page mapping — nothing to park")
        priv, shared, footprint = ent
        # the state row first: retire below flips its done flag
        row = {k: self._to_host(v[slot:slot + 1])
               for k, v in self.state.items()}
        blocks = gpt._cache_map(self._to_host,
                                gpt.cache_gather_pages(self.cache, priv))
        nbytes = sum(t.numel() * t.element_size() for t in (
            blocks.values() if isinstance(blocks, dict) else (blocks,)))
        payload = {
            "blocks": blocks, "state": row, "shared": list(shared),
            "n_priv": len(priv), "footprint": footprint,
            "mask": self._masks[slot].copy(),
            "adapter": self._adapter_virtual(int(self._adapter_ids[slot])),
        }
        # freeze the lane, then release its pages: the table row points
        # at the sink, which absorbs the frozen column's writes
        self.retire(slot)
        self._free_slot_pages(slot)
        self.set_slot_mask(slot, None)
        self._set_slot_adapter(slot, 0)
        self._page_alloc.note_swap_out(len(priv), nbytes)
        out: List[Any] = []
        for ek, e in self._host_tier.park(key, payload, len(priv), nbytes):
            self._page_alloc.note_swap_drop(e.n_pages, e.nbytes)
            out.append(ek)
        return out

    def resume_slot(self, slot: int, key: Any) -> None:
        """Swap ``key``'s parked conversation back into ``slot``: resolve
        its adapter, allocate fresh private pages and pin its shared
        ones, scatter the payload, restore the state row, the mask row
        and the adapter entry. The continued stream is the one the
        conversation would have emitted unparked, bit for bit. Raises
        ``KeyError`` when the payload was evicted (resume by recompute),
        :class:`PagesExhausted` when the pool is short and ``ValueError``
        on an adapter thrash; those three leave the payload parked. The
        wall time of the whole resume, synchronised by a value fetch,
        feeds the per-page swap-in EWMA. A failed scatter poisons the
        engine (the payload is consumed: the scheduler replays the
        conversation from its snapshot)."""
        self._check_poisoned()
        if not self._host_swap:
            raise ValueError(
                "resume_slot without host_swap (EngineConfig.host_swap "
                "== False)")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        if slot in self._slot_pages:
            raise ValueError(
                f"slot {slot} still holds a page mapping — free it "
                f"before resuming into it")
        ent = self._parked_entry(key)
        if ent is None:
            raise KeyError(
                f"{key!r} has no host payload (capacity-evicted or "
                f"never swap-parked) — resume by recompute")
        t0 = time.perf_counter()
        p = ent.payload
        n_priv, shared = p["n_priv"], p["shared"]
        if not self._page_alloc.can_alloc(n_priv):
            raise PagesExhausted(n_priv, self._page_alloc.free_pages)
        row = self._adapter_physical(p["adapter"])
        self._host_tier.take(key)
        priv = self._page_alloc.alloc(n_priv)
        self._page_alloc.share(shared)
        tab = np.full((self._max_pages,), SINK, np.int32)
        tab[:len(shared)] = shared
        tab[len(shared):len(shared) + n_priv] = priv
        self._tables[slot] = tab
        self._tables_dev = None
        self._page_alloc.used_tokens += p["footprint"]
        self._slot_pages[slot] = (priv, list(shared), p["footprint"])
        try:
            gpt.cache_insert_pages(
                self.cache, gpt._cache_map(self._to_device, p["blocks"]),
                [[q] for q in priv], page_size=self.engine_cfg.page_size)
            for k, v in p["state"].items():
                self.state[k][slot:slot + 1].copy_(v, non_blocking=True)
        except Exception:
            # the scatter writes the cache and the state: a failure may
            # have left part of them written, so poison until rebuild
            self._free_slot_pages(slot)
            self._poisoned = True
            raise
        if not np.array_equal(self._masks[slot], p["mask"]):
            self._masks[slot] = p["mask"]
            if p["mask"].all():
                self._masked_slots.discard(slot)
            else:
                self._masked_slots.add(slot)
            self._masks_dev = None
        self._set_slot_adapter(slot, row)
        self._page_alloc.note_swap_in(n_priv, ent.nbytes)
        int(self.state["tok"][slot])      # the value fetch: a sync
        sample = (time.perf_counter() - t0) / max(n_priv, 1)
        self._swap_in_ewma_s = (
            sample if self._swap_in_ewma_s <= 0.0
            else 0.7 * self._swap_in_ewma_s + 0.3 * sample)

    def drop_parked(self, key: Any) -> None:
        """Discard ``key``'s swap payload (a recompute resume, or a
        parked conversation that expired): accounting only. A no-op when
        absent."""
        if self._host_tier is None:
            return
        ent = self._host_tier.take(key)
        if ent is not None:
            self._page_alloc.note_swap_drop(ent.n_pages, ent.nbytes)

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host mirror's device copy. On CUDA it goes through pinned
        memory without blocking the host (the pinned buffer is a
        snapshot, so later edits of the mirror cannot race it)."""
        t = torch.from_numpy(host)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _table_device(self) -> torch.Tensor:
        """The block table on the device, rebuilt only after a row
        changed."""
        if self._tables_dev is None:
            self._tables_dev = self._upload(self._tables)
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
        if a.adapter:
            if not self._lora:
                raise ValueError(
                    f"admission carries adapter {a.adapter} but the "
                    f"adapter pool is disabled "
                    f"(EngineConfig.adapter_slots == 0)")
            if not 1 <= a.adapter < self._adapter_used:
                raise ValueError(
                    f"adapter {a.adapter} outside the registered rows "
                    f"[1, {self._adapter_used}) — register_adapter() "
                    f"first (0 is the pinned base adapter)")
            if a.prefix_page is not None:
                raise ValueError(
                    "prefix-pool hits require the base adapter (id "
                    "0): the pooled prefix was prefilled with base "
                    "weights, so an adapter-carrying hit would decode "
                    "against K/V a cold adapter prefill would not "
                    "produce")
        if a.prefix_page is not None:
            ps = a.prefix_len
            if not self._prefix_splits:
                raise ValueError(
                    "admission carries a prefix_page but the prefix "
                    "pool is disabled (EngineConfig.prefix_pool_slots "
                    "== 0)")
            if ps not in self._prefix_splits:
                raise ValueError(
                    f"prefix_len {ps} is not a usable split point "
                    f"{self._prefix_splits}")
            if not 0 <= a.prefix_page < self._prefix_used:
                raise ValueError(
                    f"prefix_page {a.prefix_page} outside the "
                    f"{self._prefix_used} registered pages")
            if prompt.size <= ps:
                raise ValueError(
                    f"prompt of {prompt.size} tokens leaves no tail "
                    f"beyond prefix_len {ps}")
            tb = self.bucket_for(prompt.size - ps)
            if (ps, tb) not in self._extend_variants:
                raise ValueError(
                    f"no extend variant for (split {ps}, tail bucket "
                    f"{tb}) — the combined block exceeds max_seq_len")
            stored = self._prefix_tokens[a.prefix_page]
            if tuple(int(x) for x in prompt[:ps]) != stored[:ps]:
                raise ValueError(
                    f"prompt[:{ps}] does not match the tokens "
                    f"registered on prefix page {a.prefix_page} — a "
                    f"mismatched copy would silently decode against "
                    f"another template's K/V")
        elif a.prefix_len:
            raise ValueError(
                "prefix_len without prefix_page — pass both (a "
                "match_prefix hit) or neither")
        if a.allowed_tokens is not None:
            # pre-flight: admit_many is all or nothing
            self._check_allowed_tokens(a.allowed_tokens)
        return prompt, prompt.size

    def _check_allowed_tokens(self, allowed: Sequence[int]) -> List[int]:
        """The whitelist check shared by the admission pre-flight and
        :meth:`set_slot_mask`."""
        allowed = [int(t) for t in allowed]
        if not allowed or any(not 0 <= t < self.cfg.vocab_size
                              for t in allowed):
            raise ValueError(
                f"allowed token whitelist must be a non-empty subset "
                f"of vocab [0, {self.cfg.vocab_size})")
        return allowed

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
        A prefix-pool hit (``prefix_page`` set) admits alone, through a
        tail extend at its tail bucket (``AdmitResult.bucket``). Per-row
        results equal single :meth:`admit` calls in the same order. The
        host reads the groups' first tokens after every group is
        launched. An injected ``admit`` error poisons the engine before
        any device work; an injected ``nan`` gives the rows of
        ``spec.slots`` (batch rows) the out-of-vocab first token
        ``spec.token``."""
        items = list(items)
        if not items:
            return []
        self._check_poisoned()
        spec = self._take_fault("admit")
        if spec is not None and spec.kind == KIND_ERROR:
            self._poisoned = True
            raise InjectedFault(
                f"injected device error at admit: {spec.describe()}",
                point="admit", spec=spec)
        validated = [self._validate_admission(a) for a in items]
        slots_used = [a.slot for a in items]
        if len(set(slots_used)) != len(slots_used):
            raise ValueError(
                f"admit_many slots must be distinct, got {slots_used}")
        if self._paged:
            # all or nothing: refuse the whole batch before any forward
            # when the pool cannot cover it
            total = sum(self.pages_needed(n, a.max_tokens, a.prefix_len)
                        for a, (_, n) in zip(items, validated))
            if not self._page_alloc.can_alloc(total):
                raise PagesExhausted(total, self._page_alloc.free_pages)
        try:
            pending = self._dispatch_groups(items, validated)
        except ValueError:
            raise       # an adapter thrash, refused before its group ran
        except Exception:
            # a failure mid-admission may have written part of the cache
            # and the state: poison until rebuild_slots()
            self._poisoned = True
            raise
        results: List[AdmitResult] = []
        for (first, first_lp, hit_eos, done), bucket, k, group in pending:
            first, first_lp = first.tolist(), first_lp.tolist()
            hit_eos, done = hit_eos.tolist(), done.tolist()
            for j in range(k):
                tok = int(first[j])
                if spec is not None and spec.kind == KIND_NAN \
                        and len(results) in spec.slots:
                    tok = spec.token    # a NaN prefill's garbage token
                results.append(AdmitResult(
                    tok, bool(hit_eos[j]), bool(done[j]),
                    bucket=bucket, batch_size=k, group=group,
                    logprob=float(first_lp[j])))
        return results

    def _dispatch_groups(self, items: List[Admission], validated):
        """Launch :meth:`admit_many`'s groups; returns each group's
        ``((first, first_lp, hit_eos, done), bucket, k, group)``, the
        device tensors unread."""
        cfg, dev = self.cfg, self.device
        pending = []
        i, group = 0, 0
        while i < len(items):
            if items[i].prefix_page is not None:
                # a hit runs its own tail extend, k=1: batched with cold
                # admissions it would pay the full prompt bucket again
                a, (prompt, n) = items[i], validated[i]
                pending.append((self._dispatch_prefix_admit(a, prompt, n),
                                self.bucket_for(n - a.prefix_len), 1,
                                group))
                i += 1
                group += 1
                continue
            run = i
            while run < len(items) and items[run].prefix_page is None:
                run += 1
            k = max(s for s in self._batch_sizes if s <= run - i)
            batch = items[i:i + k]
            proms = validated[i:i + k]
            bucket = self.bucket_for(max(n for _, n in proms))
            prompts = torch.as_tensor(
                np.stack([self.pad_prompt(p, bucket) for p, _ in proms]),
                device=dev)
            p_lens = torch.tensor([n for _, n in proms], dtype=torch.int64,
                                  device=dev)
            # the pool rows of the group's adapters (a cold one pages in
            # here, before the pool goes into the forward)
            phys = self._resolve_adapters([a.adapter for a in batch])
            # ONE padded forward admits the group; row i's logits and K/V
            # are exactly its solo prefill_at's
            blocks, logits0 = gpt.prefill_many(
                cfg, self._params, prompts, p_lens - 1, max_len=bucket,
                lora=self._lora_for(phys))
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
                gpt.cache_insert_slots(self.cache, blocks,
                                       [a.slot for a in batch])
            pending.append((self._start_slots(batch, [p for p, _ in proms],
                                              logits0, p_lens, phys),
                            bucket, k, group))
            self.admit_groups += 1
            i += k
            group += 1
        return pending

    def _start_slots(self, batch: Sequence[Admission], prompts, logits0,
                     p_lens, rows: Sequence[int]):
        """The admission's last step, whatever forward produced
        ``logits0 [k, vocab]``: each row draws its first token at
        ``p_lens - 1`` and its slot's state row is scattered (with the
        drafter's ring seeded from ``prompts`` on a speculative engine)
        and its adapter-id table entry set to its pool row (``rows``).
        Returns the ``(first, first_lp, hit_eos, done)`` device tensors,
        read by the caller once every group is launched."""
        dev, st = self.device, self.state
        k = len(batch)
        keys = torch.tensor(
            [sampling.request_key(a.seed, self._req_counter + j)
             for j, a in enumerate(batch)], dtype=torch.int64, device=dev)
        self._req_counter += k
        vec = lambda vals, dt: torch.tensor(vals, dtype=dt, device=dev)
        temp = vec([a.temperature for a in batch], torch.float32)
        top_k = vec([a.top_k for a in batch], torch.int64)
        top_p = vec([a.top_p for a in batch], torch.float32)
        max_tokens = vec([a.max_tokens for a in batch], torch.int64)
        eos = vec([_NO_EOS if a.eos_token_id is None
                   else int(a.eos_token_id) for a in batch], torch.int64)
        # each row's mask row is set before the draw that reads it
        # (unconstrained rows reset a stale one); the first draw takes
        # the rows only when one of them constrains
        for a, row in zip(batch, rows):
            self.set_slot_mask(a.slot, a.allowed_tokens)
            self._set_slot_adapter(a.slot, row)
        masks = None
        if any(a.allowed_tokens is not None for a in batch):
            masks = torch.as_tensor(
                np.stack([self._masks[a.slot] for a in batch]), device=dev)
            self.mask_uploads += 1
        first = sampling.draw_slots(logits0, keys, p_lens - 1, temp, top_k,
                                    top_p, masks=masks)
        first_lp = torch.log_softmax(logits0, dim=-1).gather(
            1, first[:, None])[:, 0]
        hit_eos = (eos >= 0) & (first == eos)
        done0 = hit_eos | (max_tokens <= 1)
        sl = vec([a.slot for a in batch], torch.int64)
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
                np.stack([self._hist_seed(p) for p in prompts]), device=dev)
            st["hist"][sl] = torch.cat([hist0, first[:, None]], dim=1)
        return first, first_lp, hit_eos, done0

    # -- the shared-prefix pool (EngineConfig.prefix_pool_slots > 0) -------

    def register_prefix(self, tokens) -> int:
        """Prefill a shared prompt prefix (a system-prompt template) ONCE
        into a pool page; returns the page index. The template is cut AT
        its largest usable split (every stored K/V position is real) and
        indexed at every smaller split too, so :meth:`match_prefix` can
        reuse the longest bucket-aligned piece a prompt shares. A
        template whose cut is already pooled returns its page (no device
        work). With a paged cache the block is also quantized ONCE into
        pinned cache pages that hits map copy-on-write. Raises when the
        pool is disabled, full, or the template is shorter than the
        smallest split; a failed insert resets the pool to empty."""
        if not self._prefix_splits:
            raise ValueError(
                "prefix pool disabled (EngineConfig.prefix_pool_slots "
                "== 0)")
        tokens = np.asarray(tokens, np.int64)
        if tokens.ndim != 1 or tokens.size < 1:
            raise ValueError("prefix template must be a 1-D token list")
        if tokens.min() < 0 or tokens.max() >= self.cfg.vocab_size:
            raise ValueError(
                f"prefix template tokens outside vocab "
                f"[0, {self.cfg.vocab_size})")
        usable = [b for b in self._prefix_splits if b <= tokens.size]
        if not usable:
            raise ValueError(
                f"prefix template of {tokens.size} tokens is shorter "
                f"than the smallest split bucket "
                f"{self._prefix_splits[0]} — nothing to pool")
        pb = max(usable)
        t = tuple(int(x) for x in tokens[:pb])
        hit = self._prefix_index.get(t)
        if hit is not None and hit[1] == pb:
            return hit[0]
        if self._prefix_used >= self.engine_cfg.prefix_pool_slots:
            raise ValueError(
                f"prefix pool full "
                f"({self.engine_cfg.prefix_pool_slots} pages)")
        page = self._prefix_used
        dev = self.device
        try:
            blocks, _ = gpt.prefill_many(
                self._cfg_compute, self._params,
                torch.as_tensor([t], device=dev),
                torch.full((1,), pb - 1, dtype=torch.int64, device=dev),
                max_len=pb)
            gpt.cache_insert_slot(self.pool, blocks, page)
        except Exception:
            # every registered page lives in the pool: after a failed
            # insert reset it and the registry to a clean empty state
            # (callers re-register) rather than trust its contents
            self._reset_prefix_pool()
            raise
        if self._paged:
            # page in the quantized prefix ONCE into pinned cache pages,
            # the copy-on-write master every hit maps read-only (the
            # registration holds one pin, so the pages outlive every
            # hit's release)
            p_sz = self.engine_cfg.page_size
            cache_pages = self._page_alloc.alloc(pb // p_sz)
            try:
                block = gpt.cache_gather_page(self.pool, page, pb)
                gpt.cache_insert_pages(
                    self.cache, gpt.quantize_cache_block(self.cfg, block),
                    torch.as_tensor([cache_pages], device=dev),
                    page_size=p_sz)
            except Exception:
                # the page-in writes the cache: a failure may have left
                # part of it written, so poison until rebuild_slots()
                self._page_alloc.free(cache_pages)
                self._poisoned = True
                raise
            self._prefix_pages[page] = cache_pages
            self._page_alloc.used_tokens += pb
        # the page is committed only after its inserts landed
        self._prefix_used += 1
        self._prefix_tokens[page] = t
        for b in usable:
            # the first registration wins a shorter shared key: the K/V
            # of tokens[:b] is the same whichever template stored it
            self._prefix_index.setdefault(t[:b], (page, b))
        return page

    def _reset_prefix_pool(self) -> None:
        """Empty the pool and its registry; the registrations' pins on
        cache pages drop (slots still sharing them keep their own)."""
        self._prefix_index.clear()
        self._prefix_tokens.clear()
        self._prefix_used = 0
        for pages in self._prefix_pages.values():
            self._page_alloc.free(pages)
            self._page_alloc.used_tokens -= len(pages) * \
                self.engine_cfg.page_size
        self._prefix_pages.clear()
        self.pool = self._pool_init()

    def match_prefix(self, prompt) -> Optional[Tuple[int, int]]:
        """Longest-split prefix-pool hit for ``prompt``: ``(page,
        split)`` such that ``prompt[:split]`` equals a pooled prefix,
        ``split`` is a usable split point, at least one tail token
        remains and the (split, tail bucket) variant exists — or None
        (cold prefill). Host work only."""
        if not self._prefix_index:
            return None
        t = tuple(int(x) for x in prompt)
        for split in sorted(self._prefix_splits, reverse=True):
            if split >= len(t):
                continue
            tb = self.bucket_for(len(t) - split)
            if (split, tb) not in self._extend_variants:
                continue
            hit = self._prefix_index.get(t[:split])
            if hit is not None:
                return hit[0], split
        return None

    def _dispatch_prefix_admit(self, a: Admission, prompt: np.ndarray,
                               n: int):
        """One prefix-hit admission: the pooled block, the tail's extend
        at its tail bucket, the first draw at ``n - 1``, the cache
        insert; returns the ``(first, first_lp, hit_eos, done)`` device
        tensors. A hit carries the base adapter (validated): the pooled
        prefix holds base-weight K/V, so the extend runs without one."""
        cfg, dev = self.cfg, self.device
        ps = a.prefix_len
        tb = self.bucket_for(n - ps)
        tails = np.full((1, tb), self.engine_cfg.pad_token_id, np.int64)
        tails[0, :n - ps] = prompt[ps:]
        block = gpt.cache_gather_page(self.pool, a.prefix_page, ps)
        if self._paged:
            # copy-on-write: the prefix pages are mapped into the row
            # and pinned; only the tail moves, into the private pages
            # from the page-aligned split on
            p_sz = self.engine_cfg.page_size
            row = self._alloc_slot_pages(
                a.slot, n, a.max_tokens, prefix_page=a.prefix_page,
                prefix_len=ps)
            n_tail = -(-tb // p_sz)
            pages = np.full((1, n_tail), SINK, np.int64)
            avail = row[ps // p_sz: ps // p_sz + n_tail]
            pages[0, :avail.size] = avail
        tail_kv, logits0 = gpt.prefill_extend(
            cfg, self._params, block, torch.as_tensor(tails, device=dev),
            torch.tensor([n - ps - 1], dtype=torch.int64, device=dev),
            prefix_len=ps)
        if self._paged:
            gpt.cache_insert_pages(
                self.cache,
                _pad_span(gpt.quantize_cache_block(cfg, tail_kv),
                          n_tail * p_sz),
                torch.as_tensor(pages, device=dev), page_size=p_sz)
        else:
            # the prefix block quantizes at the insert (the cold path's
            # quantizer on the same values), the tail lands after it:
            # together the bytes a cold admission of the prompt holds
            gpt.cache_insert_slot(
                self.cache, gpt.quantize_cache_block(cfg, block), a.slot)
            gpt.cache_insert_slot(
                self.cache, gpt.quantize_cache_block(cfg, tail_kv), a.slot,
                pos=ps)
        self.prefix_admits += 1
        return self._start_slots(
            [a], [prompt], logits0,
            torch.tensor([n], dtype=torch.int64, device=dev), [0])

    # -- chunked prefill (EngineConfig.prefill_chunk > 0) ------------------

    def admit_chunked_start(self, a: Admission) -> ChunkedAdmission:
        """Begin a chunked-prefill admission: validate, map the slot's
        pages (paged: :class:`PagesExhausted` fires here, before any
        device work) and run chunk 0, a bucket-sized cold prefill into
        the compute-dtype scratch. One chunked admission at a time (the
        scratch holds one prompt)."""
        self._check_poisoned()
        if not self._chunk_size:
            raise ValueError(
                "chunked prefill disabled "
                "(EngineConfig.prefill_chunk == 0)")
        if self._chunked is not None:
            raise RuntimeError(
                "a chunked admission is already in progress — the "
                "scratch buffer holds one prompt at a time")
        if a.prefix_page is not None:
            raise ValueError(
                "chunked prefill does not compose with prefix-pool "
                "hits (a hit already skips the prefix forward — "
                "nothing long is left to chunk)")
        prompt, n = self._validate_admission(a)
        c = self._chunk_size
        if n <= c:
            raise ValueError(
                f"prompt of {n} tokens fits one {c}-token chunk — use "
                f"admit_many")
        # the adapter's row (resolved first: a thrash raises before any
        # page moves) stays pinned while the admission chunks
        row = self._adapter_physical(a.adapter)
        if self._paged:
            self._alloc_slot_pages(a.slot, n, a.max_tokens)
        dev = self.device
        ca = ChunkedAdmission(a, prompt, n, -(-n // c))
        ca.adapter_row = row
        try:
            blocks, _ = gpt.prefill_many(
                self._cfg_compute, self._params,
                torch.as_tensor(prompt[None, :c], device=dev),
                torch.full((1,), c - 1, dtype=torch.int64, device=dev),
                max_len=c, lora=self._lora_for([ca.adapter_row]))
            gpt.cache_insert_slot(self._chunk_scratch, blocks, 0)
        except Exception:
            self._poisoned = True
            raise
        self.chunk_prefills += 1
        self._chunked = ca
        return ca

    def admit_chunked_step(self, ca: ChunkedAdmission
                           ) -> Optional[AdmitResult]:
        """Advance a chunked admission by one forward: the next chunk's
        ``prefill_extend`` over the scratch's first ``i * prefill_chunk``
        columns while prefilling (returns None), then the finish — the
        first draw from the last chunk's logits at ``p_len - 1``, the
        whole prompt block quantized and inserted where a cold admission
        puts it, the slot's state row — returning the
        :class:`AdmitResult`."""
        self._check_poisoned()
        if ca is not self._chunked:
            raise ValueError(
                "stale ChunkedAdmission — not the one in progress")
        try:
            return self._chunked_forward(ca)
        except Exception:
            self._poisoned = True
            self._chunked = None
            raise

    def _chunked_forward(self, ca: ChunkedAdmission
                         ) -> Optional[AdmitResult]:
        """:meth:`admit_chunked_step`'s one forward."""
        c, dev = self._chunk_size, self.device
        a = ca.admission
        if not ca.done_prefilling:
            i = ca.next_chunk
            chunk = ca.prompt[i * c: min((i + 1) * c, ca.p_len)]
            tail = np.full((1, c), self.engine_cfg.pad_token_id, np.int64)
            tail[0, :chunk.size] = chunk
            pfx = i * c
            tail_kv, ca._logits = gpt.prefill_extend(
                self.cfg, self._params, self._chunk_scratch[:, :, :, :, :pfx],
                torch.as_tensor(tail, device=dev),
                torch.tensor([chunk.size - 1], dtype=torch.int64,
                             device=dev),
                prefix_len=pfx,
                lora=self._lora_for([self._adapter_physical(a.adapter)]))
            gpt.cache_insert_slot(self._chunk_scratch, tail_kv, 0, pos=pfx)
            ca.next_chunk += 1
            self.chunk_prefills += 1
            return None
        blk = gpt.quantize_cache_block(self.cfg, self._chunk_scratch)
        if self._paged:
            p_sz = self.engine_cfg.page_size
            n_fin = -(-self.engine_cfg.max_prompt_len // p_sz)
            gpt.cache_insert_pages(
                self.cache, _pad_span(blk, n_fin * p_sz),
                torch.as_tensor(self._tables[a.slot][None, :n_fin],
                                device=dev), page_size=p_sz)
        else:
            gpt.cache_insert_slot(self.cache, blk, a.slot)
        first, first_lp, hit_eos, done = self._start_slots(
            [a], [ca.prompt], ca._logits,
            torch.tensor([ca.p_len], dtype=torch.int64, device=dev),
            [ca.adapter_row])
        self._chunked = None
        return AdmitResult(
            int(first[0]), bool(hit_eos[0]), bool(done[0]), bucket=c,
            batch_size=1, group=0, logprob=float(first_lp[0]))

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

    def step_async(self, *, spec: bool = False,
                   chunk: Optional[int] = None,
                   spec_k: Optional[int] = None) -> StepHandle:
        """Dispatch one decode chunk over every slot and return its
        :class:`StepHandle` without waiting for the device. ``spec=False``
        runs ``chunk`` plain steps (columns ``[B, chunk]``; a spec engine
        also shifts the emitted tokens into each slot's history ring).
        ``spec=True`` (needs a ``spec_ks`` rung) runs ``chunk``
        draft-verify waves of ``spec_k`` drafts each: columns ``[B, chunk
        * (spec_k + 1)]`` wave-major, with ``handle.valid`` marking the
        real emissions; it refuses while a slot's mask row constrains.
        ``chunk`` / ``spec_k`` pick rungs of ``EngineConfig.decode_chunks``
        / ``spec_ks`` (None = the base ``decode_chunk`` / ``spec_k``); a
        value off the ladder raises, as in JAX, where it would compile
        mid-serve. A plain chunk passes the mask rows to the draw only
        while one of them is not all-True, and either kind passes the
        adapter bundle only while a slot carries a nonzero adapter. An
        injected ``dispatch`` error poisons the engine before any device
        work; an injected hang rides the handle to its fetch."""
        self._check_poisoned()
        ecfg = self.engine_cfg
        n = ecfg.decode_chunk if chunk is None else int(chunk)
        if n not in self._chunk_ladder:
            raise ValueError(
                f"decode_chunk {n} is not a pre-warmed step variant "
                f"{self._chunk_ladder} — declare it in "
                f"EngineConfig.decode_chunks (dispatching it would "
                f"compile mid-serve)")
        if spec:
            if not self._spec:
                raise ValueError(
                    "step_async(spec=True) needs a compiled spec "
                    "variant (EngineConfig.spec_k > 0 or spec_ks)")
            k = ecfg.spec_k if spec_k is None else int(spec_k)
            if k not in self._spec_ladder:
                raise ValueError(
                    f"spec_k {k} (at decode_chunk {n}) is not a "
                    f"pre-warmed spec variant — declare it in "
                    f"EngineConfig.spec_ks {self._spec_ladder}")
        elif spec_k not in (None, 0):
            raise ValueError(
                f"spec_k={spec_k} without spec=True — a plain chunk "
                f"has no draft width")
        if spec and self._masked_slots:
            raise ValueError(
                f"step_async(spec=True) with constrained slots "
                f"{sorted(self._masked_slots)}: the verify wave draws "
                f"without vocab masks, so constrained traffic decodes "
                f"plain chunks")
        fspec = self._take_fault("dispatch")
        if fspec is not None and fspec.kind == KIND_ERROR:
            self._poisoned = True
            raise InjectedFault(
                f"injected device error at dispatch: {fspec.describe()}",
                point="dispatch", spec=fspec)
        fault_kw = dict(
            plan=self.fault_plan, on_poison=self._mark_poisoned,
            hang=fspec if fspec is not None and fspec.kind == KIND_HANG
            else None)
        table = self._table_device() if self._paged else None
        lora = self._lora_decode()
        if spec:
            (self.cache, self.state, toks, lps, fins,
             valid) = gpt.decode_steps_spec(
                self.cfg, self._params, self.cache, self.state, n,
                spec_k=k, pad_token_id=ecfg.pad_token_id,
                table=table, lora=lora)
            self.spec_waves_taken += n
            return StepHandle(toks, lps, fins, valid=valid, spec_k=k,
                              ncols=n * (k + 1), **fault_kw)
        pos0 = self.state["pos"]
        self.cache, self.state, toks, lps, fins = gpt.decode_steps(
            self.cfg, self._params, self.cache, self.state, n,
            pad_token_id=ecfg.pad_token_id, masks=self._masks_device(),
            table=table, lora=lora)
        if self._spec:
            # keep the drafter's ring fresh across plain chunks too: each
            # row emitted pos_after - pos_before columns, a prefix
            self.state["hist"] = gpt.shift_hist(
                self.state["hist"], toks, self.state["pos"] - pos0)
        self.decode_steps_taken += n
        return StepHandle(toks, lps, fins, ncols=n, **fault_kw)

    def _masks_device(self) -> Optional[torch.Tensor]:
        """The decode steps' ``[B, vocab]`` mask, or None while every row
        is all-True (the two draw the same tokens, and None launches
        nothing for the mask). Uploaded again only after a row
        changed."""
        if not self._masked_slots:
            return None
        if self._masks_dev is None:
            self._masks_dev = torch.as_tensor(self._masks,
                                              device=self.device)
            self.mask_uploads += 1
        return self._masks_dev

    def set_slot_mask(self, slot: int,
                      allowed: Optional[Sequence[int]] = None) -> None:
        """Replace ``slot``'s constrained-decoding vocab mask with the
        whitelist ``allowed`` (None = unconstrained, all-True). The
        schema automaton advances on the host for each emitted token; the
        scheduler calls this between dispatches, so the next decode step
        draws against the advanced row. An unchanged row keeps the
        device copy."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        if allowed is None:
            if slot not in self._masked_slots:
                return
            self._masks[slot, :] = True
            self._masked_slots.discard(slot)
        else:
            allowed = self._check_allowed_tokens(allowed)
            row = np.zeros((self.cfg.vocab_size,), bool)
            row[allowed] = True
            if (self._masks[slot] == row).all():
                return
            self._masks[slot] = row
            if row.all():
                self._masked_slots.discard(slot)
            else:
                self._masked_slots.add(slot)
        self._masks_dev = None

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One plain decode chunk over every slot — ``decode_chunk``
        steps — fetched to the host. Returns ``(tokens [B, n], logprobs
        [B, n], finished [B, n])``; column ``j`` holds step ``j``'s
        emissions, ``pad_token_id`` for slots that were done entering
        it."""
        return self.step_async().fetch()

    def retire(self, slot: int) -> None:
        """Force ``slot`` done (deadline expiry): its lane keeps riding the
        decode batch emitting pad until the next admission. The
        ``retire`` fault seam (a park retires its lane through here)."""
        self._check_poisoned()
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        spec = self._take_fault("retire")
        if spec is not None and spec.kind == KIND_ERROR:
            self._poisoned = True
            raise InjectedFault(
                f"injected device error at retire: {spec.describe()}",
                point="retire", spec=spec)
        self.state["done"][slot] = True

    # -- failure isolation (serving.resilience) ----------------------------

    def _take_fault(self, point: str) -> Optional[FaultSpec]:
        plan = self.fault_plan
        return None if plan is None else plan.take(point)

    def _mark_poisoned(self) -> None:
        self._poisoned = True

    def _check_poisoned(self) -> None:
        if self._poisoned:
            raise EngineFault(
                "engine state is poisoned (a prior fault invalidated "
                "the cache/state buffers); call rebuild_slots() "
                "before the next device call")

    @property
    def poisoned(self) -> bool:
        """True after a fault invalidated the cache and state (every
        device call raises until :meth:`rebuild_slots`)."""
        return self._poisoned

    def rebuild_slots(self) -> None:
        """Recovery: every slot comes back free, in place — the cache
        zeroed (paged: every page but the registered prefixes' pinned
        pages, whose contents survive), the slot state reset to its free
        values, the block tables at the sink page, the vocab masks
        all-True, the adapter-id table at 0. Nothing is allocated: the
        existing tensors, and their device copies, are written, in stream
        order after every chunk already queued (a handle from before the
        rebuild must be dropped, never fetched). The prefix pool, the
        adapter pool and the host tier's parked conversations survive;
        the scheduler replays interrupted requests from its host-side
        records (:mod:`.resilience`)."""
        if self._paged:
            # freeing a slot drops the table's device copy; the rebuild
            # keeps it and writes the sink rows into it instead
            tables_dev = self._tables_dev
            for slot in list(self._slot_pages):
                self._free_slot_pages(slot)
            self._tables[:, :] = SINK
            self._tables_dev = tables_dev
            if tables_dev is not None:
                tables_dev.fill_(SINK)
        self._chunked = None
        keep = {p for pages in self._prefix_pages.values() for p in pages}
        planes = (self.cache.values() if isinstance(self.cache, dict)
                  else (self.cache,))
        if keep:
            zero = torch.tensor(
                [p for p in range(self._num_pages) if p not in keep],
                dtype=torch.int64, device=self.device)
            for t in planes:
                _bytes(t).index_fill_(2, zero, 0)
        else:
            for t in planes:
                _bytes(t).zero_()
        for k, (_, _, fill) in self._state_spec().items():
            self.state[k].fill_(fill)
        if self._chunk_scratch is not None:
            self._chunk_scratch.zero_()
        self._masks[:, :] = True
        self._masked_slots.clear()
        if self._masks_dev is not None:
            self._masks_dev.fill_(True)
        self._adapter_ids[:] = 0
        if self._aids_dev is not None:
            self._aids_dev.zero_()
        self._poisoned = False
