"""Slot-based continuous-batching decode engine — the device loop.

Port of ``apex_tpu/serving/engine.py`` (its contiguous-cache core). A
fixed batch of ``B`` decode *slots* shares one KV cache ``[L, 2, B,
heads, max_seq_len, d]``, and requests flow through the slots. All
per-request state the device needs — position, remaining budget, done
flag, eos id, temperature / top-k / top-p and the sampling key — lives
in ``[B]`` tensors on the device:

- :meth:`Engine.admit_many` — a group of queued requests is prefilled in
  ONE forward (``gpt.prefill_many`` over a ``[k, bucket]`` batch of
  right-padded prompts, ``bucket`` the smallest prompt bucket that fits
  the group), each row draws its first token at ``p_len - 1``, the k
  cache blocks are inserted into their slots and the k state rows are
  scattered;
- :meth:`Engine.step` — one ``gpt.decode_steps`` chunk of
  ``decode_chunk`` steps over every slot;
- :meth:`Engine.retire` — force a slot done (deadline expiry).

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
    "spec_k": (0, "speculative decoding"),
    "spec_hist": (32, "speculative decoding"),
    "prefix_pool_slots": (0, "the prefix pool"),
    "page_size": (0, "the paged KV cache"),
    "num_pages": (0, "the paged KV cache"),
    "prefill_chunk": (0, "chunked prefill"),
    "decode_chunks": (None, "the self-tuning scheduler"),
    "spec_ks": (None, "speculative decoding"),
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
    ``slots``). The JAX engine's other fields keep their names and
    defaults here; setting one raises, naming the later slice it
    belongs to."""

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


class Engine:
    """The slot engine on one device (``device=None`` → CUDA; without a
    CUDA device it raises — pass ``device="cpu"`` to mean the CPU).

    ``params`` must live on that device; the engine casts the matmul
    weights to compute dtype once (:func:`gpt.cast_params`) and owns the
    cache and the slot-state tensors. Counters: ``decode_steps_taken``
    (single-token decode steps over the slot batch) and
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
        self.admit_groups = 0
        B, dev = ecfg.slots, self.device
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
        }

    def cache_bytes(self) -> int:
        return self.cache.numel() * self.cache.element_size()

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

    # -- decode ------------------------------------------------------------

    def step(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One decode chunk over every slot — ``decode_chunk`` steps —
        fetched to the host. Returns ``(tokens [B, n], logprobs [B, n],
        finished [B, n])``; column ``j`` holds step ``j``'s emissions,
        ``pad_token_id`` for slots that were done entering it."""
        n = self.engine_cfg.decode_chunk
        self.cache, self.state, toks, lps, fins = gpt.decode_steps(
            self.cfg, self._params, self.cache, self.state, n,
            pad_token_id=self.engine_cfg.pad_token_id)
        self.decode_steps_taken += n
        return (toks.cpu().numpy(), lps.cpu().numpy(), fins.cpu().numpy())

    def retire(self, slot: int) -> None:
        """Force ``slot`` done (deadline expiry): its lane keeps riding the
        decode batch emitting pad until the next admission."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        self.state["done"][slot] = True
