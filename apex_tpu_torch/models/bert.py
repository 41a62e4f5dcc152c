"""BERT encoder + MLM head — BERT-large pretraining with FusedLAMB and the
fused LayerNorm.

Port of ``apex_tpu/models/bert.py`` at tp=1: ``BertConfig``, ``init``,
``_embed``, ``hidden_states``, ``mlm_logits``, ``mlm_loss`` and
``make_mlm_train_step``. The encoder is the GPT stack of
:mod:`apex_tpu_torch.models.gpt` (``gpt._embed``, ``gpt._block``,
``gpt._cast_layer``) with bidirectional attention (``causal=False``),
plus BERT's token-type embedding and embedding LayerNorm and the MLM head
tied to the word table. The parameter dict keeps the JAX tree's names and
shapes, so a JAX checkpoint crosses by :func:`params_from_numpy`.

The three BERT-level norms (embedding, final, MLM head) always run the
LayerNorm kernel (:func:`apex_tpu_torch.kernels.layer_norm`), as the JAX
model calls its Pallas kernel whatever ``ln_impl`` says; the blocks'
``ln1``/``ln2`` follow ``ln_impl``. With ``remat`` each block runs under
``torch.utils.checkpoint`` with nothing saved inside it (BERT ignores
``remat_policy``, as in JAX), so the backward replays the whole block,
flash forward and LayerNorms included.

At tp=1 ``copy_to_tensor_model_parallel_region`` is the identity;
``sequence_parallel`` and ``fsdp`` raise (the distributed slices of
BERT at tp > 1 and of ZeRO and FSDP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch import _tree
from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.kernels.layer_norm import layer_norm
from apex_tpu_torch.models import gpt
from apex_tpu_torch.models import training as _training
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

#: the weight bridge is the GPT one: nested dicts of numpy arrays
params_from_numpy = gpt.params_from_numpy
params_to_numpy = gpt.params_to_numpy


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Every field of the JAX ``BertConfig`` with its default (BERT-large);
    dtype fields hold torch dtypes."""

    vocab_size: int = 30528
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    seq_len: int = 512
    type_vocab_size: int = 2
    sequence_parallel: bool = False
    remat: bool = True
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    layernorm_epsilon: float = 1e-12
    init_std: float = 0.02
    axis: str = "tp"
    remat_policy: Any = None
    attn_impl: str = "auto"
    attn_layout: str = "auto"
    ln_impl: str = "xla"
    attn_score_dtype: str = "f32"
    scan_unroll: Any = 1
    fsdp: bool = False

    def __post_init__(self):
        for name, on, later in (
                ("sequence_parallel", self.sequence_parallel,
                 "BERT at tp > 1"), ("fsdp", self.fsdp, "ZeRO and FSDP")):
            if on:
                raise ValueError(f"{name} is not supported by apex_tpu_torch "
                                 f"yet (the distributed slice of {later}, "
                                 "ROADMAP queue 1 item 4)")
        self.core()      # the core config's own checks

    def core(self) -> gpt.GPTConfig:
        return gpt.GPTConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            seq_len=self.seq_len, remat=self.remat,
            compute_dtype=self.compute_dtype, param_dtype=self.param_dtype,
            layernorm_epsilon=self.layernorm_epsilon,
            init_std=self.init_std, axis=self.axis, causal=False,
            remat_policy=self.remat_policy, attn_impl=self.attn_impl,
            attn_layout=self.attn_layout, ln_impl=self.ln_impl,
            attn_score_dtype=self.attn_score_dtype,
            scan_unroll=self.scan_unroll)

    def param_count(self) -> int:
        h = self.hidden_size
        bert_only = (self.type_vocab_size * h + 2 * h      # type emb + LN
                     + h * h + h + 2 * h + self.vocab_size)  # MLM head
        return self.core().param_count() + bert_only


def init(cfg: BertConfig, generator: torch.Generator, *,
         device: Optional[Union[str, torch.device]] = None
         ) -> Dict[str, Any]:
    """``gpt.init``'s tree plus ``embedding.token_type`` and
    ``embedding.ln``, and ``mlm_head`` (``dense``, ``ln``, the per-vocab
    ``bias``): normal(0, ``init_std``) weights, zero biases, unit
    LayerNorm scales, in ``param_dtype``. Draws come from ``generator``,
    which must live on ``device`` (None → CUDA)."""
    dev = resolve_device(device)
    core = gpt.init(cfg.core(), generator, device=dev)
    h, dt = cfg.hidden_size, cfg.param_dtype

    def normal(shape):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        return t.normal_(0.0, cfg.init_std, generator=generator).to(dt)

    zeros = lambda n: torch.zeros(n, dtype=dt, device=dev)
    ones = lambda n: torch.ones(n, dtype=dt, device=dev)
    core["embedding"]["token_type"] = normal((cfg.type_vocab_size, h))
    core["embedding"]["ln"] = {"scale": ones(h), "bias": zeros(h)}
    core["mlm_head"] = {
        "dense": {"kernel": normal((h, h)), "bias": zeros(h)},
        "ln": {"scale": ones(h), "bias": zeros(h)},
        "bias": zeros(cfg.vocab_size),
    }
    return core


def _embed(cfg: BertConfig, params, tokens, token_type_ids):
    """Word + position (``gpt._embed``) + token type, then the embedding
    LayerNorm → ``[b, s, hidden]`` in compute dtype."""
    h = gpt._embed(cfg.core(), params, tokens)
    tt = F.embedding(token_type_ids.long(), params["embedding"]["token_type"])
    h = h + tt.to(cfg.compute_dtype)
    ln = params["embedding"]["ln"]
    return layer_norm(h, ln["scale"], ln["bias"], eps=cfg.layernorm_epsilon)


def hidden_states(cfg: BertConfig, params, tokens, token_type_ids=None):
    """``[b, s]`` ids → final hidden ``[b, s, hidden]`` (after the final
    LayerNorm)."""
    core = cfg.core()
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(tokens)
    h = _embed(cfg, params, tokens, token_type_ids)
    layers = gpt._layers(params)
    body = lambda layer_p, x: gpt._block(core, gpt._cast_layer(core, layer_p),
                                         x)
    remat = cfg.remat and torch.is_grad_enabled() and (h.requires_grad or any(
        t.requires_grad for t in _tree.leaves(layers)))
    for layer_p in layers:
        h = (checkpoint(body, layer_p, h, use_reentrant=False,
                        preserve_rng_state=False)
             if remat else body(layer_p, h))
    ln = params["final_ln"]
    return layer_norm(h, ln["scale"], ln["bias"], eps=cfg.layernorm_epsilon)


def mlm_logits(cfg: BertConfig, params, tokens, token_type_ids=None):
    """MLM logits ``[b, s, vocab]`` in compute dtype: dense → tanh GELU →
    LayerNorm → the tied word table, plus the per-vocab bias."""
    h = hidden_states(cfg, params, tokens, token_type_ids)
    head = params["mlm_head"]
    cdt = cfg.compute_dtype
    h = torch.matmul(h, head["dense"]["kernel"].to(cdt))
    h = F.gelu(h + head["dense"]["bias"].to(cdt), approximate="tanh")
    h = layer_norm(h, head["ln"]["scale"], head["ln"]["bias"],
                   eps=cfg.layernorm_epsilon)
    table = params["embedding"]["word"]["table"].to(cdt)
    return torch.matmul(h, table.t()) + head["bias"].to(cdt)


def mlm_loss(cfg: BertConfig, params, tokens, targets, mlm_mask,
             token_type_ids=None):
    """Masked-LM loss: the mean cross entropy (fp32 logits) over the
    positions where ``mlm_mask`` is 1. ``tokens``, ``targets`` and
    ``mlm_mask`` are ``[b, s]``."""
    lg = mlm_logits(cfg, params, tokens, token_type_ids).float()
    per_tok = vocab_parallel_cross_entropy(lg, targets, 0.0)
    w = mlm_mask.float()
    return torch.sum(per_tok * w) / torch.clamp(torch.sum(w), min=1.0)


def make_mlm_train_step(cfg: BertConfig, optimizer, scaler_cfg=None, *,
                        clip_grad_norm: Optional[float] = None,
                        device: Optional[Union[str, torch.device]] = None):
    """``(init_fn, step_fn)`` for MLM pretraining on one device, through
    :func:`~apex_tpu_torch.models.training.make_loss_train_step`.
    ``init_fn(generator)`` builds the state on ``device`` (None → CUDA);
    ``step_fn(state, tokens, targets, mlm_mask) -> (state, metrics)``."""
    dev = resolve_device(device)

    def loss_fn(p, tokens, targets, mlm_mask):
        return mlm_loss(cfg, p, tokens, targets, mlm_mask)

    return _training.make_loss_train_step(
        loss_fn, optimizer, init_params=lambda g: init(cfg, g, device=dev),
        scaler_cfg=scaler_cfg, clip_grad_norm=clip_grad_norm,
        n_batch_args=3, device=dev)
