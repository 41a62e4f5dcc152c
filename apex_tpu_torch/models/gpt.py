"""GPT — the serving and training slices of ``apex_tpu/models/gpt.py``.

The model is plain functions over a parameter dict that keeps the JAX
tree's names and shapes (layer parameters stacked on a leading layer
axis, the fused QKV weight as the ``[h, 3, h]`` slab), so a JAX
checkpoint crosses over by :func:`params_from_numpy` with no remapping.
Layout is batch-major ``[batch, seq, hidden]``, the flash kernel's
operand layout.

What the port carries: the forward (:func:`logits`), the training loss
(:func:`loss`, :func:`hidden_states_and_aux`, the chunked cross entropy
of :func:`_ce_of_hidden`, the layer loop :func:`_scan_blocks` under
``remat`` / ``remat_policy``), bulk prefill (:func:`prefill`,
:func:`prefill_at`, :func:`prefill_many`; :func:`prefill_extend`, the
tail over a prefilled prefix), KV-cache decode
(:func:`decode_step`, :func:`decode_steps`, both over the contiguous
cache or, with a block ``table``, the paged pool, each in compute dtype
or quantized to int8 / fp8 by ``kv_cache_dtype``), speculative decoding
(:func:`ngram_drafts`, :func:`shift_hist`, :func:`decode_verify`,
:func:`decode_steps_spec`), the cache seams (:func:`init_cache`,
:func:`cache_insert_slot(s)`, :func:`cache_insert_pages`,
:func:`cache_gather_page`, :func:`quantize_cache_block`, :func:`dequantize_cache_block`),
:func:`generate`, the solo oracle of the serving engine, and
:func:`beam_search`. Batched multi-LoRA (:func:`init_lora_pool`,
:func:`lora_set_row`, :func:`init_lora_weights`, :func:`merge_lora`) rides
every serving forward as ``lora=(pool, ids, scale)``: each row's adapter
delta at the four dense seams, the pool gathered by ``ids`` once a call.

Tensor and sequence parallelism: the training functions (:func:`loss`,
:func:`logits`, :func:`hidden_states_and_aux`) take ``mesh=``, a
:class:`~apex_tpu_torch.mesh.Mesh` whose ``cfg.axis`` (tp) spans more
than one rank, and then run on this rank's shards as JAX's do inside
``shard_map``: the vocab-parallel embedding and head, the column- and
row-parallel QKV/proj and fc1/fc2 pairs through the mappings of
:mod:`apex_tpu_torch.transformer.tensor_parallel`, with the activations
sharded on the sequence between blocks under ``cfg.sequence_parallel``.
:func:`param_specs` says how each parameter shards, :func:`shard_params`
cuts the global tree into a rank's shards and :func:`gather_params`
puts them back together. Without a mesh (or over a tp axis of one rank)
every function is the JAX package's at tp=1, with two differences of
idiom:

- the KV cache is updated IN PLACE wherever the JAX function returns a
  new (donated) cache; the functions still return it, so call sites read
  the same;
- random numbers come from explicit ``torch.Generator`` objects (init)
  and from the counter-based draw of :mod:`apex_tpu_torch.serving.sampling`.

Attention dispatch: ``attn_impl="flash"`` runs the port's flash kernels
— the lane-packed :func:`apex_tpu_torch.kernels.flash_attention_bsh`
where it takes the shape and ``attn_layout="auto"``, else the head-major
``kernels.flash_attention.flash_attention`` (:func:`_attention_ctx`) —
``"xla"`` the materialised-scores expression of ``_xla_attn_probs``;
``"auto"`` is ``"flash"`` on CUDA at every length and ``"xla"`` on the
CPU.
``decode_attn_impl="kernel"`` runs the port's flash-decode kernels,
``"xla"`` the one-hot/materialised form; ``"auto"`` is ``"kernel"`` on
CUDA at every horizon and ``"xla"`` on the CPU. On the CPU an explicit
``"flash"``/``"kernel"`` runs the kernels' plain versions.

Remat: ``remat=True`` wraps each layer in ``torch.utils.checkpoint``
(non-reentrant). ``remat_policy=None`` saves nothing inside the layer,
so the backward replays all of it, the flash forward included; a named
policy is a selective-checkpoint policy (:func:`_remat_policy`) that
saves the outputs the JAX policy names — a flash forward op's
``(out, lse)`` under ``"qkv_fc1_attn"``/``"fc1_attn"``, so the backward
never re-runs that kernel.

The stacked layer parameters are unbound once per forward
(:func:`_layers`), never indexed per layer: under autograd each index
would write a zero tensor the size of the whole stack in the backward,
where the backward of ``unbind`` is one ``stack``.

Configuration fields of later slices raise a ``ValueError`` naming the
slice (see :class:`GPTConfig`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from apex_tpu_torch import _tree
from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.kernels import decode_attention, flash_attention_bsh
from apex_tpu_torch.kernels.decode_attention import (
    _bytes,
    cache_write_columns,
    cache_write_columns_quant,
    cache_write_columns_xla,
    decode_attention_quantized,
    decode_verify_attention,
    dequantize_kv,
    kv_storage_dtype,
    paged_attention_quantized,
    paged_decode_attention,
    paged_gather_planes,
    paged_gather_xla,
    paged_verify_attention,
    paged_write_column_quant,
    paged_write_columns,
    paged_write_columns_quant,
    paged_write_columns_xla,
    quantize_kv_rows,
    verify_route,
)
from apex_tpu_torch.kernels.flash_attention import (
    FLASH_FWD_OP,
    FLASH_HM_FWD_OP,
    flash_attention,
)
from apex_tpu_torch.kernels.layer_norm import layer_norm
from apex_tpu_torch.kernels.xentropy import softmax_cross_entropy
from apex_tpu_torch.mesh.sharding import gather_tree, shard_tree
from apex_tpu_torch.mesh.topology import Mesh, PartitionSpec as P
from apex_tpu_torch.serving import sampling as _sampling
from apex_tpu_torch.transformer.tensor_parallel import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)

#: sentinel in per-slot ``eos`` vectors: no stop token for this row
NO_EOS = -1


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model config. Every field name of the JAX ``gpt.GPTConfig`` is
    here with the same default; dtype fields hold torch dtypes.
    ``remat``, ``remat_policy`` and ``ce_chunk`` shape the training loss
    as in JAX; ``scan_unroll`` has no counterpart (the layer loop is a
    Python loop). Options that belong to later slices of the port raise
    at construction: context parallelism and experts (the distributed
    slice of CP and MoE), FSDP (that of ZeRO and FSDP) and chunked XLA
    attention. ``sequence_parallel`` acts where a mesh's tp axis
    spans more than one rank (see :func:`loss`).
    ``attn_layout`` is ``"auto"`` (the lane-packed flash kernels where
    they take the shape, else the head-major ones) or ``"bhsd"`` (always
    the head-major ones); see :func:`_attention_ctx`.
    ``ln_impl="pallas"`` is the port's LayerNorm kernel
    (:mod:`apex_tpu_torch.kernels.layer_norm`); ``kv_cache_dtype`` is
    ``"auto"``, ``"bf16"`` or ``"compute"`` (the unquantized cache in
    compute dtype) or ``"int8"`` / ``"fp8"`` (the quantized cache, see
    :func:`init_cache`)."""

    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    seq_len: int = 1024
    ffn_hidden_size: Optional[int] = None
    sequence_parallel: bool = False
    remat: bool = True
    remat_policy: Optional[str] = None
    ce_chunk: int = 0
    ce_impl: str = "xla"
    attn_impl: str = "auto"
    scan_unroll: Any = 1
    attn_layout: str = "auto"
    ln_impl: str = "xla"
    attn_score_dtype: str = "f32"
    decode_attn_impl: str = "auto"
    kv_cache_dtype: str = "auto"
    context_parallel: bool = False
    cp_axis: str = "cp"
    cp_zigzag: bool = False
    causal: bool = True
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_dispatch: str = "auto"
    ep_axis: str = "ep"
    fsdp: bool = False
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    layernorm_epsilon: float = 1e-5
    init_std: float = 0.02
    axis: str = "tp"

    def __post_init__(self):
        later = []
        if self.context_parallel:
            later.append("context_parallel (the distributed slice of CP "
                         "and MoE, ROADMAP queue 1 item 4)")
        if self.fsdp:
            later.append("fsdp (the distributed slice of ZeRO and FSDP, "
                         "ROADMAP queue 1 item 4)")
        if self.num_experts > 0:
            later.append("num_experts > 0 (the distributed slice of CP "
                         "and MoE, ROADMAP queue 1 item 4)")
        if self.attn_impl == "xla_chunked":
            later.append("attn_impl='xla_chunked' (the long-context "
                         "slice)")
        if later:
            raise ValueError(
                "not supported by apex_tpu_torch yet: " + "; ".join(later))
        for name, value, allowed in (
                ("attn_impl", self.attn_impl, ("auto", "flash", "xla")),
                ("attn_layout", self.attn_layout, ("auto", "bhsd")),
                ("ln_impl", self.ln_impl, ("xla", "pallas")),
                ("ce_impl", self.ce_impl, ("xla", "fused")),
                ("attn_score_dtype", self.attn_score_dtype,
                 ("f32", "compute")),
                ("decode_attn_impl", self.decode_attn_impl,
                 ("auto", "kernel", "xla")),
                ("kv_cache_dtype", self.kv_cache_dtype,
                 ("auto", "bf16", "compute", "int8", "fp8"))):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}")

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must divide by num_heads")
        return self.hidden_size // self.num_heads

    def param_count(self) -> int:
        h, f, L = self.hidden_size, self.ffn, self.num_layers
        per_layer = 4 * h + (h * 3 * h + 3 * h) + (h * h + h)
        per_layer += (h * f + f) + (f * h + h)
        return self.vocab_size * h + self.seq_len * h + L * per_layer + 2 * h


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init(cfg: GPTConfig, generator: torch.Generator, *,
         device: Optional[Union[str, torch.device]] = None
         ) -> Dict[str, Any]:
    """The global parameter dict — ``gpt.init``'s tree, names and shapes:
    normal(0, ``init_std``) weights, ``init_std / sqrt(2L)`` on
    ``proj``/``fc2``, zero biases, unit LayerNorm scales, in
    ``param_dtype``. Draws come from ``generator``, which must live on
    ``device`` (None → CUDA; see :func:`resolve_device`)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(
            f"generator on {generator.device} but device is {dev}")
    h, f, L, V = cfg.hidden_size, cfg.ffn, cfg.num_layers, cfg.vocab_size
    dt = cfg.param_dtype
    std, out_std = cfg.init_std, cfg.init_std / math.sqrt(2.0 * L)

    def normal(shape, s):
        t = torch.empty(shape, dtype=torch.float32, device=dev)
        return t.normal_(0.0, s, generator=generator).to(dt)

    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=dev)
    return {
        "embedding": {"word": {"table": normal((V, h), std)},
                      "position": normal((cfg.seq_len, h), std)},
        "layers": {
            "ln1": {"scale": ones(L, h), "bias": zeros(L, h)},
            "attn": {
                "qkv": {"kernel": normal((L, h, 3, h), std),
                        "bias": zeros(L, 3, h)},
                "proj": {"kernel": normal((L, h, h), out_std),
                         "bias": zeros(L, h)},
            },
            "ln2": {"scale": ones(L, h), "bias": zeros(L, h)},
            "mlp": {
                "fc1": {"kernel": normal((L, h, f), std),
                        "bias": zeros(L, f)},
                "fc2": {"kernel": normal((L, f, h), out_std),
                        "bias": zeros(L, h)},
            },
        },
        "final_ln": {"scale": ones(h), "bias": zeros(h)},
    }


def params_from_numpy(tree, *, device: Optional[Union[str, torch.device]]
                      = None) -> Dict[str, Any]:
    """The JAX ``gpt.init`` tree as nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) → the port's parameter dict,
    same names, shapes and values, copied onto ``device`` (None →
    CUDA). bfloat16 arrays (numpy's ml_dtypes extension type) cross via
    float32, which holds them exactly."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return _tree_map(conv, tree)


def lora_pool_from_numpy(tree, *, device: Optional[Union[str, torch.device]]
                         = None) -> Dict[str, Any]:
    """A LoRA pool as nested dicts of numpy arrays (JAX's
    ``init_lora_pool`` / ``lora_set_row`` result through ``np.asarray``)
    → the port's pool on ``device``, by :func:`params_from_numpy`'s
    conversion."""
    return params_from_numpy(tree, device=device)


def lora_pool_to_numpy(pool) -> Dict[str, Any]:
    """The reverse of :func:`lora_pool_from_numpy` (bfloat16 as
    float32)."""
    return params_to_numpy(pool)


def params_to_numpy(params) -> Dict[str, Any]:
    """The reverse of :func:`params_from_numpy`: nested dicts of numpy
    arrays on the host (bfloat16 tensors come back as float32)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _tree_map(conv, params)


def param_specs(cfg: GPTConfig) -> Dict[str, Any]:
    """The :class:`~apex_tpu_torch.mesh.PartitionSpec` of every
    parameter, mirroring :func:`init`'s tree (layer dim leading): JAX's
    ``gpt.param_specs`` without pipeline or FSDP. The fused QKV slab and
    fc1 shard their output columns over tp, ``proj`` and fc2 their input
    rows, the word table its vocab rows; the rest is replicated."""
    t = cfg.axis
    return {
        "embedding": {"word": {"table": P(t, None)},
                      "position": P(None, None)},
        "layers": {
            "ln1": {"scale": P(None), "bias": P(None)},
            "attn": {
                "qkv": {"kernel": P(None, None, None, t),
                        "bias": P(None, None, t)},
                "proj": {"kernel": P(None, t, None), "bias": P(None)},
            },
            "ln2": {"scale": P(None), "bias": P(None)},
            "mlp": {
                "fc1": {"kernel": P(None, None, t), "bias": P(None, t)},
                "fc2": {"kernel": P(None, t, None), "bias": P(None)},
            },
        },
        "final_ln": {"scale": P(None), "bias": P(None)},
    }


def seq_partial_grad_mask(cfg: GPTConfig) -> Dict[str, Any]:
    """True for the replicated parameters whose gradients are partial
    over tp under sequence parallelism (they act on sequence-sharded
    activations: the LayerNorms, the proj and fc2 biases, the final
    LayerNorm) and need a tp all-reduce — apex's
    ``sequence_parallel_enabled`` attribute."""
    ln = {"scale": True, "bias": True}
    return {
        "embedding": {"word": {"table": False}, "position": False},
        "layers": {
            "ln1": dict(ln),
            "attn": {"qkv": {"kernel": False, "bias": False},
                     "proj": {"kernel": False, "bias": True}},
            "ln2": dict(ln),
            "mlp": {"fc1": {"kernel": False, "bias": False},
                    "fc2": {"kernel": False, "bias": True}},
        },
        "final_ln": dict(ln),
    }


def shard_params(cfg: GPTConfig, params, mesh: Mesh, *,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, Any]:
    """This rank's shards of the global parameter tree by
    :func:`param_specs`: ``params`` as numpy arrays (JAX's global tree
    through ``np.asarray``) or tensors (:func:`init`'s), each shard a
    tensor of its own on ``device`` (default ``mesh.device``)."""
    return shard_tree(params, param_specs(cfg), mesh, device)


def gather_params(cfg: GPTConfig, params, mesh: Mesh) -> Dict[str, Any]:
    """The inverse of :func:`shard_params`: every rank's shards gathered
    into JAX's global tree as numpy arrays (bfloat16 as float32), on
    every rank. A collective: every rank of the mesh calls it."""
    return gather_tree(params, param_specs(cfg), mesh)


def _params_device(params) -> torch.device:
    return params["embedding"]["word"]["table"].device


def _layers(params) -> List[Dict[str, Any]]:
    """The per-layer parameter dicts, from ONE ``unbind`` of each stacked
    leaf (whose backward is one ``stack``)."""
    unbound = _tree_map(lambda x: x.unbind(0), params["layers"])
    return [_tree_map(lambda t: t[l], unbound)
            for l in range(_num_layers(params))]


def _num_layers(params) -> int:
    return params["layers"]["attn"]["qkv"]["kernel"].shape[0]


def _cast_layer(cfg: GPTConfig, layer_p):
    """Matmul weights to compute dtype; LayerNorm affine stays in
    param dtype (``_layer_norm`` reads it in fp32). A no-op on
    parameters :func:`cast_params` already cast."""
    cast = lambda t: _tree_map(
        lambda x: x.to(cfg.compute_dtype) if x.is_floating_point() else x,
        t)
    return {**layer_p, "attn": cast(layer_p["attn"]),
            "mlp": cast(layer_p["mlp"])}


def cast_params(cfg: GPTConfig, params):
    """``params`` with the layer matmul weights and the embedding tables
    cast to compute dtype ONCE (LayerNorm affines untouched) — the
    values every forward casts to anyway, so results are identical and
    a serving loop stops re-casting ~params bytes per step."""
    return {
        "embedding": _tree_map(lambda x: x.to(cfg.compute_dtype),
                               params["embedding"]),
        "layers": _cast_layer(cfg, params["layers"]),
        "final_ln": params["final_ln"],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_norm(cfg: GPTConfig, h, scale, bias):
    """fp32 statistics, affine in fp32, cast back to ``h``'s dtype:
    ``ln_impl="xla"`` as plain PyTorch, ``"pallas"`` through the LayerNorm
    kernel (its plain version on the CPU)."""
    if cfg.ln_impl == "pallas":
        return layer_norm(h, scale, bias, eps=cfg.layernorm_epsilon)
    h32 = h.float()
    mu = h32.mean(dim=-1, keepdim=True)
    d = h32 - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + cfg.layernorm_epsilon)
    return (y * scale.float() + bias.float()).to(h.dtype)


#: the remat name of the matmuls being issued (JAX's ``checkpoint_name``),
#: per thread: a checkpoint's replay runs the layer, and so sets it, in the
#: thread that replays
_REMAT_NAME = threading.local()


@contextlib.contextmanager
def _remat_name(name: str):
    """Names the matmuls issued inside for :func:`_remat_policy`."""
    prev = getattr(_REMAT_NAME, "value", None)
    _REMAT_NAME.value = name
    try:
        yield
    finally:
        _REMAT_NAME.value = prev


def _tp_mesh(cfg: GPTConfig, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` when its tp axis spans more than one rank, else None: the
    functions below take the tensor-parallel path only then (over one
    rank every mapping is the identity, so the tp=1 code runs as is)."""
    if mesh is not None and mesh.size(cfg.axis) > 1:
        return mesh
    return None


def _enter_tp(cfg: GPTConfig, x, mesh: Optional[Mesh]):
    """The entry mapping of a column-parallel matmul's input: the
    sequence-parallel all-gather (reduce-scatter backward) or the copy
    (all-reduce backward); the identity without a tp mesh."""
    if mesh is None:
        return x
    if cfg.sequence_parallel:
        return gather_from_sequence_parallel_region(x, cfg.axis, True, 1,
                                                    mesh=mesh)
    return copy_to_tensor_model_parallel_region(x, cfg.axis, mesh=mesh)


def _leave_tp(cfg: GPTConfig, y, mesh: Optional[Mesh]):
    """The exit of a row-parallel matmul: its partial products summed,
    onto this rank's sequence block under sequence parallelism."""
    if mesh is None:
        return y
    if cfg.sequence_parallel:
        return reduce_scatter_to_sequence_parallel_region(y, cfg.axis, 1,
                                                          mesh=mesh)
    return reduce_from_tensor_model_parallel_region(y, cfg.axis, mesh=mesh)


def _qkv_project(cfg: GPTConfig, p, x, lora=None, *,
                 mesh: Optional[Mesh] = None):
    """The three slab matmuls of the ``[h, 3, h_local]`` fused QKV weight
    → ``(q, k, v)``, each ``[..., h_local]`` in the flash kernel's
    layout, after ONE tp entry mapping shared by the three (its backward
    sums the three input gradients in one all-reduce / reduce-scatter).
    ``lora`` (serving only, no mesh) is the layer's gathered adapter
    bundle (:func:`_lora_layers`): each slab gains its per-row delta, the
    rank-r intermediate shared by the three."""
    if lora is not None and mesh is not None:
        raise ValueError("lora does not compose with tensor parallelism "
                         "yet (the distributed slice of serving and LoRA "
                         "at tp > 1, ROADMAP queue 1 item 4)")
    x = _enter_tp(cfg, x, mesh)
    ws, bs = p["kernel"].unbind(1), p["bias"].unbind(0)
    with _remat_name("attn_qkv"):
        ys = [torch.matmul(x, w) for w in ws]
    outs = tuple(y + b for y, b in zip(ys, bs))
    if lora is None:
        return outs
    deltas = _lora_site(x, lora, "qkv").unflatten(-1, (3, -1)).unbind(-2)
    return tuple(o + d for o, d in zip(outs, deltas))


def _proj(p, out, lora=None, *, cfg: Optional[GPTConfig] = None,
          mesh: Optional[Mesh] = None):
    """The attention output projection of ``out [..., h_local]`` (the
    heads merged), row-parallel under a tp ``mesh`` (the bias added after
    the reduction), with the layer's adapter delta under ``lora``."""
    y = _leave_tp(cfg, torch.matmul(out, p["kernel"]), mesh) + p["bias"]
    if lora is not None:
        y = y + _lora_site(out, lora, "proj")
    return y


def _attn_impl(cfg: GPTConfig, device: torch.device) -> str:
    if cfg.attn_impl == "auto":
        return "flash" if device.type == "cuda" else "xla"
    return cfg.attn_impl


def _split_heads(t, heads: int):
    b, s, hl = t.shape
    return t.reshape(b, s, heads, hl // heads).transpose(1, 2)


def _merge_heads(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _attention_ctx(cfg: GPTConfig, q, k, v, heads: int):
    """``q/k/v [b, s, hidden]`` → pre-projection context ``[b, s,
    hidden]``: flash attention, or the materialised scores. Flash
    dispatches as JAX's ``_attention_ctx`` does: with ``attn_layout=
    "auto"`` the slabs go straight to :func:`flash_attention_bsh`, which
    runs the lane-packed kernels where :func:`~apex_tpu_torch.kernels.
    flash_bsh_eligible` (the port's copy of JAX's rule, which also
    requires head width 64, the one the port's lane-packed kernels are
    built for) says yes, and the head-major ones otherwise (other head
    widths such as the 2.7B's 80, ``APEX_TPU_FLASH_BWD=split``, a dQ
    accumulator over budget); with ``"bhsd"`` heads are split to ``[b,
    heads, s, d]`` for the head-major kernels and merged back."""
    if _attn_impl(cfg, q.device) == "flash":
        if cfg.attn_layout == "auto":
            return flash_attention_bsh(q, k, v, num_heads=heads,
                                       causal=cfg.causal)
        qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
        return _merge_heads(flash_attention(qh, kh, vh, causal=cfg.causal))
    s = q.shape[1]
    tri = None
    if cfg.causal:
        ar = torch.arange(s, device=q.device)
        tri = ar[:, None] >= ar[None, :]
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    p_attn = _xla_attn_probs(cfg, qh, kh, tri)
    return _merge_heads(torch.matmul(p_attn, vh))


def _xla_attn_probs(cfg: GPTConfig, q, k, mask):
    """THE materialised-scores probabilities: ``q [b, h, Q, d]`` x ``k
    [b, h, K, d]`` → ``[b, h, Q, K]`` under boolean ``mask`` (True =
    attend, broadcasting over the scores, or None). ``attn_score_dtype``
    "f32" scores in fp32 (scaled after the product, masked to -1e30);
    "compute" keeps scores in compute dtype with the scale folded into
    q first (fp16 range guard) and fp32 softmax statistics."""
    d = q.shape[-1]
    sc = 1.0 / d ** 0.5
    if cfg.attn_score_dtype == "compute":
        scores = torch.matmul(q * torch.tensor(sc, dtype=q.dtype),
                              k.transpose(-1, -2))
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        m = scores.amax(dim=-1, keepdim=True).float()
        e = torch.exp(scores.float() - m)
        return (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * sc
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    return torch.softmax(scores, dim=-1).to(q.dtype)


def _mlp(cfg: GPTConfig, p, h, lora=None, *, mesh: Optional[Mesh] = None):
    """fc1 (column-parallel under a tp ``mesh``), tanh GELU, fc2
    (row-parallel); under ``lora`` fc1's delta lands before the GELU (the
    merged weight's semantics) and fc2's on its input."""
    x = _enter_tp(cfg, h, mesh)
    with _remat_name("mlp_fc1"):
        y = torch.matmul(x, p["fc1"]["kernel"])
    if lora is None:
        y = F.gelu(y + p["fc1"]["bias"], approximate="tanh")
        return (_leave_tp(cfg, torch.matmul(y, p["fc2"]["kernel"]), mesh)
                + p["fc2"]["bias"])
    y = F.gelu(y + p["fc1"]["bias"] + _lora_site(h, lora, "fc1"),
               approximate="tanh")
    return (torch.matmul(y, p["fc2"]["kernel"]) + p["fc2"]["bias"]
            + _lora_site(y, lora, "fc2"))


def _block(cfg: GPTConfig, p, h, *, return_kv: bool = False, lora=None,
           mesh: Optional[Mesh] = None):
    """One transformer layer over ``h [b, s(_local under SP), hidden]``;
    with ``return_kv`` also the attention's ``(k, v)`` as ``[b, heads, s,
    d]`` — the cache entries bulk prefill captures. ``lora`` is the
    layer's gathered adapter bundle (serving prefill only). Under a tp
    ``mesh`` the attention runs this rank's heads (the count read off
    the local QKV slab) and the MLP its block of the ffn."""
    x = _layer_norm(cfg, h, p["ln1"]["scale"], p["ln1"]["bias"])
    q, k, v = _qkv_project(cfg, p["attn"]["qkv"], x, lora, mesh=mesh)
    heads = q.shape[-1] // cfg.head_dim
    ctx = _attention_ctx(cfg, q, k, v, heads)
    h = h + _proj(p["attn"]["proj"], ctx, lora, cfg=cfg, mesh=mesh)
    x = _layer_norm(cfg, h, p["ln2"]["scale"], p["ln2"]["bias"])
    h = h + _mlp(cfg, p["mlp"], x, lora, mesh=mesh)
    if return_kv:
        return h, (_split_heads(k, heads), _split_heads(v, heads))
    return h


def _embed(cfg: GPTConfig, params, tokens, *, mesh: Optional[Mesh] = None):
    """tokens ``[b, s]`` → entry activation ``[b, s, hidden]``; under a
    tp ``mesh`` the lookup is vocab-parallel (this rank's block of the
    table, the partial lookups summed), and under sequence parallelism
    the result is this rank's block of the sequence."""
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    pos = params["embedding"]["position"][: tokens.shape[1]]
    if mesh is None:
        return (F.embedding(tokens.long(), table)
                + pos[None].to(cfg.compute_dtype))
    h = (vocab_parallel_embedding(tokens, table, axis=cfg.axis, mesh=mesh)
         + pos[None].to(cfg.compute_dtype))
    if cfg.sequence_parallel:
        h = scatter_to_sequence_parallel_region(h, cfg.axis, 1, mesh=mesh)
    return h


#: what each remat policy saves (``_remat_policy``'s names in JAX);
#: None: every matmul without batch dims ("dots")
_POLICY_SAVES = {
    "dots": None,
    "qkv_fc1": ("attn_qkv", "mlp_fc1"),
    "fc1": ("mlp_fc1",),
    "qkv_fc1_attn": ("attn_qkv", "mlp_fc1", "flash"),
    "fc1_attn": ("mlp_fc1", "flash"),
}


def _remat_policy(cfg: GPTConfig):
    """The ``context_fn`` of a layer's ``checkpoint`` for
    ``cfg.remat_policy``, or None (save nothing: the whole layer replays).

    A selective-checkpoint policy sees ops, not JAX's named values:
    ``"flash"`` (JAX's ``flash_out``/``flash_lse``) is either flash
    forward op, lane-packed or head-major, whose ``(out, lse)`` is saved
    whole; ``"attn_qkv"`` and
    ``"mlp_fc1"`` are the matmuls that ``_qkv_project`` and ``_mlp`` issue
    under :func:`_remat_name`. The saved values are the matmul outputs,
    the bias adds replay."""
    if cfg.remat_policy is None:
        return None
    if cfg.remat_policy in ("qkv_fc1_attn", "fc1_attn") and (
            cfg.attn_impl != "flash" or cfg.context_parallel):
        raise ValueError(
            f"remat_policy {cfg.remat_policy!r} requires attn_impl='flash' "
            "(without context_parallel); use 'qkv_fc1'/'fc1' otherwise")
    if cfg.remat_policy not in _POLICY_SAVES:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    saves = _POLICY_SAVES[cfg.remat_policy]
    mm = torch.ops.aten.mm.default

    def policy(ctx, op, *args, **kwargs):
        if op is FLASH_FWD_OP or op is FLASH_HM_FWD_OP:
            keep = saves is not None and "flash" in saves
        elif op is mm:
            keep = saves is None or getattr(_REMAT_NAME, "value",
                                            None) in saves
        else:
            keep = False
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


def _scan_blocks(cfg: GPTConfig, h, layers, *, mesh: Optional[Mesh] = None):
    """``h`` through the per-layer params ``layers`` → ``(h, aux_sum)``
    (aux is the MoE term, 0 for the dense model). With ``cfg.remat`` and
    gradients to take, each layer runs under ``checkpoint`` with the
    policy of :func:`_remat_policy`; under a tp ``mesh`` its replay in
    the backward runs the layer's collectives again, in the forward's
    order on every rank."""
    body = lambda layer_p, x: _block(cfg, _cast_layer(cfg, layer_p), x,
                                     mesh=mesh)
    needs_grad = torch.is_grad_enabled() and (h.requires_grad or any(
        t.requires_grad for t in _tree.leaves(layers)))
    if cfg.remat and needs_grad:
        ctx_fn = _remat_policy(cfg)
        kw = {} if ctx_fn is None else {"context_fn": ctx_fn}
        for layer_p in layers:
            h = checkpoint(body, layer_p, h, use_reentrant=False,
                           preserve_rng_state=False, **kw)
    else:
        for layer_p in layers:
            h = body(layer_p, h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def hidden_states_and_aux(cfg: GPTConfig, params, tokens, *,
                          mesh: Optional[Mesh] = None):
    """tokens ``[b, s]`` (global ids; the dp-local batch) → (final-LN
    hidden ``[b, s(_local under SP), hidden]`` in compute dtype, summed
    MoE aux loss — 0 for the dense model). ``mesh``: see :func:`loss`."""
    mesh = _tp_mesh(cfg, mesh)
    h, aux = _scan_blocks(cfg, _embed(cfg, params, tokens, mesh=mesh),
                          _layers(params), mesh=mesh)
    # the final LN runs inside the SP region: its gradients are
    # tp-partial (seq_partial_grad_mask)
    return _layer_norm(cfg, h, params["final_ln"]["scale"],
                       params["final_ln"]["bias"]), aux


def hidden_states(cfg: GPTConfig, params, tokens, *,
                  mesh: Optional[Mesh] = None):
    """tokens ``[b, s]`` → final-LN hidden ``[b, s(_local under SP),
    hidden]`` in compute dtype."""
    return hidden_states_and_aux(cfg, params, tokens, mesh=mesh)[0]


def logits(cfg: GPTConfig, params, tokens, *, mesh: Optional[Mesh] = None):
    """Logits ``[b, s, vocab(/tp under a mesh)]`` in compute dtype, the
    output head tied to the word embedding (vocab-sharded under a tp
    mesh, as JAX's)."""
    mesh = _tp_mesh(cfg, mesh)
    # the tied head's entry mapping: without it each rank's gradient into
    # the replicated backbone would carry only its vocab block's share
    h = _enter_tp(cfg, hidden_states(cfg, params, tokens, mesh=mesh), mesh)
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    return torch.matmul(h, table.t())


def _ce_of_hidden(cfg: GPTConfig, params, h, targets_bs, *,
                  mesh: Optional[Mesh] = None):
    """Mean CE from final hidden states ``h [b, s, hidden]`` against
    ``targets_bs [b, s]``, in fp32 logits against the tied table:
    ``ce_impl="xla"`` through the vocab-parallel cross entropy,
    ``"fused"`` through the xentropy kernels (tp=1 only, as in JAX). With
    ``cfg.ce_chunk`` the sequence is cut into chunks, each under
    ``checkpoint``: the forward keeps only each chunk's loss sum and the
    backward recomputes that chunk's logits (and, fused, re-runs the
    forward kernel), so peak memory is O(chunk * b * vocab) instead of
    O(s * b * vocab)."""
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    b, s = targets_bs.shape
    chunk = cfg.ce_chunk
    if chunk > 0 and s % chunk:
        raise ValueError(
            f"ce_chunk={chunk} must divide the (SP-local) sequence "
            f"length {s}")
    if cfg.ce_impl == "fused":
        if table.shape[0] != cfg.vocab_size:
            # the kernel's lse spans only the rows it is given: on a
            # vocab-sharded table it would be a silently wrong loss
            raise ValueError(
                "ce_impl='fused' needs the vocab unsharded locally "
                f"(tp == 1); local table rows {table.shape[0]} != "
                f"vocab_size {cfg.vocab_size}")

        def ce_sum(hb, tb, tab):
            lg = torch.matmul(hb, tab.t()).float()
            n = lg.shape[0] * lg.shape[1]
            return softmax_cross_entropy(lg.reshape(n, lg.shape[-1]),
                                         tb.reshape(n)).sum()
    elif cfg.ce_impl == "xla":
        def ce_sum(hb, tb, tab):
            lg = torch.matmul(hb, tab.t()).float()
            return vocab_parallel_cross_entropy(lg, tb, 0.0, cfg.axis,
                                                mesh=mesh).sum()
    else:
        raise ValueError(f"unknown ce_impl {cfg.ce_impl!r}")

    if chunk <= 0:
        return ce_sum(h, targets_bs, table) / (s * b)
    remat = torch.is_grad_enabled() and (h.requires_grad
                                         or table.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        hb, tb = h[:, c0:c0 + chunk], targets_bs[:, c0:c0 + chunk]
        tot = tot + (checkpoint(ce_sum, hb, tb, table, use_reentrant=False,
                                preserve_rng_state=False)
                     if remat else ce_sum(hb, tb, table))
    return tot / (s * b)


def loss(cfg: GPTConfig, params, tokens, targets, *,
         mesh: Optional[Mesh] = None):
    """Mean next-token cross entropy over the (dp-local) batch, fp32
    logits in the vocab-parallel CE. ``targets [b, s]``.

    ``mesh``: a :class:`~apex_tpu_torch.mesh.Mesh` whose ``cfg.axis``
    spans several ranks runs this rank's shards of ``params``
    (:func:`shard_params`) as JAX's ``gpt.loss`` does inside
    ``shard_map``, and every rank of the axis returns the same loss;
    ``cfg.sequence_parallel`` then keeps the activations sharded on the
    sequence between the tp regions. Without one (or over one rank) it
    is the tp=1 loss, sequence parallelism a no-op."""
    mesh = _tp_mesh(cfg, mesh)
    h, _ = hidden_states_and_aux(cfg, params, tokens, mesh=mesh)
    return _ce_of_hidden(cfg, params, _enter_tp(cfg, h, mesh), targets,
                         mesh=mesh)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def _kv_cache_dtype(cfg: GPTConfig) -> str:
    """Resolve ``cfg.kv_cache_dtype`` to the storage kind: ``"compute"``
    (the unquantized cache in compute dtype; ``"auto"`` and ``"bf16"``
    spell it too, as in JAX), ``"int8"`` or ``"fp8"``."""
    kind = cfg.kv_cache_dtype
    if kind in ("auto", "bf16", "compute"):
        return "compute"
    if kind in ("int8", "fp8"):
        return kind
    raise ValueError(f"unknown kv_cache_dtype {kind!r} "
                     f"(expected auto|bf16|compute|int8|fp8)")


def _cache_map(fn, *caches):
    """``fn`` over the planes of caches of one layout: the compute-dtype
    array itself, or each of the quantized cache's ``"kv"`` and
    ``"scale"`` planes (the result a dict of the same keys)."""
    if isinstance(caches[0], dict):
        return {k: fn(*(c[k] for c in caches)) for k in caches[0]}
    return fn(*caches)


def _cache_shape(params, cfg: GPTConfig, batch: int,
                 max_len: Optional[int]):
    qkv_k = params["layers"]["attn"]["qkv"]["kernel"]
    heads = qkv_k.shape[-1] // cfg.head_dim
    return ((qkv_k.shape[0], 2, batch, heads, max_len or cfg.seq_len,
             cfg.head_dim), qkv_k.device)


def init_cache(cfg: GPTConfig, params, batch: int,
               max_len: Optional[int] = None):
    """Zero KV cache on the parameters' device, layout ``[L, 2, batch,
    heads, max_len, head_dim]`` in compute dtype (``max_len`` defaults
    to ``cfg.seq_len``) — or, under a quantized ``cfg.kv_cache_dtype``,
    the dict ``{"kv": int8/fp8 [same shape], "scale": fp32 [L, 2, batch,
    heads, max_len]}``, both planes zero (the verify read multiplies
    stale columns by exact zeros; fp8 garbage could be NaN)."""
    shape, dev = _cache_shape(params, cfg, batch, max_len)
    kind = _kv_cache_dtype(cfg)
    if kind == "compute":
        return torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
    return {"kv": torch.zeros(shape, dtype=kv_storage_dtype(kind),
                              device=dev),
            "scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                 device=dev)}


def quantize_cache_block(cfg: GPTConfig, block):
    """Compute-dtype cache block ``[L, 2, b, heads, P, d]`` → the storage
    form of ``cfg.kv_cache_dtype`` (identity when unquantized): the one
    place a raw K/V block becomes cache bytes, through
    :func:`quantize_kv_rows`."""
    kind = _kv_cache_dtype(cfg)
    if kind == "compute":
        return block.to(cfg.compute_dtype)
    q, scale = quantize_kv_rows(block, kind)
    return {"kv": q, "scale": scale}


def dequantize_cache_block(cfg: GPTConfig, block):
    """Inverse of :func:`quantize_cache_block` (identity when
    unquantized): storage form → compute-dtype ``[L, 2, b, heads, P,
    d]``."""
    if isinstance(block, dict):
        return dequantize_kv(block["kv"], block["scale"], cfg.compute_dtype)
    return block


# ---------------------------------------------------------------------------
# batched multi-LoRA: per-row low-rank adapter deltas on the dense seams
# ---------------------------------------------------------------------------

#: the four dense seams an adapter deltas, in ``init_lora_weights``' order
LORA_SITES = ("qkv", "proj", "fc1", "fc2")


def _lora_scale(scale: float, dtype) -> float:
    """``alpha / r`` rounded to ``dtype`` (JAX multiplies by
    ``jnp.asarray(scale, x.dtype)``), as a Python number: a tensor
    product with it rounds once, in ``dtype``, and syncs nothing."""
    return float(torch.tensor(float(scale), dtype=dtype))


def _lora_u(x, ag):
    """The rank-r intermediate ``x @ ag^T``: ``x [B, din]`` or ``[B, T,
    din]`` against the gathered ``ag [B, r, din]``, in ``x``'s dtype."""
    if x.dim() == 2:
        return torch.bmm(x.unsqueeze(1), ag.transpose(1, 2)).squeeze(1)
    return torch.bmm(x, ag.transpose(1, 2))


def _lora_out(u, bg, sc: float):
    """``(u @ bg) * sc`` for ``u [B, r]`` or ``[B, T, r]`` and the gathered
    ``bg [B, r, ...]`` (the qkv site's ``[B, r, 3, dout]`` flattened to
    ``[B, r, 3 * dout]``): the product rounds, then the scale."""
    b2 = bg.reshape(bg.shape[0], bg.shape[1], -1)
    if u.dim() == 2:
        return torch.bmm(u.unsqueeze(1), b2).squeeze(1) * sc
    return torch.bmm(u, b2) * sc


def _lora_delta(x, a, b, ids, scale):
    """The batched per-row LoRA delta of ONE dense site: ``x [B, din]`` or
    ``[B, T, din]`` with per-row adapter ids ``ids [B]`` over a pool
    ``a [n, r, din]`` / ``b [n, r, dout]`` → ``(gather(a, ids) x)
    gather(b, ids) * scale`` in ``x``'s dtype (JAX's ``_lora_delta`` at
    tp=1). The pinned all-zero row 0 gives an exact-zero delta."""
    ids = torch.as_tensor(ids, device=a.device)
    return _lora_out(_lora_u(x, a.index_select(0, ids)),
                     b.index_select(0, ids), _lora_scale(scale, x.dtype))


def _lora_site(x, lora, site: str):
    """The delta of ``site`` for ``x`` under a layer's gathered bundle
    ``lora = (pages, sc)`` (:func:`_lora_layers`)."""
    ag, bg = lora[0][site]
    return _lora_out(_lora_u(x, ag), bg, lora[1])


def _lora_layers(cfg: GPTConfig, lora):
    """``(pool, ids, scale)`` → one ``({site: (a [B, r, din], b [B, r,
    ...])}, sc)`` bundle a layer, or None. Each pool tensor is gathered
    by ``ids`` ONCE over its stacked layers; a layer's factors are views
    of that gather."""
    if lora is None:
        return None
    pool, ids, scale = lora
    ids = torch.as_tensor(ids, device=pool["qkv"]["a"].device)
    g = {site: (pool[site]["a"].index_select(1, ids),
                pool[site]["b"].index_select(1, ids)) for site in LORA_SITES}
    sc = _lora_scale(scale, cfg.compute_dtype)
    return [({site: (a[l], b[l]) for site, (a, b) in g.items()}, sc)
            for l in range(pool["qkv"]["a"].shape[0])]


def init_lora_pool(cfg: GPTConfig, params, n_adapters: int, rank: int):
    """The zero adapter pool for the four dense seams of every layer, on
    the parameters' device in compute dtype: per site ``a [L, n, r,
    din]`` / ``b [L, n, r(, 3), dout]``. Row 0 is the pinned all-zero
    adapter (base traffic); the serving engine registers adapters into
    rows >= 1 (:func:`lora_set_row`)."""
    if cfg.num_experts:
        raise ValueError(
            "LoRA adapters do not compose with num_experts > 0 (the "
            "expert FFN has no per-row dense seam to delta)")
    qkv_k = params["layers"]["attn"]["qkv"]["kernel"]   # [L, h, 3, hl]
    L, hl, h = qkv_k.shape[0], qkv_k.shape[-1], cfg.hidden_size
    fl = params["layers"]["mlp"]["fc1"]["kernel"].shape[-1]
    z = lambda *s: torch.zeros((L, n_adapters, rank) + s,
                               dtype=cfg.compute_dtype, device=qkv_k.device)
    return {
        "qkv": {"a": z(h), "b": z(3, hl)},
        "proj": {"a": z(hl), "b": z(h)},
        "fc1": {"a": z(h), "b": z(fl)},
        "fc2": {"a": z(fl), "b": z(h)},
    }


def lora_set_row(pool, row, idx: int):
    """Write one adapter's ``[L, r, ...]`` row block (per site ``{"a",
    "b"}``, tensors or numpy arrays) into pool row ``idx`` IN PLACE, cast
    to the pool's dtype (returns ``pool``)."""
    for site, parts in pool.items():
        for part, c in parts.items():
            c[:, int(idx)] = torch.as_tensor(
                row[site][part], device=c.device).to(c.dtype)
    return pool


def init_lora_weights(cfg: GPTConfig, rank: int, seed: int, *,
                      std: float = 0.02):
    """Deterministic synthetic adapter weights, host numpy fp32: per site
    ``a [L, r, din]`` / ``b [L, r(, 3), dout]`` ~ N(0, std) from
    ``default_rng(seed & 0xFFFFFFFF)`` in JAX's site and draw order, so
    they are JAX's bit for bit. Both factors are nonzero, so the delta
    moves logits."""
    if cfg.num_experts:
        raise ValueError(
            "LoRA adapters do not compose with num_experts > 0")
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFF)
    h, f, L = cfg.hidden_size, cfg.ffn, cfg.num_layers
    g = lambda *s: rng.normal(0.0, std, (L, rank) + s).astype(np.float32)
    return {
        "qkv": {"a": g(h), "b": g(3, h)},
        "proj": {"a": g(h), "b": g(h)},
        "fc1": {"a": g(h), "b": g(f)},
        "fc2": {"a": g(f), "b": g(h)},
    }


def merge_lora(cfg: GPTConfig, params, weights, alpha: float):
    """Fold adapter ``weights`` (:func:`init_lora_weights`' layout) into a
    COPY of ``params``: ``W += (alpha / r) a^T b`` per dense site, the
    product in fp32 and the sum in param dtype, as JAX's. The
    merged-weight oracle: a solo forward with the merged params matches
    the engine's batched adapter path within per-dtype tolerance."""
    lay = params["layers"]
    dev = lay["attn"]["qkv"]["kernel"].device
    w = {site: {part: torch.as_tensor(x, device=dev).float()
                for part, x in parts.items()}
         for site, parts in weights.items()}
    sc = float(alpha) / float(w["qkv"]["a"].shape[1])

    def fold(kernel, eq, site):
        d = sc * torch.einsum(eq, w[site]["a"], w[site]["b"]).float()
        return kernel + d.to(kernel.dtype)

    attn, mlp = lay["attn"], lay["mlp"]
    return {**params, "layers": {
        **lay,
        "attn": {**attn,
                 "qkv": {**attn["qkv"], "kernel": fold(
                     attn["qkv"]["kernel"], "lrh,lrci->lhci", "qkv")},
                 "proj": {**attn["proj"], "kernel": fold(
                     attn["proj"]["kernel"], "lri,lro->lio", "proj")}},
        "mlp": {"fc1": {**mlp["fc1"], "kernel": fold(
                    mlp["fc1"]["kernel"], "lrh,lrf->lhf", "fc1")},
                "fc2": {**mlp["fc2"], "kernel": fold(
                    mlp["fc2"]["kernel"], "lrf,lrh->lfh", "fc2")}},
    }}


def _decode_attn_impl(cfg: GPTConfig, device: torch.device) -> str:
    """THE decode-attention dispatch predicate: ``"auto"`` → the kernel
    on CUDA at every horizon, the XLA form on the CPU."""
    if cfg.decode_attn_impl == "auto":
        return "kernel" if device.type == "cuda" else "xla"
    return cfg.decode_attn_impl


def _xla_decode_read(q, k_cache, v_cache, pos):
    """THE materialised-scores read of one query row per (batch, head):
    ``q [b, heads, d]`` over columns ``0..pos[b]`` of ``k_cache/v_cache
    [b, heads, S, d]``. The scale is folded into q BEFORE the product
    (the fp16 range guard); the contiguous and the paged path both call
    this, so on the same bytes they give the same bits."""
    d = q.shape[-1]
    s_max = k_cache.shape[2]
    p = pos.to(device=q.device, dtype=torch.long)
    valid = (torch.arange(s_max, device=q.device)[None] <= p[:, None])[:, None]
    q = q * torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    scores = torch.einsum("bhd,bhsd->bhs", q, k_cache).float()
    scores = scores.masked_fill(~valid, -1e30)
    p_attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bhsd->bhd", p_attn, v_cache)


def _decode_attend(cfg: GPTConfig, q, k_new, v_new, kv, pos):
    """Write this token's K/V at ``pos [b]`` (int32) into the layer's
    cache ``kv`` IN PLACE and attend ``q [b, heads, d]`` over ``0..pos``
    → ``ctx [b, heads, d]``. ``kv`` is ``[2, b, heads, S, d]``, or the
    quantized layer view ``{"kv": [2, b, heads, S, d], "scale": [2, b,
    heads, S]}``: the kernel impl quantizes the rows in the write kernel
    and folds the scales into the read; the XLA impl quantizes them
    with :func:`quantize_kv_rows`, writes both planes and reads the cache
    dequantized to compute dtype (JAX's two branches)."""
    d = q.shape[-1]
    kind = _kv_cache_dtype(cfg)
    kernel = _decode_attn_impl(cfg, q.device) == "kernel"
    if kind != "compute":
        kvq, kvs = kv["kv"], kv["scale"]
        if kernel:
            return decode_attention_quantized(
                q, k_new, v_new, kvq[0], kvs[0], kvq[1], kvs[1], pos,
                kind=kind, scale=1.0 / math.sqrt(d))
        rows = torch.arange(q.shape[0], device=q.device)
        p = pos.long()
        for i, new in enumerate((k_new, v_new)):
            nq, ns = quantize_kv_rows(new, kind)
            _bytes(kvq[i])[rows, :, p] = _bytes(nq)
            kvs[i][rows, :, p] = ns
        return _xla_decode_read(
            q, dequantize_kv(kvq[0], kvs[0], cfg.compute_dtype),
            dequantize_kv(kvq[1], kvs[1], cfg.compute_dtype), pos)
    if kernel:
        return decode_attention(q, k_new, v_new, kv[0], kv[1], pos,
                                scale=1.0 / math.sqrt(d))
    rows = torch.arange(q.shape[0], device=q.device)
    p = pos.long()
    kv[0][rows, :, p] = k_new.to(kv.dtype)
    kv[1][rows, :, p] = v_new.to(kv.dtype)
    return _xla_decode_read(q, kv[0], kv[1], pos)


def _paged_xla_write(cfg: GPTConfig, kv, k_new, v_new, table, pos) -> None:
    """The XLA impl's paged write of ``k_new/v_new [b, heads, T, d]`` at
    ``pos[b] + j`` (lanes past the horizon dropped) into the layer's pool
    ``kv``: the data planes as they are, or the rows quantized by
    :func:`quantize_kv_rows` into both planes of the quantized pool."""
    kind = _kv_cache_dtype(cfg)
    for i, new in enumerate((k_new, v_new)):
        if kind == "compute":
            paged_write_columns_xla(kv[i], new, table, pos)
            continue
        nq, ns = quantize_kv_rows(new, kind)
        paged_write_columns_xla(_bytes(kv["kv"][i]), _bytes(nq), table, pos)
        paged_write_columns_xla(kv["scale"][i][..., None], ns[..., None],
                                table, pos)


def _paged_view(cfg: GPTConfig, kv, table):
    """The row-contiguous K and V of the layer's pool under ``table``, in
    compute dtype (the quantized pool gathered, then dequantized)."""
    if _kv_cache_dtype(cfg) == "compute":
        return paged_gather_xla(kv[0], table), paged_gather_xla(kv[1], table)
    g = lambda x: paged_gather_planes(x, table)
    return tuple(dequantize_kv(g(kv["kv"][i]), g(kv["scale"][i]),
                               cfg.compute_dtype) for i in (0, 1))


def _paged_attend(cfg: GPTConfig, q, k_new, v_new, kv, pos, table):
    """:func:`_decode_attend` over the PAGED layout: ``kv`` is the
    layer's slice of the page pool (``[2, num_pages, heads, P, d]``, or
    the quantized pool's two planes) and ``table [b, max_pages]``
    (int32) maps each row's logical horizon onto pages. The write lands
    at ``(table[b, pos // P], pos % P)`` IN PLACE. The kernel impl runs
    the paged write and read in one launch (the quantized pool: its write
    kernel, then its read); the XLA impl writes through
    :func:`paged_write_columns_xla`, GATHERS the row-contiguous view and
    applies the contiguous read verbatim — the same bytes and
    expression, so paged logits equal contiguous ones bit for bit."""
    d = q.shape[-1]
    kind = _kv_cache_dtype(cfg)
    if _decode_attn_impl(cfg, q.device) == "kernel":
        if kind != "compute":
            kvq, kvs = kv["kv"], kv["scale"]
            paged_write_column_quant(k_new, v_new, kvq[0], kvs[0], kvq[1],
                                     kvs[1], table, pos, kind)
            return paged_attention_quantized(
                q, kvq[0], kvs[0], kvq[1], kvs[1], table, pos, kind=kind,
                scale=1.0 / math.sqrt(d))
        return paged_decode_attention(q, k_new, v_new, kv[0], kv[1], table,
                                      pos, scale=1.0 / math.sqrt(d))
    _paged_xla_write(cfg, kv, k_new[:, :, None], v_new[:, :, None], table,
                     pos)
    return _xla_decode_read(q, *_paged_view(cfg, kv, table), pos)


def _decode_layer(cfg: GPTConfig, p, x, kv, pos, table=None, lora=None):
    """One layer for one token: ``x [b, hidden]``, ``kv`` the layer's
    cache ``[2, b, heads, S, d]`` — or, with ``table``, its page-pool
    slice ``[2, num_pages, heads, P, d]`` — updated in place. ``lora``
    is the layer's gathered adapter bundle."""
    xa = _layer_norm(cfg, x, p["ln1"]["scale"], p["ln1"]["bias"])
    d = cfg.head_dim
    b = xa.shape[0]
    q, k_new, v_new = (t.reshape(b, t.shape[-1] // d, d)
                       for t in _qkv_project(cfg, p["attn"]["qkv"], xa, lora))
    if table is None:
        ctx = _decode_attend(cfg, q, k_new, v_new, kv, pos)
    else:
        ctx = _paged_attend(cfg, q, k_new, v_new, kv, pos, table)
    x = x + _proj(p["attn"]["proj"], ctx.reshape(b, -1), lora)
    xb = _layer_norm(cfg, x, p["ln2"]["scale"], p["ln2"]["bias"])
    return x + _mlp(cfg, p["mlp"], xb, lora)


def _lm_head(cfg: GPTConfig, params, h):
    """Tied-embedding head for one position: ``h [b, hidden]`` (pre
    final LN) → fp32 logits ``[b, vocab]``."""
    h = _layer_norm(cfg, h, params["final_ln"]["scale"],
                    params["final_ln"]["bias"])
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    return torch.matmul(h, table.t()).float()


def decode_step(cfg: GPTConfig, params, cache, token, pos, table=None,
                lora=None):
    """One decoding step: ``token [b]`` at position ``pos`` (an int, a
    0-d tensor, or a ``[b]`` vector of per-row positions) → ``(fp32
    logits [b, vocab], cache)``; the cache gains each row's K/V column
    at its position in place. Entries past a row's position are masked
    to exact softmax zeros, so a row's logits do not depend on its
    batch-mates or the horizon.

    ``table`` (int32 ``[b, max_pages]``) switches to the PAGED layout:
    ``cache`` is then the page pool :func:`init_cache` makes with
    ``batch=num_pages, max_len=page_size``, and row ``b``'s horizon is
    its table row (logical column ``c`` in page ``table[b, c // P]``).

    ``lora`` (optional ``(pool, ids, scale)``: the pool of
    :func:`init_lora_pool`, ``ids [b]`` per-row adapter rows, ``scale =
    alpha / r``) adds each row's low-rank adapter delta at every dense
    seam; id 0, the all-zero row, leaves a row's logits exactly the
    base model's."""
    if not cfg.causal:
        raise ValueError(
            "decoding is autoregressive; causal=False has no "
            "incremental-decode semantics")
    if cfg.sequence_parallel:
        cfg = dataclasses.replace(cfg, sequence_parallel=False)
    b = token.shape[0]
    dev = token.device
    pos = torch.as_tensor(pos, device=dev)
    pos = (pos.expand(b) if pos.ndim == 0 else pos).to(torch.int32)
    pos = pos.contiguous()
    emb = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    pos_e = params["embedding"]["position"][pos.long()]
    x = (emb[token.long()] + pos_e.to(cfg.compute_dtype)).to(
        cfg.compute_dtype)
    pages = _lora_layers(cfg, lora)
    for l, layer_p in enumerate(_layers(params)):
        x = _decode_layer(cfg, _cast_layer(cfg, layer_p), x,
                          _cache_map(lambda c: c[l], cache), pos, table,
                          None if pages is None else pages[l])
    return _lm_head(cfg, params, x), cache


def decode_steps(cfg: GPTConfig, params, cache, state, n: int, *,
                 pad_token_id: int = 0, draw_fn=None, masks=None,
                 table=None, lora=None):
    """``n`` decode steps, each a :func:`decode_step` + the per-slot draw
    + per-slot eos/budget masking, with no host round trip in between.

    ``state`` holds ``[B]`` tensors on the cache's device: ``tok``
    (int64, last token), ``pos`` (int32, its position), ``remaining``
    (token budget left), ``done`` (bool), ``eos`` (``NO_EOS`` = no stop
    token), plus ``temp``/``top_k``/``top_p``/``key`` (``key`` is ``[B,
    2]`` int64) for the default :func:`sampling.draw_slots` draw. Live
    slots emit their draw and advance; done slots emit
    ``pad_token_id`` with ``tok``/``pos`` frozen. A slot finishes when
    it emits its eos or exhausts ``remaining``. ``draw_fn(logits, pos)
    → [B]`` overrides the draw (:func:`generate` passes its shared-seed
    sampler). ``table`` selects the paged layout and ``lora`` the
    per-row adapters (:func:`decode_step`).
    ``masks`` (bool ``[B, vocab]``, optional) is the per-slot
    constrained-decoding vocab mask of the default draw; it is constant
    across the chunk (the host's schema automaton advances between
    dispatches), so a constrained slot is exact only at ``n == 1``.

    Returns ``(cache, state, tokens [B, n], logprobs [B, n], finished
    [B, n])``; ``logprobs`` is the log-softmax of the raw fp32 logits at
    each emitted token (before temperature, filters and mask), 0.0 in
    pad lanes."""
    st = dict(state)
    toks, lps, fins = [], [], []
    for _ in range(n):
        logits_, cache = decode_step(cfg, params, cache, st["tok"],
                                     st["pos"], table, lora)
        if draw_fn is None:
            nxt = _sampling.draw_slots(logits_, st["key"], st["pos"],
                                       st["temp"], st["top_k"], st["top_p"],
                                       masks=masks)
        else:
            nxt = draw_fn(logits_, st["pos"])
        nxt = nxt.to(torch.int64)
        lp = torch.log_softmax(logits_, dim=-1).gather(1, nxt[:, None])[:, 0]
        live = ~st["done"]
        emit = torch.where(live, nxt, torch.full_like(nxt, pad_token_id))
        lp = torch.where(live, lp, torch.zeros_like(lp))
        remaining = st["remaining"] - live.to(st["remaining"].dtype)
        hit_eos = live & (st["eos"] >= 0) & (emit == st["eos"])
        finished = live & (hit_eos | (remaining <= 0))
        st = {
            **st,
            # done slots keep tok/pos frozen so their lanes never index
            # past the cache horizon
            "tok": torch.where(live, emit, st["tok"]),
            "pos": st["pos"] + live.to(st["pos"].dtype),
            "remaining": remaining,
            "done": st["done"] | finished,
        }
        toks.append(emit)
        lps.append(lp)
        fins.append(finished)
    if not toks:
        B = st["tok"].shape[0]
        dev = st["tok"].device
        return (cache, st, torch.zeros((B, 0), dtype=torch.int64, device=dev),
                torch.zeros((B, 0), device=dev),
                torch.zeros((B, 0), dtype=torch.bool, device=dev))
    return (cache, st, torch.stack(toks, 1), torch.stack(lps, 1),
            torch.stack(fins, 1))


# ---------------------------------------------------------------------------
# speculative decoding: draft k, verify k + 1 in one forward, accept a prefix
# ---------------------------------------------------------------------------

def shift_hist(hist, toks, m):
    """Shift ``m[b]`` newly emitted tokens (the PREFIX of ``toks [B, n]``:
    emitted columns are always a prefix) into the drafter's history ring
    ``hist [B, H]`` (oldest first). The one ring-shift expression, shared
    by the speculative loop and the engine's plain-chunk refresh."""
    h = hist.shape[1]
    ext = torch.cat([hist, toks.to(hist.dtype)], dim=1)
    idx = (m.to(torch.long)[:, None]
           + torch.arange(h, device=hist.device)[None])
    return torch.gather(ext, 1, idx)


def ngram_drafts(hist, tok, k: int):
    """The n-gram drafter: ``k`` candidate continuations ``[B, k]`` of
    ``tok [B]`` from each row's history ``hist [B, H]`` (oldest first,
    ``-1`` in unfilled slots, which never matches a token). Per draft:
    the token that followed the LATEST earlier occurrence of the current
    2-token suffix in the window (history, current token, drafts so far),
    else of the 1-token suffix, else the current token again."""
    if k < 1:
        raise ValueError(f"ngram_drafts needs k >= 1, got {k}")
    win = torch.cat([hist.to(torch.long), tok[:, None].to(torch.long)],
                    dim=1)
    dev = win.device
    out = []
    for _ in range(k):
        b, w = win.shape
        ctx = win[:, -1]
        prev = win[:, -2]
        body = win[:, :-1]                       # candidate positions
        # prevcol[m] = win[m-1] (m = 0 gets a never-matching sentinel)
        prevcol = torch.cat([torch.full((b, 1), -2, dtype=torch.long,
                                        device=dev), win[:, :-2]], dim=1)
        idx = torch.arange(w - 1, device=dev)[None]
        none = torch.full_like(body, -1)
        hit1 = body == ctx[:, None]
        m1 = torch.where(hit1, idx, none).amax(dim=1)
        m2 = torch.where(hit1 & (prevcol == prev[:, None]), idx,
                         none).amax(dim=1)
        m = torch.where(m2 >= 0, m2, m1)
        succ = torch.gather(win, 1, (m + 1).clamp(0, w - 1)[:, None])[:, 0]
        d = torch.where((m >= 0) & (succ >= 0), succ, ctx)
        out.append(d)
        win = torch.cat([win, d[:, None]], dim=1)
    return torch.stack(out, dim=1)


def _xla_verify_read(q, k_cache, v_cache, pos):
    """:func:`_xla_decode_read` for ``T`` query rows per (batch, head):
    ``q [b, heads, T, d]``, row ``t`` over columns ``0 .. pos[b] + t``
    of ``k_cache/v_cache [b, heads, S, d]``. The same expression with
    one more query dim (scale folded into q, fp32 scores, -1e30 mask,
    fp32 softmax cast back)."""
    d = q.shape[-1]
    t = q.shape[2]
    s_max = k_cache.shape[2]
    dev = q.device
    last = (pos.to(device=dev, dtype=torch.long)[:, None]
            + torch.arange(t, device=dev)[None])               # [b, T]
    valid = torch.arange(s_max, device=dev)[None, None] <= last[:, :, None]
    q = q * torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    scores = torch.einsum("bhtd,bhsd->bhts", q, k_cache).float()
    scores = scores.masked_fill(~valid[:, None], -1e30)
    p_attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bhtd", p_attn, v_cache)


def _decode_attend_multi(cfg: GPTConfig, q, k_new, v_new, kv, pos):
    """:func:`_decode_attend` for ``T`` tokens per row at positions
    ``pos[b] .. pos[b] + T - 1`` — the verify forward's attention:
    ``q/k_new/v_new [b, heads, T, d]``; all T K/V columns land in the
    layer's cache ``kv`` IN PLACE (quantized, under a quantized cache;
    the kernel clamps lanes past the horizon onto its last column, the
    XLA spelling drops them), then row ``t`` attends over ``0 .. pos[b] +
    t``. A compute-dtype cache on the kernel impl with ``verify_route(T)``
    runs both in ONE launch (:func:`decode_verify_attention`, row ``t``
    the decode step's read at ``pos[b] + t``); otherwise the write, then
    the materialised read over the (dequantized) cache, as in JAX."""
    kind = _kv_cache_dtype(cfg)
    kernel = _decode_attn_impl(cfg, q.device) == "kernel"
    if kind == "compute":
        if kernel and verify_route(q.shape[2]):
            return decode_verify_attention(
                q.contiguous(), k_new.contiguous(), v_new.contiguous(),
                kv[0], kv[1], pos, scale=1.0 / math.sqrt(q.shape[-1]))
        if kernel:
            cache_write_columns(k_new.contiguous(), v_new.contiguous(),
                                kv[0], kv[1], pos)
        else:
            cache_write_columns_xla(kv[0], k_new, pos)
            cache_write_columns_xla(kv[1], v_new, pos)
        return _xla_verify_read(q, kv[0], kv[1], pos)
    kvq, kvs = kv["kv"], kv["scale"]
    if kernel:
        cache_write_columns_quant(k_new.contiguous(), v_new.contiguous(),
                                  kvq[0], kvs[0], kvq[1], kvs[1], pos, kind)
    else:
        for i, new in enumerate((k_new, v_new)):
            nq, ns = quantize_kv_rows(new, kind)
            cache_write_columns_xla(_bytes(kvq[i]), _bytes(nq), pos)
            cache_write_columns_xla(kvs[i][..., None], ns[..., None], pos)
    return _xla_verify_read(
        q, dequantize_kv(kvq[0], kvs[0], cfg.compute_dtype),
        dequantize_kv(kvq[1], kvs[1], cfg.compute_dtype), pos)


def _paged_attend_multi(cfg: GPTConfig, q, k_new, v_new, kv, pos, table):
    """:func:`_decode_attend_multi` over the paged layout: the T columns
    land through the paged multi-column write (kernel: clamp; XLA:
    drop), then the rows attend the GATHERED (and, quantized,
    dequantized) row-contiguous view with the contiguous verify read
    verbatim, so paged verify logits equal contiguous ones on the same
    bytes. A compute-dtype pool on the kernel impl with
    ``verify_route(T)`` runs both in one launch
    (:func:`paged_verify_attention`, the contiguous launch's bits) and
    gathers nothing."""
    kind = _kv_cache_dtype(cfg)
    if _decode_attn_impl(cfg, q.device) != "kernel":
        _paged_xla_write(cfg, kv, k_new, v_new, table, pos)
    elif kind == "compute" and verify_route(q.shape[2]):
        return paged_verify_attention(
            q.contiguous(), k_new.contiguous(), v_new.contiguous(), kv[0],
            kv[1], table, pos, scale=1.0 / math.sqrt(q.shape[-1]))
    elif kind == "compute":
        paged_write_columns(k_new.contiguous(), v_new.contiguous(), kv[0],
                            kv[1], table, pos)
    else:
        paged_write_columns_quant(k_new.contiguous(), v_new.contiguous(),
                                  kv["kv"][0], kv["scale"][0], kv["kv"][1],
                                  kv["scale"][1], table, pos, kind)
    return _xla_verify_read(q, *_paged_view(cfg, kv, table), pos)


def _verify_layer(cfg: GPTConfig, p, x, kv, pos, table=None, lora=None):
    """:func:`_decode_layer` for ``T`` tokens per row: ``x [b, T,
    hidden]`` at positions ``pos[b] + t``. Projections, LayerNorms and
    the MLP act per position; attention is :func:`_decode_attend_multi`
    (or its paged sibling with ``table``)."""
    xa = _layer_norm(cfg, x, p["ln1"]["scale"], p["ln1"]["bias"])
    d = cfg.head_dim
    b, t, hl = xa.shape
    q, k_new, v_new = (z.reshape(b, t, hl // d, d).transpose(1, 2)
                       for z in _qkv_project(cfg, p["attn"]["qkv"], xa, lora))
    if table is None:
        ctx = _decode_attend_multi(cfg, q, k_new, v_new, kv, pos)
    else:
        ctx = _paged_attend_multi(cfg, q, k_new, v_new, kv, pos, table)
    out = ctx.transpose(1, 2).reshape(b, t, hl)
    x = x + _proj(p["attn"]["proj"], out, lora)
    xb = _layer_norm(cfg, x, p["ln2"]["scale"], p["ln2"]["bias"])
    return x + _mlp(cfg, p["mlp"], xb, lora)


def decode_verify(cfg: GPTConfig, params, cache, tokens, pos, table=None,
                  lora=None):
    """The speculative verify forward: ``tokens [b, T]`` (this step's
    input token, then T-1 drafts) at positions ``pos[b] .. pos[b] + T -
    1`` through ONE batched forward → ``(fp32 logits [b, T, vocab],
    cache)``; row ``t``'s logits predict position ``pos[b] + t + 1`` and
    match what T sequential :func:`decode_step` calls would give to
    rounding (the matmuls reduce in another order). All T K/V columns
    land in the cache in place; a caller that accepts only a prefix
    leaves the rest as garbage past ``pos``, which decode masks and
    overwrites. Lanes past the position table clamp their
    position-embedding index to ``seq_len - 1`` (their logits are
    discarded). ``lora`` as in :func:`decode_step`."""
    if not cfg.causal:
        raise ValueError(
            "decoding is autoregressive; causal=False has no "
            "incremental-decode semantics")
    if cfg.sequence_parallel:
        cfg = dataclasses.replace(cfg, sequence_parallel=False)
    b, t = tokens.shape
    dev = tokens.device
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).contiguous()
    posn = (pos.long()[:, None] + torch.arange(t, device=dev)[None]).clamp(
        max=cfg.seq_len - 1)
    emb = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    pos_e = params["embedding"]["position"][posn]
    x = (emb[tokens.long()] + pos_e.to(cfg.compute_dtype)).to(
        cfg.compute_dtype)
    pages = _lora_layers(cfg, lora)
    for l, layer_p in enumerate(_layers(params)):
        x = _verify_layer(cfg, _cast_layer(cfg, layer_p), x,
                          _cache_map(lambda c: c[l], cache), pos, table,
                          None if pages is None else pages[l])
    lg = _lm_head(cfg, params, x.reshape(b * t, x.shape[-1]))
    return lg.reshape(b, t, -1), cache


def decode_steps_spec(cfg: GPTConfig, params, cache, state, n: int, *,
                      spec_k: int, pad_token_id: int = 0, draw_fn=None,
                      draft_fn=None, table=None, lora=None):
    """:func:`decode_steps` with draft-k-verify speculation: ``n`` waves,
    each drafting ``spec_k`` tokens from the row's history
    (:func:`ngram_drafts`, or ``draft_fn(hist, tok, k) → [B, k]``),
    verifying all ``spec_k + 1`` positions in ONE :func:`decode_verify`,
    and accepting the matching prefix. Candidate ``j`` is drawn from the
    verify logits of position ``pos + j`` with the plain path's draw at
    the same position, and draft ``j`` survives iff it equals that draw,
    so the emitted stream is the plain path's (greedy and sampled),
    whatever the drafts.

    ``state`` is :func:`decode_steps`'s plus ``hist [B, H]``, the token
    ring the drafter matches against, updated per wave. Returns
    ``(cache, state, tokens, logprobs, finished, valid)``, each ``[B, n
    * (spec_k + 1)]`` wave-major in emission order; ``valid`` is True
    exactly where a real token was emitted (done rows and rejected lanes
    emit ``pad_token_id`` under False). ``lora`` as in
    :func:`decode_step`."""
    k = int(spec_k)
    if k < 1:
        raise ValueError(f"decode_steps_spec needs spec_k >= 1, got {k}")
    if "hist" not in state:
        raise ValueError(
            "decode_steps_spec needs a 'hist' [B, H] token-history ring in "
            "state (see EngineConfig.spec_hist)")
    drafter = draft_fn or ngram_drafts
    st = dict(state)
    toks, lps, fins, vals = [], [], [], []
    for _ in range(n):
        tok, pos = st["tok"], st["pos"]
        drafts = drafter(st["hist"], tok, k).clamp(0, cfg.vocab_size - 1)
        tokens_in = torch.cat([tok[:, None], drafts.to(tok.dtype)], dim=1)
        logits_all, cache = decode_verify(cfg, params, cache, tokens_in,
                                          pos, table, lora)
        live0 = ~st["done"]
        rem, done = st["remaining"], st["done"]
        tok_new, pos_new = tok, pos
        cand_ok = torch.ones_like(live0)
        not_fin = torch.ones_like(live0)
        nxt_prev = None
        emits, lpw, finw, valw = [], [], [], []
        for j in range(k + 1):
            lg = logits_all[:, j]
            tj = pos + j
            if draw_fn is None:
                nxt = _sampling.draw_slots(lg, st["key"], tj, st["temp"],
                                           st["top_k"], st["top_p"])
            else:
                nxt = draw_fn(lg, tj)
            nxt = nxt.to(torch.int64)
            if j > 0:
                # draft j survives iff it matches the target's own draw at
                # its position, and every earlier draft did
                cand_ok = cand_ok & (drafts[:, j - 1] == nxt_prev)
            nxt_prev = nxt
            emit_j = live0 & cand_ok & not_fin
            lp = torch.log_softmax(lg, dim=-1).gather(1, nxt[:, None])[:, 0]
            rem = rem - emit_j.to(rem.dtype)
            hit_eos = emit_j & (st["eos"] >= 0) & (nxt == st["eos"])
            fin_j = emit_j & (hit_eos | (rem <= 0))
            emits.append(torch.where(emit_j, nxt,
                                     torch.full_like(nxt, pad_token_id)))
            lpw.append(torch.where(emit_j, lp, torch.zeros_like(lp)))
            finw.append(fin_j)
            valw.append(emit_j)
            tok_new = torch.where(emit_j, nxt, tok_new)
            pos_new = pos_new + emit_j.to(pos.dtype)
            done = done | fin_j
            not_fin = not_fin & ~fin_j
        toks_w = torch.stack(emits, dim=1)            # [B, k+1]
        val_w = torch.stack(valw, dim=1)
        st = {
            **st,
            "tok": tok_new,
            "pos": pos_new,
            "remaining": rem,
            "done": done,
            "hist": shift_hist(st["hist"], toks_w, val_w.sum(dim=1)),
        }
        toks.append(toks_w)
        lps.append(torch.stack(lpw, dim=1))
        fins.append(torch.stack(finw, dim=1))
        vals.append(val_w)
    return (cache, st, torch.cat(toks, 1), torch.cat(lps, 1),
            torch.cat(fins, 1), torch.cat(vals, 1))


# ---------------------------------------------------------------------------
# prefill and the cache seams
# ---------------------------------------------------------------------------

def check_stop_tokens(cfg: GPTConfig, eos_token_id, pad_token_id) -> None:
    for name, tok_id in (("eos_token_id", eos_token_id),
                         ("pad_token_id", pad_token_id)):
        if tok_id is not None and not 0 <= tok_id < cfg.vocab_size:
            raise ValueError(
                f"{name} {tok_id} outside vocab [0, {cfg.vocab_size})")


def _decode_entry_cfg(cfg: GPTConfig, p_len: int,
                      n_new: Optional[int] = None) -> GPTConfig:
    """Decode-entry validation (autoregressive only, at least one prompt
    token, horizon within ``seq_len``) with sequence parallelism
    stripped."""
    if not cfg.causal:
        raise ValueError(
            "decoding is autoregressive; causal=False has no "
            "incremental-decode semantics")
    if p_len < 1:
        raise ValueError("decoding needs at least one prompt token")
    if n_new is not None and p_len + n_new > cfg.seq_len:
        raise ValueError(
            f"prompt {p_len} + n_new {n_new} exceeds seq_len {cfg.seq_len}")
    if cfg.sequence_parallel:
        cfg = dataclasses.replace(cfg, sequence_parallel=False)
    return cfg


def _prefill_states(cfg: GPTConfig, params, prompt, max_len: int,
                    lora=None):
    """One forward over ``prompt [b, p_len]`` → (cache block ``[L, 2, b,
    heads, max_len, d]``, zero past ``p_len``, in the storage form of
    ``cfg.kv_cache_dtype`` — quantized once at the end, as in JAX; the
    pre-final-LN hidden ``[b, p_len, hidden]``). ``lora`` as in
    :func:`decode_step`, one id a prompt."""
    b, p_len = prompt.shape
    if p_len > max_len:
        raise ValueError(f"prompt {p_len} exceeds cache max_len {max_len}")
    h = _embed(cfg, params, prompt)
    shape, dev = _cache_shape(params, cfg, b, max_len)
    cache = torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
    pages = _lora_layers(cfg, lora)
    for l, layer_p in enumerate(_layers(params)):
        h, (k, v) = _block(cfg, _cast_layer(cfg, layer_p), h,
                           return_kv=True,
                           lora=None if pages is None else pages[l])
        cache[l, 0, :, :, :p_len] = k
        cache[l, 1, :, :, :p_len] = v
    return quantize_cache_block(cfg, cache), h


def prefill(cfg: GPTConfig, params, prompt, *, max_len: Optional[int] = None):
    """Bulk prompt ingestion: one forward over ``prompt [b, p_len]``
    fills a cache and returns ``(cache, logits [b, vocab] fp32)``
    predicting position ``p_len``."""
    cfg = _decode_entry_cfg(cfg, prompt.shape[1])
    cache, h = _prefill_states(cfg, params, prompt, max_len or cfg.seq_len)
    return cache, _lm_head(cfg, params, h[:, -1])


def prefill_at(cfg: GPTConfig, params, prompt, last: int, *,
               max_len: Optional[int] = None):
    """:func:`prefill` for right-padded prompts whose real tokens end at
    ``last``: the logits predict position ``last + 1``. Causal attention
    makes every real position's hidden state and K/V identical to an
    unpadded run; pad positions' cache entries are garbage that decode
    masks and overwrites."""
    cfg = _decode_entry_cfg(cfg, prompt.shape[1])
    cache, h = _prefill_states(cfg, params, prompt, max_len or cfg.seq_len)
    return cache, _lm_head(cfg, params, h[:, int(last)])


def prefill_many(cfg: GPTConfig, params, prompts, last, *,
                 max_len: Optional[int] = None, lora=None):
    """:func:`prefill_at` for a batch of right-padded prompts with
    per-row end positions ``last [k]`` → ``(cache [L, 2, k, heads,
    max_len, d], logits [k, vocab])``; row ``i`` equals a solo
    ``prefill_at(prompts[i:i+1], last[i])``. ``lora`` as in
    :func:`decode_step`, one adapter id a row."""
    cfg = _decode_entry_cfg(cfg, prompts.shape[1])
    cache, h = _prefill_states(cfg, params, prompts,
                               max_len or cfg.seq_len, lora)
    last = torch.as_tensor(last, device=h.device).long()
    h_last = h[torch.arange(h.shape[0], device=h.device), last]
    return cache, _lm_head(cfg, params, h_last)


def prefill_extend(cfg: GPTConfig, params, prefix_kv, tail, last, *,
                   prefix_len: int, lora=None):
    """Tail-only prefill over an already-prefilled prefix: ONE forward
    over the right-padded tail tokens ``tail [b, T]`` (positions
    ``prefix_len .. prefix_len + T - 1``, real tokens ending at the
    tail-local ``last [b]``) attending causally over ``prefix_kv [L, 2,
    b, heads, prefix_len, d]`` (compute dtype, every position real) plus
    the tail's own K/V. Returns ``(tail_kv [L, 2, b, heads, T, d]`` in
    compute dtype, ``logits [b, vocab])``; row ``i``'s logits predict
    position ``prefix_len + last[i] + 1``.

    The prefix pool's admission and chunked prefill's later chunks run
    it. Projections, LayerNorm and the MLP are per position; attention is
    :func:`_xla_attn_probs` (the materialised scores, on every device)
    over the keys in prompt order, prefix then tail, with masked columns
    exact softmax zeros. So where the cold prefill also runs that
    expression (``attn_impl`` "xla") every real position's K/V and the
    end logits are the cold :func:`prefill_many`'s of the whole prompt;
    under flash the two sum in another order and may part at near-ties.
    ``lora`` as in :func:`decode_step`, one adapter id a row."""
    b, tb = tail.shape
    cfg = _decode_entry_cfg(cfg, prefix_len + 1)
    if prefix_len + tb > cfg.seq_len:
        raise ValueError(
            f"prefix_len {prefix_len} + tail width {tb} exceeds the "
            f"position table (cfg.seq_len={cfg.seq_len})")
    if cfg.num_experts:
        # expert capacity follows the routed token count: tail-only
        # routing would drop other tokens than the cold forward
        raise ValueError(
            "prefill_extend does not support num_experts > 0 (expert "
            "capacity depends on the routed token count; tail-only "
            "routing breaks prefix-hit == cold-prefill parity)")
    dev = _params_device(params)
    tail = torch.as_tensor(tail, device=dev).long()
    d = cfg.head_dim
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    pos_e = params["embedding"]["position"][prefix_len:prefix_len + tb]
    h = F.embedding(tail, table) + pos_e[None].to(cfg.compute_dtype)
    # a tail row at global position prefix_len + i sees the whole prefix
    # and the tail columns j <= i: [T, prefix_len + T]
    mask = (torch.arange(prefix_len + tb, device=dev)[None]
            <= prefix_len + torch.arange(tb, device=dev)[:, None])
    layers = _layers(params)
    tail_kv = torch.empty((len(layers), 2, b, prefix_kv.shape[3], tb, d),
                          dtype=cfg.compute_dtype, device=dev)
    pages = _lora_layers(cfg, lora)
    for l, layer_p in enumerate(layers):
        p = _cast_layer(cfg, layer_p)
        lo = None if pages is None else pages[l]
        x = _layer_norm(cfg, h, p["ln1"]["scale"], p["ln1"]["bias"])
        q, k, v = _qkv_project(cfg, p["attn"]["qkv"], x, lo)
        heads = q.shape[-1] // d
        qs, kt, vt = (_split_heads(t, heads) for t in (q, k, v))
        k_full = torch.cat([prefix_kv[l, 0], kt], dim=2)
        v_full = torch.cat([prefix_kv[l, 1], vt], dim=2)
        ctx = _merge_heads(torch.matmul(
            _xla_attn_probs(cfg, qs, k_full, mask), v_full))
        h = h + _proj(p["attn"]["proj"], ctx, lo)
        x = _layer_norm(cfg, h, p["ln2"]["scale"], p["ln2"]["bias"])
        h = h + _mlp(cfg, p["mlp"], x, lo)
        tail_kv[l, 0] = kt
        tail_kv[l, 1] = vt
    last = torch.as_tensor(last, device=dev).long()
    h_last = h[torch.arange(b, device=dev), last]
    return tail_kv, _lm_head(cfg, params, h_last)


def cache_gather_page(cache, page: int, length: int):
    """Page ``page`` of a pool cache (dim 2), cut to its first ``length``
    horizon positions: ``[L, 2, 1, heads, length, d]`` in the pool's
    layout, both planes of a quantized pool. A view of the pool, not a
    copy (the serving engine only reads it)."""
    page = int(page)
    return _cache_map(lambda c: c[:, :, page:page + 1, :, :length], cache)


def cache_gather_pages(cache, pages):
    """The host-swap tier's gather: whole pages ``pages [n]`` of a PAGED
    cache along the page dim, ``[L, 2, n, heads, P, d]`` in the cache's
    own STORAGE dtype (both planes of a quantized pool), as a copy and
    not a view. One-byte planes move as bytes (fp8 has no
    ``index_select`` everywhere), so a block parked in host RAM
    round-trips bit for bit, and :func:`cache_insert_pages` scatters it
    back with ``pages[:, None]``."""
    def gather(c):
        idx = torch.as_tensor(pages, device=c.device).reshape(-1).long()
        return _bytes(c).index_select(2, idx).view(c.dtype)

    return _cache_map(gather, cache)


def cache_insert_slot(cache, block, slot: int, *, pos: int = 0):
    """Insert one prefilled block ``[L, 2, 1, heads, P, d]`` into slot
    ``slot`` of the shared cache ``[L, 2, B, heads, S, d]`` at horizon
    offset ``pos``, IN PLACE (returns ``cache``). Columns past the block
    keep what the slot last held; decode masks them. A quantized cache
    and block (``{"kv", "scale"}``) insert both planes."""
    def ins(c, blk):
        if blk.ndim != c.ndim:
            raise ValueError(
                f"cache block rank {blk.ndim} != cache rank {c.ndim}")
        p = blk.shape[4]
        c[:, :, int(slot), :, pos:pos + p] = blk[:, :, 0].to(c.dtype)

    _cache_map(ins, cache, block)
    return cache


def cache_insert_slots(cache, blocks, slots: Sequence[int]):
    """:func:`cache_insert_slot` for a batch: ``blocks [L, 2, k, heads,
    P, d]`` (or the quantized pair) land at the distinct slot indices
    ``slots``, in place."""
    for i, slot in enumerate(slots):
        cache_insert_slot(cache, _cache_map(lambda x: x[:, :, i:i + 1],
                                            blocks), slot)
    return cache


def cache_insert_pages(cache, blocks, pages, *, page_size: int):
    """Scatter prefilled blocks ``[L, 2, k, heads, span, d]`` (``span`` a
    multiple of ``page_size``; or the quantized pair, whose scale plane
    has no ``d``) into the page pool ``[L, 2, num_pages, heads, P, d]``
    IN PLACE (returns ``cache``): row ``i``'s columns ``[j·P, (j+1)·P)``
    fill page ``pages[i, j]``. Pages must be distinct except for the
    sink, which holds garbage."""
    def ins(c, blk):
        span = blk.shape[4]
        if span % page_size:
            raise ValueError(
                f"block span {span} not a multiple of page_size "
                f"{page_size}")
        L, two, k, h = blk.shape[:4]
        rest = blk.shape[5:]
        n = span // page_size
        nd = len(rest)
        blk = blk.reshape(L, two, k, h, n, page_size, *rest).permute(
            0, 1, 2, 4, 3, 5, *range(6, 6 + nd)).reshape(
            L, two, k * n, h, page_size, *rest)
        idx = torch.as_tensor(pages, device=c.device).reshape(-1).long()
        _bytes(c)[:, :, idx] = _bytes(blk.to(c.dtype))

    _cache_map(ins, cache, blocks)
    return cache


def generate(cfg: GPTConfig, params, prompt, n_new: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: Optional[int] = None,
             eos_token_id: Optional[int] = None, pad_token_id: int = 0,
             device: Optional[Union[str, torch.device]] = None):
    """Continuation: ``prompt [b, p_len]`` → int64 ``[b, n_new]``.

    The prompt is ingested by one :func:`prefill`; the rest rides
    :func:`decode_steps`. ``temperature=0`` is greedy argmax; > 0 samples
    under ``seed`` (required then) with ``top_k``/``top_p`` filters in
    warper order. With ``eos_token_id`` a row that emits it keeps the eos
    and then emits ``pad_token_id``. ``device`` (None → CUDA) must be
    where ``params`` live."""
    dev = resolve_device(device)
    if _params_device(params).type != dev.type:
        raise ValueError(
            f"params on {_params_device(params)} but device is {dev}")
    if temperature > 0.0 and seed is None:
        raise ValueError("temperature > 0 needs a seed")
    if (top_k > 0 or top_p < 1.0) and temperature <= 0.0:
        raise ValueError("top_k/top_p filter sampled draws; set "
                         "temperature > 0")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    check_stop_tokens(cfg, eos_token_id, pad_token_id)
    prompt = torch.as_tensor(prompt, device=_params_device(params)).long()
    b, p_len = prompt.shape
    cfg = _decode_entry_cfg(cfg, p_len, n_new)
    if n_new < 1:
        return torch.zeros((b, 0), dtype=torch.int64, device=prompt.device)

    def draw(lg, t):
        return _sampling.draw(lg, t, temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=seed)

    cache0, logits0 = prefill(cfg, params, prompt, max_len=p_len + n_new)
    first = draw(logits0, p_len - 1)
    eos = eos_token_id
    d = prompt.device
    state = {
        "tok": first,
        "pos": torch.full((b,), p_len, dtype=torch.int32, device=d),
        "remaining": torch.full((b,), 2 ** 30, dtype=torch.int64, device=d),
        "done": (first == eos) if eos is not None
        else torch.zeros((b,), dtype=torch.bool, device=d),
        "eos": torch.full((b,), NO_EOS if eos is None else eos,
                          dtype=torch.int64, device=d),
    }
    # rows decode in lockstep; the shared-seed draw uses the live rows'
    # position (done rows freeze theirs; a live row holds the max)
    _, _, outs, _, _ = decode_steps(
        cfg, params, cache0, state, n_new - 1, pad_token_id=pad_token_id,
        draw_fn=lambda lg, posv: draw(lg, posv.max()))
    return torch.cat([first[:, None], outs], dim=1)


def _top_k_lower(x, k: int):
    """``lax.top_k`` over the last dim: the ``k`` largest values in
    descending order, the LOWER index first among equal values (a stable
    descending sort; bare ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(cfg: GPTConfig, params, prompt, n_new: int, *,
                num_beams: int, eos_token_id: Optional[int] = None,
                pad_token_id: int = 0,
                device: Optional[Union[str, torch.device]] = None):
    """Fixed-length beam search: ``prompt [b, p_len]`` → ``(sequences [b,
    num_beams, n_new]`` int64, ``scores [b, num_beams]`` fp32), beams
    sorted by total log-probability, descending.

    JAX's contract: one :func:`prefill`; the beams ride a ``b *
    num_beams`` decode batch over the contiguous cache (the prompt's
    block repeated per beam); every step takes the fp32 log-softmax, the
    top ``num_beams`` of ``[b, num_beams * vocab]`` candidates (lower
    index first among ties, as ``lax.top_k``), their parent beams and
    tokens, and reorders the cache by parent into a new tensor (the
    decode step writes its column in place, so no later beam may alias
    an earlier one's cache). With ``eos_token_id`` a beam that emits it
    is frozen: it extends only with ``pad_token_id`` at unchanged score.
    The backtrace walks the parents from the final order to the root.
    ``device`` (None → CUDA) must be where ``params`` live."""
    dev = resolve_device(device)
    if _params_device(params).type != dev.type:
        raise ValueError(
            f"params on {_params_device(params)} but device is {dev}")
    prompt = torch.as_tensor(prompt, device=_params_device(params)).long()
    b, p_len = prompt.shape
    k = int(num_beams)
    if k < 1:
        raise ValueError("num_beams must be >= 1")
    if k > cfg.vocab_size:
        raise ValueError(
            f"num_beams {k} exceeds vocab_size {cfg.vocab_size} (the "
            "first step has only vocab_size distinct continuations)")
    check_stop_tokens(cfg, eos_token_id, pad_token_id)
    if n_new < 1:
        raise ValueError("beam_search needs n_new >= 1")
    cfg = _decode_entry_cfg(cfg, p_len, n_new)
    total = p_len + n_new
    d = prompt.device
    eos = eos_token_id

    cache0, logits0 = prefill(cfg, params, prompt, max_len=total)
    scores, first = _top_k_lower(torch.log_softmax(logits0.float(), -1), k)
    # beams become the decode batch: row i * k + j = batch i, beam j
    cache = _cache_map(lambda c: c.repeat_interleave(k, dim=2), cache0)
    done = (first == eos) if eos is not None else None
    frozen = None
    if eos is not None:
        frozen = torch.full((cfg.vocab_size,), -math.inf, device=d)
        frozen[pad_token_id] = 0.0
    row0 = torch.arange(b, device=d)[:, None] * k
    tok_in = first.reshape(b * k)
    toks, parents = [], []
    for t in range(p_len, total - 1):
        logits_, cache = decode_step(cfg, params, cache, tok_in, t)
        logp = torch.log_softmax(logits_.float(), -1).reshape(b, k, -1)
        vocab = logp.shape[-1]
        if eos is not None:
            logp = torch.where(done[:, :, None], frozen, logp)
        scores, flat = _top_k_lower(
            (scores[:, :, None] + logp).reshape(b, k * vocab), k)
        parent = flat // vocab
        tok = flat % vocab
        if eos is not None:
            done = done.gather(1, parent) | (tok == eos)
        gather = (row0 + parent).reshape(b * k)
        cache = _cache_map(lambda c: c.index_select(2, gather), cache)
        tok_in = tok.reshape(b * k)
        toks.append(tok)
        parents.append(parent)
    # backtrace: walk the parents from the final beam order to the root
    beam = torch.arange(k, device=d)[None].expand(b, k)
    tail = []
    for tok, parent in zip(reversed(toks), reversed(parents)):
        tail.append(tok.gather(1, beam))
        beam = parent.gather(1, beam)
    seq = [first.gather(1, beam)] + tail[::-1]
    return torch.stack(seq, dim=-1), scores
