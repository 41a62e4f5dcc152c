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
:func:`prefill_at`, :func:`prefill_many`), KV-cache decode
(:func:`decode_step`, :func:`decode_steps`), the cache seams
(:func:`init_cache`, :func:`cache_insert_slot(s)`) and :func:`generate`,
the solo oracle of the serving engine. The port has no mesh and runs
tp=1. Every function has the JAX package's tp=1 semantics with two
differences of idiom:

- the KV cache is updated IN PLACE wherever the JAX function returns a
  new (donated) cache; the functions still return it, so call sites read
  the same;
- random numbers come from explicit ``torch.Generator`` objects (init)
  and from the counter-based draw of :mod:`apex_tpu_torch.serving.sampling`.

Attention dispatch: ``attn_impl="flash"`` runs the port's flash kernel
(:func:`apex_tpu_torch.kernels.flash_attention_bsh`), ``"xla"`` the
materialised-scores expression of ``_xla_attn_probs``; ``"auto"`` is
``"flash"`` on CUDA at every length and ``"xla"`` on the CPU.
``decode_attn_impl="kernel"`` runs the port's flash-decode kernels,
``"xla"`` the one-hot/materialised form; ``"auto"`` is ``"kernel"`` on
CUDA at every horizon and ``"xla"`` on the CPU. On the CPU an explicit
``"flash"``/``"kernel"`` runs the kernels' plain versions.

Remat: ``remat=True`` wraps each layer in ``torch.utils.checkpoint``
(non-reentrant). ``remat_policy=None`` saves nothing inside the layer,
so the backward replays all of it, the flash forward included; a named
policy is a selective-checkpoint policy (:func:`_remat_policy`) that
saves the outputs the JAX policy names — the flash forward op's
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
from apex_tpu_torch.kernels.flash_attention import FLASH_FWD_OP
from apex_tpu_torch.kernels.layer_norm import layer_norm
from apex_tpu_torch.serving import sampling as _sampling
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
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
    at construction: context parallelism and FSDP (the distributed
    slice), experts (the MoE slice), quantized KV caches, the fused
    cross entropy (the xentropy kernel's slice), and the head-major flash
    layout / chunked XLA attention. ``ln_impl="pallas"`` is the port's
    LayerNorm kernel (:mod:`apex_tpu_torch.kernels.layer_norm`)."""

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
            later.append("context_parallel (the port has no mesh: the "
                         "distributed slice)")
        if self.fsdp:
            later.append("fsdp (the distributed slice)")
        if self.num_experts > 0:
            later.append("num_experts > 0 (the MoE slice)")
        if self.kv_cache_dtype in ("int8", "fp8"):
            later.append(f"kv_cache_dtype={self.kv_cache_dtype!r} (the "
                         "quantized-cache slice)")
        if self.ce_impl == "fused":
            later.append("ce_impl='fused' (the xentropy kernel's slice)")
        if self.attn_impl == "xla_chunked":
            later.append("attn_impl='xla_chunked' (the long-context "
                         "slice)")
        if self.attn_layout == "bhsd":
            later.append("attn_layout='bhsd' (the head-major flash "
                         "kernel's slice)")
        if later:
            raise ValueError(
                "not supported by apex_tpu_torch yet: " + "; ".join(later))
        for name, value, allowed in (
                ("attn_impl", self.attn_impl, ("auto", "flash", "xla")),
                ("attn_layout", self.attn_layout, ("auto",)),
                ("ln_impl", self.ln_impl, ("xla", "pallas")),
                ("ce_impl", self.ce_impl, ("xla",)),
                ("attn_score_dtype", self.attn_score_dtype,
                 ("f32", "compute")),
                ("decode_attn_impl", self.decode_attn_impl,
                 ("auto", "kernel", "xla")),
                ("kv_cache_dtype", self.kv_cache_dtype, ("auto", "bf16"))):
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


def params_to_numpy(params) -> Dict[str, Any]:
    """The reverse of :func:`params_from_numpy`: nested dicts of numpy
    arrays on the host (bfloat16 tensors come back as float32)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _tree_map(conv, params)


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


def _qkv_project(cfg: GPTConfig, p, x):
    """The three slab matmuls of the ``[h, 3, h]`` fused QKV weight →
    ``(q, k, v)``, each ``[..., h]`` in the flash kernel's layout."""
    ws, bs = p["kernel"].unbind(1), p["bias"].unbind(0)
    with _remat_name("attn_qkv"):
        ys = [torch.matmul(x, w) for w in ws]
    return tuple(y + b for y, b in zip(ys, bs))


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
    hidden]``: the flash kernel, or the materialised scores."""
    if _attn_impl(cfg, q.device) == "flash":
        return flash_attention_bsh(q, k, v, num_heads=heads,
                                   causal=cfg.causal)
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


def _mlp(cfg: GPTConfig, p, h):
    with _remat_name("mlp_fc1"):
        y = torch.matmul(h, p["fc1"]["kernel"])
    y = F.gelu(y + p["fc1"]["bias"], approximate="tanh")
    return torch.matmul(y, p["fc2"]["kernel"]) + p["fc2"]["bias"]


def _block(cfg: GPTConfig, p, h, *, return_kv: bool = False):
    """One transformer layer over ``h [b, s, hidden]``; with
    ``return_kv`` also the attention's ``(k, v)`` as ``[b, heads, s,
    d]`` — the cache entries bulk prefill captures."""
    x = _layer_norm(cfg, h, p["ln1"]["scale"], p["ln1"]["bias"])
    q, k, v = _qkv_project(cfg, p["attn"]["qkv"], x)
    heads = q.shape[-1] // cfg.head_dim
    ctx = _attention_ctx(cfg, q, k, v, heads)
    h = h + (torch.matmul(ctx, p["attn"]["proj"]["kernel"])
             + p["attn"]["proj"]["bias"])
    x = _layer_norm(cfg, h, p["ln2"]["scale"], p["ln2"]["bias"])
    h = h + _mlp(cfg, p["mlp"], x)
    if return_kv:
        return h, (_split_heads(k, heads), _split_heads(v, heads))
    return h


def _embed(cfg: GPTConfig, params, tokens):
    """tokens ``[b, s]`` → entry activation ``[b, s, hidden]``."""
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    pos = params["embedding"]["position"][: tokens.shape[1]]
    return F.embedding(tokens.long(), table) + pos[None].to(cfg.compute_dtype)


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
    ``"flash"`` (JAX's ``flash_out``/``flash_lse``) is the flash forward
    op, whose ``(out, lse)`` is saved whole; ``"attn_qkv"`` and
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
        if op is FLASH_FWD_OP:
            keep = saves is not None and "flash" in saves
        elif op is mm:
            keep = saves is None or getattr(_REMAT_NAME, "value",
                                            None) in saves
        else:
            keep = False
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


def _scan_blocks(cfg: GPTConfig, h, layers):
    """``h`` through the per-layer params ``layers`` → ``(h, aux_sum)``
    (aux is the MoE term, 0 for the dense model). With ``cfg.remat`` and
    gradients to take, each layer runs under ``checkpoint`` with the
    policy of :func:`_remat_policy`."""
    body = lambda layer_p, x: _block(cfg, _cast_layer(cfg, layer_p), x)
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


def hidden_states_and_aux(cfg: GPTConfig, params, tokens):
    """tokens ``[b, s]`` → (final-LN hidden ``[b, s, hidden]`` in compute
    dtype, summed MoE aux loss — 0 for the dense model)."""
    h, aux = _scan_blocks(cfg, _embed(cfg, params, tokens), _layers(params))
    return _layer_norm(cfg, h, params["final_ln"]["scale"],
                       params["final_ln"]["bias"]), aux


def hidden_states(cfg: GPTConfig, params, tokens):
    """tokens ``[b, s]`` → final-LN hidden ``[b, s, hidden]`` in compute
    dtype (sequence parallelism is a no-op at tp=1)."""
    return hidden_states_and_aux(cfg, params, tokens)[0]


def logits(cfg: GPTConfig, params, tokens):
    """Logits ``[b, s, vocab]`` in compute dtype, the output head tied to
    the word embedding."""
    h = hidden_states(cfg, params, tokens)
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    return torch.matmul(h, table.t())


def _ce_of_hidden(cfg: GPTConfig, params, h, targets_bs):
    """Mean CE from final hidden states ``h [b, s, hidden]`` against
    ``targets_bs [b, s]``, in fp32 logits against the tied table. With
    ``cfg.ce_chunk`` the sequence is cut into chunks, each under
    ``checkpoint``: the forward keeps only each chunk's loss sum and the
    backward recomputes that chunk's logits, so peak memory is
    O(chunk * b * vocab) instead of O(s * b * vocab)."""
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    b, s = targets_bs.shape
    chunk = cfg.ce_chunk
    if chunk > 0 and s % chunk:
        raise ValueError(
            f"ce_chunk={chunk} must divide the (SP-local) sequence "
            f"length {s}")
    if cfg.ce_impl != "xla":
        raise ValueError(f"unknown ce_impl {cfg.ce_impl!r}")

    def ce_sum(hb, tb, tab):
        lg = torch.matmul(hb, tab.t()).float()
        return vocab_parallel_cross_entropy(lg, tb, 0.0).sum()

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


def loss(cfg: GPTConfig, params, tokens, targets):
    """Mean next-token cross entropy over the batch, fp32 logits in
    vocab-parallel CE (tp=1). ``targets [b, s]``."""
    if cfg.sequence_parallel:
        raise ValueError(
            "sequence_parallel is not supported by apex_tpu_torch yet "
            "(the distributed slice)")
    h, _ = hidden_states_and_aux(cfg, params, tokens)
    return _ce_of_hidden(cfg, params, h, targets)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def init_cache(cfg: GPTConfig, params, batch: int,
               max_len: Optional[int] = None):
    """Zero KV cache on the parameters' device, layout ``[L, 2, batch,
    heads, max_len, head_dim]`` in compute dtype (``max_len`` defaults
    to ``cfg.seq_len``)."""
    qkv_k = params["layers"]["attn"]["qkv"]["kernel"]
    heads = qkv_k.shape[-1] // cfg.head_dim
    shape = (qkv_k.shape[0], 2, batch, heads, max_len or cfg.seq_len,
             cfg.head_dim)
    return torch.zeros(shape, dtype=cfg.compute_dtype, device=qkv_k.device)


def _decode_attn_impl(cfg: GPTConfig, device: torch.device) -> str:
    """THE decode-attention dispatch predicate: ``"auto"`` → the kernel
    on CUDA at every horizon, the XLA form on the CPU."""
    if cfg.decode_attn_impl == "auto":
        return "kernel" if device.type == "cuda" else "xla"
    return cfg.decode_attn_impl


def _decode_attend(cfg: GPTConfig, q, k_new, v_new, kv, pos):
    """Write this token's K/V at ``pos [b]`` (int32) into the layer's
    cache ``kv [2, b, heads, S, d]`` IN PLACE and attend ``q [b, heads,
    d]`` over ``0..pos`` → ``ctx [b, heads, d]``."""
    d = q.shape[-1]
    if _decode_attn_impl(cfg, q.device) == "kernel":
        return decode_attention(q, k_new, v_new, kv[0], kv[1], pos,
                                scale=1.0 / math.sqrt(d))
    s_max = kv.shape[3]
    rows = torch.arange(q.shape[0], device=q.device)
    p = pos.long()
    kv[0][rows, :, p] = k_new.to(kv.dtype)
    kv[1][rows, :, p] = v_new.to(kv.dtype)
    valid = (torch.arange(s_max, device=q.device)[None] <= p[:, None])[:, None]
    # scale folded into q BEFORE the product (the fp16 range guard)
    q = q * torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    scores = torch.einsum("bhd,bhsd->bhs", q, kv[0]).float()
    scores = scores.masked_fill(~valid, -1e30)
    p_attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bhsd->bhd", p_attn, kv[1])


def _decode_layer(cfg: GPTConfig, p, x, kv, pos):
    """One layer for one token: ``x [b, hidden]``, ``kv`` the layer's
    cache ``[2, b, heads, S, d]`` (updated in place)."""
    xa = _layer_norm(cfg, x, p["ln1"]["scale"], p["ln1"]["bias"])
    d = cfg.head_dim
    b = xa.shape[0]
    q, k_new, v_new = (t.reshape(b, t.shape[-1] // d, d)
                       for t in _qkv_project(cfg, p["attn"]["qkv"], xa))
    ctx = _decode_attend(cfg, q, k_new, v_new, kv, pos).reshape(b, -1)
    x = x + (torch.matmul(ctx, p["attn"]["proj"]["kernel"])
             + p["attn"]["proj"]["bias"])
    xb = _layer_norm(cfg, x, p["ln2"]["scale"], p["ln2"]["bias"])
    return x + _mlp(cfg, p["mlp"], xb)


def _lm_head(cfg: GPTConfig, params, h):
    """Tied-embedding head for one position: ``h [b, hidden]`` (pre
    final LN) → fp32 logits ``[b, vocab]``."""
    h = _layer_norm(cfg, h, params["final_ln"]["scale"],
                    params["final_ln"]["bias"])
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    return torch.matmul(h, table.t()).float()


def decode_step(cfg: GPTConfig, params, cache, token, pos):
    """One decoding step: ``token [b]`` at position ``pos`` (an int, a
    0-d tensor, or a ``[b]`` vector of per-row positions) → ``(fp32
    logits [b, vocab], cache)``; the cache gains each row's K/V column
    at its position in place. Entries past a row's position are masked
    to exact softmax zeros, so a row's logits do not depend on its
    batch-mates or the horizon."""
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
    table = params["embedding"]["word"]["table"].to(cfg.compute_dtype)
    pos_e = params["embedding"]["position"][pos.long()]
    x = (table[token.long()] + pos_e.to(cfg.compute_dtype)).to(
        cfg.compute_dtype)
    for l, layer_p in enumerate(_layers(params)):
        x = _decode_layer(cfg, _cast_layer(cfg, layer_p), x, cache[l], pos)
    return _lm_head(cfg, params, x), cache


def decode_steps(cfg: GPTConfig, params, cache, state, n: int, *,
                 pad_token_id: int = 0, draw_fn=None):
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
    sampler).

    Returns ``(cache, state, tokens [B, n], logprobs [B, n], finished
    [B, n])``; ``logprobs`` is the log-softmax of the raw fp32 logits at
    each emitted token, 0.0 in pad lanes."""
    st = dict(state)
    toks, lps, fins = [], [], []
    for _ in range(n):
        logits_, cache = decode_step(cfg, params, cache, st["tok"],
                                     st["pos"])
        if draw_fn is None:
            nxt = _sampling.draw_slots(logits_, st["key"], st["pos"],
                                       st["temp"], st["top_k"], st["top_p"])
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


def _prefill_states(cfg: GPTConfig, params, prompt, max_len: int):
    """One forward over ``prompt [b, p_len]`` → (cache block ``[L, 2, b,
    heads, max_len, d]``, zero past ``p_len``; pre-final-LN hidden
    ``[b, p_len, hidden]``)."""
    b, p_len = prompt.shape
    if p_len > max_len:
        raise ValueError(f"prompt {p_len} exceeds cache max_len {max_len}")
    h = _embed(cfg, params, prompt)
    cache = init_cache(cfg, params, b, max_len)
    for l, layer_p in enumerate(_layers(params)):
        h, (k, v) = _block(cfg, _cast_layer(cfg, layer_p), h,
                           return_kv=True)
        cache[l, 0, :, :, :p_len] = k
        cache[l, 1, :, :, :p_len] = v
    return cache, h


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
                 max_len: Optional[int] = None):
    """:func:`prefill_at` for a batch of right-padded prompts with
    per-row end positions ``last [k]`` → ``(cache [L, 2, k, heads,
    max_len, d], logits [k, vocab])``; row ``i`` equals a solo
    ``prefill_at(prompts[i:i+1], last[i])``."""
    cfg = _decode_entry_cfg(cfg, prompts.shape[1])
    cache, h = _prefill_states(cfg, params, prompts,
                               max_len or cfg.seq_len)
    last = torch.as_tensor(last, device=h.device).long()
    h_last = h[torch.arange(h.shape[0], device=h.device), last]
    return cache, _lm_head(cfg, params, h_last)


def cache_insert_slot(cache, block, slot: int, *, pos: int = 0):
    """Insert one prefilled block ``[L, 2, 1, heads, P, d]`` into slot
    ``slot`` of the shared cache ``[L, 2, B, heads, S, d]`` at horizon
    offset ``pos``, IN PLACE (returns ``cache``). Columns past the block
    keep what the slot last held; decode masks them."""
    if block.ndim != cache.ndim:
        raise ValueError(
            f"cache block rank {block.ndim} != cache rank {cache.ndim}")
    p = block.shape[4]
    cache[:, :, int(slot), :, pos:pos + p] = block[:, :, 0].to(cache.dtype)
    return cache


def cache_insert_slots(cache, blocks, slots: Sequence[int]):
    """:func:`cache_insert_slot` for a batch: ``blocks [L, 2, k, heads,
    P, d]`` land at the distinct slot indices ``slots``, in place."""
    for i, slot in enumerate(slots):
        cache_insert_slot(cache, blocks[:, :, i:i + 1], slot)
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
