"""The fused train step at tp=1: amp + fused optimizer in one call.

Port of ``apex_tpu/models/training.py`` (``TrainState``,
``_clip_by_global_norm``, ``make_loss_train_step``, and
``make_train_step`` on its non-pipelined path, here a caller of
``make_loss_train_step``): loss under the scaler → grads → optional
global-norm clip → ``optimizer.step`` → scaler update. The port has no
mesh: there is no gradient sync, and sequence parallelism, pipeline /
data / context / expert parallelism, FSDP and ``n_chunks > 1`` raise
(the distributed slice).

Differences of idiom from the JAX step:

- the step runs eagerly; ``step_fn`` consumes the state it is given (the
  JAX step donates it) — the flat optimizer updates its moment buffers
  in place;
- on overflow (scaler enabled) the optimizer's ``skip`` flag leaves
  params and optimizer state bit for bit unchanged, which is
  ``apply_if_finite``'s select moved into the sweep;
- the metrics are device tensors; nothing in a step waits on the host.

:func:`train_state_from_numpy` / :func:`train_state_to_numpy` carry a
state across from and to the JAX package as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch import _tree
from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.amp import ScalerConfig, ScalerState
from apex_tpu_torch.amp import update as scaler_update
from apex_tpu_torch.amp import value_and_scaled_grad
from apex_tpu_torch.models import gpt
from apex_tpu_torch.optimizers import (
    FusedAdamState,
    FusedLAMBState,
    FusedOptimizer,
    TreeAdamState,
    TreeLAMBState,
)


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt_state: Any
    scaler: ScalerState
    #: non-trainable model state threaded through the loss; () for GPT
    extra: Any = ()


def _clip_by_global_norm(grads, clip: float):
    """(clipped grads, pre-clip global L2 norm): the leaves' fp32 sums of
    squares, added in tree order, one norm for all."""
    total = None
    for g in _tree.leaves(grads):
        v = torch.sum(torch.square(g.float()))
        total = v if total is None else total + v
    norm = torch.sqrt(total)
    coeff = torch.clamp(clip / (norm + 1e-6), max=1.0)
    return _tree.tree_map(lambda g: g * coeff.to(g.dtype), grads), norm


def make_loss_train_step(loss_fn: Callable, optimizer: FusedOptimizer, *,
                         init_params: Callable,
                         scaler_cfg: Optional[ScalerConfig] = None,
                         clip_grad_norm: Optional[float] = None,
                         n_batch_args: int = 2, sp_psum_mask=None,
                         fsdp: bool = False, init_extra=None,
                         extra_pspecs=None,
                         device: Optional[Union[str, torch.device]] = None):
    """``(init_fn, step_fn)`` over an arbitrary loss on one device — the
    machinery of :func:`make_train_step` for models that are not GPT
    (BERT's :func:`~apex_tpu_torch.models.bert.make_mlm_train_step`).

    - ``loss_fn(params, *batch) -> scalar``; ``batch`` is
      ``n_batch_args`` tensors (or arrays) moved to ``device``;
    - ``init_params(generator) -> param tree`` on ``device`` (None →
      CUDA); ``init_fn(generator)`` adds the optimizer state, the scaler
      and the step count;
    - ``step_fn(state, *batch) -> (state, metrics)``: the loss under the
      scaler, the optional global-norm clip (``grad_norm`` metric, the
      pre-clip norm), ``optimizer.step`` with the scaler's skip flag, the
      scaler update. Metrics: ``loss``, ``grads_finite`` (int32),
      ``loss_scale``.

    The mesh-only arguments of the JAX function raise: ``sp_psum_mask``
    and ``fsdp`` (the distributed slice), ``init_extra`` and
    ``extra_pspecs`` (non-trainable model state: the ResNet slice)."""
    scaler_cfg = scaler_cfg or ScalerConfig(enabled=False)
    later = [name for name, on in (
        ("sp_psum_mask (the distributed slice)", sp_psum_mask is not None),
        ("fsdp (the distributed slice)", fsdp),
        ("init_extra (the ResNet slice)", init_extra is not None),
        ("extra_pspecs (the ResNet slice)", extra_pspecs is not None)) if on]
    if later:
        raise ValueError("not supported by apex_tpu_torch yet: "
                         + "; ".join(later))
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_params(generator)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=params, opt_state=optimizer.init(params),
            scaler=scaler_cfg.init(device=dev))

    vag = value_and_scaled_grad(loss_fn, scaler_cfg)

    def step_fn(state: TrainState, *batch):
        if len(batch) != n_batch_args:
            raise ValueError(f"step_fn takes {n_batch_args} batch arrays, "
                             f"got {len(batch)}")
        batch = [torch.as_tensor(x, device=dev) for x in batch]
        value, grads, finite = vag(state.params, *batch,
                                   scaler_state=state.scaler)
        grad_norm = None
        if clip_grad_norm is not None:
            grads, grad_norm = _clip_by_global_norm(grads, clip_grad_norm)
        # identity scaler: like apex without a scaler the step is never
        # skipped; grads_finite stays a truthful observability metric
        skip = ~finite if scaler_cfg.enabled else None
        new_params, new_opt = optimizer.step(grads, state.opt_state,
                                             state.params, skip=skip)
        new_scaler = scaler_update(scaler_cfg, state.scaler, finite)
        metrics = {"loss": value,
                   "grads_finite": finite.to(torch.int32),
                   "loss_scale": new_scaler.loss_scale}
        if grad_norm is not None:
            metrics["grad_norm"] = grad_norm
        return TrainState(state.step + 1, new_params, new_opt,
                          new_scaler), metrics

    return init_fn, step_fn


def make_train_step(cfg: gpt.GPTConfig, optimizer: FusedOptimizer,
                    scaler_cfg: Optional[ScalerConfig] = None, *,
                    n_micro: int = 1, n_chunks: int = 1,
                    clip_grad_norm: Optional[float] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """``(init_fn, step_fn)`` for GPT training on one device, through
    :func:`make_loss_train_step`.

    ``init_fn(generator) -> TrainState`` initialises params
    (``gpt.init``), optimizer state and scaler on ``device`` (None →
    CUDA); ``generator`` must live there. ``step_fn(state, tokens,
    targets) -> (state, metrics)`` takes ``[batch, seq]`` token and
    target ids. ``n_micro > 1`` accumulates the gradient over sequential
    microbatches, each replayed in the backward. ``clip_grad_norm`` clips
    to a global L2 norm before the optimizer and adds a ``grad_norm``
    metric (the pre-clip norm). Metrics: ``loss``, ``grads_finite``
    (int32), ``loss_scale``, and ``grad_norm`` when clipping."""
    if cfg.sequence_parallel:
        raise ValueError("sequence_parallel is not supported by "
                         "apex_tpu_torch yet (the distributed slice)")
    if n_chunks > 1:
        raise ValueError("n_chunks > 1 needs pipeline parallelism, not "
                         "supported by apex_tpu_torch yet (the distributed "
                         "slice)")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    if cfg.remat:
        gpt._remat_policy(cfg)  # fail at build time, not in the first step
    dev = resolve_device(device)

    def _local_loss(p, tokens, targets):
        if n_micro == 1:
            return gpt.loss(cfg, p, tokens, targets)
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(
                f"local batch {b} not divisible by n_micro={n_micro}")
        mb = b // n_micro
        tot = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(n_micro):
            sl = slice(i * mb, (i + 1) * mb)
            tot = tot + checkpoint(gpt.loss, cfg, p, tokens[sl],
                                   targets[sl], use_reentrant=False,
                                   preserve_rng_state=False)
        return tot / n_micro

    return make_loss_train_step(
        _local_loss, optimizer,
        init_params=lambda g: gpt.init(cfg, g, device=dev),
        scaler_cfg=scaler_cfg, clip_grad_norm=clip_grad_norm,
        n_batch_args=2, device=dev)


# ---------------------------------------------------------------------------
# crossing states with the JAX package
# ---------------------------------------------------------------------------

def _to_tensor(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _to_numpy(t):
    """A host copy: a CPU tensor's ``.numpy()`` would share memory with a
    buffer that the next step updates in place."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


#: the optimizer states the bridge carries: flat (moments as group
#: buffers) or tree (moments mirroring the params)
_OPT_STATES = {"FusedAdamState": (FusedAdamState, True),
               "TreeAdamState": (TreeAdamState, False),
               "FusedLAMBState": (FusedLAMBState, True),
               "TreeLAMBState": (TreeLAMBState, False)}


def train_state_from_numpy(state, *, device: Optional[
        Union[str, torch.device]] = None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) → the port's, on ``device`` (None → CUDA). Fields are read
    by name: ``step``, ``params`` (any nested dicts: GPT's or BERT's),
    ``opt_state`` (``FusedAdamState`` or ``FusedLAMBState`` with flat fp32
    group buffers, or ``TreeAdamState`` or ``TreeLAMBState`` whose
    moments mirror the params) and ``scaler`` (a ``ScalerState``)."""
    dev = resolve_device(device)
    conv = lambda tree: _tree.tree_map(lambda a: _to_tensor(a, dev), tree)
    opt = state.opt_state
    kind = type(opt).__name__
    if kind not in _OPT_STATES:
        raise ValueError(f"unsupported optimizer state {kind} (the port "
                         f"carries {', '.join(_OPT_STATES)})")
    cls, flat = _OPT_STATES[kind]
    if flat:
        opt_t = cls(conv(opt.count), tuple(conv(list(opt.m))),
                    tuple(conv(list(opt.v))))
    else:
        opt_t = cls(conv(opt.count), conv(opt.m), conv(opt.v))
    sc = state.scaler
    return TrainState(
        step=conv(state.step), params=gpt.params_from_numpy(
            state.params, device=dev),
        opt_state=opt_t,
        scaler=ScalerState(conv(sc.loss_scale), conv(sc.growth_count),
                           conv(sc.hysteresis_left)))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The reverse of :func:`train_state_from_numpy`: the same structure
    with numpy leaves on the host (bfloat16 tensors come back as
    float32); its fields map one to one onto the JAX ``TrainState``."""
    return _tree.tree_map(_to_numpy, state)
