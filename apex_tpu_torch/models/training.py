"""The fused GPT train step at tp=1: amp + fused optimizer in one call.

Port of ``apex_tpu/models/training.py`` (``TrainState``,
``_clip_by_global_norm``, ``make_train_step`` on its non-pipelined
path): loss under the scaler → grads → optional global-norm clip →
``optimizer.step`` → scaler update. The port has no mesh: there is no
gradient sync, and sequence parallelism, pipeline / data / context /
expert parallelism, FSDP and ``n_chunks > 1`` raise (the distributed
slice).

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

from typing import Any, NamedTuple, Optional, Union

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
    FusedOptimizer,
    TreeAdamState,
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


def make_train_step(cfg: gpt.GPTConfig, optimizer: FusedOptimizer,
                    scaler_cfg: Optional[ScalerConfig] = None, *,
                    n_micro: int = 1, n_chunks: int = 1,
                    clip_grad_norm: Optional[float] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """``(init_fn, step_fn)`` for GPT training on one device.

    ``init_fn(generator) -> TrainState`` initialises params
    (``gpt.init``), optimizer state and scaler on ``device`` (None →
    CUDA); ``generator`` must live there. ``step_fn(state, tokens,
    targets) -> (state, metrics)`` takes ``[batch, seq]`` token and
    target ids. ``n_micro > 1`` accumulates the gradient over sequential
    microbatches, each replayed in the backward. ``clip_grad_norm`` clips
    to a global L2 norm before the optimizer and adds a ``grad_norm``
    metric (the pre-clip norm). Metrics: ``loss``, ``grads_finite``
    (int32), ``loss_scale``, and ``grad_norm`` when clipping."""
    scaler_cfg = scaler_cfg or ScalerConfig(enabled=False)
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

    def init_fn(generator: torch.Generator) -> TrainState:
        params = gpt.init(cfg, generator, device=dev)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=params, opt_state=optimizer.init(params),
            scaler=scaler_cfg.init(device=dev))

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

    vag = value_and_scaled_grad(_local_loss, scaler_cfg)

    def step_fn(state: TrainState, tokens, targets):
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        value, grads, finite = vag(state.params, tokens, targets,
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


def train_state_from_numpy(state, *, device: Optional[
        Union[str, torch.device]] = None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) → the port's, on ``device`` (None → CUDA). Fields are read
    by name: ``step``, ``params``, ``opt_state`` (a ``FusedAdamState``
    with flat fp32 group buffers, or a ``TreeAdamState`` whose moments
    mirror the params) and ``scaler`` (a ``ScalerState``)."""
    dev = resolve_device(device)
    conv = lambda tree: _tree.tree_map(lambda a: _to_tensor(a, dev), tree)
    opt = state.opt_state
    kind = type(opt).__name__
    if kind == "FusedAdamState":
        opt_t = FusedAdamState(conv(opt.count), tuple(conv(list(opt.m))),
                               tuple(conv(list(opt.v))))
    elif kind == "TreeAdamState":
        opt_t = TreeAdamState(conv(opt.count), conv(opt.m), conv(opt.v))
    else:
        raise ValueError(f"unsupported optimizer state {kind} (the port "
                         "carries FusedAdamState and TreeAdamState)")
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
