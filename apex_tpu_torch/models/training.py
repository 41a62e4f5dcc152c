"""The fused train step: amp + gradient sync + fused optimizer in one call.

Port of ``apex_tpu/models/training.py`` (``TrainState``,
``_clip_by_global_norm``, ``_clip_leaf_axes``, ``make_loss_train_step``,
and ``make_train_step`` on its non-pipelined path): loss under the
scaler → grads → the gradient sync → optional global-norm clip →
``optimizer.step`` → scaler update.

Without a mesh the step runs on one device (``make_train_step`` is then
a caller of ``make_loss_train_step``). With ``mesh=`` (a
:class:`~apex_tpu_torch.mesh.Mesh` of {dp, tp} over
``torch.distributed``) ``make_train_step`` is JAX's ``_local_step`` on
this rank's shards: the dp average of the gradients
(:func:`~apex_tpu_torch.parallel.allreduce_gradients`), the tp sum of
the sequence-parallel partial gradients, the overflow vote over every
rank, the clip's model-parallel norm, the optimizer, the dp mean of
the loss. Pipeline, context and expert parallelism, FSDP and
``n_chunks > 1`` raise, naming their later distributed slices, and so
do the mesh-only arguments of ``make_loss_train_step``.

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
from apex_tpu_torch.amp import ScalerConfig, ScalerState, apply_if_finite
from apex_tpu_torch.amp import update as scaler_update
from apex_tpu_torch.amp import value_and_scaled_grad
from apex_tpu_torch.mesh import collectives as C
from apex_tpu_torch.mesh.sharding import (
    gather_leaf,
    map_with_specs,
    shard_leaf,
    to_numpy,
)
from apex_tpu_torch.mesh.topology import (
    AXIS_CP,
    AXIS_DP,
    AXIS_EP,
    AXIS_PP,
    AXIS_TP,
    Mesh,
    PartitionSpec,
)
from apex_tpu_torch.models import gpt
from apex_tpu_torch.parallel.distributed import (
    allreduce_gradients,
    flat_dist_call,
)
from apex_tpu_torch.optimizers import (
    FusedAdagradState,
    FusedAdamState,
    FusedLAMBState,
    FusedNovoGradState,
    FusedOptimizer,
    FusedSGDState,
    TreeAdagradState,
    TreeAdamState,
    TreeLAMBState,
    TreeNovoGradState,
    TreeSGDState,
)


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt_state: Any
    scaler: ScalerState
    #: non-trainable model state threaded through the loss; () for GPT
    extra: Any = ()


def _clip_by_global_norm(grads, clip: float, leaf_axes=None,
                         mesh: Optional[Mesh] = None):
    """(clipped grads, pre-clip global L2 norm). Without ``leaf_axes``:
    the leaves' fp32 sums of squares added in tree order. With them (one
    tuple of mesh axes per leaf, :func:`_clip_leaf_axes`): JAX's
    model-parallel norm — each leaf's shard sum of squares is added to
    its axis set's total (sets in order of first appearance), each total
    all-reduced over its axes, then the totals added; a replicated leaf
    counts once."""
    if leaf_axes is None:
        total = None
        for g in _tree.leaves(grads):
            v = torch.sum(torch.square(g.float()))
            total = v if total is None else total + v
    else:
        sq = {}
        for g, axes in zip(_tree.leaves(grads), leaf_axes):
            v = torch.sum(torch.square(g.float()))
            sq[axes] = sq[axes] + v if axes in sq else v
        total = torch.zeros((), dtype=torch.float32,
                            device=_tree.leaves(grads)[0].device)
        for axes, v in sq.items():
            if axes and mesh.size(axes) > 1:
                v = C.psum(v, axes, mesh)
            total = total + v
    norm = torch.sqrt(total)
    coeff = torch.clamp(clip / (norm + 1e-6), max=1.0)
    return _tree.tree_map(lambda g: g * coeff.to(g.dtype), grads), norm


def _mentions(spec, axis: str) -> bool:
    """True when ``axis`` appears in the spec (in tuples too)."""
    return any(a == axis or (isinstance(a, (tuple, list)) and axis in a)
               for a in spec if a is not None)


def _clip_leaf_axes(pspecs, norm_axes):
    """Per leaf, in tree order, the model-parallel axes its spec
    mentions, for the clip's norm."""
    named = map_with_specs(lambda _, sp: ",".join(
        a for a in norm_axes if _mentions(sp, a)), pspecs, pspecs)
    return [tuple(x.split(",")) if x else () for x in _tree.leaves(named)]


def make_loss_train_step(loss_fn: Callable, optimizer: FusedOptimizer, *,
                         init_params: Callable,
                         scaler_cfg: Optional[ScalerConfig] = None,
                         clip_grad_norm: Optional[float] = None,
                         n_batch_args: int = 2, sp_psum_mask=None,
                         fsdp: bool = False, init_extra=None,
                         extra_pspecs=None, extra_sync_dp: bool = True,
                         device: Optional[Union[str, torch.device]] = None):
    """``(init_fn, step_fn)`` over an arbitrary loss on one device — the
    machinery of :func:`make_train_step` for models that are not GPT
    (BERT's :func:`~apex_tpu_torch.models.bert.make_mlm_train_step`,
    ResNet's :func:`~apex_tpu_torch.models.resnet.make_train_step`).

    - ``loss_fn(params, *batch) -> scalar``; ``batch`` is
      ``n_batch_args`` tensors (or arrays) moved to ``device``;
    - ``init_params(generator) -> param tree`` on ``device`` (None →
      CUDA); ``init_fn(generator)`` adds the optimizer state, the scaler
      and the step count;
    - ``init_extra(generator) -> tree`` (or ``"with_params"``:
      ``init_params`` returns ``(params, extra)`` in one pass) enables
      non-trainable model state (BatchNorm running statistics, torch's
      buffers): the loss becomes ``loss_fn(params, extra, *batch) ->
      (loss, new_extra)``, the state rides ``TrainState.extra`` and, on
      an overflow-skipped step, stays as it was with the params;
      ``extra_sync_dp`` (the dp-mean of the state, torch DDP's
      broadcast-buffers role) does nothing on one device;
    - ``step_fn(state, *batch) -> (state, metrics)``: the loss under the
      scaler, the optional global-norm clip (``grad_norm`` metric, the
      pre-clip norm), ``optimizer.step`` with the scaler's skip flag, the
      scaler update. Metrics: ``loss``, ``grads_finite`` (int32),
      ``loss_scale``.

    The mesh-only arguments of the JAX function raise: ``sp_psum_mask``
    (BERT at tp > 1), ``fsdp`` (ZeRO and FSDP) and ``extra_pspecs``
    (SyncBN with ResNet DDP) wait for those distributed slices; GPT's
    mesh step is :func:`make_train_step`'s ``mesh=``."""
    scaler_cfg = scaler_cfg or ScalerConfig(enabled=False)
    later = [name for name, on in (
        ("sp_psum_mask (the distributed slice of BERT at tp > 1)",
         sp_psum_mask is not None),
        ("fsdp (the distributed slice of ZeRO and FSDP)", fsdp),
        ("extra_pspecs (the distributed slice of SyncBN with ResNet DDP)",
         extra_pspecs is not None))
        if on]
    if later:
        raise ValueError("not supported by apex_tpu_torch yet: "
                         + "; ".join(later))
    if not (init_extra is None or init_extra == "with_params"
            or callable(init_extra)):
        raise ValueError(f"init_extra must be None, 'with_params' or a "
                         f"callable, got {init_extra!r}")
    del extra_sync_dp     # one device: its state is already everyone's
    has_extra = init_extra is not None
    dev = resolve_device(device)

    def init_fn(generator: torch.Generator) -> TrainState:
        if init_extra == "with_params":
            params, extra = init_params(generator)
        else:
            params = init_params(generator)
            extra = init_extra(generator) if has_extra else ()
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=params, opt_state=optimizer.init(params),
            scaler=scaler_cfg.init(device=dev), extra=extra)

    vag = value_and_scaled_grad(loss_fn, scaler_cfg, has_aux=has_extra)

    def step_fn(state: TrainState, *batch):
        if len(batch) != n_batch_args:
            raise ValueError(f"step_fn takes {n_batch_args} batch arrays, "
                             f"got {len(batch)}")
        batch = [torch.as_tensor(x, device=dev) for x in batch]
        new_extra = state.extra
        if has_extra:
            (value, new_extra), grads, finite = vag(
                state.params, state.extra, *batch, scaler_state=state.scaler)
            new_extra = _tree.tree_map(torch.Tensor.detach, new_extra)
            if scaler_cfg.enabled:
                new_extra = apply_if_finite(new_extra, state.extra, finite)
        else:
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
                          new_scaler, new_extra), metrics

    return init_fn, step_fn


def make_train_step(cfg: gpt.GPTConfig, optimizer: FusedOptimizer,
                    scaler_cfg: Optional[ScalerConfig] = None, *,
                    n_micro: int = 1, n_chunks: int = 1,
                    clip_grad_norm: Optional[float] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    mesh: Optional[Mesh] = None):
    """``(init_fn, step_fn)`` for GPT training.

    Without ``mesh``: one device, through :func:`make_loss_train_step`.
    ``init_fn(generator) -> TrainState`` initialises params
    (``gpt.init``), optimizer state and scaler on ``device`` (None →
    CUDA); ``generator`` must live there. ``step_fn(state, tokens,
    targets) -> (state, metrics)`` takes ``[batch, seq]`` token and
    target ids.

    With ``mesh`` (built by every rank; ``device`` is the mesh's): the
    step of JAX's ``make_train_step`` over a {dp, tp} mesh.
    ``init_fn(generator)`` draws the global parameters from the
    generator (the same seed on every rank gives the same model) and
    keeps this rank's shards (:func:`gpt.shard_params`); ``step_fn``
    takes the GLOBAL ``[batch, seq]`` batch, as JAX's does, and runs
    this rank's dp block of it: the loss on the shards, the dp average
    of the gradients, the tp all-reduce of the sequence-parallel partial
    gradients (:func:`gpt.seq_partial_grad_mask`), the overflow vote
    (one rank's overflow skips the step on every rank), the clip, the
    optimizer on the shards, the dp mean of the loss. Every rank returns
    the same metrics.

    ``n_micro > 1`` accumulates the gradient over sequential
    microbatches of the (local) batch, each replayed in the backward.
    ``clip_grad_norm`` clips to a global L2 norm before the optimizer
    (tp-sharded leaves' sums of squares summed over tp, replicated ones
    counted once) and adds a ``grad_norm`` metric (the pre-clip norm).
    Metrics: ``loss``, ``grads_finite`` (int32), ``loss_scale``, and
    ``grad_norm`` when clipping."""
    if n_chunks > 1:
        raise ValueError("n_chunks > 1 needs pipeline parallelism, not "
                         "supported by apex_tpu_torch yet (the distributed "
                         "slice of pipeline parallelism)")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    if cfg.remat:
        gpt._remat_policy(cfg)  # fail at build time, not in the first step
    if mesh is not None:
        return _make_mesh_train_step(cfg, optimizer, scaler_cfg, mesh,
                                     n_micro, clip_grad_norm, device)
    dev = resolve_device(device)
    return make_loss_train_step(
        _micro_loss(cfg, n_micro, None), optimizer,
        init_params=lambda g: gpt.init(cfg, g, device=dev),
        scaler_cfg=scaler_cfg, clip_grad_norm=clip_grad_norm,
        n_batch_args=2, device=dev)


def _micro_loss(cfg: gpt.GPTConfig, n_micro: int, mesh: Optional[Mesh]):
    """The loss of a local batch; ``n_micro > 1`` sums the sequential
    microbatches' losses, each under ``checkpoint`` (its forward, the
    collectives included, replays in the backward), and averages."""
    def local_loss(p, tokens, targets):
        if n_micro == 1:
            return gpt.loss(cfg, p, tokens, targets, mesh=mesh)
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(
                f"local batch {b} not divisible by n_micro={n_micro}")
        mb = b // n_micro
        tot = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(n_micro):
            sl = slice(i * mb, (i + 1) * mb)
            tot = tot + checkpoint(gpt.loss, cfg, p, tokens[sl],
                                   targets[sl], mesh=mesh,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        return tot / n_micro

    return local_loss


def _check_mesh(cfg: gpt.GPTConfig, mesh: Mesh) -> None:
    later = [what for what, on in (
        (f"pp={mesh.size(AXIS_PP)} (the distributed slice of pipeline "
         "parallelism)", mesh.size(AXIS_PP) > 1),
        (f"cp={mesh.size(AXIS_CP)} (the distributed slice of CP and MoE)",
         mesh.size(AXIS_CP) > 1),
        (f"ep={mesh.size(AXIS_EP)} (the distributed slice of CP and MoE)",
         mesh.size(AXIS_EP) > 1)) if on]
    if later:
        raise ValueError("not supported by apex_tpu_torch yet: "
                         + "; ".join(later) + " (ROADMAP queue 1 item 4)")
    if cfg.axis != AXIS_TP:
        raise ValueError(f"cfg.axis {cfg.axis!r}: the mesh's tensor axis "
                         f"is {AXIS_TP!r}")


def _dp_rows(x, mesh: Mesh, dev) -> torch.Tensor:
    """This rank's dp block of the global batch's rows."""
    x = torch.as_tensor(x, device=dev)
    dp, i = mesh.size(AXIS_DP), mesh.index(AXIS_DP)
    if x.shape[0] % dp:
        raise ValueError(f"global batch {x.shape[0]} not divisible by "
                         f"dp={dp}")
    b = x.shape[0] // dp
    return x[i * b:(i + 1) * b]


def _make_mesh_train_step(cfg, optimizer, scaler_cfg, mesh: Mesh,
                          n_micro: int, clip_grad_norm, device):
    _check_mesh(cfg, mesh)
    dev = mesh.device
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's {dev}")
    scaler_cfg = scaler_cfg or ScalerConfig(enabled=False)
    dp, tp = mesh.size(AXIS_DP), mesh.size(AXIS_TP)
    pspecs = gpt.param_specs(cfg)
    sp_leaves = [bool(m) for m in _tree.leaves(gpt.seq_partial_grad_mask(
        cfg))]
    clip_axes = _clip_leaf_axes(pspecs, (AXIS_TP, AXIS_PP, AXIS_EP,
                                         AXIS_DP))
    # every rank agrees on finiteness: the axes the grads sync over
    sync_axes = tuple(a for a in (AXIS_PP, AXIS_DP, AXIS_TP)
                      if mesh.size(a) > 1)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = gpt.shard_params(cfg, gpt.init(cfg, generator, device=dev),
                                  mesh)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            params=params, opt_state=optimizer.init(params),
            scaler=scaler_cfg.init(device=dev))

    vag = value_and_scaled_grad(_micro_loss(cfg, n_micro, mesh), scaler_cfg)

    def step_fn(state: TrainState, tokens, targets):
        tok, tgt = _dp_rows(tokens, mesh, dev), _dp_rows(targets, mesh, dev)
        value, grads, finite = vag(state.params, tok, tgt,
                                   scaler_state=state.scaler)
        if dp > 1:
            grads = allreduce_gradients(grads, AXIS_DP, mesh=mesh)
        if cfg.sequence_parallel and tp > 1:
            leaves, spec = _tree.flatten(grads)
            part = flat_dist_call([g for g, m in zip(leaves, sp_leaves)
                                   if m], AXIS_TP, op="psum", mesh=mesh)
            it = iter(part)
            grads = _tree.unflatten(spec, [next(it) if m else g for g, m
                                           in zip(leaves, sp_leaves)])
        if sync_axes:
            finite = C.pmin(finite.to(torch.int32), sync_axes, mesh) > 0
        grad_norm = None
        if clip_grad_norm is not None:
            grads, grad_norm = _clip_by_global_norm(
                grads, clip_grad_norm, clip_axes, mesh)
        skip = ~finite if scaler_cfg.enabled else None
        new_params, new_opt = optimizer.step(grads, state.opt_state,
                                             state.params, skip=skip)
        new_scaler = scaler_update(scaler_cfg, state.scaler, finite)
        loss_out = C.pmean(value, AXIS_DP, mesh) if dp > 1 else value
        metrics = {"loss": loss_out,
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


#: the optimizer states the bridge carries, by the JAX type's name: flat
#: (moments as tuples of group buffers) or tree (moments mirroring the
#: params); the fields are the JAX type's, in its order
_OPT_STATES = {cls.__name__: cls for cls in (
    FusedAdamState, TreeAdamState, FusedLAMBState, TreeLAMBState,
    FusedSGDState, TreeSGDState, FusedAdagradState, TreeAdagradState,
    FusedNovoGradState, TreeNovoGradState)}


def _state_specs(state, pspecs):
    """The specs of a ``TrainState``'s leaves, in its structure: params and
    tree-layout moments by ``pspecs``; a flat optimizer's buffers per
    (pp, tp) rank, as JAX's ``_opt_state_specs`` lays them (the global
    buffer is the ranks' buffers end to end, dp ranks holding copies);
    scalars replicated."""
    params_spec = _tree.flatten(state.params)[1]
    flat = PartitionSpec((AXIS_PP, AXIS_TP))

    def field(x):
        if _tree.flatten(x)[1] == params_spec:
            return pspecs
        return _tree.tree_map(
            lambda a: PartitionSpec() if np.ndim(a) == 0 else flat, x)

    opt = state.opt_state
    return TrainState(
        step=PartitionSpec(), params=pspecs,
        opt_state=type(opt)(*(field(getattr(opt, f)) for f in opt._fields)),
        scaler=ScalerState(*(PartitionSpec(),) * 3), extra=())


def train_state_from_numpy(state, *, device: Optional[
        Union[str, torch.device]] = None, mesh: Optional[Mesh] = None,
        pspecs=None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) → the port's, on ``device`` (None → CUDA). Fields are read
    by name: ``step``, ``params`` (any tree of dicts and lists: GPT's,
    BERT's, ResNet's, in the JAX layouts), ``opt_state`` (an Adam, LAMB,
    SGD, Adagrad or NovoGrad state, flat or tree), ``scaler`` (a ``ScalerState``) and
    ``extra`` (the non-trainable model state, e.g. BatchNorm's running
    statistics; () when there is none).

    With ``mesh``: the global state of JAX's mesh step → this rank's,
    on the mesh's device. Params shard by ``pspecs`` (default GPT's
    :func:`gpt.param_specs`), tree-layout moments like their params, a
    flat optimizer's buffers per (pp, tp) rank (JAX's
    ``_opt_state_specs``), scalars whole."""
    opt = state.opt_state
    kind = type(opt).__name__
    if kind not in _OPT_STATES:
        raise ValueError(f"unsupported optimizer state {kind} (the port "
                         f"carries {', '.join(_OPT_STATES)})")
    cls = _OPT_STATES[kind]
    opt = cls(*(getattr(opt, f) for f in cls._fields))
    sc = state.scaler
    sc = ScalerState(sc.loss_scale, sc.growth_count, sc.hysteresis_left)
    if mesh is not None:
        _check_mesh(gpt.GPTConfig(), mesh)
        state = TrainState(state.step, state.params, opt, sc)
        specs = _state_specs(state, pspecs or gpt.param_specs(
            gpt.GPTConfig()))
        return map_with_specs(lambda a, sp: shard_leaf(a, sp, mesh), state,
                              specs)
    dev = resolve_device(device)
    conv = lambda tree: _tree.tree_map(lambda a: _to_tensor(a, dev), tree)
    return TrainState(
        step=conv(state.step), params=conv(state.params),
        opt_state=type(opt)(*(conv(x) for x in opt)),
        scaler=ScalerState(*(conv(x) for x in sc)),
        extra=conv(getattr(state, "extra", ())))


def train_state_to_numpy(state: TrainState, *, mesh: Optional[Mesh] = None,
                         pspecs=None) -> TrainState:
    """The reverse of :func:`train_state_from_numpy`: the same structure
    with numpy leaves on the host (bfloat16 tensors come back as
    float32); its fields map one to one onto the JAX ``TrainState``.
    With ``mesh`` every rank's shards are gathered into the global state
    of JAX's mesh step, on every rank (a collective)."""
    if mesh is None:
        return _tree.tree_map(_to_numpy, state)
    specs = _state_specs(state, pspecs or gpt.param_specs(gpt.GPTConfig()))
    return map_with_specs(lambda t, sp: to_numpy(gather_leaf(t, sp, mesh)),
                          state, specs)
