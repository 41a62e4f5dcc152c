"""Data-parallel gradient reduction — port of
``apex_tpu/parallel/distributed.py`` (apex's ``DistributedDataParallel``).

apex hooks each parameter's gradient, packs the ready ones into flat
buckets and all-reduces them on side streams during the backward. Here
the reduction is a call the train step makes once the backward is done,
and what carries over is the policy:

- :func:`allreduce_gradients` — a tree reduced over the dp axis with
  ``gradient_average`` and ``allreduce_always_fp32``, one collective per
  dtype group of flat buffers (:mod:`apex_tpu_torch.multi_tensor`'s
  packing, apex's ``flatten``);
- :func:`flat_dist_call` — the same flat call for ``psum``, ``pmean``
  or a broadcast from one rank (DDP's initial parameter sync);
- :class:`DistributedDataParallel` — wraps a gradient function, with
  ``delay_allreduce`` / ``no_sync`` for gradient accumulation;
- :class:`Reducer` — the reduction at a time of the caller's choosing.

Every rank of the axis makes the same calls in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch import multi_tensor as mt
from apex_tpu_torch.mesh import collectives as C
from apex_tpu_torch.mesh.topology import AXIS_DP, Mesh, resolve_mesh


def _flat(bufs, axis, op, mesh, src):
    out = []
    for b in bufs:
        if op == "psum":
            out.append(C.psum(b, axis, mesh))
        elif op == "pmean":
            out.append(C.pmean(b, axis, mesh))
        elif op == "broadcast":
            out.append(C.pbroadcast_from(b, axis, src, mesh))
        else:
            raise ValueError(f"unknown op {op!r}")
    return out


def flat_dist_call(tree: Any, axis: str = AXIS_DP, *, op: str = "pmean",
                   src: int = 0, mesh: Optional[Mesh] = None) -> Any:
    """The tree packed into one buffer per dtype, ONE collective per
    buffer, unpacked — apex's ``flat_dist_call``. ``op``: ``"pmean"``,
    ``"psum"`` or ``"broadcast"`` (from rank ``src`` of ``axis``)."""
    mesh = resolve_mesh(mesh)
    if not _tree.leaves(tree):
        return tree
    bufs, layout = mt.pack(tree)
    return mt.unpack(_flat(bufs, axis, op, mesh, src), layout)


def allreduce_gradients(grads: Any, axis: str = AXIS_DP, *,
                        gradient_average: bool = True,
                        allreduce_always_fp32: bool = False,
                        mesh: Optional[Mesh] = None) -> Any:
    """A gradient tree reduced over ``axis``: averaged
    (``gradient_average=True``, apex's default) or summed; with
    ``allreduce_always_fp32`` half-precision leaves are reduced in fp32
    and cast back (apex's guard against fp16 overflow in large rings).
    One collective per dtype group."""
    mesh = resolve_mesh(mesh)
    if not _tree.leaves(grads):
        return grads
    op = "pmean" if gradient_average else "psum"
    bufs, layout = mt.pack(grads)
    if allreduce_always_fp32:
        bufs = [b.float() if b.dtype in (torch.float16, torch.bfloat16)
                else b for b in bufs]
    red = _flat(bufs, axis, op, mesh, 0)
    return mt.unpack([r.to(dt) for r, dt in zip(red, layout.group_dtypes)],
                     layout)


@dataclasses.dataclass(frozen=True)
class DistributedDataParallel:
    """Wrap a gradient function so the gradients it returns are reduced
    over ``axis``::

        ddp = DistributedDataParallel(mesh=mesh)
        grad_fn = ddp.wrap_grad_fn(my_grad_fn)       # reduced grads
        g1 = ddp.no_sync(my_grad_fn)(params, shard_a)  # accumulation
        g = grad_fn(params, shard_b, accumulated=g1)

    ``gradient_average`` and ``allreduce_always_fp32`` as apex's;
    ``message_size`` (apex's bucket size) is accepted and unused: the
    reduction is one call per dtype."""

    axis: str = AXIS_DP
    gradient_average: bool = True
    allreduce_always_fp32: bool = False
    delay_allreduce: bool = False
    message_size: int = 10_000_000
    mesh: Optional[Mesh] = None

    def reduce(self, grads):
        return allreduce_gradients(
            grads, self.axis, gradient_average=self.gradient_average,
            allreduce_always_fp32=self.allreduce_always_fp32,
            mesh=self.mesh)

    def wrap_grad_fn(self, grad_fn: Callable) -> Callable:
        def wrapped(*args, accumulated: Optional[Any] = None, **kwargs):
            grads = grad_fn(*args, **kwargs)
            if accumulated is not None:
                grads = _tree.tree_map(torch.add, accumulated, grads)
            if self.delay_allreduce:
                return grads
            return self.reduce(grads)

        return wrapped

    def no_sync(self, grad_fn: Callable) -> Callable:
        """The gradient function without the reduction (accumulation
        micro-batches; torch DDP's ``no_sync``, apex's
        ``delay_allreduce``)."""
        return dataclasses.replace(self, delay_allreduce=True).wrap_grad_fn(
            grad_fn)

    def broadcast_params(self, params):
        """The parameters of dp rank 0 on every rank (DDP's initial
        sync)."""
        return flat_dist_call(params, self.axis, op="broadcast",
                              mesh=self.mesh)


class Reducer:
    """``Reducer(axis).reduce(tree)`` — apex's ``Reducer``: the
    all-reduce at a time of the caller's choosing."""

    def __init__(self, axis: str = AXIS_DP, gradient_average: bool = True,
                 mesh: Optional[Mesh] = None):
        self.axis = axis
        self.gradient_average = gradient_average
        self.mesh = mesh

    def reduce(self, tree):
        return allreduce_gradients(tree, self.axis,
                                   gradient_average=self.gradient_average,
                                   mesh=self.mesh)

    def broadcast(self, tree, src: int = 0):
        return flat_dist_call(tree, self.axis, op="broadcast", src=src,
                              mesh=self.mesh)
