"""The collective autograd mappings tensor parallelism is built from.

Port of ``apex_tpu/transformer/tensor_parallel/mappings.py`` (apex's
seven ``torch.autograd.Function`` pairs), over the collectives of
:mod:`apex_tpu_torch.mesh.collectives`. Forward and backward pairs, the
JAX package's exactly:

====================================  ==================  ==================
mapping                               forward             backward
====================================  ==================  ==================
copy_to_tensor_model_parallel_region  identity            all-reduce
reduce_from_tensor_model_parallel…    all-reduce          identity
scatter_to_tensor_model_parallel…     split last dim      all-gather last
gather_from_tensor_model_parallel…    all-gather last     split last dim
scatter_to_sequence_parallel_region   split seq dim       all-gather seq
gather_from_sequence_parallel_region  all-gather seq      reduce-scatter seq
                                                          (or split, when
                                                          its consumer is
                                                          not tp-parallel)
reduce_scatter_to_sequence_parallel…  reduce-scatter seq  all-gather seq
====================================  ==================  ==================

The sequence dimension defaults to dim 0 (Megatron's [s, b, h]); the
batch-major GPT passes ``dim=1``. Each takes the mesh as ``mesh=``, else
the current ``with mesh:``, else the installed
:mod:`~apex_tpu_torch.transformer.parallel_state`'s
(:func:`~apex_tpu_torch.mesh.topology.resolve_mesh`). Over an axis of one
rank every mapping is the identity (apex returns its input when the
tensor-parallel world size is 1). A backward runs its collective on the
mesh its forward saw, in whatever thread autograd runs it.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.mesh import collectives as C
from apex_tpu_torch.mesh.topology import AXIS_TP, Mesh, resolve_mesh

_SEQ_DIM = 0
_LAST_DIM = -1


def local_chunk(x: torch.Tensor, axis: str, dim: int, mesh: Mesh
                ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (contiguous)."""
    size = mesh.size(axis)
    dim = dim % x.dim()
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not "
                         f"divisible by axis {axis!r} size {size}")
    chunk = x.shape[dim] // size
    return x.narrow(dim, mesh.index(axis) * chunk, chunk).contiguous()


def _gather(x, axis, dim, mesh):
    return C.all_gather(x, axis, gather_axis=dim, tiled=True, mesh=mesh)


def _reduce_scatter(x, axis, dim, mesh):
    return C.psum_scatter(x, axis, scatter_axis=dim, tiled=True, mesh=mesh)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.psum(g, ctx.axis, ctx.mesh), None, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return C.psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ScatterToRegion(torch.autograd.Function):
    """Local block forward, all-gather backward, along ``dim``."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return local_chunk(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None


class _GatherFromRegion(torch.autograd.Function):
    """All-gather forward along ``dim``; backward a reduce-scatter
    (``reduce_grad``) or the local block."""

    @staticmethod
    def forward(ctx, x, axis, dim, reduce_grad, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        ctx.reduce_grad = reduce_grad
        return _gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            dx = _reduce_scatter(g, ctx.axis, ctx.dim, ctx.mesh)
        else:
            dx = local_chunk(g, ctx.axis, ctx.dim, ctx.mesh)
        return dx, None, None, None, None


class _ReduceScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return _reduce_scatter(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim, ctx.mesh), None, None, None


def _active(axis: str, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh when ``axis`` spans more than one rank, else None."""
    mesh = resolve_mesh(mesh)
    return mesh if mesh.size(axis) > 1 else None


def copy_to_tensor_model_parallel_region(x, axis: str = AXIS_TP, *,
                                         mesh: Optional[Mesh] = None):
    """Enter a TP region with a replicated activation: identity forward,
    all-reduce backward."""
    m = _active(axis, mesh)
    return x if m is None else _CopyToRegion.apply(x, axis, m)


def reduce_from_tensor_model_parallel_region(x, axis: str = AXIS_TP, *,
                                             mesh: Optional[Mesh] = None):
    """Leave a TP region: all-reduce forward, identity backward."""
    m = _active(axis, mesh)
    return x if m is None else _ReduceFromRegion.apply(x, axis, m)


def scatter_to_tensor_model_parallel_region(x, axis: str = AXIS_TP, *,
                                            mesh: Optional[Mesh] = None):
    """Keep this rank's block of the last dim; all-gather backward."""
    m = _active(axis, mesh)
    return x if m is None else _ScatterToRegion.apply(x, axis, _LAST_DIM, m)


def gather_from_tensor_model_parallel_region(x, axis: str = AXIS_TP, *,
                                             mesh: Optional[Mesh] = None):
    """All-gather the last dim; the local block backward."""
    m = _active(axis, mesh)
    return x if m is None else _GatherFromRegion.apply(
        x, axis, _LAST_DIM, False, m)


def scatter_to_sequence_parallel_region(x, axis: str = AXIS_TP,
                                        dim: int = _SEQ_DIM, *,
                                        mesh: Optional[Mesh] = None):
    """Shard the sequence dim across the TP ranks (the SP entry)."""
    m = _active(axis, mesh)
    return x if m is None else _ScatterToRegion.apply(x, axis, dim, m)


def gather_from_sequence_parallel_region(
        x, axis: str = AXIS_TP, tensor_parallel_output_grad: bool = True,
        dim: int = _SEQ_DIM, *, mesh: Optional[Mesh] = None):
    """All-gather the sequence dim before a column-parallel linear. The
    backward is a reduce-scatter when the consumer is tensor-parallel
    (each rank holds a partial gradient of the whole sequence), else the
    local block."""
    m = _active(axis, mesh)
    return x if m is None else _GatherFromRegion.apply(
        x, axis, dim, bool(tensor_parallel_output_grad), m)


def reduce_scatter_to_sequence_parallel_region(x, axis: str = AXIS_TP,
                                               dim: int = _SEQ_DIM, *,
                                               mesh: Optional[Mesh] = None):
    """Sum the partial products and shard the sequence dim after a
    row-parallel linear."""
    m = _active(axis, mesh)
    return x if m is None else _ReduceScatterToRegion.apply(x, axis, dim, m)
