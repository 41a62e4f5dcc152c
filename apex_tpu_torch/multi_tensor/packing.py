"""Static tree → flat per-dtype buffer packing.

Port of ``apex_tpu/multi_tensor/packing.py`` (``pad_to``, ``FlatLayout``,
``pack``, ``unpack``, ``pack_cast``, ``flatten_dense_tensors``,
``unflatten_dense_tensors`` and ``MultiTensorApply``). The grouping, leaf
order, offsets
and padding are the JAX package's: leaves in JAX's tree order (sorted
dict keys), one buffer per dtype in order of first appearance, each
padded to a multiple of ``512 * 128`` elements. So a flat optimizer
state written by either package crosses to the other as numpy arrays.

:func:`unpack` returns views into the buffers (no copy); :func:`pack`
and :func:`pack_cast` write one new buffer per group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch import _tree

#: the TPU lane width the JAX package pads for; kept so offsets agree
LANE = 128

#: pad granularity: 512 rows x 128 lanes (the JAX package's
#: ``_PAD_MULTIPLE``)
_PAD_MULTIPLE = 512 * LANE


def pad_to(n: int, multiple: int = _PAD_MULTIPLE) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class _LeafMeta:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    group: int      # index into the per-dtype buffer list
    offset: int     # element offset within the group buffer
    size: int


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """How a tree maps into flat buffers: per leaf its group and offset,
    per group its dtype, padded size and used size."""

    treedef: Any
    leaves: Tuple[_LeafMeta, ...]
    group_dtypes: Tuple[torch.dtype, ...]
    group_sizes: Tuple[int, ...]        # padded sizes
    group_used: Tuple[int, ...]         # unpadded element counts

    @property
    def num_groups(self) -> int:
        return len(self.group_dtypes)


def layout_of(tree: Any) -> FlatLayout:
    leaves, treedef = _tree.flatten(tree)
    group_index = {}
    cursor: List[int] = []
    dtypes: List[torch.dtype] = []
    metas: List[_LeafMeta] = []
    for leaf in leaves:
        dt = leaf.dtype
        if dt not in group_index:
            group_index[dt] = len(dtypes)
            dtypes.append(dt)
            cursor.append(0)
        g = group_index[dt]
        size = math.prod(leaf.shape)
        metas.append(_LeafMeta(tuple(leaf.shape), dt, g, cursor[g], size))
        cursor[g] += size
    return FlatLayout(treedef=treedef, leaves=tuple(metas),
                      group_dtypes=tuple(dtypes),
                      group_sizes=tuple(pad_to(c) for c in cursor),
                      group_used=tuple(cursor))


def _concat(parts: List[torch.Tensor], padded: int, dtype, device):
    used = sum(p.numel() for p in parts)
    if padded > used:
        parts = parts + [torch.zeros(padded - used, dtype=dtype,
                                     device=device)]
    if not parts:
        return torch.zeros(0, dtype=dtype, device=device)
    return torch.cat(parts)


def _check_leaf_count(leaves, layout: FlatLayout) -> None:
    if len(leaves) != len(layout.leaves):
        raise ValueError("tree does not match layout (leaf count differs)")


def pack(tree: Any, layout: Optional[FlatLayout] = None
         ) -> Tuple[List[torch.Tensor], FlatLayout]:
    """One padded 1-D buffer per dtype (``apex_C.flatten``); ``layout``
    may be passed to reuse one (it is checked against the tree)."""
    if layout is None:
        layout = layout_of(tree)
    leaves = _tree.leaves(tree)
    _check_leaf_count(leaves, layout)
    parts: List[List[torch.Tensor]] = [[] for _ in range(layout.num_groups)]
    for leaf, meta in zip(leaves, layout.leaves):
        if tuple(leaf.shape) != meta.shape or leaf.dtype != meta.dtype:
            raise ValueError(
                f"leaf mismatch: got {tuple(leaf.shape)}/{leaf.dtype}, "
                f"layout has {meta.shape}/{meta.dtype}")
        parts[meta.group].append(leaf.reshape(-1))
    device = leaves[0].device if leaves else None
    return [_concat(parts[g], layout.group_sizes[g],
                    layout.group_dtypes[g], device)
            for g in range(layout.num_groups)], layout


def unpack(buffers: Sequence[torch.Tensor], layout: FlatLayout) -> Any:
    """The tree back from flat buffers: each leaf a view of its buffer
    (``apex_C.unflatten``)."""
    leaves = [buffers[m.group][m.offset:m.offset + m.size].view(m.shape)
              for m in layout.leaves]
    return _tree.unflatten(layout.treedef, leaves)


def pack_cast(tree: Any, layout: FlatLayout,
              dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Pack into ``layout``'s grouping and offsets with every buffer in
    ``dtype``: the master-grad path, fp32 grads at the params' offsets
    so (param, grad, moment) buffers line up element by element."""
    leaves = _tree.leaves(tree)
    _check_leaf_count(leaves, layout)
    parts: List[List[torch.Tensor]] = [[] for _ in range(layout.num_groups)]
    for leaf, meta in zip(leaves, layout.leaves):
        if tuple(leaf.shape) != meta.shape:
            raise ValueError(
                f"leaf shape mismatch: got {tuple(leaf.shape)}, layout has "
                f"{meta.shape}")
        parts[meta.group].append(leaf.to(dtype).reshape(-1))
    device = leaves[0].device if leaves else None
    return [_concat(parts[g], layout.group_sizes[g], dtype, device)
            for g in range(layout.num_groups)]


# -- list-of-tensors convenience, apex_C's call shapes ----------------------

def flatten_dense_tensors(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Same-dtype tensors as one unpadded 1-D buffer (``apex_C.flatten``,
    torch's ``_flatten_dense_tensors``)."""
    tensors = [torch.as_tensor(t) for t in tensors]
    if not tensors:
        raise ValueError("need at least one tensor")
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError("flatten_dense_tensors requires a single dtype")
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_dense_tensors(flat: torch.Tensor,
                            like: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """Split a flat buffer back to the shapes of ``like``: views, no
    copy (``apex_C.unflatten``)."""
    out, offset = [], 0
    for t in like:
        size = math.prod(t.shape)
        out.append(flat[offset:offset + size].view(tuple(t.shape)))
        offset += size
    return out


class MultiTensorApply:
    """apex's ``MultiTensorApply`` call shape: ``apply(op, noop_flag,
    tensor_lists, *args)`` runs ``op`` across every tensor in one logical
    sweep. Each list is packed into flat per-dtype buffers (the static
    form of apex's runtime chunking: ``chunk_size`` is accepted and
    unused), ``op`` receives one list of flat buffers per tensor list,
    and its outputs are sliced back to tensor lists (views of the
    buffers the op returned).

    Overflow is **returned, not written**: apex mutates ``noop_flag`` in
    place, so here ``noop_flag`` must be None and an op that detects
    overflow returns ``(buffers, found_inf)``, whose flag is passed
    through::

        mta = MultiTensorApply()
        [unscaled], found_inf = mta(scale_flat, None, [grads], 1 / scale)
    """

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists, *args):
        if noop_flag is not None:
            raise NotImplementedError(
                "apex mutates the overflow buffer in place; here ops "
                "return the flag instead — pass noop_flag=None and read "
                "the op's returned found_inf (see MultiTensorApply "
                "docstring)")
        layouts, packed = [], []
        for tl in tensor_lists:
            bufs, layout = pack(list(tl))
            packed.append(bufs)
            layouts.append(layout)
        outs = op(*packed, *args)
        if outs is None or (isinstance(outs, (tuple, list))
                            and len(outs) == 0):
            return outs
        # the flat sweeps return (buffer_list, found_inf): unpack the
        # buffers, pass the flag through
        aux = None
        if (isinstance(outs, tuple) and len(outs) == 2
                and isinstance(outs[0], (tuple, list))
                and not isinstance(outs[1], (tuple, list))):
            outs, aux = [list(outs[0])], outs[1]
        # normalise to a list of buffer lists: op may return one buffer,
        # one buffer list, or several buffer lists
        elif not isinstance(outs, (tuple, list)):
            outs = [[outs]]
        elif not isinstance(outs[0], (tuple, list)):
            outs = [list(outs)]
        # outputs mirror the dtype grouping of the first input list
        for o in outs:
            if not isinstance(o, (tuple, list)) or len(o) != layouts[
                    0].num_groups:
                raise ValueError(
                    f"op must return buffer list(s) matching the input's "
                    f"{layouts[0].num_groups} dtype group(s) (got "
                    f"{type(o).__name__}); use pack/unpack directly for "
                    f"ops that regroup dtypes")
        unpacked = [unpack(list(o), layouts[0]) for o in outs]
        return (unpacked, aux) if aux is not None else unpacked
