"""Static tree → flat per-dtype buffer packing.

Port of ``apex_tpu/multi_tensor/packing.py`` (``pad_to``, ``FlatLayout``,
``pack``, ``unpack``, ``pack_cast``). The grouping, leaf order, offsets
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
