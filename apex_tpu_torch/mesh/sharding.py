"""Global arrays ↔ this rank's shards, by :class:`PartitionSpec`.

What ``jax.device_put(x, NamedSharding(mesh, spec))`` and reading a
global array back do in the JAX package: :func:`shard_tree` keeps this
rank's block of every leaf (dimension ``d`` of a leaf whose spec names
axes there is cut into their size's blocks, and the rank keeps the one
at its index along them), :func:`gather_tree` all-gathers the blocks
back into the global tree as numpy arrays (every rank of the mesh calls
it). Specs are matched to leaves by the tree's dict keys.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from apex_tpu_torch.mesh import collectives as C
from apex_tpu_torch.mesh.topology import Mesh, PartitionSpec


def map_with_specs(fn: Callable, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree of dicts, lists, tuples and
    NamedTuples and a spec tree of the same structure whose leaves are
    :class:`PartitionSpec`."""
    if isinstance(specs, PartitionSpec):
        return fn(tree, specs)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise ValueError(f"tree {type(tree).__name__} does not match "
                             f"the spec keys {sorted(specs)}")
        return {k: map_with_specs(fn, tree[k], specs[k]) for k in specs}
    if isinstance(specs, (list, tuple)):
        out = [map_with_specs(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    raise TypeError(f"bad spec node {specs!r}")


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def shard_leaf(x, spec: PartitionSpec, mesh: Mesh,
               device: Optional[Union[str, torch.device]] = None
               ) -> torch.Tensor:
    """This rank's block of the global ``x`` (numpy or tensor) under
    ``spec``, as a tensor of its own on ``device`` (default the
    mesh's)."""
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.size(axes)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of shape {tuple(x.shape)} does not "
                             f"split over {axes} of size {n}")
        c = x.shape[d] // n
        i = mesh.index(axes)
        idx = [slice(None)] * x.ndim
        idx[d] = slice(i * c, (i + 1) * c)
        x = x[tuple(idx)]
    t = _to_tensor(x, device or mesh.device)
    return t.clone() if isinstance(x, torch.Tensor) else t


def shard_tree(tree: Any, specs: Any, mesh: Mesh,
               device: Optional[Union[str, torch.device]] = None) -> Any:
    """:func:`shard_leaf` over a tree and its specs."""
    return map_with_specs(lambda x, s: shard_leaf(x, s, mesh, device),
                          tree, specs)


def gather_leaf(t: torch.Tensor, spec: PartitionSpec, mesh: Mesh
                ) -> torch.Tensor:
    """The global tensor from every rank's block (a collective)."""
    for d in reversed(range(len(spec))):
        axes = spec[d]
        if axes is not None and mesh.size(axes) > 1:
            t = C.all_gather(t, axes, gather_axis=d, mesh=mesh)
    return t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (bfloat16 as float32)."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def gather_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The global tree as numpy arrays, on every rank."""
    return map_with_specs(lambda t, s: to_numpy(gather_leaf(t, s, mesh)),
                          tree, specs)
