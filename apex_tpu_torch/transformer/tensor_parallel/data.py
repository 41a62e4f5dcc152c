"""Data broadcast across the tensor-parallel group — port of
``apex_tpu/transformer/tensor_parallel/data.py`` (apex's
``broadcast_data``): tokenizer output from tp rank 0 to the others."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from apex_tpu_torch.mesh import collectives as C
from apex_tpu_torch.mesh.topology import AXIS_TP, Mesh, resolve_mesh


def broadcast_from_src(x: torch.Tensor, axis: str = AXIS_TP, src: int = 0,
                       *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The value of ``x`` on rank ``src`` of ``axis``, on every rank."""
    return C.pbroadcast_from(x, axis, src, resolve_mesh(mesh))


def broadcast_data(keys: Sequence[str], data: Dict[str, torch.Tensor],
                   datatype=torch.int32, axis: str = AXIS_TP, *,
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """apex's call shape: ``data[k] for k in keys``, cast to
    ``datatype``, broadcast from tp rank 0. Shapes must match across
    ranks. On ``mesh.device``."""
    mesh = resolve_mesh(mesh)
    return {k: broadcast_from_src(
        torch.as_tensor(data[k], device=mesh.device).to(datatype), axis,
        mesh=mesh) for k in keys}
