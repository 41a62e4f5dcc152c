"""Model-parallel topology state over a mesh of processes.

Port of ``apex_tpu/transformer/parallel_state.py`` (apex's
``parallel_state``): one :class:`~apex_tpu_torch.mesh.Mesh` with named
{pp, dp, tp} axes stands for apex's process groups, and the group
handles are the axis names, which the collectives and mappings take.

- ``get_*_world_size()`` → the mesh axis's size;
- ``get_*_rank()`` → this process's index along the axis (a Python int:
  the port runs eagerly, so it is known on the host).

A module-level current state mirrors apex's global API
(``initialize_model_parallel`` / ``destroy_model_parallel``);
everything is also on the returned :class:`ParallelState`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from apex_tpu_torch.mesh.topology import (
    AXIS_DP,
    AXIS_PP,
    AXIS_TP,
    Mesh,
    build_mesh,
    mesh_shape_of,
)

_STATE: Optional["ParallelState"] = None


@dataclasses.dataclass(frozen=True)
class ParallelState:
    """The mesh plus virtual-pipeline bookkeeping."""

    mesh: Mesh
    virtual_pipeline_model_parallel_size: Optional[int] = None

    @property
    def tensor_model_parallel_size(self) -> int:
        return mesh_shape_of(self.mesh).get(AXIS_TP, 1)

    @property
    def pipeline_model_parallel_size(self) -> int:
        return mesh_shape_of(self.mesh).get(AXIS_PP, 1)

    @property
    def data_parallel_size(self) -> int:
        return mesh_shape_of(self.mesh).get(AXIS_DP, 1)

    @property
    def world_size(self) -> int:
        return self.mesh.world_size


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    virtual_pipeline_model_parallel_size: Optional[int] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> ParallelState:
    """Build the mesh over the initialised default process group and
    install it as the current topology (``initialize_model_parallel(tp,
    pp, vpp)``); ``device`` as in :func:`~apex_tpu_torch.mesh.
    build_mesh`."""
    global _STATE
    if virtual_pipeline_model_parallel_size is not None:
        if pipeline_model_parallel_size < 2:
            raise ValueError(
                "virtual pipeline parallelism requires "
                "pipeline_model_parallel_size >= 2")
    mesh = build_mesh(tp=tensor_model_parallel_size,
                      pp=pipeline_model_parallel_size, device=device)
    _STATE = ParallelState(mesh, virtual_pipeline_model_parallel_size)
    return _STATE


def set_state(state: ParallelState) -> None:
    global _STATE
    _STATE = state


def model_parallel_is_initialized() -> bool:
    return _STATE is not None


def destroy_model_parallel() -> None:
    global _STATE
    _STATE = None


def get_state() -> ParallelState:
    if _STATE is None:
        raise RuntimeError(
            "model parallel topology is not initialized; call "
            "initialize_model_parallel() first")
    return _STATE


def get_mesh() -> Mesh:
    return get_state().mesh


# -- group handles (axis names) -------------------------------------------
def get_tensor_model_parallel_group() -> str:
    return AXIS_TP


def get_pipeline_model_parallel_group() -> str:
    return AXIS_PP


def get_data_parallel_group() -> str:
    return AXIS_DP


# -- world sizes -----------------------------------------------------------
def get_tensor_model_parallel_world_size() -> int:
    return get_state().tensor_model_parallel_size


def get_pipeline_model_parallel_world_size() -> int:
    return get_state().pipeline_model_parallel_size


def get_data_parallel_world_size() -> int:
    return get_state().data_parallel_size


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return get_state().virtual_pipeline_model_parallel_size


# -- ranks -----------------------------------------------------------------
def get_tensor_model_parallel_rank() -> int:
    return get_mesh().index(AXIS_TP)


def get_pipeline_model_parallel_rank() -> int:
    return get_mesh().index(AXIS_PP)


def get_data_parallel_rank() -> int:
    return get_mesh().index(AXIS_DP)


def is_pipeline_first_stage(rank=None) -> bool:
    """True on pipeline stage 0 (``rank`` may be passed; else this
    process's)."""
    r = get_pipeline_model_parallel_rank() if rank is None else rank
    return r == 0


def is_pipeline_last_stage(rank=None) -> bool:
    r = get_pipeline_model_parallel_rank() if rank is None else rank
    return r == get_pipeline_model_parallel_world_size() - 1


def get_tensor_model_parallel_src_rank() -> int:
    """Index 0 along the tp axis — apex's broadcast source for tokenizer
    output."""
    return 0
