"""The mesh of processes and its collectives (``apex_tpu.mesh``).

One :class:`~apex_tpu_torch.mesh.topology.Mesh` per rank of
``torch.distributed`` holds the named {pp, dp, ep, cp, tp} axes of the
JAX package's device mesh, with tp innermost; the collectives run
over the process group of an axis (NCCL with a card per rank, gloo on
the CPU or on ranks that share a card). ``build_hybrid_mesh`` raises:
the multi-slice placement waits for a later slice.
"""

from apex_tpu_torch.mesh.topology import (
    AXIS_CP,
    AXIS_DP,
    AXIS_EP,
    AXIS_PP,
    AXIS_TP,
    DEFAULT_AXIS_ORDER,
    Mesh,
    MeshConfig,
    PartitionSpec,
    build_hybrid_mesh,
    build_mesh,
    current_mesh,
    mesh_shape_of,
)
from apex_tpu_torch.mesh.collectives import (
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
    pbroadcast_from,
    pmax,
    pmean,
    pmin,
    ppermute,
    ppermute_shift,
    psum,
    psum_scatter,
    reduce_scatter,
)

__all__ = [
    "AXIS_DP",
    "AXIS_EP",
    "AXIS_PP",
    "AXIS_TP",
    "MeshConfig",
    "build_hybrid_mesh",
    "build_mesh",
    "mesh_shape_of",
    "all_gather",
    "all_to_all",
    "axis_index",
    "axis_size",
    "pbroadcast_from",
    "pmean",
    "ppermute",
    "ppermute_shift",
    "psum",
    "psum_scatter",
    "reduce_scatter",
]
