"""Tensor-parallel layers: column/row-parallel linear and the
vocab-parallel embedding.

Port of ``apex_tpu/transformer/tensor_parallel/layers.py``: each layer
is a function over this rank's shards (``column_parallel_linear``,
``row_parallel_linear``, ``vocab_parallel_embedding``) plus a config
class that initialises the global weights and reports the
:class:`~apex_tpu_torch.mesh.PartitionSpec` that shards them.
``param_is_tensor_parallel`` and ``set_tensor_model_parallel_attributes``
read and write that spec, which stands for apex's tensor attributes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.mesh.topology import (
    AXIS_TP,
    Mesh,
    PartitionSpec,
    resolve_mesh,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility

P = PartitionSpec


def init_method_normal(sigma: float) -> Callable:
    """``init(generator, shape, dtype, device)``: normal(0, sigma) drawn
    in fp32 from ``generator``, cast to ``dtype``."""
    def init(generator, shape, dtype=torch.float32, device=None):
        t = torch.empty(shape, dtype=torch.float32,
                        device=device or generator.device)
        return t.normal_(0.0, sigma, generator=generator).to(dtype)

    return init


def scaled_init_method_normal(sigma: float, num_layers: int) -> Callable:
    """Megatron's output-layer init: sigma / sqrt(2 * num_layers)."""
    return init_method_normal(sigma / (2.0 * num_layers) ** 0.5)


# -- functional cores (this rank's shards) ----------------------------------
def column_parallel_linear(x, kernel, bias=None, *, axis: str = AXIS_TP,
                           gather_output: bool = False,
                           sequence_parallel: bool = False,
                           sequence_dim: int = 0,
                           mesh: Optional[Mesh] = None):
    """Y = X·A with A column-sharded: ``kernel`` is the local ``[in,
    out/tp]`` block. Under ``sequence_parallel`` ``x`` arrives sharded on
    ``sequence_dim``, all-gathered forward and reduce-scattered backward;
    otherwise it is replicated and the copy mapping sums its gradient."""
    if sequence_parallel:
        x = gather_from_sequence_parallel_region(x, axis, True, sequence_dim,
                                                 mesh=mesh)
    else:
        x = copy_to_tensor_model_parallel_region(x, axis, mesh=mesh)
    y = torch.matmul(x, kernel)
    if bias is not None:
        y = y + bias
    if gather_output:
        if sequence_parallel:
            raise ValueError(
                "gather_output is incompatible with sequence_parallel")
        y = gather_from_tensor_model_parallel_region(y, axis, mesh=mesh)
    return y


def row_parallel_linear(x, kernel, bias=None, *, axis: str = AXIS_TP,
                        input_is_parallel: bool = True,
                        sequence_parallel: bool = False,
                        sequence_dim: int = 0, mesh: Optional[Mesh] = None):
    """Y = X·A with A row-sharded: ``kernel`` is the local ``[in/tp,
    out]`` block and the partial products are summed over the axis (a
    reduce-scatter onto the sequence dim under ``sequence_parallel``);
    the replicated ``bias`` is added after the reduction."""
    if not input_is_parallel:
        if sequence_parallel:
            raise ValueError(
                "sequence_parallel requires input_is_parallel")
        x = scatter_to_tensor_model_parallel_region(x, axis, mesh=mesh)
    y = torch.matmul(x, kernel)
    if sequence_parallel:
        y = reduce_scatter_to_sequence_parallel_region(y, axis, sequence_dim,
                                                       mesh=mesh)
    else:
        y = reduce_from_tensor_model_parallel_region(y, axis, mesh=mesh)
    if bias is not None:
        y = y + bias
    return y


def vocab_parallel_embedding(ids, table, *, axis: str = AXIS_TP,
                             mesh: Optional[Mesh] = None):
    """Vocab-sharded lookup: ``table`` is the local ``[vocab/tp,
    hidden]`` block; ids outside it contribute zero and the partial
    lookups are all-reduced (a masked lookup, then the reduce mapping)."""
    mesh = resolve_mesh(mesh)
    per_partition = table.shape[0]
    start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
        per_partition, mesh.index(axis), mesh.size(axis))
    ids = torch.as_tensor(ids, device=table.device).long()
    mask = (ids >= start) & (ids < end)
    local_ids = torch.where(mask, ids - start, torch.zeros_like(ids))
    out = F.embedding(local_ids, table)
    out = out * mask[..., None].to(out.dtype)
    return reduce_from_tensor_model_parallel_region(out, axis, mesh=mesh)


# -- config classes (global init + the specs that shard it) -----------------
def _linear_init(self, generator):
    init = self.init_method or init_method_normal(0.02)
    kernel = init(generator, (self.in_features, self.out_features),
                  self.param_dtype)
    if not self.bias:
        return {"kernel": kernel}
    return {"kernel": kernel,
            "bias": torch.zeros((self.out_features,), dtype=self.param_dtype,
                                device=kernel.device)}


@dataclasses.dataclass(frozen=True)
class ColumnParallelLinear:
    """``init(generator)`` returns the global params; shard them with
    ``specs`` (:func:`apex_tpu_torch.mesh.sharding.shard_tree`);
    ``apply`` runs on this rank's shards."""

    in_features: int
    out_features: int
    bias: bool = True
    gather_output: bool = False
    sequence_parallel: bool = False
    axis: str = AXIS_TP
    param_dtype: torch.dtype = torch.float32
    init_method: Optional[Callable] = None

    init = _linear_init

    @property
    def specs(self):
        s = {"kernel": P(None, self.axis)}
        if self.bias:
            s["bias"] = P(self.axis)
        return s

    def apply(self, params, x, mesh: Optional[Mesh] = None):
        return column_parallel_linear(
            x, params["kernel"], params.get("bias"), axis=self.axis,
            gather_output=self.gather_output,
            sequence_parallel=self.sequence_parallel, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class RowParallelLinear:
    in_features: int
    out_features: int
    bias: bool = True
    input_is_parallel: bool = True
    sequence_parallel: bool = False
    axis: str = AXIS_TP
    param_dtype: torch.dtype = torch.float32
    init_method: Optional[Callable] = None

    init = _linear_init

    @property
    def specs(self):
        s = {"kernel": P(self.axis, None)}
        if self.bias:
            s["bias"] = P()  # replicated; added after the reduction
        return s

    def apply(self, params, x, mesh: Optional[Mesh] = None):
        return row_parallel_linear(
            x, params["kernel"], params.get("bias"), axis=self.axis,
            input_is_parallel=self.input_is_parallel,
            sequence_parallel=self.sequence_parallel, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class VocabParallelEmbedding:
    num_embeddings: int
    embedding_dim: int
    axis: str = AXIS_TP
    param_dtype: torch.dtype = torch.float32
    init_method: Optional[Callable] = None

    def init(self, generator):
        init = self.init_method or init_method_normal(0.02)
        return {"table": init(generator, (self.num_embeddings,
                                           self.embedding_dim),
                              self.param_dtype)}

    @property
    def specs(self):
        return {"table": P(self.axis, None)}

    def apply(self, params, ids, mesh: Optional[Mesh] = None):
        return vocab_parallel_embedding(ids, params["table"], axis=self.axis,
                                        mesh=mesh)


def param_is_tensor_parallel(spec) -> bool:
    """A param is tp-sharded iff its spec mentions the tp axis (apex's
    ``param_is_not_tensor_parallel_duplicate`` inverted)."""
    return any(a == AXIS_TP or (isinstance(a, (tuple, list)) and AXIS_TP in a)
               for a in spec if a is not None)


def set_tensor_model_parallel_attributes(spec, is_parallel: bool, dim: int,
                                         stride: int = 1) -> PartitionSpec:
    """The spec apex's attribute triple implies: ``dim`` sharded on tp
    when ``is_parallel`` (``stride`` is accepted and has no layout
    meaning, as in the JAX package)."""
    del stride
    if not is_parallel:
        return P(*spec)
    parts = list(spec) + [None] * (dim + 1 - len(spec))
    parts[dim] = AXIS_TP
    return P(*parts)
