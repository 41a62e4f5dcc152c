"""Tensor-parallel building blocks (``apex_tpu.transformer.tensor_parallel``):
the seven mappings, the parallel linear and embedding layers, the
vocab-parallel cross entropy, the RNG streams and recompute, and the tp
broadcast, over a :class:`~apex_tpu_torch.mesh.Mesh`."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import (
    broadcast_data,
    broadcast_from_src,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_parallel_linear,
    param_is_tensor_parallel,
    row_parallel_linear,
    set_tensor_model_parallel_attributes,
    vocab_parallel_embedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    RNGStatesTracker,
    checkpoint,
    get_cuda_rng_tracker,
    get_rng_tracker,
    model_parallel_rng_key,
    model_parallel_seed_keys,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
    split_tensor_along_last_dim,
)

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "RNGStatesTracker",
    "get_rng_tracker",
    "get_cuda_rng_tracker",
    "set_tensor_model_parallel_attributes",
    "param_is_tensor_parallel",
    "model_parallel_rng_key",
    "model_parallel_seed_keys",
    "checkpoint",
    "divide",
    "split_tensor_along_last_dim",
    "VocabUtility",
    "broadcast_data",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "vocab_parallel_cross_entropy",
]
