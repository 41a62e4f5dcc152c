"""Tensor-parallel ops of the port at tp=1
(``apex_tpu.transformer.tensor_parallel``): the vocab-parallel cross
entropy."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)

__all__ = ["vocab_parallel_cross_entropy"]
