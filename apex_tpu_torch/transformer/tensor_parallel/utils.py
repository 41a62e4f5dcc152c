"""Shard math helpers — ``apex_tpu/transformer/tensor_parallel/utils.py``."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(x: torch.Tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False
                                ) -> Sequence[torch.Tensor]:
    """``num_partitions`` equal chunks of the last dimension (views, or
    contiguous copies as apex's flag asks)."""
    size = divide(x.shape[-1], num_partitions)
    chunks = torch.split(x, size, dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return chunks


class VocabUtility:
    """Vocab shard ranges for the vocab-parallel embedding and cross
    entropy."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        first = rank * per_partition_vocab_size
        return first, first + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
            global_vocab_size: int, rank: int, world_size: int
    ) -> Tuple[int, int]:
        per_partition = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition, rank, world_size)
