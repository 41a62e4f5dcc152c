"""Flat per-dtype buffers for multi-tensor ops (``apex_tpu.multi_tensor``):
the packing, apex_C's flatten/unflatten call shapes, and
``MultiTensorApply``."""

from apex_tpu_torch.multi_tensor.packing import (
    LANE,
    FlatLayout,
    MultiTensorApply,
    flatten_dense_tensors,
    layout_of,
    pack,
    pack_cast,
    pad_to,
    unflatten_dense_tensors,
    unpack,
)

__all__ = ["FlatLayout", "LANE", "MultiTensorApply", "flatten_dense_tensors",
           "layout_of", "pack", "pack_cast", "pad_to",
           "unflatten_dense_tensors", "unpack"]
