"""Flat per-dtype buffers for multi-tensor ops (``apex_tpu.multi_tensor``,
packing only; ``MultiTensorApply`` comes with a later slice)."""

from apex_tpu_torch.multi_tensor.packing import (
    LANE,
    FlatLayout,
    layout_of,
    pack,
    pack_cast,
    pad_to,
    unpack,
)

__all__ = ["FlatLayout", "LANE", "layout_of", "pack", "pack_cast", "pad_to",
           "unpack"]
