"""On-device image normalisation (``apex_tpu/data.py:189-201``): the
ImageNet channel statistics and :func:`normalize_images`. The packed-file
loaders come with the infrastructure slice."""

from __future__ import annotations

from typing import Tuple

import torch

#: ImageNet channel statistics (the constants the reference example's
#: torchvision transform bakes in), for on-device normalisation
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor, dtype=torch.float32,
                     mean: Tuple[float, ...] = IMAGENET_MEAN,
                     std: Tuple[float, ...] = IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC → ``(x / 255 - mean) / std`` in ``dtype``, on the
    images' device."""
    x = images.to(dtype) / torch.tensor(255.0, dtype=dtype,
                                        device=images.device)
    m = torch.tensor(mean, dtype=dtype, device=images.device)
    s = torch.tensor(std, dtype=dtype, device=images.device)
    return (x - m) / s


__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_images"]
