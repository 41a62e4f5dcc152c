"""BatchNorm with two-pass statistics, the local case of SyncBatchNorm.

Port of ``apex_tpu/parallel/sync_batchnorm.py`` (``_moments``,
``sync_batch_norm``) for ``axis=None``: ordinary BatchNorm on one device.
The moments are two-pass in fp32 (the mean, then the centred square
sum), the JAX package's numerically faithful form of apex's Welford
kernels; the one-pass ``E[x²] − mean²`` cancels in fp32 when
``|mean| ≫ std``. Running statistics are carried functionally and the
running variance is unbiased (``n / (n − 1)``), as apex keeps it. The
JAX package computes BN outside any kernel, so this is plain PyTorch.

A reduction ``axis`` (cross-replica statistics) raises: the distributed
slice. The JAX function's default axis is its dp mesh axis; here the
default is None, the one case there is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _moments(x: torch.Tensor, reduce_dims):
    """``(mean, var, n)`` in fp32 over ``reduce_dims``, two-pass."""
    xf = x.float()
    n = 1.0
    for d in reduce_dims:
        n *= x.shape[d]
    mean = xf.sum(dim=reduce_dims) / n
    bshape = [1 if d in reduce_dims else x.shape[d] for d in range(x.ndim)]
    d2 = torch.square(xf - mean.reshape(bshape)).sum(dim=reduce_dims)
    return mean, torch.clamp(d2 / n, min=0.0), n


def sync_batch_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor],
                    running_mean: Optional[torch.Tensor] = None,
                    running_var: Optional[torch.Tensor] = None, *,
                    axis=None, momentum: float = 0.1, eps: float = 1e-5,
                    training: bool = True, channel_axis: int = 1
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """Normalise over every dim but ``channel_axis`` →
    ``(y, new_running_mean, new_running_var)``; ``y`` is computed in
    fp32 and cast to x's dtype.

    Training uses the batch's moments and returns the updated running
    statistics (no gradient flows into them); eval uses the running
    statistics and returns them unchanged. ``axis`` must be None: a
    cross-replica reduction waits for the distributed slice of SyncBN
    with ResNet DDP (ROADMAP queue 1 item 4)."""
    if axis is not None:
        raise ValueError(
            f"sync_batch_norm axis={axis!r}: cross-replica statistics are "
            "not supported by apex_tpu_torch yet (the distributed slice of "
            "SyncBN with ResNet DDP, ROADMAP queue 1 item 4); axis=None is "
            "local BatchNorm")
    ch = channel_axis % x.ndim
    reduce_dims = tuple(d for d in range(x.ndim) if d != ch)
    bshape = [x.shape[ch] if d == ch else 1 for d in range(x.ndim)]

    if training:
        mean, var, n = _moments(x, reduce_dims)
        new_rm = new_rv = None
        if running_mean is not None:
            with torch.no_grad():
                unbiased = var * (n / max(n - 1.0, 1.0))
                new_rm = (1 - momentum) * running_mean + momentum * mean
                new_rv = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean.float(), running_var.float()
        new_rm, new_rv = running_mean, running_var

    inv = torch.rsqrt(var + eps)
    y = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
    if scale is not None:
        y = y * scale.float().reshape(bshape)
    if bias is not None:
        y = y + bias.float().reshape(bshape)
    return y.to(x.dtype), new_rm, new_rv


__all__ = ["sync_batch_norm"]
