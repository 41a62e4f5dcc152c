"""LARC, layer-wise adaptive rate clipping (apex/parallel/LARC.py).

Port of ``apex_tpu/optimizers/larc.py``. Apex wraps an optimizer and
rescales each param's gradient in place before the wrapped ``step()``;
here, as in the JAX package, that is a gradient transformation applied
before any optimizer:

.. code-block:: python

    tx = fused_sgd(lr)
    grads = larc_transform(grads, params, learning_rate=lr)
    new_p, state = tx.step(grads, state, params)
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.kernels.flat_ops import device_scalar


def larc_transform(grads, params, *, learning_rate,
                   trust_coefficient: float = 0.02, clip: bool = True,
                   eps: float = 1e-8, weight_decay: float = 0.0):
    """Rescale each gradient leaf by its LARC adaptive rate ``trust *
    ||p|| / (||g|| + wd * ||p|| + eps)`` (1 where either norm is zero),
    after adding ``weight_decay * p``. ``clip=True`` is apex's clipping
    mode, the rate ``min(adaptive / lr, 1)``, so LARC only ever reduces
    the step; ``clip=False`` is LARS-style scaling by the adaptive rate.
    Leaves keep their dtypes; everything stays on the device."""

    def one(g, p):
        lr = device_scalar(learning_rate, g.device)
        g32 = g.float()
        p32 = p.float()
        p_norm = torch.linalg.vector_norm(p32.reshape(-1))
        g_norm = torch.linalg.vector_norm(g32.reshape(-1))
        adaptive = trust_coefficient * p_norm / (
            g_norm + weight_decay * p_norm + eps)
        ok = (p_norm > 0.0) & (g_norm > 0.0)
        rate = torch.clamp(adaptive / lr, max=1.0) if clip else adaptive
        rate = torch.where(ok, rate, 1.0)
        return ((g32 + weight_decay * p32) * rate).to(g.dtype)

    return _tree.tree_map(one, grads, params)
