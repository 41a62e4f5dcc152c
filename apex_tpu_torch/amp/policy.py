"""Mixed-precision policies: apex amp's opt levels as dtypes.

Port of ``apex_tpu/amp/policy.py``. Apex amp configures mixed precision
with opt levels O0–O3, each a bundle of ``Properties``
(``cast_model_type``, ``patch_torch_functions``, ``keep_batchnorm_fp32``,
``master_weights``, ``loss_scale``). As in the JAX package, there is no
op patching: a :class:`Policy` carries three dtypes (params, compute,
output), the norm-precision and master-weight flags and the loss-scale
mode, and the models apply it at op boundaries (``cast_to_compute``).

bfloat16 needs no loss scaling (fp32's exponent range); float16
policies default to dynamic loss scaling, as apex does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch

from apex_tpu_torch import _tree

HALF_DTYPES = (torch.float16, torch.bfloat16)


def _cast_floating(tree: Any, dtype) -> Any:
    """Cast only floating-point leaves; ints and bools pass through. A
    leaf that is not a tensor is made one first (``jnp.asarray``)."""
    if dtype is None:
        return tree

    def cast(x):
        x = torch.as_tensor(x)
        return x.to(dtype) if x.is_floating_point() else x

    return _tree.tree_map(cast, tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """What dtype params live in, compute runs in and outputs are
    returned in (torch dtypes). Mirrors apex amp ``Properties``:

    - ``param_dtype``      ≈ ``cast_model_type``
    - ``compute_dtype``    ≈ the O1 whitelist cast target
    - ``output_dtype``     ≈ loss/output dtype
    - ``keep_norms_fp32``  ≈ ``keep_batchnorm_fp32`` (all normalisation
      statistics)
    - ``master_weights``   ≈ O2 fp32 master params
    - ``loss_scale``       ≈ ``loss_scale`` ("dynamic", a float, or None)
    """

    name: str
    param_dtype: Any
    compute_dtype: Any
    output_dtype: Any
    keep_norms_fp32: bool = True
    master_weights: bool = False
    loss_scale: Union[str, float, None] = None

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast_floating(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return _cast_floating(tree, self.output_dtype)

    def cast_norms(self, tree):
        """Dtype for normalisation math: fp32 if ``keep_norms_fp32``."""
        return _cast_floating(
            tree, torch.float32 if self.keep_norms_fp32
            else self.compute_dtype)

    @property
    def requires_loss_scaling(self) -> bool:
        return self.loss_scale is not None

    def with_(self, **overrides) -> "Policy":
        """Keyword overrides, like ``amp.initialize(..., keyword=...)``."""
        return dataclasses.replace(self, **overrides)


def get_policy(opt_level: str = "O1", half_dtype=torch.bfloat16) -> Policy:
    """The policy of an apex opt level:

    ============ ===========================================================
    ``O0``       fp32 everywhere (debugging baseline).
    ``O1``       params fp32, compute in ``half_dtype`` at op boundaries,
                 norms fp32.
    ``O2``       params in ``half_dtype`` with fp32 master weights in the
                 optimizer, compute half, norms fp32.
    ``O3``       pure half, no masters, no fp32 norms.
    ============ ===========================================================

    With ``half_dtype=torch.float16`` the O1–O3 policies enable dynamic
    loss scaling (apex's default); with bfloat16 ``loss_scale`` stays
    None."""
    if half_dtype not in HALF_DTYPES:
        raise ValueError(
            f"half_dtype must be float16 or bfloat16, got {half_dtype}")
    scale = "dynamic" if half_dtype == torch.float16 else None
    lvl = opt_level.upper()
    f32 = torch.float32
    if lvl == "O0":
        return Policy("O0", f32, f32, f32, keep_norms_fp32=True,
                      master_weights=False, loss_scale=None)
    if lvl == "O1":
        return Policy("O1", f32, half_dtype, f32, keep_norms_fp32=True,
                      master_weights=False, loss_scale=scale)
    if lvl == "O2":
        return Policy("O2", half_dtype, half_dtype, f32,
                      keep_norms_fp32=True, master_weights=True,
                      loss_scale=scale)
    if lvl == "O3":
        return Policy("O3", half_dtype, half_dtype, half_dtype,
                      keep_norms_fp32=False, master_weights=False,
                      loss_scale=scale)
    raise ValueError(
        f"unknown opt_level {opt_level!r}; expected O0/O1/O2/O3")
