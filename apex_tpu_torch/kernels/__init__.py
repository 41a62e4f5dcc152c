"""CUDA kernels of the port, each beside its plain PyTorch twin.

Wrappers dispatch on the tensors' device (:func:`_build.on_cuda`): CUDA
tensors launch the kernel, CPU tensors run the plain version, anything
else raises. Every wrapper counts its launches in a plain integer
attribute; :func:`launch_counts` reads them and
:func:`reset_launch_counts` zeroes them, so a run can show that its main
path went through the kernels. Importing this package builds nothing:
the library is compiled at the first launch.
"""

from typing import Dict

from apex_tpu_torch.kernels import _build
from apex_tpu_torch.kernels.decode_attention import (
    attend_cache,
    attend_cache_plain,
    decode_attention,
    decode_attention_plain,
    write_column,
    write_column_plain,
)
from apex_tpu_torch.kernels.flash_attention import (
    flash_attention_bsh,
    flash_attention_bsh_bwd,
    flash_attention_bsh_bwd_plain,
    flash_attention_bsh_fwd,
    flash_attention_bsh_plain,
)
from apex_tpu_torch.kernels.flat_ops import (
    adam_flat,
    adam_flat_plain,
    l2norm_flat,
    l2norm_flat_plain,
)
from apex_tpu_torch.kernels.layer_norm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_plain,
    layer_norm_fwd,
    layer_norm_fwd_plain,
    rms_norm,
)

#: every kernel wrapper, by the name its launch count is reported under
KERNEL_WRAPPERS = {
    "flash_attention_bsh": flash_attention_bsh_fwd,
    "decode_write_column": write_column,
    "decode_attention": attend_cache,
    "flash_attention_bsh_bwd": flash_attention_bsh_bwd,
    "adam_flat": adam_flat,
    "layer_norm_fwd": layer_norm_fwd,
    "layer_norm_bwd": layer_norm_bwd,
    "l2norm_flat": l2norm_flat,
}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "KERNEL_WRAPPERS",
    "adam_flat",
    "adam_flat_plain",
    "attend_cache",
    "attend_cache_plain",
    "decode_attention",
    "decode_attention_plain",
    "flash_attention_bsh",
    "flash_attention_bsh_bwd",
    "flash_attention_bsh_bwd_plain",
    "flash_attention_bsh_fwd",
    "flash_attention_bsh_plain",
    "l2norm_flat",
    "l2norm_flat_plain",
    "launch_counts",
    "layer_norm",
    "layer_norm_bwd",
    "layer_norm_bwd_plain",
    "layer_norm_fwd",
    "layer_norm_fwd_plain",
    "reset_launch_counts",
    "rms_norm",
    "write_column",
    "write_column_plain",
]
