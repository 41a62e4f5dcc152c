"""CUDA kernels of the port, each beside its plain PyTorch twin.

Wrappers dispatch on the tensors' device (:func:`_build.on_cuda`): CUDA
tensors launch the kernel, CPU tensors run the plain version, anything
else raises. Every wrapper counts its launches in a plain integer
attribute; :func:`launch_counts` reads them and
:func:`reset_launch_counts` zeroes them, so a run can show that its main
path went through the kernels. The two flash forwards, the two fused
flash backwards and the split dQ and dK/dV sweeps also count the
launches of their tensor-core kernel apart (``tc_launches``, reported as
``flash_attention_bsh_tc``, ``flash_attention_tc``,
``flash_attention_bsh_bwd_tc``, ``flash_attention_bwd_tc``,
``flash_attention_bwd_dq_tc`` and ``flash_attention_bwd_dkdv_tc``): the
total stays in ``launches``. Importing this package builds nothing: the
library is compiled at the first launch.

Unlike the JAX package, the name ``flash_attention`` here stays the
submodule (callers import it as a module): the head-major function is
``kernels.flash_attention.flash_attention``; its siblings
(``flash_attention_with_lse``, ``mha``, the kernel wrappers) are
exported here.
"""

from typing import Dict

from apex_tpu_torch.kernels import _build
from apex_tpu_torch.kernels.decode_attention import (
    attend_cache,
    attend_cache_plain,
    attend_cache_quant,
    attend_cache_quant_plain,
    cache_write_columns,
    cache_write_columns_plain,
    cache_write_columns_quant,
    cache_write_columns_quant_plain,
    decode_attention,
    decode_attention_plain,
    decode_attention_quantized,
    decode_attention_quantized_plain,
    decode_verify_attention,
    decode_verify_attention_plain,
    paged_attention,
    paged_attention_plain,
    paged_attention_quantized,
    paged_attention_quantized_plain,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_verify_attention,
    paged_verify_attention_plain,
    paged_write_column,
    paged_write_column_plain,
    paged_write_column_quant,
    paged_write_column_quant_plain,
    paged_write_columns,
    paged_write_columns_plain,
    paged_write_columns_quant,
    paged_write_columns_quant_plain,
    quantize_kv_rows,
    verify_route,
    write_column,
    write_column_plain,
    write_column_quant,
    write_column_quant_plain,
)
from apex_tpu_torch.kernels.flash_attention import (
    flash_attention_bsh,
    flash_attention_bsh_bwd,
    flash_attention_bsh_bwd_plain,
    flash_attention_bsh_fwd,
    flash_attention_bsh_plain,
    flash_attention_bwd,
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dkdv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_with_lse,
    flash_bsh_eligible,
    mha,
    tc_route,
)
from apex_tpu_torch.kernels.flat_ops import (
    adagrad_flat,
    adagrad_flat_plain,
    adam_flat,
    adam_flat_plain,
    axpby_flat,
    axpby_flat_plain,
    l2norm_flat,
    l2norm_flat_plain,
    scale_flat,
    scale_flat_plain,
    sgd_flat,
    sgd_flat_plain,
)
from apex_tpu_torch.kernels.layer_norm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_plain,
    layer_norm_fwd,
    layer_norm_fwd_plain,
    rms_norm,
)
from apex_tpu_torch.kernels.softmax import (
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
    softmax_bwd,
    softmax_bwd_plain,
    softmax_fwd,
    softmax_fwd_plain,
)
from apex_tpu_torch.kernels.xentropy import (
    softmax_cross_entropy,
    xentropy_bwd,
    xentropy_bwd_plain,
    xentropy_fwd,
    xentropy_fwd_plain,
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
    "paged_write_column": paged_write_column,
    "paged_attention": paged_attention,
    "cache_write_columns": cache_write_columns,
    "paged_write_columns": paged_write_columns,
    "decode_write_column_quant": write_column_quant,
    "decode_attention_quant": attend_cache_quant,
    "cache_write_columns_quant": cache_write_columns_quant,
    "paged_write_column_quant": paged_write_column_quant,
    "paged_write_columns_quant": paged_write_columns_quant,
    "paged_attention_quant": paged_attention_quantized,
    "xentropy_fwd": xentropy_fwd,
    "xentropy_bwd": xentropy_bwd,
    "sgd_flat": sgd_flat,
    "flash_attention": flash_attention_fwd,
    "flash_attention_bwd": flash_attention_bwd,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkdv": flash_attention_bwd_dkdv,
    "scale_flat": scale_flat,
    "axpby_flat": axpby_flat,
    "adagrad_flat": adagrad_flat,
    "softmax_fwd": softmax_fwd,
    "softmax_bwd": softmax_bwd,
    "decode_attention_write": decode_attention,
    "paged_attention_write": paged_decode_attention,
    "decode_verify_attention": decode_verify_attention,
    "paged_verify_attention": paged_verify_attention,
}


#: the wrappers that also count their tensor-core launches
#: (``tc_launches``), by the name that count is reported under
TC_COUNTERS = {
    "flash_attention_bsh_tc": flash_attention_bsh_fwd,
    "flash_attention_tc": flash_attention_fwd,
    "flash_attention_bsh_bwd_tc": flash_attention_bsh_bwd,
    "flash_attention_bwd_tc": flash_attention_bwd,
    "flash_attention_bwd_dq_tc": flash_attention_bwd_dq,
    "flash_attention_bwd_dkdv_tc": flash_attention_bwd_dkdv,
}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`;
    the ``*_tc`` entries are the tensor-core share of a flash forward's
    or backward's."""
    counts = {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
    counts.update((name, fn.tc_launches) for name, fn in TC_COUNTERS.items())
    return counts


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for fn in TC_COUNTERS.values():
        fn.tc_launches = 0


__all__ = [
    "KERNEL_WRAPPERS",
    "TC_COUNTERS",
    "adagrad_flat",
    "adagrad_flat_plain",
    "adam_flat",
    "adam_flat_plain",
    "attend_cache",
    "attend_cache_plain",
    "attend_cache_quant",
    "attend_cache_quant_plain",
    "axpby_flat",
    "axpby_flat_plain",
    "cache_write_columns",
    "cache_write_columns_plain",
    "cache_write_columns_quant",
    "cache_write_columns_quant_plain",
    "decode_attention",
    "decode_attention_plain",
    "decode_attention_quantized",
    "decode_attention_quantized_plain",
    "decode_verify_attention",
    "decode_verify_attention_plain",
    "flash_attention_bsh",
    "flash_attention_bsh_bwd",
    "flash_attention_bsh_bwd_plain",
    "flash_attention_bsh_fwd",
    "flash_attention_bsh_plain",
    "flash_attention_bwd",
    "flash_attention_bwd_dkdv",
    "flash_attention_bwd_dkdv_plain",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_plain",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_with_lse",
    "flash_bsh_eligible",
    "generic_scaled_masked_softmax",
    "l2norm_flat",
    "l2norm_flat_plain",
    "launch_counts",
    "layer_norm",
    "layer_norm_bwd",
    "layer_norm_bwd_plain",
    "layer_norm_fwd",
    "layer_norm_fwd_plain",
    "mha",
    "paged_attention",
    "paged_attention_plain",
    "paged_attention_quantized",
    "paged_attention_quantized_plain",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_verify_attention",
    "paged_verify_attention_plain",
    "paged_write_column",
    "paged_write_column_plain",
    "paged_write_column_quant",
    "paged_write_column_quant_plain",
    "paged_write_columns",
    "paged_write_columns_plain",
    "paged_write_columns_quant",
    "paged_write_columns_quant_plain",
    "quantize_kv_rows",
    "reset_launch_counts",
    "rms_norm",
    "scale_flat",
    "scale_flat_plain",
    "scaled_masked_softmax",
    "scaled_upper_triang_masked_softmax",
    "sgd_flat",
    "sgd_flat_plain",
    "softmax_bwd",
    "softmax_bwd_plain",
    "softmax_cross_entropy",
    "softmax_fwd",
    "softmax_fwd_plain",
    "tc_route",
    "verify_route",
    "write_column",
    "write_column_plain",
    "write_column_quant",
    "write_column_quant_plain",
    "xentropy_bwd",
    "xentropy_bwd_plain",
    "xentropy_fwd",
    "xentropy_fwd_plain",
]
