"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu, for NVIDIA Hopper.

The JAX package ``apex_tpu`` is the reference; this package is its port,
slice by slice. The slice here is the serving path: the GPT model's
forward, bulk prefill and KV-cache decode, the continuous-batching
:class:`~apex_tpu_torch.serving.Engine` and its FIFO
:class:`~apex_tpu_torch.serving.Scheduler`. Every Pallas kernel on that
path is a CUDA kernel written for ``sm_90a`` (``apex_tpu_torch/csrc``),
built with ``nvcc`` at first use and bound with ``ctypes``:

- ``apex_tpu_torch.kernels.flash_attention`` — causal flash prefill over
  the ``[b, s, hidden]`` layout,
- ``apex_tpu_torch.kernels.decode_attention`` — the one-column cache
  write and the flash-decode read.

Each kernel has a plain PyTorch twin in the same module; a wrapper takes
it only for tensors on the CPU (the tests), and for CUDA tensors it
launches the kernel or raises.

Entry points take ``device=None``, which means ``"cuda"``; without a CUDA
device they raise instead of running on the CPU (pass ``device="cpu"``
to mean the CPU). Importing the package initialises no CUDA context and
builds nothing. It never imports ``jax`` or ``apex_tpu``.
"""

from apex_tpu_torch._capabilities import capabilities, resolve_device

__version__ = "0.1.0"

__all__ = ["capabilities", "resolve_device", "__version__"]
