"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu, for NVIDIA Hopper.

The JAX package ``apex_tpu`` is the reference; this package is its port,
slice by slice (``ROADMAP.md``): GPT serving through the
continuous-batching :class:`~apex_tpu_torch.serving.Engine` and its
:class:`~apex_tpu_torch.serving.Scheduler` (contiguous, paged,
speculative and quantized KV caches; stop sequences, schema-constrained
decoding and tenant fair queueing) behind the OpenAI HTTP front end
(``apex_tpu_torch.serving.api``, ``apex_tpu_torch.examples.serve_gpt``),
observed through ``apex_tpu_torch.telemetry`` (metrics registry, spans,
SLO sketches, the flight recorder and its replay) and tuned online by
``apex_tpu_torch.serving.tuner``; and single-device training of GPT
(355M and Megatron-GPT 2.7B: ``apex_tpu_torch.examples.gpt_train``),
BERT and ResNet with the fused optimizers and amp; and apex's L3 entry
points (``multi_tensor.MultiTensorApply``, ``contrib.clip_grad_norm_``,
the fused optimizers, ``transformer.functional.FusedScaleMaskSoftmax``).
Every Pallas kernel is a CUDA kernel written for ``sm_90a``
(``apex_tpu_torch/csrc``), built with ``nvcc`` at first use and bound
with ``ctypes``, in ``apex_tpu_torch.kernels``:

- ``flash_attention`` — flash attention forward and backward over the
  lane-packed ``[b, s, hidden]`` layout and over the head-major
  ``[b, heads, s, d]`` one,
- ``decode_attention`` — the cache writes and the flash-decode reads,
  contiguous, paged and quantized,
- ``layer_norm``, ``xentropy``, ``softmax``, ``flat_ops`` — LayerNorm,
  the softmax cross entropy, the scaled masked softmax, and the
  multi-tensor sweeps (the optimizers, scale, axpby, the L2 norm).

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
