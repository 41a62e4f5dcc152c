"""Megatron-style transformer pieces of the port (``apex_tpu.transformer``):
the parallel state over a mesh of processes, the tensor-parallel core
(mappings, parallel layers, vocab-parallel cross entropy, RNG streams),
the enums, the fused softmax of ``transformer.functional``, the
LayerNorm selection of ``transformer.layers`` and the namespaced logger
of ``log_util``. Pipeline schedules and context parallelism come with
later distributed slices."""
