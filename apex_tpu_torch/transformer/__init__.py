"""Megatron-style transformer pieces of the port (``apex_tpu.transformer``):
the tensor-parallel cross entropy at tp=1, the enums, and the fused
softmax of ``transformer.functional``. Parallel state, the parallel
layers, pipeline schedules and context parallelism come with the
distributed slice."""
