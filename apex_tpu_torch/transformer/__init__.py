"""Megatron-style transformer pieces of the port (``apex_tpu.transformer``):
the tensor-parallel cross entropy at tp=1. Parallel state, the parallel
layers, pipeline schedules and context parallelism come with the
distributed slice."""
