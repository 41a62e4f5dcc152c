"""Parallel layers of the port (``apex_tpu.parallel``): data-parallel
gradient reduction (``allreduce_gradients``, ``flat_dist_call``,
``DistributedDataParallel``, ``Reducer``), joining the process group
(``initialize_distributed``) and local BatchNorm through
``sync_batch_norm``. Cross-replica BatchNorm statistics wait for a later
distributed slice (SyncBN with ResNet DDP)."""

from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    allreduce_gradients,
    flat_dist_call,
)
from apex_tpu_torch.parallel.multiproc import (
    destroy_distributed,
    initialize_distributed,
)
from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm

__all__ = [
    "DistributedDataParallel",
    "Reducer",
    "allreduce_gradients",
    "destroy_distributed",
    "flat_dist_call",
    "initialize_distributed",
    "sync_batch_norm",
]
