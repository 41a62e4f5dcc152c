"""Parallel layers of the port (``apex_tpu.parallel``): local BatchNorm
through ``sync_batch_norm``. Cross-replica statistics, DDP and the
multi-process launcher come with the distributed slice."""

from apex_tpu_torch.parallel.sync_batchnorm import sync_batch_norm

__all__ = ["sync_batch_norm"]
