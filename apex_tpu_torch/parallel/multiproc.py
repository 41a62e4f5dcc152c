"""Joining the process group: ``apex_tpu/parallel/multiproc.py``'s
``initialize_distributed``.

One process per rank, as ``torchrun`` starts them: the rank, world size
and local rank come from its ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
(or are passed), the rendezvous from ``MASTER_ADDR`` / ``MASTER_PORT``
(``env://``) or an ``init_method`` such as ``tcp://localhost:<port>`` or
``file://<path>``.

The backend is NCCL unless the caller names another. NCCL needs a card
per rank: rank ``LOCAL_RANK`` takes ``cuda:LOCAL_RANK``. Under gloo the
caller names the device: ``"cpu"`` (the tests), or ``"cuda"``, where
ranks share the host's cards round robin (one card, several ranks: the
one-card rig). Without a card, ``device=None`` raises as every entry
point of the port does; nothing falls back to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from apex_tpu_torch._capabilities import resolve_device


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def initialize_distributed(backend: Optional[str] = None, *,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           local_rank: Optional[int] = None,
                           init_method: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None,
                           timeout_s: float = 600.0) -> torch.device:
    """Initialise ``torch.distributed``'s default group and return this
    rank's device (made current when it is a card). ``backend`` None
    means NCCL; ``device`` None means ``cuda:LOCAL_RANK``. A group that
    is already initialised is checked against the arguments and kept
    (its rank and world size then stand where the arguments and the
    environment are silent)."""
    dev = resolve_device(device)
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device per rank")
    if dist.is_initialized():
        # joined already (a launcher or a test rig did it): check it
        if dist.get_backend() != backend or (
                rank is not None and rank != dist.get_rank()) or (
                world_size is not None
                and world_size != dist.get_world_size()):
            raise RuntimeError(
                f"torch.distributed is already initialised as "
                f"{dist.get_backend()} rank {dist.get_rank()} of "
                f"{dist.get_world_size()}")
        rank, world_size = dist.get_rank(), dist.get_world_size()
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = (_env_int("WORLD_SIZE", 1) if world_size is None
                  else world_size)
    local_rank = (_env_int("LOCAL_RANK", rank) if local_rank is None
                  else local_rank)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if dev.index is None:
            if backend == "nccl" and local_rank >= n:
                raise RuntimeError(
                    f"NCCL needs a card per rank: local rank {local_rank} "
                    f"but {n} card(s); name the gloo backend to share "
                    "cards")
            dev = torch.device("cuda", local_rank % n)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if init_method is None:
        init_method = "env://"
        os.environ.setdefault("MASTER_ADDR", "localhost")
        if "MASTER_PORT" not in os.environ:
            if world_size > 1:
                raise RuntimeError(
                    "no rendezvous: set MASTER_ADDR / MASTER_PORT (torchrun "
                    "does) or pass init_method")
            os.environ["MASTER_PORT"] = str(_free_port())
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def destroy_distributed() -> None:
    """Tear the default group down when one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
