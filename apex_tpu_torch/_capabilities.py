"""Runtime capabilities of the PyTorch/CUDA port, and the one device rule.

:func:`capabilities` reports what the card and the toolchain offer (CUDA
present, the device's name and compute capability, where ``nvcc`` is and
where the kernels are built). :func:`resolve_device` is the single place
that maps the entry points' ``device=None`` to ``"cuda"``: without a CUDA
device it raises instead of carrying on on the CPU, so a run on the
wrong machine fails loudly. Callers that mean the CPU (the tests) say so
with ``device="cpu"``.

Nothing here initialises CUDA or builds a kernel at import time.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

#: the compute capability the kernels are built for (``sm_90a``)
REQUIRED_CAPABILITY = (9, 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda`` (raises :class:`RuntimeError` when no CUDA
    device exists); an explicit device is returned as a
    :class:`torch.device`, after the same check for a CUDA one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apex_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch "
            "versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(
            f"unsupported device {dev} (expected 'cuda' or 'cpu')")
    return dev


def capabilities() -> Dict[str, Any]:
    """Snapshot of the runtime: CUDA presence, the first device's name
    and compute capability (``kernels_supported`` is True only on
    (9, 0)), the ``nvcc`` in use and the kernels' build directory.
    Computed per call; reading it initialises CUDA only when a device
    exists."""
    from apex_tpu_torch.kernels import _build

    caps: Dict[str, Any] = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_name": None,
        "device_count": 0,
        "compute_capability": None,
        "nvcc": _build.find_nvcc(),
        "build_dir": str(_build.build_dir()),
    }
    if caps["cuda_available"]:
        caps["device_name"] = torch.cuda.get_device_name(0)
        caps["device_count"] = torch.cuda.device_count()
        caps["compute_capability"] = tuple(
            torch.cuda.get_device_capability(0))
    caps["kernels_supported"] = (
        caps["compute_capability"] == REQUIRED_CAPABILITY
        and caps["nvcc"] is not None)
    return caps
