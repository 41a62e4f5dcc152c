"""Flat-buffer multi-tensor kernels (the ``amp_C`` equivalent): Adam and
the global L2 norm.

Port of ``apex_tpu/kernels/flat_ops.py:adam_flat`` (kernel body
``_adam_kernel``), apex's ``multi_tensor_adam``: one sweep per dtype
group over packed (param, grad, m, v) buffers; and of ``l2norm_flat``
(kernel body ``_sumsq_kernel``), ``multi_tensor_l2norm``'s global mode.
CUDA tensors launch ``csrc/flat_ops.cu``; CPU tensors run
:func:`adam_flat_plain` and :func:`l2norm_flat_plain`.

Differences of idiom from the JAX functions:

- ``m`` and ``v`` are updated IN PLACE, and so are the params unless
  ``out_is_delta`` (the JAX function returns new buffers; its train step
  donates the old ones). With ``out_is_delta`` the update ``-lr * upd``
  goes to a new fp32 buffer per group and the params are only read: the
  JAX function's ``out_dtype=float32``, which FusedLAMB's stage 1 uses;
- the hyperparameters may be Python numbers or 0-d tensors on the
  buffers' device (a schedule's learning rate, the bias corrections of a
  step count kept on the device); the kernel reads all eight from one
  device buffer, so a step never waits on the host;
- ``skip`` (a bool 0-d tensor on the device, or None) is apex's
  ``noop_flag``: where it is True the sweep changes nothing, so an
  overflow step leaves params, m and v bit for bit as they were.

- ``l2norm_flat`` returns the norm as a 0-d fp32 tensor on the
  buffers' device, so no step waits on the host for it.

The other flat sweeps (scale, axpby, sgd, adagrad) come with later
slices.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from apex_tpu_torch.kernels import _build


def device_scalar(x, device) -> torch.Tensor:
    """``x`` as an fp32 0-d tensor on ``device``. A Python number is
    filled in place there (a kernel, not a copy from pageable host memory,
    which would make the host wait for the stream and cannot be captured
    in a CUDA graph); a tensor is cast and moved."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def adam_scalars(lr, b1, b2, eps, weight_decay, bias_correction1,
                 bias_correction2, grad_scale, device) -> torch.Tensor:
    """The eight fp32 scalars of ``_adam_kernel``'s ``s_ref``, in its
    order, as one device tensor (built on the device, no host sync)."""
    vals = [lr, b1, b2, eps, weight_decay, bias_correction1,
            bias_correction2, grad_scale]
    return torch.stack([device_scalar(x, device) for x in vals])


def _adam_math(p, g, m, v, s, adam_w_mode: bool, out_is_delta: bool,
               grad_averaging: bool):
    """``_adam_kernel`` on whole buffers in fp32 → ``(out, m, v)``."""
    lr, b1, b2, eps, wd, bc1, bc2, gscale = s.unbind(0)
    p32 = p.float()
    gr = g.float() * gscale
    if not adam_w_mode:
        gr = gr + wd * p32
    m_new = b1 * m + ((1.0 - b1) if grad_averaging else 1.0) * gr
    v_new = b2 * v + (1.0 - b2) * gr * gr
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode:
        upd = upd + wd * p32
    out = -lr * upd if out_is_delta else p32 - lr * upd
    return out, m_new, v_new


def adam_flat_plain(p_bufs, g_bufs, m_bufs, v_bufs, scalars, *,
                    adam_w_mode: bool = True, out_is_delta: bool = False,
                    grad_averaging: bool = True, skip=None):
    """Plain PyTorch twin of the kernel, with its contract: m and v (and
    p, unless ``out_is_delta``) are written in place; with
    ``out_is_delta`` the first result is new fp32 delta buffers. Where
    ``skip`` is True nothing changes and the deltas are zero (a select,
    no host sync)."""
    outs = []
    for p, g, m, v in zip(p_bufs, g_bufs, m_bufs, v_bufs):
        new_p, new_m, new_v = _adam_math(p, g, m, v, scalars, adam_w_mode,
                                         out_is_delta, grad_averaging)
        if skip is not None:
            keep = torch.zeros_like(new_p) if out_is_delta else p.float()
            new_p = torch.where(skip, keep, new_p)
            new_m = torch.where(skip, m, new_m)
            new_v = torch.where(skip, v, new_v)
        if out_is_delta:
            outs.append(new_p)
        else:
            p.copy_(new_p)
            outs.append(p)
        m.copy_(new_m)
        v.copy_(new_v)
    return outs, list(m_bufs), list(v_bufs)


def adam_flat(p_bufs: Sequence[torch.Tensor], g_bufs: Sequence[torch.Tensor],
              m_bufs: Sequence[torch.Tensor], v_bufs: Sequence[torch.Tensor],
              *, lr, b1, b2, eps, weight_decay, bias_correction1,
              bias_correction2, grad_scale=1.0, adam_w_mode: bool = True,
              out_is_delta: bool = False, grad_averaging: bool = True,
              skip: Optional[torch.Tensor] = None):
    """``amp_C.multi_tensor_adam``: one fused sweep per group updating the
    params and both moments in place → ``(p_bufs, m_bufs, v_bufs)``; with
    ``out_is_delta`` the params are left as they are and the first result
    is one new fp32 buffer per group holding ``-lr * upd``.

    Params are fp32 or bf16; grads, m and v fp32; every buffer 1-D and
    padded (``multi_tensor.pack``). CUDA buffers launch the kernel once
    per group (counted in ``adam_flat.launches``); CPU buffers run the
    plain version."""
    groups = list(zip(p_bufs, g_bufs, m_bufs, v_bufs))
    if not len(groups) == len(p_bufs) == len(g_bufs) == len(m_bufs) \
            == len(v_bufs):
        raise ValueError("p/g/m/v buffer lists differ in length")
    flat = [t for grp in groups for t in grp]
    if not flat:
        return [], [], []
    dev = flat[0].device
    scalars = adam_scalars(lr, b1, b2, eps, weight_decay, bias_correction1,
                           bias_correction2, grad_scale, dev)
    if skip is not None:
        skip = torch.as_tensor(skip, device=dev).reshape(()).bool()
    if not _build.on_cuda(*flat, scalars):
        return adam_flat_plain(p_bufs, g_bufs, m_bufs, v_bufs, scalars,
                               adam_w_mode=adam_w_mode,
                               out_is_delta=out_is_delta,
                               grad_averaging=grad_averaging, skip=skip)
    noop = None if skip is None else skip.to(torch.int32).reshape(1)
    lib = _build.library()
    outs = []
    for p, g, m, v in groups:
        n = p.numel()
        code = _build.dtype_code(p, "adam_flat param")
        _build.require(p, "p", (n,), p.dtype)
        for name, t in (("g", g), ("m", m), ("v", v)):
            _build.require(t, name, (n,), torch.float32)
        if n % 4:
            raise ValueError(f"adam_flat kernel: buffer size {n} is not a "
                             f"multiple of 4 (pack pads to 65536)")
        delta = None
        if out_is_delta:
            # a skipped sweep writes nothing, and its update is zero
            alloc = torch.empty if skip is None else torch.zeros
            delta = alloc(n, dtype=torch.float32, device=dev)
        rc = lib.apex_tpu_torch_adam_flat(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if delta is None else delta.data_ptr(), scalars.data_ptr(),
            None if noop is None else noop.data_ptr(), n, int(adam_w_mode),
            int(grad_averaging), code, _build.stream())
        _build.check(rc, "adam_flat")
        adam_flat.launches += 1
        outs.append(p if delta is None else delta)
    return outs, list(m_bufs), list(v_bufs)


adam_flat.launches = 0


def l2norm_flat_plain(bufs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: each buffer's fp32 sum of
    squares, added in list order, then the square root."""
    total = torch.zeros((), dtype=torch.float32, device=bufs[0].device)
    for b in bufs:
        b32 = b.float()
        total = total + torch.sum(b32 * b32)
    return torch.sqrt(total)


def l2norm_flat(bufs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``amp_C.multi_tensor_l2norm`` in its global mode: the L2 norm of
    all the buffers together, a 0-d fp32 tensor on their device. Buffers
    are 1-D, fp32 or bf16 (float16 is widened to fp32, as the JAX
    function does). CUDA buffers launch the two-pass kernel once per call
    (counted in ``l2norm_flat.launches``); CPU buffers run the plain
    version."""
    bufs = [b.float() if b.dtype == torch.float16 else b for b in bufs]
    if not bufs:
        raise ValueError("l2norm_flat needs at least one buffer")
    if not _build.on_cuda(*bufs):
        return l2norm_flat_plain(bufs)
    for i, b in enumerate(bufs):
        _build.require(b, f"buffer {i}", (b.numel(),), b.dtype)
    dev = bufs[0].device
    lib = _build.library()
    g = len(bufs)
    ptrs = (ctypes.c_void_p * g)(*[b.data_ptr() for b in bufs])
    ns = (ctypes.c_longlong * g)(*[b.numel() for b in bufs])
    codes = (ctypes.c_int * g)(*[_build.dtype_code(b, "l2norm_flat buffer")
                                 for b in bufs])
    work = torch.empty(g * lib.apex_tpu_torch_l2norm_blocks(),
                       dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    rc = lib.apex_tpu_torch_l2norm_flat(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(ns, ctypes.c_void_p),
        ctypes.cast(codes, ctypes.c_void_p), g, work.data_ptr(),
        out.data_ptr(), _build.stream())
    _build.check(rc, "l2norm_flat")
    l2norm_flat.launches += 1
    return out


l2norm_flat.launches = 0

__all__: List[str] = ["adam_flat", "adam_flat_plain", "adam_scalars",
                      "device_scalar", "l2norm_flat", "l2norm_flat_plain"]
