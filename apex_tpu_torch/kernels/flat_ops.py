"""Flat-buffer multi-tensor kernels (the ``amp_C`` equivalent): Adam, SGD
with momentum, Adagrad, the global L2 norm, and amp's scale and axpby.

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

``sgd_flat`` (kernel body ``_sgd_kernel``, ``multi_tensor_sgd``) and
``adagrad_flat`` (``_adagrad_kernel``, ``multi_tensor_adagrad``) follow
Adam's contract: in place, or deltas with ``out_is_delta``, device
scalars, the ``skip`` no-op flag; their plain twins are
:func:`sgd_flat_plain` and :func:`adagrad_flat_plain`.

``scale_flat`` (``_scale_kernel``, ``multi_tensor_scale``) and
``axpby_flat`` (``_axpby_kernel``, ``multi_tensor_axpby``) keep the JAX
functions' contract: they return new buffers and a found-inf flag,
``(outs, found_inf)``. ``found_inf`` is a bool 0-d tensor on the
buffers' device (no host sync): scale raises it for a non-finite INPUT,
axpby for a non-finite fp32 RESULT taken before it is narrowed to the
output dtype, so in neither does an fp16 output that overflows in the
narrowing raise it. Their plain twins are :func:`scale_flat_plain` and
:func:`axpby_flat_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

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


def _check_multiple(n: int, what: str) -> None:
    if n % 4:
        raise ValueError(f"{what} kernel: buffer size {n} is not a multiple "
                         f"of 4 (pack pads to 65536)")


def _widen(b: torch.Tensor) -> torch.Tensor:
    return b.float() if b.dtype == torch.float16 else b


def _found_inf(bad: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(bad).any()


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
        _check_multiple(n, "adam_flat")
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


def sgd_scalars(lr, momentum, dampening, weight_decay, grad_scale,
                device) -> torch.Tensor:
    """The five fp32 scalars of ``_sgd_kernel``'s ``s_ref``, in its
    order, as one device tensor (built on the device, no host sync)."""
    vals = [lr, momentum, dampening, weight_decay, grad_scale]
    return torch.stack([device_scalar(x, device) for x in vals])


def _sgd_math(p, g, m, s, nesterov: bool, out_is_delta: bool):
    """``_sgd_kernel`` on whole buffers in fp32 → ``(out, m)``."""
    lr, momentum, dampening, wd, gscale = s.unbind(0)
    p32 = p.float()
    gr = g.float() * gscale + wd * p32
    m_new = momentum * m + (1.0 - dampening) * gr
    upd = gr + momentum * m_new if nesterov else m_new
    out = -lr * upd if out_is_delta else p32 - lr * upd
    return out, m_new


def sgd_flat_plain(p_bufs, g_bufs, m_bufs, scalars, *,
                   nesterov: bool = False, out_is_delta: bool = False,
                   skip=None):
    """Plain PyTorch twin of the kernel, with its contract: m (and p,
    unless ``out_is_delta``) are written in place; with
    ``out_is_delta`` the first result is new fp32 delta buffers. Where
    ``skip`` is True nothing changes and the deltas are zero."""
    outs = []
    for p, g, m in zip(p_bufs, g_bufs, m_bufs):
        new_p, new_m = _sgd_math(p, g, m, scalars, nesterov, out_is_delta)
        if skip is not None:
            keep = torch.zeros_like(new_p) if out_is_delta else p.float()
            new_p = torch.where(skip, keep, new_p)
            new_m = torch.where(skip, m, new_m)
        if out_is_delta:
            outs.append(new_p)
        else:
            p.copy_(new_p)
            outs.append(p)
        m.copy_(new_m)
    return outs, list(m_bufs)


def sgd_flat(p_bufs: Sequence[torch.Tensor], g_bufs: Sequence[torch.Tensor],
             m_bufs: Sequence[torch.Tensor], *, lr, momentum, dampening,
             weight_decay, grad_scale=1.0, nesterov: bool = False,
             out_is_delta: bool = False,
             skip: Optional[torch.Tensor] = None):
    """``amp_C.multi_tensor_sgd``: one fused sweep per group → ``(p_bufs,
    m_bufs)``, params and momentum updated in place; with
    ``out_is_delta`` the params are only read and the first result is
    one new fp32 buffer per group holding ``-lr * upd``.

    Per element: ``g' = g * grad_scale + weight_decay * p``, ``m =
    momentum * m + (1 - dampening) * g'``, ``upd = g' + momentum * m``
    (Nesterov) or ``m``. The caller zeroes ``dampening`` on the first
    step (torch's momentum buffer starts as the raw gradient). Params
    are fp32 or bf16 (float16 is widened to fp32 for the sweep and
    written back); grads and momentum fp32; every buffer 1-D and padded
    (``multi_tensor.pack``). CUDA buffers launch the kernel once per
    group (counted in ``sgd_flat.launches``); CPU buffers run the plain
    version. ``skip`` is ``adam_flat``'s."""
    if not len(p_bufs) == len(g_bufs) == len(m_bufs):
        raise ValueError("p/g/m buffer lists differ in length")
    if not p_bufs:
        return [], []
    wide = [_widen(p) for p in p_bufs]
    g_bufs = [g if g.dtype == torch.float32 else g.float() for g in g_bufs]
    dev = wide[0].device
    scalars = sgd_scalars(lr, momentum, dampening, weight_decay, grad_scale,
                          dev)
    if skip is not None:
        skip = torch.as_tensor(skip, device=dev).reshape(()).bool()
    if not _build.on_cuda(*wide, *g_bufs, *m_bufs, scalars):
        outs, m_out = sgd_flat_plain(wide, g_bufs, m_bufs, scalars,
                                     nesterov=nesterov,
                                     out_is_delta=out_is_delta, skip=skip)
    else:
        noop = None if skip is None else skip.to(torch.int32).reshape(1)
        lib = _build.library()
        outs = []
        for p, g, m in zip(wide, g_bufs, m_bufs):
            n = p.numel()
            code = _build.dtype_code(p, "sgd_flat param")
            _build.require(p, "p", (n,), p.dtype)
            _build.require(g, "g", (n,), torch.float32)
            _build.require(m, "m", (n,), torch.float32)
            _check_multiple(n, "sgd_flat")
            delta = None
            if out_is_delta:
                alloc = torch.empty if skip is None else torch.zeros
                delta = alloc(n, dtype=torch.float32, device=dev)
            rc = lib.apex_tpu_torch_sgd_flat(
                p.data_ptr(), g.data_ptr(), m.data_ptr(),
                None if delta is None else delta.data_ptr(),
                scalars.data_ptr(), None if noop is None else noop.data_ptr(),
                n, int(nesterov), code, _build.stream())
            _build.check(rc, "sgd_flat")
            sgd_flat.launches += 1
            outs.append(p if delta is None else delta)
        m_out = list(m_bufs)
    if not out_is_delta:          # a widened float16 group goes back
        for p, w in zip(p_bufs, wide):
            if w is not p:
                p.copy_(w)
        outs = list(p_bufs)
    return outs, m_out


sgd_flat.launches = 0


def adagrad_scalars(lr, eps, weight_decay, grad_scale, device
                    ) -> torch.Tensor:
    """The four fp32 scalars of ``_adagrad_kernel``'s ``s_ref``, in its
    order, as one device tensor (built on the device, no host sync)."""
    return torch.stack([device_scalar(x, device)
                        for x in (lr, eps, weight_decay, grad_scale)])


def _adagrad_math(p, g, h, s, out_is_delta: bool):
    """``_adagrad_kernel`` on whole buffers in fp32 → ``(out, h)``, in
    its order of operations: ``(lr * g') / (sqrt(h) + eps)``."""
    lr, eps, wd, gscale = s.unbind(0)
    p32 = p.float()
    gr = g.float() * gscale + wd * p32
    h_new = h + gr * gr
    upd = lr * gr / (torch.sqrt(h_new) + eps)
    return (-upd if out_is_delta else p32 - upd), h_new


def adagrad_flat_plain(p_bufs, g_bufs, h_bufs, scalars, *,
                       out_is_delta: bool = False, skip=None):
    """Plain PyTorch twin of the kernel, with its contract: h (and p,
    unless ``out_is_delta``) are written in place; with ``out_is_delta``
    the first result is new fp32 delta buffers. Where ``skip`` is True
    nothing changes and the deltas are zero."""
    outs = []
    for p, g, h in zip(p_bufs, g_bufs, h_bufs):
        new_p, new_h = _adagrad_math(p, g, h, scalars, out_is_delta)
        if skip is not None:
            keep = torch.zeros_like(new_p) if out_is_delta else p.float()
            new_p = torch.where(skip, keep, new_p)
            new_h = torch.where(skip, h, new_h)
        if out_is_delta:
            outs.append(new_p)
        else:
            p.copy_(new_p)
            outs.append(p)
        h.copy_(new_h)
    return outs, list(h_bufs)


def adagrad_flat(p_bufs: Sequence[torch.Tensor],
                 g_bufs: Sequence[torch.Tensor],
                 h_bufs: Sequence[torch.Tensor], *, lr, eps, weight_decay,
                 grad_scale=1.0, out_is_delta: bool = False,
                 skip: Optional[torch.Tensor] = None):
    """``amp_C.multi_tensor_adagrad``: one fused sweep per group →
    ``(p_bufs, h_bufs)``, params and the sum of squares updated in place;
    with ``out_is_delta`` the params are only read and the first result
    is one new fp32 buffer per group holding ``-upd``.

    Per element: ``g' = g * grad_scale + weight_decay * p``, ``h += g'^2``,
    ``upd = lr * g' / (sqrt(h) + eps)``, ``p -= upd``. Params are fp32 or
    bf16 (float16 is widened to fp32 for the sweep and written back);
    grads any float type (taken as fp32), h fp32; every buffer 1-D and
    padded (``multi_tensor.pack``). CUDA buffers launch the kernel once
    per group (counted in ``adagrad_flat.launches``); CPU buffers run the
    plain version. ``skip`` is ``adam_flat``'s."""
    if not len(p_bufs) == len(g_bufs) == len(h_bufs):
        raise ValueError("p/g/h buffer lists differ in length")
    if not p_bufs:
        return [], []
    wide = [_widen(p) for p in p_bufs]
    g_bufs = [g if g.dtype == torch.float32 else g.float() for g in g_bufs]
    dev = wide[0].device
    scalars = adagrad_scalars(lr, eps, weight_decay, grad_scale, dev)
    if skip is not None:
        skip = torch.as_tensor(skip, device=dev).reshape(()).bool()
    if not _build.on_cuda(*wide, *g_bufs, *h_bufs, scalars):
        outs, h_out = adagrad_flat_plain(wide, g_bufs, h_bufs, scalars,
                                         out_is_delta=out_is_delta,
                                         skip=skip)
    else:
        noop = None if skip is None else skip.to(torch.int32).reshape(1)
        lib = _build.library()
        outs = []
        for p, g, h in zip(wide, g_bufs, h_bufs):
            n = p.numel()
            code = _build.dtype_code(p, "adagrad_flat param")
            _build.require(p, "p", (n,), p.dtype)
            _build.require(g, "g", (n,), torch.float32)
            _build.require(h, "h", (n,), torch.float32)
            _check_multiple(n, "adagrad_flat")
            delta = None
            if out_is_delta:
                alloc = torch.empty if skip is None else torch.zeros
                delta = alloc(n, dtype=torch.float32, device=dev)
            rc = lib.apex_tpu_torch_adagrad_flat(
                p.data_ptr(), g.data_ptr(), h.data_ptr(),
                None if delta is None else delta.data_ptr(),
                scalars.data_ptr(), None if noop is None else noop.data_ptr(),
                n, code, _build.stream())
            _build.check(rc, "adagrad_flat")
            adagrad_flat.launches += 1
            outs.append(p if delta is None else delta)
        h_out = list(h_bufs)
    if not out_is_delta:          # a widened float16 group goes back
        for p, w in zip(p_bufs, wide):
            if w is not p:
                p.copy_(w)
        outs = list(p_bufs)
    return outs, h_out


adagrad_flat.launches = 0


def scale_flat_plain(bufs: Sequence[torch.Tensor], scalar: torch.Tensor):
    """Plain PyTorch twin of the kernel: each buffer times the fp32 0-d
    ``scalar`` in fp32, in the buffer's dtype, and whether any input is
    not finite → ``(outs, found_inf)``."""
    outs, bad = [], []
    for b in bufs:
        x = b.float()
        outs.append((x * scalar).to(b.dtype))
        bad.append(~torch.isfinite(x).all())
    return outs, _found_inf(bad)


def scale_flat(bufs: Sequence[torch.Tensor], scale):
    """``amp_C.multi_tensor_scale``: ``(outs, found_inf)``, each out a new
    buffer ``x * scale`` in x's dtype, ``found_inf`` a bool 0-d device
    tensor, True when any input element is not finite — the unscale with
    overflow check of the dynamic loss scaler. ``scale`` is a number or a
    0-d tensor. Buffers are 1-D, fp32 or bf16 (float16 is widened to fp32
    and the result narrowed back, as the JAX function does). CUDA buffers
    launch the kernel once per buffer (counted in
    ``scale_flat.launches``); CPU buffers run the plain version."""
    want = [b.dtype for b in bufs]
    wide = [_widen(b) for b in bufs]
    if not wide:
        raise ValueError("scale_flat needs at least one buffer")
    dev = wide[0].device
    s = device_scalar(scale, dev)
    if not _build.on_cuda(*wide, s):
        outs, found = scale_flat_plain(wide, s)
    else:
        lib = _build.library()
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        outs = []
        for i, x in enumerate(wide):
            n = x.numel()
            code = _build.dtype_code(x, "scale_flat buffer")
            _build.require(x, f"buffer {i}", (n,), x.dtype)
            _check_multiple(n, "scale_flat")
            out = torch.empty_like(x)
            rc = lib.apex_tpu_torch_scale_flat(
                x.data_ptr(), out.data_ptr(), s.data_ptr(), flag.data_ptr(),
                n, code, _build.stream())
            _build.check(rc, "scale_flat")
            scale_flat.launches += 1
            outs.append(out)
        found = flag[0] != 0
    return [o if o.dtype == w else o.to(w) for o, w in zip(outs, want)], found


scale_flat.launches = 0


def axpby_flat_plain(scalars: torch.Tensor, xbufs: Sequence[torch.Tensor],
                     ybufs: Sequence[torch.Tensor],
                     out_dtypes: Sequence[torch.dtype]):
    """Plain PyTorch twin of the kernel: ``a * x + b * y`` in fp32 (each
    product and the sum rounded on its own), stored in each group's out
    dtype, and whether any fp32 result is not finite → ``(outs,
    found_inf)``. ``scalars`` is the fp32 ``[a, b]`` device tensor."""
    a, b = scalars.unbind(0)
    outs, bad = [], []
    for x, y, dt in zip(xbufs, ybufs, out_dtypes):
        o = a * x.float() + b * y.float()
        bad.append(~torch.isfinite(o).all())
        outs.append(o.to(dt))
    return outs, _found_inf(bad)


def axpby_flat(a, xbufs: Sequence[torch.Tensor], b,
               ybufs: Sequence[torch.Tensor], out_dtype=None):
    """``amp_C.multi_tensor_axpby``: ``(outs, found_inf)``, each out a new
    buffer ``a * x + b * y`` computed in fp32 and stored in ``out_dtype``
    (default: x's dtype), ``found_inf`` a bool 0-d device tensor, True
    when any fp32 result is not finite (taken before the narrowing) — the
    master-grad accumulation of apex's ``unscale_with_stashed``. ``a``
    and ``b`` are numbers (passed to the kernel by value) or 0-d tensors
    (read by the kernel on the device). x and y are 1-D, fp32 or bf16
    each (float16 is widened); a float16 output is computed in fp32 and
    narrowed, as the JAX function does. CUDA buffers launch the kernel
    once per pair (counted in ``axpby_flat.launches``); CPU buffers run
    the plain version."""
    if len(xbufs) != len(ybufs):
        raise ValueError("x/y buffer lists differ in length")
    if not xbufs:
        raise ValueError("axpby_flat needs at least one buffer pair")
    want = [out_dtype or x.dtype for x in xbufs]
    kernel_dt = [torch.float32 if w == torch.float16 else w for w in want]
    xw = [_widen(x) for x in xbufs]
    yw = [_widen(y) for y in ybufs]
    dev = xw[0].device
    numbers = not isinstance(a, torch.Tensor) and \
        not isinstance(b, torch.Tensor)
    on_cuda = _build.on_cuda(*xw, *yw)
    # numbers reach the kernel by value: no device scalars to build
    scalars = None if numbers and on_cuda else \
        torch.stack([device_scalar(a, dev), device_scalar(b, dev)])
    if not on_cuda:
        outs, found = axpby_flat_plain(scalars, xw, yw, kernel_dt)
    else:
        lib = _build.library()
        flag = torch.zeros(1, dtype=torch.bool, device=dev)
        outs = []
        for i, (x, y, dt) in enumerate(zip(xw, yw, kernel_dt)):
            n = x.numel()
            out = torch.empty(n, dtype=dt, device=dev)
            codes = (_build.dtype_code(x, "axpby_flat x"),
                     _build.dtype_code(y, "axpby_flat y"),
                     _build.dtype_code(out, "axpby_flat out"))
            _build.require(x, f"x {i}", (n,), x.dtype)
            _build.require(y, f"y {i}", (n,), y.dtype)
            _check_multiple(n, "axpby_flat")
            rc = lib.apex_tpu_torch_axpby_flat(
                x.data_ptr(), y.data_ptr(), out.data_ptr(),
                None if scalars is None else scalars.data_ptr(),
                float(a) if numbers else 0.0, float(b) if numbers else 0.0,
                flag.data_ptr(), n, *codes, _build.stream())
            _build.check(rc, "axpby_flat")
            axpby_flat.launches += 1
            outs.append(out)
        found = flag.reshape(())
    return [o if o.dtype == w else o.to(w) for o, w in zip(outs, want)], found


axpby_flat.launches = 0


def l2norm_flat_plain(bufs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: each buffer's fp32 sum of
    squares, added in list order, then the square root."""
    total = torch.zeros((), dtype=torch.float32, device=bufs[0].device)
    for b in bufs:
        b32 = b.float()
        total = total + torch.sum(b32 * b32)
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class L2NormGeometry:
    """The launch geometry of ``csrc/flat_ops.cu``'s ``l2norm_kernel`` for
    one call: buffer i is summed by ``blocks[i]`` blocks of
    ``chunks[i]`` elements each (the last one up to n); ``launches`` are
    the ``[start, stop)`` runs of buffers that go in one launch each, in
    list order; ``words`` is the fp32 workspace the launches index (the
    ticket, one sum a buffer, one partial a block of the largest
    launch)."""

    blocks: Tuple[int, ...]
    chunks: Tuple[int, ...]
    launches: Tuple[Tuple[int, int], ...]
    words: int


def l2norm_geometry(ns: Sequence[int], dtypes: Sequence[torch.dtype]
                    ) -> L2NormGeometry:
    """Where each block of ``l2norm_flat``'s kernel reads. A tile is
    ``_build.L2NORM_UNROLL`` 16-byte vectors of each of the block's
    ``_build.L2NORM_THREADS`` threads; a buffer's tiles are dealt out in
    contiguous runs of equal length to at most
    ``_build.L2NORM_MAX_BLOCKS`` blocks (an empty buffer still gets one
    block, which adds 0). A buffer's blocks and chunk depend on its n and
    dtype alone, so a call sums each buffer in the same order whatever
    the other buffers are. Up to ``_build.L2NORM_MAX_BUFFERS`` buffers go
    in one launch."""
    blocks, chunks = [], []
    for n, dt in zip(ns, dtypes):
        tile = _build.L2NORM_UNROLL * (16 // dt.itemsize) \
            * _build.L2NORM_THREADS
        tiles = max(1, -(-n // tile))
        per_block = -(-tiles // min(tiles, _build.L2NORM_MAX_BLOCKS))
        blocks.append(-(-tiles // per_block))
        chunks.append(per_block * tile)
    cap = _build.L2NORM_MAX_BUFFERS
    launches = tuple((i, min(i + cap, len(blocks)))
                     for i in range(0, len(blocks), cap))
    words = 1 + len(blocks) + max(sum(blocks[a:b]) for a, b in launches)
    return L2NormGeometry(tuple(blocks), tuple(chunks), launches, words)


def _host_array(ctype, values) -> ctypes.c_void_p:
    return ctypes.cast((ctype * len(values))(*values), ctypes.c_void_p)


def l2norm_flat(bufs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``amp_C.multi_tensor_l2norm`` in its global mode: the L2 norm of
    all the buffers together, a 0-d fp32 tensor on their device. Buffers
    are 1-D, fp32 or bf16 (float16 is widened to fp32, as the JAX
    function does). CUDA buffers launch the kernel once per call (and
    once more per further ``_build.L2NORM_MAX_BUFFERS`` buffers), counted
    once in ``l2norm_flat.launches``; CPU buffers run the plain
    version."""
    bufs = [_widen(b) for b in bufs]
    if not bufs:
        raise ValueError("l2norm_flat needs at least one buffer")
    if not _build.on_cuda(*bufs):
        return l2norm_flat_plain(bufs)
    codes = [_build.dtype_code(b, f"l2norm_flat buffer {i}")
             for i, b in enumerate(bufs)]
    for i, b in enumerate(bufs):
        _build.require(b, f"buffer {i}", (b.numel(),), b.dtype)
    geo = l2norm_geometry([b.numel() for b in bufs], [b.dtype for b in bufs])
    dev = bufs[0].device
    lib = _build.library()
    work = torch.empty(geo.words, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    for start, stop in geo.launches:
        part = range(start, stop)
        rc = lib.apex_tpu_torch_l2norm_flat(
            _host_array(ctypes.c_void_p, [bufs[i].data_ptr() for i in part]),
            _host_array(ctypes.c_longlong, [bufs[i].numel() for i in part]),
            _host_array(ctypes.c_int, codes[start:stop]),
            _host_array(ctypes.c_int, geo.blocks[start:stop]),
            _host_array(ctypes.c_longlong, geo.chunks[start:stop]),
            stop - start, start, len(bufs), work.data_ptr(), out.data_ptr(),
            _build.stream())
        _build.check(rc, "l2norm_flat")
    l2norm_flat.launches += 1
    return out


l2norm_flat.launches = 0

__all__: List[str] = ["adagrad_flat", "adagrad_flat_plain",
                      "adagrad_scalars", "adam_flat", "adam_flat_plain",
                      "adam_scalars", "axpby_flat", "axpby_flat_plain",
                      "device_scalar", "l2norm_flat", "l2norm_flat_plain",
                      "l2norm_geometry", "scale_flat", "scale_flat_plain",
                      "sgd_flat", "sgd_flat_plain", "sgd_scalars"]
