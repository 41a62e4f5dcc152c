"""The port's fused scaled, masked softmax vs the JAX package: the
kernels' plain twins (``softmax_fwd`` / ``softmax_bwd``) against the
interpret-mode Pallas kernels (``_run_fwd`` / ``_run_bwd``), the public
``scaled_masked_softmax`` / ``scaled_upper_triang_masked_softmax`` with
their gradients, every mask shape the JAX function broadcasts, and
``FusedScaleMaskSoftmax``'s dispatch, fused and unfused (the reference's
``tests/test_softmax_xentropy.py`` cases, re-pointed).

Inputs are made with numpy from fixed seeds and cross as numpy arrays;
JAX runs on the CPU with Pallas in interpret mode, the port with CPU
tensors (the plain versions; ``chip_smoke.py`` holds the CUDA kernels
against the same plain versions on the card).

Tolerances, each with its reason:

- fp32: ``atol = rtol = 1e-6`` (the row sums are added in another order
  and XLA's and PyTorch's ``exp`` differ by an ulp or two);
- bf16 and fp16 outputs and gradients: one ulp of the output dtype
  (2^-7 and 2^-10 relative), plus 1e-6 of the largest entry: both sides
  compute in fp32 and round once, and fp32 values that differ in the
  last bits can round to neighbouring half-precision values; a gradient
  entry where ``dy`` nearly cancels ``sum(y * dy)`` keeps only the
  absolute part.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.enums import AttnMaskType as JMask
from apex_tpu.transformer.functional import FusedScaleMaskSoftmax as JFSMS
from apex_tpu_torch import kernels as tk
from apex_tpu_torch.transformer import functional as tfunc
from apex_tpu_torch.transformer.enums import AttnMaskType as TMask

# the module (apex_tpu.kernels re-exports its functions)
jsm = importlib.import_module("apex_tpu.kernels.softmax")

torch.set_num_threads(1)

DT = {"f32": (jnp.float32, torch.float32, 0.0),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7),
      "f16": (jnp.float16, torch.float16, 2.0 ** -10)}


def _np(t):
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _both(arr, dtype):
    jd, td, _ = DT[dtype]
    return (jnp.asarray(arr, jnp.float32).astype(jd),
            torch.from_numpy(np.array(arr, np.float32)).to(td))


def _close(got, want, dtype):
    """The module's tolerance for one output of ``dtype``."""
    got = _np(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    ulp = DT[dtype][2]
    lim = ulp * np.abs(want) + 1e-6 * max(float(np.abs(want).max()), 1e-30)
    bad = np.abs(got - want) > lim
    assert not bad.any(), (np.abs(got - want)[bad].max(), bad.sum())


def _run_both(x_np, mask_np, dtype, *, scale, causal=False, dy_seed=0):
    """JAX's ``scaled_masked_softmax`` and its VJP, and the port's and its
    autograd gradient, on the same inputs → ((jy, jdx), (ty, tdx))."""
    jx, tx = _both(x_np, dtype)
    jmask = None if mask_np is None else jnp.asarray(mask_np)
    tmask = None if mask_np is None else torch.from_numpy(mask_np)
    dy_np = np.random.default_rng(dy_seed).standard_normal(
        x_np.shape).astype(np.float32)
    jdy, tdy = _both(dy_np, dtype)
    jy, vjp = jax.vjp(lambda x: jsm.scaled_masked_softmax(
        x, jmask, scale=scale, causal=causal), jx)
    (jdx,) = vjp(jdy)
    tx.requires_grad_(True)
    ty = tk.scaled_masked_softmax(tx, tmask, scale=scale, causal=causal)
    (tdx,) = torch.autograd.grad(ty, tx, tdy)
    assert ty.dtype == tx.dtype and tdx.dtype == tx.dtype
    return (jy, jdx), (ty, tdx)


B, H, SQ, SK = 2, 3, 8, 20

#: mask shapes over [b, h, sq, sk] scores, as apex users pass them
MASKS = {
    "none": None,
    "full": (B, H, SQ, SK),
    "b1_sq_sk": (B, 1, SQ, SK),
    "padding": (B, 1, 1, SK),
    "legacy": (B, SQ, SK),
    "sq_sk": (SQ, SK),
}


def _mask(shape, seed):
    m = np.random.default_rng(seed).random(shape) < 0.3
    m[..., 0] = False            # keep one key per row
    return m


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("kind", sorted(MASKS))
def test_scaled_masked_softmax_matches_jax(dtype, kind):
    x = (np.random.default_rng(1).standard_normal((B, H, SQ, SK)) * 2
         ).astype(np.float32)
    shape = MASKS[kind]
    mask = None if shape is None else _mask(shape, 2)
    if kind == "legacy":
        mask = mask.astype(np.int32)      # 0/1 ints are masks too
    (jy, jdx), (ty, tdx) = _run_both(x, mask, dtype, scale=0.7)
    _close(ty, jy, dtype)
    _close(tdx, jdx, dtype)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("with_mask", [False, True])
def test_causal_softmax_matches_jax(dtype, with_mask):
    """Causal alone (the upper-triangular variant) and causal composed
    with a padding mask in the kernel; entries past the diagonal are
    exactly zero."""
    s = 16
    x = (np.random.default_rng(3).standard_normal((B, 2, s, s)) * 2
         ).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((B, 1, 1, s), bool)
        mask[..., -3:] = True
    (jy, jdx), (ty, tdx) = _run_both(x, mask, dtype, scale=1.3,
                                     causal=True, dy_seed=4)
    _close(ty, jy, dtype)
    _close(tdx, jdx, dtype)
    upper = np.triu(np.ones((s, s), bool), 1)
    assert (_np(ty)[..., upper] == 0).all()
    if not with_mask:
        jx, tx = _both(x, dtype)
        _close(tk.scaled_upper_triang_masked_softmax(tx, scale=1.3),
               jsm.scaled_upper_triang_masked_softmax(jx, scale=1.3), dtype)


@pytest.mark.parametrize("shape,mask_shape", [
    ((1, 2, 4, 1000), (1, 1, 1, 1000)),    # sk not a multiple of 128
    ((2, 2, 5, 7), (2, 1, 5, 7)),          # 1 < sk < 32
    ((1, 3, 3, 24), (1, 3, 24)),           # sq != sk, the legacy mask
    ((2, 1, 1, 130), None),                # one query row
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_odd_shapes_match_jax(shape, mask_shape, dtype):
    x = (np.random.default_rng(5).standard_normal(shape) * 3
         ).astype(np.float32)
    mask = None if mask_shape is None else _mask(mask_shape, 6)
    (jy, jdx), (ty, tdx) = _run_both(x, mask, dtype, scale=0.125,
                                     dy_seed=7)
    _close(ty, jy, dtype)
    _close(tdx, jdx, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_twins_match_pallas(dtype, causal):
    """The wrappers the CUDA kernels sit behind, on the JAX kernels' own
    3-D operands: a ratio-tiled mask (one mask batch for 3 score
    batches), and the backward on the forward's output."""
    nb, s = 6, 40
    x = (np.random.default_rng(8).standard_normal((nb, s, s)) * 2
         ).astype(np.float32)
    m = _mask((2, s, s), 9).astype(np.int32)
    jx, tx = _both(x, dtype)
    jy = jsm._run_fwd(jx, jnp.asarray(m), 0.5, causal)
    ty = tk.softmax_fwd(tx, torch.from_numpy(m), scale=0.5, causal=causal)
    _close(ty, jy, dtype)
    dy = np.random.default_rng(10).standard_normal((nb, s, s)).astype(
        np.float32)
    jdy, tdy = _both(dy, dtype)
    _close(tk.softmax_bwd(ty, tdy, scale=0.5),
           jsm._run_bwd(jnp.asarray(_np(ty)).astype(DT[dtype][0]), jdy, 0.5),
           dtype)
    assert tk.softmax_fwd.launches == 0 and tk.softmax_bwd.launches == 0


def test_fully_masked_row_yields_zeros():
    """A row with every key masked: zeros (and a zero gradient), not NaN,
    in both packages; the other rows are untouched."""
    x = np.random.default_rng(11).standard_normal((1, 2, 4, 8)).astype(
        np.float32)
    mask = np.zeros((1, 1, 4, 8), bool)
    mask[0, 0, 2] = True
    (jy, jdx), (ty, tdx) = _run_both(x, mask, "f32", scale=1.0)
    _close(ty, jy, "f32")
    _close(tdx, jdx, "f32")
    assert np.isfinite(_np(ty)).all()
    assert (_np(ty)[:, :, 2] == 0).all() and (_np(tdx)[:, :, 2] == 0).all()
    np.testing.assert_allclose(_np(ty)[:, :, [0, 1, 3]].sum(-1), 1.0,
                               rtol=1e-6)


def test_errors_match_jax():
    """Causal with sq != sk, a mask of higher rank than the scores, and a
    mask that does not broadcast: ValueError in both packages."""
    cases = [
        (dict(causal=True), (1, 1, 4, 8), None),
        ({}, (1, 1, 4, 8), (1, 1, 1, 4, 8)),
        ({}, (2, 2, 4, 8), (3, 1, 1, 8)),
    ]
    for kw, xs, ms in cases:
        jm = None if ms is None else jnp.zeros(ms, bool)
        tm = None if ms is None else torch.zeros(ms, dtype=torch.bool)
        with pytest.raises(ValueError):
            jsm.scaled_masked_softmax(jnp.ones(xs), jm, **kw)
        with pytest.raises(ValueError):
            tk.scaled_masked_softmax(torch.ones(xs), tm, **kw)
    for f in (jsm.scaled_upper_triang_masked_softmax,
              tk.scaled_upper_triang_masked_softmax):
        with pytest.raises(ValueError, match="square"):
            f(jnp.ones((1, 1, 4, 8)) if f is jsm.
              scaled_upper_triang_masked_softmax else torch.ones(1, 1, 4, 8))
    with pytest.raises(ValueError, match="tile"):
        tk.softmax_fwd(torch.ones(4, 2, 3), torch.zeros(3, 2, 3))
    assert tk.generic_scaled_masked_softmax is tk.scaled_masked_softmax


# ---------------------------------------------------------------------------
# FusedScaleMaskSoftmax
# ---------------------------------------------------------------------------

def _fsms(kind, fusion, **kw):
    j = JFSMS(attn_mask_type=getattr(JMask, kind),
              scaled_masked_softmax_fusion=fusion, **kw)
    t = tfunc.FusedScaleMaskSoftmax(attn_mask_type=getattr(TMask, kind),
                                    scaled_masked_softmax_fusion=fusion, **kw)
    return j, t


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("kind,mask", [("padding", "random"),
                                       ("padding", None),
                                       ("causal", None),
                                       ("causal", "pad")])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_scale_mask_softmax_matches_jax(fusion, kind, mask, dtype):
    """The dispatcher, fused (the kernels) and unfused (plain PyTorch at
    fp32 with the -10000 fill), against the JAX dataclass; each path is
    also held to the other, as the reference's test does."""
    x = np.random.default_rng(12).standard_normal((2, 2, 8, 8)).astype(
        np.float32)
    m = None
    if mask == "random":
        m = np.random.default_rng(13).random((2, 1, 8, 8)) < 0.2
        m[..., 0] = False
    elif mask == "pad":
        m = np.zeros((2, 1, 1, 8), bool)
        m[..., -2:] = True
    jx, tx = _both(x, dtype)
    j, t = _fsms(kind, fusion, scale=0.5)
    assert isinstance(t, torch.nn.Module)
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    got = t(tx, tm)
    _close(got, j(jx, jm), dtype)
    other = _fsms(kind, not fusion, scale=0.5)[1](tx, tm)
    np.testing.assert_allclose(_np(got), _np(other), rtol=1e-2 if
                               dtype == "bf16" else 1e-4, atol=1e-5)
    if kind == "causal":
        assert np.allclose(_np(got)[..., 0, 1:], 0.0, atol=1e-6)


def test_fused_scale_mask_softmax_options_match_jax():
    """A row with every key masked (zeros fused, uniform 1/sk unfused, in
    both packages), ``softmax_in_fp32=False`` in bf16, a custom
    ``mask_func``, gradients through the fused module, and the
    non-square causal refusal."""
    x = np.random.default_rng(14).standard_normal((1, 2, 4, 8)).astype(
        np.float32)
    m = np.zeros((1, 1, 4, 8), bool)
    m[0, 0, 1] = True
    for fusion, want_row in ((True, 0.0), (False, 1 / 8)):
        j, t = _fsms("padding", fusion)
        got = t(torch.from_numpy(x), torch.from_numpy(m))
        _close(got, j(jnp.asarray(x), jnp.asarray(m)), "f32")
        np.testing.assert_allclose(_np(got)[:, :, 1], want_row, atol=1e-7)
    jx, tx = _both(x, "bf16")
    j, t = _fsms("padding", False, softmax_in_fp32=False)
    _close(t(tx, torch.from_numpy(m)), j(jx, jnp.asarray(m)), "bf16")
    mf_j = lambda s, mk: jnp.where(mk, -50.0, s)
    mf_t = lambda s, mk: torch.where(mk, -50.0, s)
    j = JFSMS(scaled_masked_softmax_fusion=False, mask_func=mf_j)
    t = tfunc.FusedScaleMaskSoftmax(scaled_masked_softmax_fusion=False,
                                    mask_func=mf_t)
    _close(t(torch.from_numpy(x), torch.from_numpy(m)),
           j(jnp.asarray(x), jnp.asarray(m)), "f32")
    j, t = _fsms("causal", True, scale=2.0)
    xt = torch.from_numpy(np.ascontiguousarray(x[..., :4])).requires_grad_()
    (gt,) = torch.autograd.grad(t(xt).square().sum(), xt)
    gj = jax.grad(lambda v: jnp.sum(jnp.square(j(v))))(
        jnp.asarray(x[..., :4]))
    _close(gt, gj, "f32")
    with pytest.raises(ValueError, match="square"):
        t(torch.ones(1, 1, 2, 8), torch.zeros(1, 1, 1, 8, dtype=torch.bool))
