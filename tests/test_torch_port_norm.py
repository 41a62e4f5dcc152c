"""The port's LayerNorm kernels, its multi-tensor L2 norm and the delta
mode of its Adam sweep, against the JAX package.

The same numpy-seeded inputs go through the JAX Pallas kernels (in
interpret mode on the CPU, as the JAX package's own tests run them) and
through the port's wrappers, which take their plain PyTorch versions for
CPU tensors; the CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py``.

Tolerances, each with its reason:

- LayerNorm in fp32: ``rtol=atol=1e-5`` forward (the same fp32
  expression; ``rsqrt`` and the order of the row sums differ in the last
  ulps), ``rtol=atol=1e-4`` for the three gradients (sums over rows);
- LayerNorm in bf16: the output is rounded to bf16 (one ulp is 2^-7
  relative) on both sides from fp32 values that differ in the last fp32
  ulps, so ``rtol=atol=2e-2`` (``tests/test_layer_norm.py``'s own band);
  dx likewise; dw and db are fp32 sums of bf16 products: ``2e-2`` of the
  largest entry;
- the L2 norm: fp32 sums of squares in another order, ``rtol=1e-5``;
- Adam's delta mode: ``rtol=1e-5, atol=1e-6`` (the port's Adam oracle).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import multi_tensor as jmt
from apex_tpu import normalization as jnorm
from apex_tpu.kernels import flat_ops as jflat
from apex_tpu.kernels import layer_norm as jlayer_norm
from apex_tpu.kernels import rms_norm as jrms_norm
from apex_tpu_torch import multi_tensor as tmt
from apex_tpu_torch import normalization as tnorm
from apex_tpu_torch.kernels import (
    adam_flat,
    l2norm_flat,
    layer_norm,
    layer_norm_bwd,
    layer_norm_fwd,
    rms_norm,
)
from apex_tpu_torch.models import gpt as tgpt

# the module (apex_tpu_torch.kernels re-exports a function of its name)
tln = importlib.import_module("apex_tpu_torch.kernels.layer_norm")

#: tests/test_layer_norm.py's shape grid: 96 and 513 are not multiples of
#: the kernels' vector widths, 1024 is BERT-large's hidden
SHAPES = [(4, 96), (3, 7, 128), (16, 1024), (2, 513)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
           "bf16": dict(rtol=2e-2, atol=2e-2)}


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _inputs(shape, dtype, seed):
    """x in ``dtype`` (rounded once, handed to both sides), fp32 w, b and
    dy, as numpy."""
    rng = np.random.default_rng(seed)
    h = shape[-1]
    jd, _ = DTYPES[dtype]
    x = np.array(jnp.asarray(rng.standard_normal(shape) * 2 + 0.5, jd
                             ).astype(jnp.float32))
    dy = np.array(jnp.asarray(rng.standard_normal(shape), jd
                              ).astype(jnp.float32))
    w = rng.standard_normal(h).astype(np.float32)
    b = rng.standard_normal(h).astype(np.float32)
    return x, w, b, dy


def _jax_norm(fn, x, w, b, dy, dtype, rms):
    jd, _ = DTYPES[dtype]
    args = [jnp.asarray(x, jd), jnp.asarray(w)] + ([] if rms else
                                                   [jnp.asarray(b)])
    y, vjp = jax.vjp(lambda *a: fn(*a, eps=1e-5), *args)
    return y, vjp(jnp.asarray(dy, jd))


def _port_norm(fn, x, w, b, dy, dtype, rms):
    _, td = DTYPES[dtype]
    args = [torch.from_numpy(x).to(td).requires_grad_(True),
            torch.from_numpy(w.copy()).requires_grad_(True)]
    if not rms:
        args.append(torch.from_numpy(b.copy()).requires_grad_(True))
    y = fn(*args, eps=1e-5)
    grads = torch.autograd.grad(y, args, torch.from_numpy(dy).to(td))
    return y, grads


def _check_grads(got, want, dtype):
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(_np(g), w_, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(_np(g), w_, rtol=2e-2,
                                       atol=2e-2 * np.abs(w_).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_forward_and_grads_match_jax(shape, dtype):
    x, w, b, dy = _inputs(shape, dtype, seed=shape[-1])
    y_j, grads_j = _jax_norm(jlayer_norm, x, w, b, dy, dtype, rms=False)
    y_t, grads_t = _port_norm(layer_norm, x, w, b, dy, dtype, rms=False)
    assert y_t.dtype == DTYPES[dtype][1] and tuple(y_t.shape) == shape
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32),
                               **FWD_TOL[dtype])
    assert grads_t[1].dtype == grads_t[2].dtype == torch.float32
    _check_grads(grads_t, grads_j, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rms_norm_forward_and_grads_match_jax(shape, dtype):
    x, w, b, dy = _inputs(shape, dtype, seed=shape[-1] + 1)
    y_j, grads_j = _jax_norm(jrms_norm, x, w, b, dy, dtype, rms=True)
    y_t, grads_t = _port_norm(rms_norm, x, w, b, dy, dtype, rms=True)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32),
                               **FWD_TOL[dtype])
    _check_grads(grads_t, grads_j, dtype)


def test_layer_norm_float16_widens_and_defaults_to_identity_affine():
    """float16 input is widened to fp32 and the result cast back, as the
    JAX ``widen_f16``; no weight/bias is the identity affine."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 64)).astype(np.float16)
    want = jlayer_norm(jnp.asarray(x))
    got = layer_norm(torch.from_numpy(x))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-3,
                               atol=2e-3)


def test_layer_norm_ops_are_the_plain_functions_with_saved_stats():
    """The forward op returns fp32 mean and rstd per row; the backward op
    on them equals autograd through the plain forward (fp32)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    for sub in (True, False):
        y, mean, rstd = layer_norm_fwd(x, w, b, eps=1e-5, subtract_mean=sub)
        assert mean.shape == rstd.shape == (6,)
        assert mean.dtype == rstd.dtype == torch.float32
        xa, wa, ba = (t.clone().requires_grad_(True) for t in (x, w, b))
        ya, _, _ = tln.layer_norm_fwd_plain(xa, wa, ba, 1e-5, sub)
        want = torch.autograd.grad(ya, (xa, wa, ba), dy)
        got = layer_norm_bwd(x, w, mean, rstd, dy, subtract_mean=sub)
        torch.testing.assert_close(y, ya.detach())
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


def test_normalization_aliases_match_jax():
    """The four apex class names map onto the two functions, as in JAX."""
    for name in ("FusedLayerNorm", "MixedFusedLayerNorm"):
        assert getattr(tnorm, name) is tnorm.fused_layer_norm is layer_norm
        assert hasattr(jnorm, name)
    for name in ("FusedRMSNorm", "MixedFusedRMSNorm"):
        assert getattr(tnorm, name) is tnorm.fused_rms_norm is rms_norm
    assert sorted(tnorm.__all__) == sorted(jnorm.__all__)


def test_gpt_pallas_layer_norm_logits_equal_xla():
    """``GPTConfig(ln_impl="pallas")`` builds and its logits equal the
    "xla" LayerNorm's: the same fp32 statistics, computed as x.sum/h
    against x.mean (fp32, ``rtol=atol=1e-5``)."""
    cfg = tgpt.GPTConfig(vocab_size=96, hidden_size=128, num_layers=2,
                         num_heads=2, seq_len=32, compute_dtype=torch.float32,
                         remat=False, ln_impl="pallas")
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, 96, (2, 32)))
    got = tgpt.logits(cfg, params, tok)
    want = tgpt.logits(dataclasses.replace(cfg, ln_impl="xla"), params, tok)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown ln_impl"):
        tgpt.GPTConfig(ln_impl="nope")


# ---------------------------------------------------------------------------
# l2norm_flat and adam_flat's delta mode
# ---------------------------------------------------------------------------

def _packed_tree(seed):
    """A multi-leaf tree with an fp32 and a bf16 group, packed by both
    packages (the same offsets and padding)."""
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((24, 40)).astype(np.float32),
            "b": rng.standard_normal(77).astype(np.float32),
            "c": (rng.standard_normal((3, 50)) * 3).astype(np.float32),
            "h": rng.standard_normal((9, 11)).astype(np.float32)}
    jt = {k: jnp.asarray(v, jnp.bfloat16 if k == "h" else jnp.float32)
          for k, v in tree.items()}
    tt = {k: torch.from_numpy(np.array(jt[k], np.float32)).to(
        torch.bfloat16 if k == "h" else torch.float32) for k in tree}
    return jmt.pack(jt)[0], tmt.pack(tt)[0]


def test_l2norm_flat_matches_jax_on_packed_groups():
    jbufs, tbufs = _packed_tree(3)
    want = jflat.l2norm_flat(jbufs)
    got = l2norm_flat(tbufs)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # a float16 buffer is widened, as the JAX function does
    half = np.random.default_rng(4).standard_normal(256).astype(np.float16)
    np.testing.assert_allclose(
        float(l2norm_flat([torch.from_numpy(half)])),
        float(jflat.l2norm_flat([jnp.asarray(half)])), rtol=1e-5)


@pytest.mark.parametrize("grad_averaging", [True, False])
def test_adam_flat_delta_mode_matches_jax_and_leaves_params(grad_averaging):
    """LAMB's stage 1: ``out_is_delta=True`` returns new fp32 buffers equal
    to JAX's ``adam_flat(..., out_is_delta=True, out_dtype=float32)``;
    the params stay bit for bit as they were, m and v are updated in
    place. With ``skip`` the deltas are zero and nothing moves."""
    rng = np.random.default_rng(11)
    n = 2 * 128 * 8
    arrs = [rng.standard_normal(n).astype(np.float32) for _ in range(8)]
    arrs[3], arrs[7] = np.abs(arrs[3]), np.abs(arrs[7])
    hp = dict(lr=1.0, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 2, bias_correction2=1 - 0.999 ** 2,
              grad_scale=0.5, out_is_delta=True,
              grad_averaging=grad_averaging)
    pj = [jnp.asarray(arrs[0]), jnp.asarray(arrs[4], jnp.bfloat16)]
    gj, mj, vj = ([jnp.asarray(arrs[i]), jnp.asarray(arrs[i + 4])]
                  for i in (1, 2, 3))
    want = jflat.adam_flat(pj, gj, mj, vj, out_dtype=jnp.float32, **hp)
    pt = [torch.from_numpy(arrs[0].copy()),
          torch.from_numpy(np.asarray(pj[1], np.float32)).bfloat16()]
    p_before = [p.clone() for p in pt]
    gt, mt_, vt = ([torch.from_numpy(arrs[i].copy()),
                    torch.from_numpy(arrs[i + 4].copy())] for i in (1, 2, 3))
    got = adam_flat(pt, gt, mt_, vt, **hp)
    for p, b in zip(pt, p_before):
        assert torch.equal(p, b)
    for d in got[0]:
        assert d.dtype == torch.float32
    for wl, gl in zip(want, got):
        for w_, g in zip(wl, gl):
            np.testing.assert_allclose(_np(g), np.asarray(w_, np.float32),
                                       rtol=1e-5, atol=1e-6)
    assert got[1][0] is mt_[0] and got[2][1] is vt[1]
    m_before = [m.clone() for m in mt_]
    skipped = adam_flat(pt, gt, mt_, vt, skip=torch.tensor(True), **hp)
    assert all(not d.any() for d in skipped[0])
    assert all(torch.equal(a, b) for a, b in zip(mt_, m_before))
