"""The port's multi-tensor surface vs the JAX package: ``scale_flat`` and
``axpby_flat`` (the kernels' plain twins against the interpret-mode
Pallas kernels), ``MultiTensorApply``'s branches, ``flatten`` /
``unflatten_dense_tensors`` and ``contrib.clip_grad_norm_``.

Inputs are made with numpy from fixed seeds and cross as numpy arrays;
JAX runs on the CPU with Pallas in interpret mode, the port with CPU
tensors (its wrappers take the plain versions there; ``chip_smoke.py``
holds the CUDA kernels against the same plain versions on the card).

Tolerances, each with its reason:

- scale and axpby: bit-equal in every dtype, and the same ``found_inf``.
  Both sides round ``x * s`` (and ``a * x``, ``b * y`` and their sum) in
  fp32 one operation at a time, then once to the output dtype. The one
  exception is axpby with scalars that are not powers of two: one fp32
  rounding of a product plus one ulp of the output dtype, because XLA's
  CPU backend fuses one product into a multiply-add for some dtype
  pairings (see the test);
- ``clip_grad_norm_`` below ``max_norm``: bit-equal (the coefficient is
  exactly 1); above it: the norm and the clipped gradients to
  ``rtol=1e-6`` (the sums of squares are added in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import multi_tensor as jmt
from apex_tpu.contrib import clip_grad_norm_ as j_clip
from apex_tpu.kernels import flat_ops as jflat
from apex_tpu_torch import multi_tensor as tmt
from apex_tpu_torch.contrib import clip_grad_norm_ as t_clip
from apex_tpu_torch.kernels import flat_ops as tflat

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16),
          "f16": (np.float16, jnp.float16, torch.float16)}


def _np(t):
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _both(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 is rounded once from fp32 on each side: the same RNE)."""
    _, jd, td = DTYPES[dtype]
    return (jnp.asarray(arr, jnp.float32).astype(jd),
            torch.from_numpy(np.array(arr, np.float32)).to(td))


def _groups(seed, dtypes, n=4096, scale=3.0):
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for i, dt in enumerate(dtypes):
        arr = (rng.standard_normal(n * (i + 1)) * scale).astype(np.float32)
        j, t = _both(arr, dt)
        js.append(j)
        ts.append(t)
    return js, ts


def _same(jouts, touts):
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype,
                                                              j.dtype)
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


# ---------------------------------------------------------------------------
# scale_flat and axpby_flat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", [("f32",), ("bf16",), ("f16",),
                                    ("f32", "bf16", "f16")])
@pytest.mark.parametrize("case", ["finite", "input_inf", "f16_narrowing"])
def test_scale_flat_matches_jax(dtypes, case):
    """``x * s`` bit for bit and the flag of a non-finite INPUT; an fp16
    output that overflows in the narrowing (x * 1e4 past 65504) is inf in
    both and raises no flag, as in JAX."""
    js, ts = _groups(1, dtypes)
    s = 0.125
    if case == "input_inf":
        js[-1] = js[-1].at[7].set(jnp.inf)
        ts[-1][7] = float("inf")
    if case == "f16_narrowing":
        s = 1e4
    jo, jf = jflat.scale_flat(js, s)
    to, tf = tflat.scale_flat(ts, s)
    _same(jo, to)
    assert tf.dtype == torch.bool and tf.shape == ()
    assert bool(tf) == bool(jf) == (case == "input_inf")
    if case == "f16_narrowing" and "f16" in dtypes:
        assert np.isinf(_np(to[dtypes.index("f16")])).any()


def test_scale_flat_takes_a_tensor_scale():
    js, ts = _groups(2, ("f32",))
    jo, _ = jflat.scale_flat(js, jnp.float32(1 / 3))
    to, _ = tflat.scale_flat(ts, torch.tensor(1 / 3))
    _same(jo, to)


#: one ulp of each output dtype, relative (2^-23, 2^-7, 2^-10)
ULP = {"float32": 1.2e-7, "bfloat16": 7.9e-3, "float16": 9.8e-4}


@pytest.mark.parametrize("xy", [("f32", "f32"), ("bf16", "f32"),
                                ("f32", "bf16"), ("bf16", "bf16"),
                                ("f16", "f16"), ("f16", "f32")])
@pytest.mark.parametrize("out", [None, "f32", "bf16", "f16"])
@pytest.mark.parametrize("ab", [(0.25, -0.5), (0.3, -1.7)])
def test_axpby_flat_matches_jax(xy, out, ab):
    """``a * x + b * y`` in fp32, stored in ``out_dtype`` (x's by
    default), for every pairing of input dtypes. With powers of two (the
    accumulation's ``a = 1 / S``, ``b = 1``) every product is exact and
    the results are bit-equal. With other scalars they are within one
    ulp: XLA's CPU backend contracts ``b * y + a * x`` into one fused
    multiply-add when x is bf16 and y fp32 (the port rounds each product,
    as the JAX kernel's source reads)."""
    jx, tx = _groups(3, (xy[0], xy[0]))
    jy, ty = _groups(4, (xy[1], xy[1]))
    od = None if out is None else DTYPES[out]
    a, b = ab
    jo, jf = jflat.axpby_flat(a, jx, b, jy,
                              out_dtype=None if od is None else od[1])
    to, tf = tflat.axpby_flat(a, tx, b, ty,
                              out_dtype=None if od is None else od[2])
    assert not bool(tf) and not bool(jf)
    if ab == (0.25, -0.5):
        _same(jo, to)
        return
    for j, t, x, y in zip(jo, to, tx, ty):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        # one rounding of a product (an fp32 ulp of |a x| + |b y|), then
        # at most one ulp of the output dtype
        size = (np.abs(a * _np(x).astype(np.float64))
                + np.abs(b * _np(y).astype(np.float64)))
        lim = 2.0 ** -23 * size + ULP[str(j.dtype)] * np.abs(_np(t))
        assert (np.abs(_np(t) - np.asarray(j, np.float32)) <= lim).all()


@pytest.mark.parametrize("case", ["output_overflow", "input_nan",
                                  "f16_narrowing"])
def test_axpby_flat_flag_matches_jax(case):
    """The flag is a non-finite fp32 RESULT: a * x past fp32's range
    raises it, so does a NaN input; an fp16 output that overflows only
    in the narrowing does not."""
    jx, tx = _groups(5, ("f32", "f16"))
    jy, ty = _groups(6, ("f32", "f16"))
    a = 1.0
    if case == "output_overflow":
        jx[0] = jx[0].at[3].set(3e38)
        tx[0][3] = 3e38
        a = 4.0
    if case == "input_nan":
        jy[1] = jy[1].at[11].set(jnp.nan)
        ty[1][11] = float("nan")
    if case == "f16_narrowing":
        a = 2.0 ** 15
    jo, jf = jflat.axpby_flat(a, jx, 1.0, jy)
    to, tf = tflat.axpby_flat(a, tx, 1.0, ty)
    _same(jo, to)
    assert bool(tf) == bool(jf) == (case != "f16_narrowing")
    if case == "f16_narrowing":
        assert np.isinf(_np(to[1])).any()


def test_flat_sweeps_refuse_mixed_devices_and_lengths():
    ts = [torch.zeros(8)]
    with pytest.raises(ValueError, match="differ in length"):
        tflat.axpby_flat(1.0, ts, 1.0, ts + ts)
    with pytest.raises(ValueError, match="at least one"):
        tflat.scale_flat([], 1.0)
    with pytest.raises(RuntimeError, match="devices"):
        tflat.scale_flat([torch.zeros(8, device="meta")], 1.0)


# ---------------------------------------------------------------------------
# MultiTensorApply
# ---------------------------------------------------------------------------

def _tensor_lists(seed):
    rng = np.random.default_rng(seed)
    shapes = [(3, 5), (7,), (2, 2, 2)]
    dts = ["f32", "bf16", "f32"]
    j, t = [], []
    for shp, dt in zip(shapes, dts):
        a, b = _both(rng.standard_normal(shp).astype(np.float32), dt)
        j.append(a)
        t.append(b)
    return j, t


def _same_lists(jl, tl):
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


OPS = {
    "flag": (lambda b, s: jflat.scale_flat(b, s),
             lambda b, s: tflat.scale_flat(b, s)),
    "list": (lambda b, s: [x * 2 for x in b],
             lambda b, s: [x * 2 for x in b]),
    "lists": (lambda b, s: ([x * 2 for x in b], [x + 1 for x in b]),
              lambda b, s: ([x * 2 for x in b], [x + 1 for x in b])),
}


@pytest.mark.parametrize("kind", sorted(OPS))
def test_multi_tensor_apply_matches_jax(kind):
    """An op returning ``(buffers, found_inf)`` (the flag passes
    through), one buffer list, or several: the same tensor lists back."""
    jl, tl = _tensor_lists(7)
    jop, top = OPS[kind]
    jout = jmt.MultiTensorApply()(jop, None, [jl], 0.5)
    tout = tmt.MultiTensorApply()(top, None, [tl], 0.5)
    if kind == "flag":
        (jres,), jf = jout
        (tres,), tf = tout
        assert bool(tf) == bool(jf) is False
        _same_lists(jres, tres)
    else:
        assert len(tout) == len(jout)
        for jres, tres in zip(jout, tout):
            _same_lists(jres, tres)


def test_multi_tensor_apply_axpby_two_lists():
    """Two tensor lists: the op gets one buffer list per list."""
    jx, tx = _tensor_lists(8)
    jy, ty = _tensor_lists(9)
    (jres,), jf = jmt.MultiTensorApply()(
        lambda x, y: jflat.axpby_flat(0.5, x, 1.0, y), None, [jx, jy])
    (tres,), tf = tmt.MultiTensorApply()(
        lambda x, y: tflat.axpby_flat(0.5, x, 1.0, y), None, [tx, ty])
    _same_lists(jres, tres)
    assert bool(tf) == bool(jf) is False


def test_multi_tensor_apply_single_buffer_and_empty_results():
    """One dtype group: an op returning one bare buffer is one list; an op
    returning None or an empty list hands it back as it is."""
    rng = np.random.default_rng(10)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((4,), (2, 3))]
    jl = [jnp.asarray(a) for a in arrs]
    tl = [torch.from_numpy(a) for a in arrs]
    jout = jmt.MultiTensorApply()(lambda b: b[0] * 3, None, [jl])
    tout = tmt.MultiTensorApply()(lambda b: b[0] * 3, None, [tl])
    assert len(tout) == len(jout) == 1
    _same_lists(jout[0], tout[0])
    for ret in (None, [], ()):
        assert tmt.MultiTensorApply()(lambda b: ret, None, [tl]) == \
            jmt.MultiTensorApply()(lambda b: ret, None, [jl])


def test_multi_tensor_apply_errors():
    jl, tl = _tensor_lists(11)
    for mta, lst in ((tmt.MultiTensorApply(), tl),
                     (jmt.MultiTensorApply(), jl)):
        with pytest.raises(NotImplementedError, match="noop_flag=None"):
            mta(lambda b: b, object(), [lst])
        # two dtype groups in, one buffer out
        with pytest.raises(ValueError, match="dtype group"):
            mta(lambda b: [b[0]], None, [lst])
    assert tmt.MultiTensorApply(chunk_size=7).chunk_size == 7


# ---------------------------------------------------------------------------
# flatten / unflatten
# ---------------------------------------------------------------------------

def test_flatten_unflatten_dense_tensors_match_jax():
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((3, 4), (5,), (), (2, 1, 3))]
    jflatb = jmt.flatten_dense_tensors([jnp.asarray(a) for a in arrs])
    tflatb = tmt.flatten_dense_tensors([torch.from_numpy(a) for a in arrs])
    np.testing.assert_array_equal(_np(tflatb), np.asarray(jflatb))
    jparts = jmt.unflatten_dense_tensors(jflatb, [jnp.asarray(a)
                                                  for a in arrs])
    tparts = tmt.unflatten_dense_tensors(tflatb, [torch.from_numpy(a)
                                                  for a in arrs])
    _same_lists(jparts, tparts)
    assert tparts[0].data_ptr() == tflatb.data_ptr()   # views, no copy
    with pytest.raises(ValueError, match="single dtype"):
        tmt.flatten_dense_tensors([torch.zeros(2), torch.zeros(2).double()])
    with pytest.raises(ValueError, match="at least one"):
        tmt.flatten_dense_tensors([])


# ---------------------------------------------------------------------------
# clip_grad_norm_
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_grad_norm_matches_jax(max_norm):
    """Below ``max_norm`` (1e3 against a norm of about 9) the gradients
    pass through bit for bit; above it (0.5) they are rescaled."""
    rng = np.random.default_rng(13)
    tree = {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "h": rng.standard_normal((4, 4)).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in tree.items()}
    jg["h"] = jg["h"].astype(jnp.bfloat16)
    tg = {k: torch.from_numpy(v) for k, v in tree.items()}
    tg["h"] = tg["h"].to(torch.bfloat16)
    jout, jtot = j_clip(jg, max_norm)
    tout, ttot = t_clip(tg, max_norm)
    assert ttot.dtype == torch.float32 and ttot.shape == ()
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-6)
    for k in tree:
        assert tout[k].dtype == tg[k].dtype
        if max_norm > float(jtot):
            np.testing.assert_array_equal(_np(tout[k]),
                                          np.asarray(jout[k], np.float32))
            np.testing.assert_array_equal(_np(tout[k]), _np(tg[k]))
        else:
            np.testing.assert_allclose(_np(tout[k]),
                                       np.asarray(jout[k], np.float32),
                                       rtol=1e-6 if k != "h" else 8e-3,
                                       atol=1e-7)
    if max_norm < float(jtot):
        flat = torch.cat([tout[k].float().reshape(-1) for k in tree])
        assert abs(float(flat.norm()) - max_norm) < 5e-3
