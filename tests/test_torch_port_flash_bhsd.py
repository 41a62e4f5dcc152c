"""The port's head-major flash attention vs the JAX package's.

``apex_tpu_torch.kernels.flash_attention``'s ``flash_attention``,
``flash_attention_with_lse`` and ``mha`` over ``[b, heads, s, d]`` run,
on CPU tensors, the plain PyTorch twins of the four head-major kernels
(the forward, the fused backward and the split dQ and dK/dV sweeps);
``chip_smoke.py`` phase 25 holds the CUDA kernels against the same twins
on the card. Here the twins are held against ``apex_tpu/kernels/
flash_attention.py``'s ``flash_attention`` (Pallas in interpret mode, as
the JAX package's own tests run it) on the same numpy-seeded inputs:
fp32, bf16 and fp16; causal and not; head widths 64, 80 and 128; sq !=
sk; ``kv_lengths`` with a 0 (every column of those rows masked: out 0,
lse ``-1e30 + log(1e-30)``); segment ids with and without
``kv_segment_ids``; the lse cotangent; ``mha``; the
``APEX_TPU_FLASH_BWD`` rule and ``flash_bsh_eligible`` against JAX's
choices.

Tolerances (``tests/test_torch_port_kernels.py``'s bands):

- fp32: ``rtol=atol=1e-5`` (the same fp32 arithmetic, summed in another
  order);
- bf16: ``2e-2`` for out, ``1e-3`` for lse (fp32 statistics of bf16
  inputs); gradients ``3e-2`` of the largest entry: both sides round P
  and dS to bf16 before their products, from fp32 scores summed in
  another order (a P or dS near a rounding boundary may land on the
  other side), and each gradient is rounded to bf16;
- fp16: JAX widens to fp32 and rounds the results to fp16; the port runs
  fp16 at d 64, 80 and 128 as the tensor-core kernels do (P and dS
  rounded to fp16, 11 significant bits; a head width off a multiple of 8
  widened as JAX does), so they differ by about one fp16 ulp (2^-10
  relative): ``rtol=atol=2e-3`` (gradients: ``atol`` of ``2e-3`` of the
  largest entry).
"""

import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import flash_attention as tfa

# the module (apex_tpu.kernels re-exports a function of the same name)
jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
OUT_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
           "bf16": dict(rtol=2e-2, atol=2e-2),
           "f16": dict(rtol=2e-3, atol=2e-3)}
LSE_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
           "bf16": dict(rtol=1e-3, atol=1e-3),
           "f16": dict(rtol=1e-5, atol=1e-5)}
GRAD_REL = {"f32": None, "bf16": 3e-2, "f16": 2e-3}


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float16)
            else t).numpy()


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


#: (id, dtype, causal, d, b, h, sq, sk, kv_lengths, segments) — segments
#: "q" passes segment_ids only, "qk" both segment_ids and kv_segment_ids
CASES = [
    ("f32-causal-64", "f32", True, 64, 2, 2, 48, 48, None, None),
    ("f32-causal-80-lens", "f32", True, 80, 2, 3, 40, 40, [40, 0], None),
    ("f32-cross-128-lens", "f32", False, 128, 2, 2, 24, 56, [0, 31], None),
    ("f32-cross-80-segqk", "f32", False, 80, 2, 2, 40, 56, None, "qk"),
    ("f32-causal-80-segq", "f32", True, 80, 2, 2, 40, 40, None, "q"),
    ("bf16-causal-80", "bf16", True, 80, 2, 2, 48, 48, None, None),
    ("bf16-cross-64-lens", "bf16", False, 64, 2, 2, 24, 40, [0, 20], None),
    ("bf16-cross-128-segq", "bf16", False, 128, 2, 2, 40, 40, None, "q"),
    ("f16-causal-80", "f16", True, 80, 2, 2, 40, 40, None, None),
    ("f16-cross-128-lens", "f16", False, 128, 2, 2, 24, 48, [13, 0], None),
]


def _inputs(case):
    _, dtype, causal, d, b, h, sq, sk, lens, segs = case
    rng = np.random.default_rng(d * 100 + sq + sk)
    arrs = [rng.standard_normal(shape) for shape in
            ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d), (b, h, sq, d))]
    pairs = [_pair(a, dtype) for a in arrs]
    dlse = rng.standard_normal((b, h, sq)).astype(np.float32)
    kw = dict(causal=causal)
    if lens is not None:
        kw["kv_lengths"] = np.asarray(lens, np.int32)
    if segs is not None:
        kw["segment_ids"] = rng.integers(0, 3, (b, sq)).astype(np.int32)
        if segs == "qk":
            kw["kv_segment_ids"] = rng.integers(0, 3, (b, sk)).astype(
                np.int32)
    return pairs, dlse, kw


@functools.lru_cache(maxsize=None)
def _jax_ref(case_id):
    """JAX's (out, lse, dq, dk, dv) of one case: ``flash_attention_with_
    lse`` under ``jax.vjp`` with the output cotangent ``do`` and the lse
    cotangent ``dlse`` (0 when ``with_dlse`` is off)."""
    case = next(c for c in CASES if c[0] == case_id)
    pairs, dlse, kw = _inputs(case)
    (qj, _), (kj, _), (vj, _), (doj, _) = pairs
    jkw = {k: jnp.asarray(v) for k, v in kw.items() if k != "causal"}
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, causal=kw["causal"], **jkw), qj, kj, vj)
    res = {}
    for tag, dl in (("plain", np.zeros_like(dlse)), ("dlse", dlse)):
        res[tag] = tuple(np.asarray(x, np.float32)
                         for x in vjp((doj, jnp.asarray(dl))))
    return tuple(np.asarray(x, np.float32) for x in out), res


def _torch_run(case, with_dlse):
    pairs, dlse, kw = _inputs(case)
    q, k, v, do = (t.clone().requires_grad_(i < 3)
                   for i, (_, t) in enumerate(pairs))
    out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
    cots = (do, torch.from_numpy(dlse if with_dlse else 0 * dlse))
    torch.autograd.backward((out, lse), cots)
    return out, lse, (q.grad, k.grad, v.grad), kw


def _assert_grads(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[dtype][1]
        if dtype == "f32":
            np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(
                _np(g), w, rtol=OUT_TOL[dtype]["rtol"],
                atol=GRAD_REL[dtype] * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_attention_matches_jax(case):
    """out, lse and the gradients of ``flash_attention`` (the lse
    cotangent 0) against JAX's; the public out-only call equals the out
    of ``flash_attention_with_lse``."""
    dtype = case[1]
    (out_j, lse_j), grads_j = _jax_ref(case[0])
    out, lse, grads, kw = _torch_run(case, with_dlse=False)
    assert out.dtype == DTYPES[dtype][1] and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), out_j, **OUT_TOL[dtype])
    np.testing.assert_allclose(_np(lse), lse_j, **LSE_TOL[dtype])
    _assert_grads(grads, grads_j["plain"], dtype)
    pairs, _, _ = _inputs(case)
    pub = tfa.flash_attention(*(t for _, t in pairs[:3]), **kw)
    assert torch.equal(pub, out.detach())


@pytest.mark.parametrize("case_id", ["f32-causal-80-lens",
                                     "bf16-cross-128-segq",
                                     "f16-cross-128-lens"])
def test_flash_attention_with_lse_cotangent_matches_jax(case_id):
    """A nonzero lse cotangent folds into the backward as ``delta -
    dlse`` (JAX's ``_flash_with_lse_bwd``)."""
    case = next(c for c in CASES if c[0] == case_id)
    _, grads_j = _jax_ref(case_id)
    _, _, grads, _ = _torch_run(case, with_dlse=True)
    _assert_grads(grads, grads_j["dlse"], case[1])
    assert not np.allclose(grads_j["dlse"][0], grads_j["plain"][0])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_all_masked_rows_give_zero_out_and_the_finite_lse(dtype):
    """kv_lengths 0: every column masked, out exactly 0 and lse
    ``-1e30 + log(1e-30)`` (``_fwd_kernel``'s ``_finish``), in both
    packages; the row's gradients are 0."""
    case = next(c for c in CASES if c[1] == dtype and c[8] is not None)
    (out_j, lse_j), _ = _jax_ref(case[0])
    out, lse, grads, kw = _torch_run(case, with_dlse=False)
    rows = np.asarray(kw["kv_lengths"]) == 0
    assert rows.any()
    assert (out_j[rows] == 0).all() and (_np(out)[rows] == 0).all()
    want = np.float32(-1e30) + np.log(np.float32(1e-30))
    assert (lse_j[rows] == want).all() and (_np(lse)[rows] == want).all()
    assert (_np(grads[0])[rows] == 0).all()


def test_mha_matches_jax():
    """``mha`` over ``[b, s, h, d]`` with kv lengths and segment ids."""
    rng = np.random.default_rng(7)
    b, s, h, d = 2, 40, 2, 80
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal((b, s, h, d)), "f32") for _ in range(3))
    lens = np.asarray([33, 40], np.int32)
    seg = rng.integers(0, 2, (b, s)).astype(np.int32)
    want = jfa.mha(qj, kj, vj, causal=True, kv_lengths=jnp.asarray(lens),
                   segment_ids=jnp.asarray(seg))
    got = tfa.mha(qt, kt, vt, causal=True, kv_lengths=lens, segment_ids=seg)
    assert got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


_OPS = torch.ops.apex_tpu_torch
_BWD_OPS = {"fused": (_OPS.flash_attention_bwd.default,),
            "split": (_OPS.flash_attention_bwd_dq.default,
                      _OPS.flash_attention_bwd_dkdv.default)}


@pytest.mark.parametrize("mode", ["fused", "split"])
def test_fused_and_split_backwards_agree(monkeypatch, mode):
    """The fused plain backward and the split dQ + dK/dV pair give the
    same gradients, bit for bit (the same fp32 arithmetic), directly and
    through autograd under ``APEX_TPU_FLASH_BWD``, which picks the ops
    that run."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, 72, 80))).float()
                   for _ in range(4))
    lens = torch.tensor([72, 5, 0, 40], dtype=torch.int32)
    segs = (torch.from_numpy(rng.integers(0, 2, (2, 72))).int(),) * 2
    kw = dict(causal=True, lens=lens, segs=segs, n_rep=2)
    out, lse = tk.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (out * do).sum(-1)
    fused = tk.flash_attention_bwd(q, k, v, do, lse, delta, **kw)
    dq = tk.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tk.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    for a, b in zip(fused, (dq, dk, dv)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    log = _OpLog()
    with log:
        o, _ = tk.flash_attention_fwd(qa, ka, va, **kw)
        got = torch.autograd.grad(o, (qa, ka, va), do)
    for op in _BWD_OPS[mode]:
        assert log.ops.count(op) == 1
    other = "split" if mode == "fused" else "fused"
    assert not any(op in log.ops for op in _BWD_OPS[other])
    for a, b in zip(got, fused):
        assert torch.equal(a, b)


def _kernel_name(kernel):
    """The Pallas kernel body a ``pallas_call`` was given (through the
    ``functools.partial`` of its parameters and ``_bind_aux``'s
    adapter)."""
    f = kernel.func if isinstance(kernel, functools.partial) else kernel
    if f.__name__ == "<lambda>":
        f = inspect.getclosurevars(f).nonlocals["kernel"]
    return f.__name__


@pytest.fixture
def pallas_spy(monkeypatch):
    """Records the kernel body of every ``pallas_call`` JAX traces."""
    seen = []
    orig = jfa.pl.pallas_call

    def spy(kernel, *a, **kw):
        seen.append(_kernel_name(kernel))
        return orig(kernel, *a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    return seen


#: (sq, d, block_q): around the 4 MiB dQ budget at each padded width
BWD_SHAPES = [(1024, 80, None), (8192, 64, None), (8193, 64, None),
              (8200, 128, None), (16384, 32, None), (4096, 256, None),
              (10000, 64, 256), (12288, 80, 4096), (300, 96, None)]


@pytest.mark.parametrize("mode", ["auto", "fused", "split"])
def test_backward_choice_matches_jax(monkeypatch, pallas_spy, mode):
    """``fused_backward`` against the backward JAX's ``_run_bwd`` traces
    (abstractly, by ``jax.eval_shape``) on a table of shapes."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    for sq, d, block_q in BWD_SHAPES:
        pallas_spy.clear()
        x = jax.ShapeDtypeStruct((1, sq, d), jnp.float32)
        st = jax.ShapeDtypeStruct((1, sq, 1), jnp.float32)
        lens = jax.ShapeDtypeStruct((1,), jnp.int32)
        seg = jax.ShapeDtypeStruct((1, sq), jnp.int32)
        jax.eval_shape(
            lambda q, lse, ln, sg: jfa._run_bwd(
                q, q, q, q, lse, lse, ln, (sg, sg), 0.1, True,
                block_q=block_q), x, st, lens, seg)
        jax_fused = pallas_spy == ["_dqkv_kernel"]
        assert jax_fused or pallas_spy == ["_dq_kernel", "_dkv_kernel"]
        assert tfa.fused_backward(sq, d, block_q) == jax_fused, (sq, d,
                                                                 block_q)


def test_bad_backward_mode_raises_in_both(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", "sometimes")
    with pytest.raises(ValueError, match="APEX_TPU_FLASH_BWD"):
        tfa.fused_backward(1024, 80)
    with pytest.raises(ValueError, match="APEX_TPU_FLASH_BWD"):
        tfa.flash_bsh_eligible(1024, 16, 1024)
    with pytest.raises(ValueError, match="APEX_TPU_FLASH_BWD"):
        jfa.flash_bsh_eligible(1024, 16, 1024)
    q = torch.zeros(1, 1, 8, 64, requires_grad=True)
    out = tfa.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="APEX_TPU_FLASH_BWD"):
        out.sum().backward()


#: (hidden, heads, seq): head widths 16-256, hidden multiples of 128 and
#: not, sequences around the 4 MiB budget of the fused dQ accumulator
ELIGIBLE_SHAPES = [(1024, 16, 1024), (2560, 32, 1024), (1024, 8, 1024),
                   (1024, 32, 512), (128, 2, 64), (160, 2, 64),
                   (192, 3, 64), (1024, 16, 8192), (1024, 16, 8193),
                   (1024, 16, 16384), (768, 12, 2048), (512, 2, 1024),
                   (2048, 16, 1024), (96, 6, 128)]


@pytest.mark.parametrize("mode", ["auto", "split"])
def test_flash_bsh_eligible_matches_jax(monkeypatch, mode):
    """The port's copy of ``flash_bsh_eligible`` says yes exactly where
    JAX's does and the head width is 64, the width the port's lane-packed
    kernels are built for (at other widths JAX packs, the port runs the
    head-major kernels)."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    differ = 0
    for hidden, heads, seq in ELIGIBLE_SHAPES:
        want = jfa.flash_bsh_eligible(hidden, heads, seq)
        got = tfa.flash_bsh_eligible(hidden, heads, seq)
        assert got == (want and hidden // heads == 64), (hidden, heads, seq)
        differ += got != want
    # the table holds packed widths other than 64 (JAX yes, port no)
    assert differ == (3 if mode == "auto" else 0)


def test_head_width_above_128_runs_plain_on_the_cpu():
    """On CPU tensors any width runs the plain version, as JAX takes any
    width; the CUDA kernels stop at 128 (their wrappers raise there)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16, 160))).float()
    want = jfa.flash_attention(*(jnp.asarray(q.numpy()),) * 3, causal=True)
    np.testing.assert_allclose(
        _np(tfa.flash_attention(q, q, q, causal=True)), np.asarray(want),
        rtol=1e-5, atol=1e-5)


def test_geometry_errors_match_jax():
    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 2, 9, 64)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="segment_ids"):
        tfa.flash_attention(q, q, q, segment_ids=np.zeros((1, 7), np.int32))
    with pytest.raises(ValueError, match=r"\[b, h, s, d\]"):
        tfa.flash_attention(q[0], q[0], q[0])
    assert tfa._fit_block(512, 1000) == jfa._fit_block(512, 1000)
    for seq in (8, 100, 129, 640, 1000, 1024, 5000):
        for want in (128, 256, 512):
            assert tfa._fit_block(want, seq) == jfa._fit_block(want, seq)


@pytest.mark.parametrize("hidden,heads,mode", [(160, 2, "auto"),
                                               (128, 4, "auto"),
                                               (128, 2, "split")])
def test_flash_attention_bsh_falls_back_to_head_major(monkeypatch, hidden,
                                                      heads, mode):
    """``flash_attention_bsh`` on a shape the lane-packed kernels do not
    take (heads of 80; heads of 32, which JAX packs and the port's kernels
    are not built for; ``APEX_TPU_FLASH_BWD=split``) runs the head-major
    op, and its output and gradients equal JAX's function's."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    rng = np.random.default_rng(hidden + heads)
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = (
        _pair(rng.standard_normal((2, 24, hidden)), "f32") for _ in range(4))
    out_j, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bsh(
        q, k, v, num_heads=heads, causal=True), qj, kj, vj)
    q, k, v = (t.clone().requires_grad_(True) for t in (qt, kt, vt))
    log = _OpLog()
    with log:
        out = tk.flash_attention_bsh(q, k, v, num_heads=heads, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), dot)
    assert log.ops.count(tfa.FLASH_HM_FWD_OP) == 1
    assert tfa.FLASH_FWD_OP not in log.ops
    np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(grads, vjp(doj)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
