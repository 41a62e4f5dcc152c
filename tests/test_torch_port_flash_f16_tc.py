"""The fp16 flash-attention forward and fused backward as the tensor-core
kernels compute them, against the JAX package's.

``csrc/flash_fwd_tc.cu`` and ``csrc/flash_bwd_tc.cu`` take fp16 as they
take bf16: P (and, in the backward, dS) is computed in fp32 and rounded to
fp16 before the ``P V``, dV, dK and dQ products. The plain twins
(``flash_attention_bsh_plain``, ``flash_attention_fwd_plain``,
``flash_attention_bsh_bwd_plain``, ``flash_attention_bwd_plain``) round at
the same places, and ``chip_smoke.py`` holds the kernels against them on
the card. JAX widens fp16 to fp32 at its kernels' boundary
(``widen_f16``, ``apex_tpu/kernels/_utils.py:49``), so there P and dS stay
fp32: a difference by design. Here the rounding twins are held against
the Pallas kernels in interpret mode on the same numpy-seeded fp16 values,
widened as JAX's public functions widen them (``_run_fwd_bsh`` /
``_run_fwd`` and ``_run_bwd_bsh`` / ``_run_bwd`` fused, lse and delta from
JAX's own forward): the lane-packed layout with 2 heads of 64 at s = 24,
64 and 200, causal and not; the head-major layout at head widths 64 and 80
with kv lengths holding a 0, with segment ids, and with ``n_rep = 2``.

Tolerances. fp16 keeps 11 significant bits, so rounding P and dS moves
each by at most 2^-11 relative, and the sums over keys (or queries)
average those moves out; every output is then rounded to fp16 (one ulp:
2^-10 relative) on both sides. On these inputs:

- out within one fp16 ulp of JAX's plus ``OUT_ATOL`` (the rounding twins
  need at most 2.7e-4, the same twins on widened inputs 2.2e-7); lse is
  untouched by the rounding and within ``LSE_TOL`` (7.2e-7 at most);
- each gradient within one fp16 ulp plus ``GRAD_ATOL`` of its largest
  entry (at most 2.3e-4 needed; widened 4.2e-7), and the RMS of the
  difference within ``GRAD_RMS`` of the RMS of JAX's gradient (at most
  3.5e-4; widened 3.4e-5).

Then that the rounding is real (the same twins on the inputs widened to
fp32 give other values on every case), and fp16's range: a dS past 65504
is inf in the rounding twin and in the op that runs it, where the
widened route's gradients are finite.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import kernels as tk

jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

torch.set_num_threads(1)

F16_ULP = 2.0 ** -10
OUT_ATOL = 1e-3
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL = 1e-3
GRAD_RMS = 1e-3


def _pair(x):
    """The same fp16 values as a JAX fp32 array (widened, as JAX's public
    functions widen them) and a torch fp16 CPU tensor."""
    h = np.asarray(x, np.float16)
    return jnp.asarray(h.astype(np.float32)), torch.from_numpy(h.copy())


def _np(t):
    return t.detach().float().cpu().numpy()


def _errs(got, want):
    """(max |got - want| less one fp16 ulp of want, over want's largest
    entry; RMS of the difference over the RMS of want)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    top = max(float(np.abs(want).max()), 1e-30)
    over = float((diff - F16_ULP * np.abs(want)).max()) / top
    rms = float(np.sqrt((diff ** 2).mean() / max((want ** 2).mean(), 1e-30)))
    return over, rms


def _hold_out(out_t, lse_t, out_j, lse_j):
    want = np.asarray(out_j, np.float32).astype(np.float16).astype(
        np.float32)
    got = _np(out_t)
    over = float((np.abs(got - want) - F16_ULP * np.abs(want)).max())
    assert over <= OUT_ATOL, over
    np.testing.assert_allclose(_np(lse_t), lse_j, **LSE_TOL)


def _hold_grads(got, want):
    for g, w in zip(got, want):
        w16 = np.asarray(w, np.float32).astype(np.float16).astype(np.float32)
        over, rms = _errs(_np(g), w16)
        assert over <= GRAD_ATOL and rms <= GRAD_RMS, (over, rms)


# ---------------------------------------------------------------------------
# the lane-packed layout: _run_fwd_bsh, _run_bwd_bsh
# ---------------------------------------------------------------------------

BSH_CASES = [(b, s, causal) for b, s in ((2, 24), (3, 64), (1, 200))
             for causal in (True, False)]


@pytest.fixture(scope="module")
def bsh_cases():
    """{(b, s, causal): (torch fp16 q, k, v, do; lse, delta; JAX's out,
    lse and grads)}, JAX's side run once for the module."""
    hidden, heads = 128, 2
    d, g, n_grp = jfa._group_geometry(hidden, heads)
    out = {}
    for b, s, causal in BSH_CASES:
        rng = np.random.default_rng(3000 + b * s + causal)
        pairs = [_pair(rng.standard_normal((b, s, hidden)))
                 for _ in range(4)]
        qj, kj, vj, doj = (p[0] for p in pairs)
        o_j, lse_j = jfa._run_fwd_bsh(qj, kj, vj, None, None, 1 / d ** 0.5,
                                      causal, d, g, n_grp)
        prod = (o_j * doj).reshape(b, s, heads, d).sum(-1)
        delta_j = jnp.transpose(prod.reshape(b, s, n_grp, g),
                                (0, 2, 3, 1)).reshape(b * n_grp, g, s)
        want = jfa._run_bwd_bsh(qj, kj, vj, doj, lse_j, delta_j, None, None,
                                1 / d ** 0.5, causal, d, g, n_grp)
        lse = torch.from_numpy(np.array(lse_j)).reshape(b, heads, s)
        delta = torch.from_numpy(np.array(delta_j)).reshape(b, heads, s)
        out[(b, s, causal)] = (
            [p[1] for p in pairs], lse, delta, np.asarray(o_j),
            np.asarray(lse_j).reshape(b, heads, s),
            [np.asarray(w, np.float32) for w in want])
    return out


@pytest.mark.parametrize("b,s,causal", BSH_CASES)
def test_bsh_fwd_f16_rounds_p(bsh_cases, b, s, causal):
    """The lane-packed forward twin on fp16 inputs against
    ``_run_fwd_bsh`` on the same values widened; the public op takes the
    twin on CPU tensors, unwidened."""
    (q, k, v, _), _, _, out_j, lse_j, _ = bsh_cases[(b, s, causal)]
    out_t, lse_t = tk.flash_attention_bsh_plain(q, k, v, num_heads=2,
                                                causal=causal)
    assert out_t.dtype == torch.float16
    _hold_out(out_t, lse_t, out_j, lse_j)
    op_out, op_lse = tk.flash_attention_bsh_fwd(q, k, v, num_heads=2,
                                                causal=causal)
    assert torch.equal(op_out, out_t) and torch.equal(op_lse, lse_t)


@pytest.mark.parametrize("b,s,causal", BSH_CASES)
def test_bsh_bwd_f16_rounds_p_and_ds(bsh_cases, b, s, causal):
    """The lane-packed backward twin on fp16 inputs against
    ``_run_bwd_bsh`` (fp32 P and dS) with JAX's lse and delta; gradients
    come back in fp16, and the public op takes the twin."""
    (q, k, v, do), lse, delta, _, _, want = bsh_cases[(b, s, causal)]
    got = tk.flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta,
                                           num_heads=2, causal=causal)
    assert all(t.dtype == torch.float16 for t in got)
    _hold_grads(got, want)
    op = tk.flash_attention_bsh_bwd(q, k, v, do, lse, delta, num_heads=2,
                                    causal=causal)
    assert all(torch.equal(a, w) for a, w in zip(op, got))


# ---------------------------------------------------------------------------
# the head-major layout: _run_fwd, _run_bwd fused
# ---------------------------------------------------------------------------

def _hm_case(case: str, d: int):
    """(bh, sq, sk, causal, n_rep, lens, segs) of one head-major case, the
    aux operands as numpy arrays (or None)."""
    rng = np.random.default_rng(d + 11)
    if case == "lens":
        return 4, 40, 56, False, 1, np.array([56, 0, 17, 40], np.int32), None
    if case == "segs":
        ids = rng.integers(0, 3, (3, 72)).astype(np.int32)
        return 3, 72, 72, True, 1, None, (ids, ids)
    # n_rep = 2: two heads share each batch row's segment ids, and one
    # batch row has no kv at all
    seg_q = rng.integers(0, 2, (2, 100)).astype(np.int32)
    seg_k = rng.integers(0, 2, (2, 130)).astype(np.int32)
    lens = np.array([130, 130, 0, 0], np.int32)
    return 4, 100, 130, False, 2, lens, (seg_q, seg_k)


HM_CASES = [(d, case) for d in (64, 80) for case in ("lens", "segs",
                                                     "nrep2")]


@pytest.fixture(scope="module")
def hm_cases():
    """{(d, case): (torch fp16 q, k, v, do, lse, delta; kwargs; JAX's out,
    lse and grads)}, JAX's side run once for the module."""
    out = {}
    for d, case in HM_CASES:
        bh, sq, sk, causal, n_rep, lens, segs = _hm_case(case, d)
        rng = np.random.default_rng(30 * d + len(case))
        pairs = [_pair(rng.standard_normal((bh, s_, d)))
                 for s_ in (sq, sk, sk, sq)]
        qj, kj, vj, doj = (p[0] for p in pairs)
        scale = 1 / d ** 0.5
        lens_j = None if lens is None else jnp.asarray(lens)
        segs_j = None if segs is None else tuple(jnp.asarray(x)
                                                 for x in segs)
        o_j, lse_j = jfa._run_fwd(qj, kj, vj, lens_j, segs_j, scale, causal,
                                  n_rep=n_rep)
        delta_j = jnp.sum(o_j * doj, axis=-1, keepdims=True)
        want = jfa._run_bwd(qj, kj, vj, doj, lse_j, delta_j, lens_j, segs_j,
                            scale, causal, n_rep=n_rep)
        kw = dict(causal=causal, scale=scale, n_rep=n_rep,
                  lens=None if lens is None else torch.from_numpy(lens),
                  segs=None if segs is None else tuple(
                      torch.from_numpy(x) for x in segs))
        args = [p[1] for p in pairs] + [
            torch.from_numpy(np.asarray(lse_j)[..., 0].copy()),
            torch.from_numpy(np.asarray(delta_j)[..., 0].copy())]
        out[(d, case)] = (args, kw, np.asarray(o_j),
                          np.asarray(lse_j)[..., 0],
                          [np.asarray(w, np.float32) for w in want])
    return out


@pytest.mark.parametrize("d,case", HM_CASES)
def test_hm_fwd_f16_rounds_p(hm_cases, d, case):
    """The head-major forward twin on fp16 inputs against ``_run_fwd``
    (interpret mode, widened): every mask of ``_valid_cols`` and the rows
    a kv length of 0 leaves with no column (out 0); the op takes the twin
    on CPU tensors."""
    args, kw, out_j, lse_j, _ = hm_cases[(d, case)]
    q, k, v = args[:3]
    out_t, lse_t = tk.flash_attention_fwd_plain(q, k, v, **kw)
    assert out_t.dtype == torch.float16
    _hold_out(out_t, lse_t, out_j, lse_j)
    if kw["lens"] is not None:
        assert bool((out_t[kw["lens"] == 0] == 0).all())
    op_out, op_lse = tk.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(op_out, out_t) and torch.equal(op_lse, lse_t)


@pytest.mark.parametrize("d,case", HM_CASES)
def test_hm_bwd_f16_rounds_p_and_ds(hm_cases, d, case):
    """The head-major fused backward twin on fp16 inputs against
    ``_run_bwd`` (fp32 P and dS) with JAX's lse and delta; its fp32
    gradients cast to fp16 as the autograd formula casts them; the fused
    op takes the twin, and so do the split ops, on the same unwidened
    inputs (their tensor-core kernels round P and dS to fp16 as the fused
    one does): their dQ, dK and dV equal the fused twin's."""
    args, kw, _, _, want = hm_cases[(d, case)]
    got = tk.flash_attention_bwd_plain(*args, **kw)
    assert all(t.dtype == torch.float32 for t in got)
    _hold_grads([g.half() for g in got], want)
    op = tk.flash_attention_bwd(*args, **kw)
    assert all(torch.equal(a, w) for a, w in zip(op, got))
    assert torch.equal(tk.flash_attention_bwd_dq(*args, **kw), got[0])
    dk, dv = tk.flash_attention_bwd_dkdv(*args, **kw)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


# ---------------------------------------------------------------------------
# the rounding is real; fp16's range
# ---------------------------------------------------------------------------

def test_f16_twins_differ_from_the_widened_route(bsh_cases, hm_cases):
    """The same twins on the inputs widened to fp32 (P and dS kept in
    fp32, what JAX and the CUDA-core kernels compute) give other fp16
    outputs and gradients on every case: the fp16 rounding is there, not
    a no-op."""
    for (b, s, causal), ((q, k, v, do), lse, delta, *_) in bsh_cases.items():
        wide = [t.float() for t in (q, k, v, do)]
        out16, _ = tk.flash_attention_bsh_plain(q, k, v, num_heads=2,
                                                causal=causal)
        out32, _ = tk.flash_attention_bsh_plain(*wide[:3], num_heads=2,
                                                causal=causal)
        assert not torch.equal(out16, out32.half()), (b, s, causal)
        g16 = tk.flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta,
                                               num_heads=2, causal=causal)
        g32 = tk.flash_attention_bsh_bwd_plain(*wide, lse, delta,
                                               num_heads=2, causal=causal)
        assert not any(torch.equal(a, w.half()) for a, w in zip(g16, g32))
    for key, (args, kw, *_) in hm_cases.items():
        wide = [t.float() for t in args[:4]] + args[4:]
        out16, _ = tk.flash_attention_fwd_plain(*args[:3], **kw)
        out32, _ = tk.flash_attention_fwd_plain(*wide[:3], **kw)
        assert not torch.equal(out16, out32.half()), key
        g16 = tk.flash_attention_bwd_plain(*args, **kw)
        g32 = tk.flash_attention_bwd_plain(*wide, **kw)
        assert not any(torch.equal(a.half(), w.half())
                       for a, w in zip(g16, g32)), key


def test_ds_past_f16_range_is_inf_as_the_twin_says():
    """fp16's range, the hazard of rounding dS: with ``do`` near fp16's
    top (as amp's loss scale makes it) and values ±1 that split the keys,
    ``|dS| = P |dP - delta| scale`` is 120000 at 4 keys, past 65504. The
    rounding twin (and so the kernel) turns it into inf, so dq and dk are
    not finite, where the route widened to fp32 gives finite fp16
    gradients (q and k are 1e-3, so dq and dk are small); dv is finite on
    both. The
    public op on CPU tensors gives the twin's values, inf included."""
    b, s, heads, d = 1, 4, 2, 64
    q = torch.full((b, s, heads * d), 1e-3, dtype=torch.float16)
    k = q.clone()
    sign = torch.tensor([1.0, -1.0, 1.0, -1.0])
    v = (sign[None, :, None] * torch.ones(b, s, heads * d)).half()
    do = torch.full((b, s, heads * d), 6e4, dtype=torch.float16)
    out, lse = tk.flash_attention_bsh_plain(q, k, v, num_heads=heads)
    delta = (out.float() * do.float()).reshape(b, s, heads, d).sum(
        -1).transpose(1, 2).contiguous()
    wide = tk.flash_attention_bsh_bwd_plain(
        *(t.float() for t in (q, k, v, do)), lse, delta, num_heads=heads)
    assert all(bool(torch.isfinite(g.half()).all()) for g in wide)
    dq, dk, dv = tk.flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta,
                                                  num_heads=heads)
    # dS is +inf and -inf on alternate keys: dk = dS^T q is inf, and dq =
    # dS k sums the two (NaN)
    assert bool(torch.isinf(dk).all()) and not bool(torch.isfinite(dq).any())
    assert bool(torch.isfinite(dv).all())
    torch.testing.assert_close(dv, wide[2].half(), rtol=F16_ULP, atol=0)
    op = tk.flash_attention_bsh_bwd(q, k, v, do, lse, delta,
                                    num_heads=heads)
    for a, w in zip(op, (dq, dk, dv)):
        torch.testing.assert_close(a, w, rtol=0, atol=0, equal_nan=True)
