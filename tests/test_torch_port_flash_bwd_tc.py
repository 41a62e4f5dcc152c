"""The bf16 fused flash-attention backward as the tensor-core kernel
computes it, against the JAX package's.

``csrc/flash_bwd_tc.cu`` is the bf16 fused backward of both layouts on the
card: it recomputes P in fp32, then rounds P and dS to bf16 before the dV,
dK and dQ products, as JAX's ``_p_ds`` does (``p.astype(q.dtype)``,
``ds ... .astype(q.dtype)``, ``apex_tpu/kernels/flash_attention.py:188-189``).
The plain twins (``flash_attention_bsh_bwd_plain``,
``flash_attention_bwd_plain`` and the split twins, through ``_p_ds_plain``)
round at the same place, and ``chip_smoke.py`` holds the kernel against
them on the card. Here the twins are held against the Pallas kernels
themselves, ``_run_bwd_bsh`` and ``_run_bwd`` (fused) in interpret mode, on
the same numpy-seeded bf16 inputs, with lse and delta from JAX's own
forward: the lane-packed layout with 2 heads of 64 at s = 24, 64 and 200,
causal and not; the head-major layout at head widths 64 and 80 with kv
lengths holding a 0, with segment ids, and with ``n_rep = 2``.

Tolerances. Both sides round the same fp32 P and dS to bf16, from scores
summed in another order, so a value within an fp32 rounding of a bf16
boundary may land on the other side; the gradients are then rounded to
bf16 (JAX's ``_run_bwd`` casts its fp32 sums to the input dtype, the
port's op casts the same way). On these inputs:

- every entry within one bf16 ulp (``2^-7`` relative) plus
  ``GRAD_ATOL``: the rounding twins come within 2.4e-5 of one ulp, the
  same twins on inputs widened to fp32 (P and dS kept in fp32) 6.8e-4 to
  4.7e-3 past it;
- the RMS of the difference within ``GRAD_RMS`` of the RMS of JAX's
  gradient: flips are rare, while P and dS kept in fp32 differ everywhere
  (at most 7.7e-5 rounded, 2.3e-3 to 2.7e-3 unrounded).

Then the fp32 twins, which do not round, and the fp16 ones, which round
as the tensor-core kernel does (held against JAX in
``tests/test_torch_port_flash_f16_tc.py``); the rule that sends a
backward to the tensor-core kernel (:func:`~apex_tpu_torch.kernels.
flash_attention.tc_route`, by dtype and width alone), on CPU tensors; and
the backward's tensor-core launch counters, which CPU tensors leave at 0.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import kernels as tk

jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

torch.set_num_threads(1)

GRAD_ATOL = 3e-4
GRAD_RMS = 5e-4
BF16_ULP = 2.0 ** -7


def _pair(x):
    """The same bf16 values as a JAX array and a torch CPU tensor."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(t):
    return t.detach().float().cpu().numpy()


def _errs(got, want):
    """(max |got - want| less one bf16 ulp of want, RMS of the difference
    over the RMS of want)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    over = float((diff - BF16_ULP * np.abs(want)).max())
    rms = float(np.sqrt((diff ** 2).mean() / max((want ** 2).mean(), 1e-30)))
    return over, rms


def _hold(got, want):
    for g, w in zip(got, want):
        over, rms = _errs(_np(g), w)
        assert over <= GRAD_ATOL and rms <= GRAD_RMS, (over, rms)


# ---------------------------------------------------------------------------
# the lane-packed layout: _run_bwd_bsh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bsh_cases():
    """{(b, s, causal): (torch inputs, lse, delta, JAX's grads)}, JAX's side
    run once for the module."""
    hidden, heads = 128, 2
    d, g, n_grp = jfa._group_geometry(hidden, heads)
    out = {}
    for b, s in ((2, 24), (3, 64), (1, 200)):
        for causal in (True, False):
            rng = np.random.default_rng(2000 + b * s + causal)
            pairs = [_pair(rng.standard_normal((b, s, hidden)))
                     for _ in range(4)]
            qj, kj, vj, doj = (p[0] for p in pairs)
            o_j, lse_j = jfa._run_fwd_bsh(qj, kj, vj, None, None,
                                          1 / d ** 0.5, causal, d, g, n_grp)
            prod = (o_j.astype(jnp.float32) * doj.astype(jnp.float32)
                    ).reshape(b, s, heads, d).sum(-1)
            delta_j = jnp.transpose(prod.reshape(b, s, n_grp, g),
                                    (0, 2, 3, 1)).reshape(b * n_grp, g, s)
            want = jfa._run_bwd_bsh(qj, kj, vj, doj, lse_j, delta_j, None,
                                    None, 1 / d ** 0.5, causal, d, g, n_grp)
            lse = torch.from_numpy(np.array(lse_j)).reshape(b, heads, s)
            delta = torch.from_numpy(np.array(delta_j)).reshape(b, heads, s)
            out[(b, s, causal)] = ([p[1] for p in pairs], lse, delta,
                                   [np.asarray(w, np.float32) for w in want])
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s", [(2, 24), (3, 64), (1, 200)])
def test_bsh_bwd_plain_rounds_p_and_ds_as_jax(bsh_cases, b, s, causal):
    """The lane-packed twin against ``_run_bwd_bsh``: hidden 128 = 2 heads
    of 64 in one JAX lane group; 24 and 200 are not tile multiples. The op
    takes the twin on CPU tensors."""
    (q, k, v, do), lse, delta, want = bsh_cases[(b, s, causal)]
    got = tk.flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta,
                                           num_heads=2, causal=causal)
    assert all(t.dtype == torch.bfloat16 for t in got)
    _hold(got, want)
    op = tk.flash_attention_bsh_bwd(q, k, v, do, lse, delta, num_heads=2,
                                    causal=causal)
    assert all(torch.equal(a, w) for a, w in zip(op, got))


def test_bsh_bwd_unrounded_twin_misses_jax(bsh_cases):
    """What the RMS bound tells apart: the same twin on the inputs widened
    to fp32 (P and dS kept in fp32, as the CUDA-core kernel computes them)
    is off JAX's gradients by more than ``GRAD_RMS`` on every case."""
    for (b, s, causal), ((q, k, v, do), lse, delta, want) in \
            bsh_cases.items():
        got = tk.flash_attention_bsh_bwd_plain(
            *(t.float() for t in (q, k, v, do)), lse, delta, num_heads=2,
            causal=causal)
        rms = max(_errs(_np(g.bfloat16()), w)[1] for g, w in zip(got, want))
        assert rms > GRAD_RMS, (b, s, causal, rms)


# ---------------------------------------------------------------------------
# the head-major layout: _run_bwd, fused
# ---------------------------------------------------------------------------

def _hm_case(case: str, d: int):
    """(bh, sq, sk, causal, n_rep, lens, segs) of one head-major case, the
    aux operands as numpy arrays (or None)."""
    rng = np.random.default_rng(d + 7)
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
    """{(d, case): (torch inputs, kwargs, JAX's grads)}, JAX's side run
    once for the module."""
    out = {}
    for d, case in HM_CASES:
        bh, sq, sk, causal, n_rep, lens, segs = _hm_case(case, d)
        rng = np.random.default_rng(20 * d + len(case))
        pairs = [_pair(rng.standard_normal((bh, s_, d)))
                 for s_ in (sq, sk, sk, sq)]
        qj, kj, vj, doj = (p[0] for p in pairs)
        scale = 1 / d ** 0.5
        lens_j = None if lens is None else jnp.asarray(lens)
        segs_j = None if segs is None else tuple(jnp.asarray(x)
                                                 for x in segs)
        o_j, lse_j = jfa._run_fwd(qj, kj, vj, lens_j, segs_j, scale, causal,
                                  n_rep=n_rep)
        delta_j = jnp.sum(o_j.astype(jnp.float32) * doj.astype(jnp.float32),
                          axis=-1, keepdims=True)
        want = jfa._run_bwd(qj, kj, vj, doj, lse_j, delta_j, lens_j, segs_j,
                            scale, causal, n_rep=n_rep)
        kw = dict(causal=causal, scale=scale, n_rep=n_rep,
                  lens=None if lens is None else torch.from_numpy(lens),
                  segs=None if segs is None else tuple(
                      torch.from_numpy(x) for x in segs))
        args = [p[1] for p in pairs] + [
            torch.from_numpy(np.asarray(lse_j)[..., 0].copy()),
            torch.from_numpy(np.asarray(delta_j)[..., 0].copy())]
        out[(d, case)] = (args, kw, [np.asarray(w, np.float32)
                                     for w in want])
    return out


@pytest.mark.parametrize("d,case", HM_CASES)
def test_hm_bwd_plain_rounds_p_and_ds_as_jax(hm_cases, d, case):
    """The head-major fused twin against ``_run_bwd`` (interpret mode):
    every mask of ``_valid_cols``, a kv length of 0 (zero dK and dV), and
    two heads sharing a batch row's segment ids. Its fp32 gradients are
    cast to bf16, as the op's autograd formula casts them and as JAX
    does."""
    args, kw, want = hm_cases[(d, case)]
    got = tk.flash_attention_bwd_plain(*args, **kw)
    assert all(t.dtype == torch.float32 for t in got)
    _hold([g.bfloat16() for g in got], want)
    if kw["lens"] is not None:
        empty = kw["lens"] == 0
        assert bool((got[1][empty] == 0).all() and (got[2][empty] == 0).all())
    op = tk.flash_attention_bwd(*args, **kw)
    assert all(torch.equal(a, w) for a, w in zip(op, got))
    # the split twins share the rounding (_p_ds_plain)
    assert torch.equal(tk.flash_attention_bwd_dq_plain(*args, **kw), got[0])
    dk, dv = tk.flash_attention_bwd_dkdv_plain(*args, **kw)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


def test_hm_bwd_unrounded_twin_misses_jax(hm_cases):
    """The head-major twin on widened inputs (P and dS in fp32) is off
    JAX's gradients by more than ``GRAD_RMS`` on every case."""
    for key, (args, kw, want) in hm_cases.items():
        got = tk.flash_attention_bwd_plain(
            *(t.float() for t in args[:4]), *args[4:], **kw)
        rms = max(_errs(_np(g.bfloat16()), w)[1] for g, w in zip(got, want))
        assert rms > GRAD_RMS, (key, rms)


# ---------------------------------------------------------------------------
# fp32 does not round; fp16 does
# ---------------------------------------------------------------------------

def test_bwd_twins_keep_p_and_ds_in_fp32_for_fp32_and_fp16():
    """fp32 keeps P and dS in fp32 (the unrounded formula); fp16, which
    the tensor-core kernel takes since it has an fp16 instantiation,
    rounds them as bf16 does: its gradients come back in fp16, within an
    fp16 ulp or two of the widened route's and not equal to them; bf16
    differs from its own values run through fp32."""
    rng = np.random.default_rng(8)
    x = [torch.from_numpy(rng.standard_normal((2, 40, 128)).astype(
        np.float32)) for _ in range(4)]
    lse = torch.from_numpy(rng.standard_normal((2, 2, 40)).astype(
        np.float32)) + 3.0
    delta = torch.from_numpy(rng.standard_normal((2, 2, 40)).astype(
        np.float32))
    half = [t.half() for t in x]
    got = tk.flash_attention_bsh_bwd(*half, lse, delta, num_heads=2,
                                     causal=True)
    want = tk.flash_attention_bsh_bwd_plain(*(t.float() for t in half), lse,
                                            delta, num_heads=2, causal=True)
    assert all(g.dtype == torch.float16 for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, (
        tk.flash_attention_bsh_bwd_plain(*half, lse, delta, num_heads=2,
                                         causal=True))))
    assert not any(torch.equal(g, w.half()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, rtol=2.0 ** -9, atol=2e-3 *
                                   float(w.abs().max()))
    hm = [t.reshape(4, 40, 64) for t in x]
    lse_h, delta_h = lse.reshape(4, 40), delta.reshape(4, 40)
    f32 = tk.flash_attention_bwd_plain(*hm, lse_h, delta_h, causal=True)
    # fp32 is the unrounded formula itself
    s = torch.matmul(hm[0], hm[1].transpose(-1, -2)) / 8.0
    p = torch.exp(s - lse_h[..., None]).tril()
    ds = p * (torch.matmul(hm[3], hm[2].transpose(-1, -2))
              - delta_h[..., None]) / 8.0
    torch.testing.assert_close(f32[1], ds.transpose(-1, -2) @ hm[0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f32[2], p.transpose(-1, -2) @ hm[3],
                               rtol=1e-5, atol=1e-5)
    bf = [t.bfloat16() for t in x]
    got = tk.flash_attention_bsh_bwd_plain(*bf, lse, delta, num_heads=2,
                                           causal=True)
    wide = tk.flash_attention_bsh_bwd_plain(*(t.float() for t in bf), lse,
                                            delta, num_heads=2, causal=True)
    assert not any(torch.equal(g, w.bfloat16()) for g, w in zip(got, wide))


# ---------------------------------------------------------------------------
# the rule and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 72, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 100, False), (torch.bfloat16, 136, False),
    (torch.float32, 64, False), (torch.float16, 80, True),
    (torch.float16, 100, False)])
def test_tc_route_of_the_backward(dtype, d, tc):
    """A backward goes to the tensor-core kernel for bf16 or fp16 q, k, v
    and do (one dtype) with a head width in multiples of 8 up to 128, by
    dtype and width alone; a do of another dtype keeps it on the CUDA
    cores."""
    t = torch.zeros(2, 16, d, dtype=dtype)
    assert tk.tc_route(d, t, t, t, t) is tc
    if tc:
        assert not tk.tc_route(d, t, t, t, t.float())
        other = torch.float16 if dtype == torch.bfloat16 else torch.bfloat16
        assert not tk.tc_route(d, t, t, t, t.to(other))


def test_cpu_tensors_count_no_tensor_core_backward():
    """bf16 CPU tensors take the plain twins through both backward ops, by
    autograd and directly: no launch, tensor-core or other, is counted."""
    tk.reset_launch_counts()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 24, 128)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    tk.flash_attention_bsh(x, x, x, num_heads=2, causal=True).sum().backward()
    h = x.detach().reshape(2, 24, 2, 64).transpose(1, 2).requires_grad_(True)
    tk.flash_attention_with_lse(h, h, h, causal=True)[0].sum().backward()
    f = x.detach().reshape(4, 24, 64)
    out, lse = tk.flash_attention_fwd(f, f, f, causal=True)
    tk.flash_attention_bwd(f, f, f, f, lse, (out.float() * f.float()).sum(-1),
                           causal=True)
    counts = tk.launch_counts()
    assert x.grad is not None and h.grad is not None
    assert counts["flash_attention_bsh_bwd_tc"] == \
        counts["flash_attention_bwd_tc"] == \
        counts["flash_attention_bsh_bwd"] == counts["flash_attention_bwd"] == 0
    tk.flash_attention_bsh_bwd.tc_launches = 3
    tk.flash_attention_bwd.tc_launches = 2
    tk.reset_launch_counts()
    counts = tk.launch_counts()
    assert counts["flash_attention_bsh_bwd_tc"] == \
        counts["flash_attention_bwd_tc"] == 0
