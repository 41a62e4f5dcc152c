"""The bf16 flash-attention forward as the tensor-core kernel computes it,
against the JAX package's (fp16: ``tests/test_torch_port_flash_f16_tc.py``).

``csrc/flash_fwd_tc.cu`` is the bf16 forward of both layouts on the card:
it sums ``l`` from fp32 ``p`` and rounds ``p`` to bf16 before ``P V``, as
JAX's ``_online_update`` does (``p.astype(v.dtype)``,
``apex_tpu/kernels/flash_attention.py:90``). The plain twins
(``flash_attention_bsh_plain``, ``flash_attention_fwd_plain``) round at
the same place, and ``chip_smoke.py`` holds the kernel against them on the
card. Here the twins are held against the Pallas kernels themselves,
``_run_fwd_bsh`` and ``_run_fwd`` in interpret mode, on the same
numpy-seeded bf16 inputs: the lane-packed layout with 2 heads of 64 at
s = 24, 64 and 200, causal and not; the head-major layout at head widths
64 and 80 with kv lengths holding a 0, with segment ids, and with
``n_rep = 2``.

Tolerances: out within ``4e-3`` absolute (the twins and JAX round the same
fp32 ``p`` to bf16, relative to another running max, and each out to
bf16: at most 9.8e-4 apart on these inputs, against up to 1.56e-2 with
``p`` kept in fp32), lse within ``1e-3`` (fp32 statistics of bf16
inputs, as ``tests/test_torch_port_kernels.py``).

Then the rule that picks a forward's (and a fused backward's) kernel on
the card (:func:`~apex_tpu_torch.kernels.flash_attention.tc_route`), which
runs on CPU tensors too, and the tensor-core launch counters, which CPU
tensors leave at 0.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import flash_attention as fa

jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

torch.set_num_threads(1)

OUT_ATOL = 4e-3
LSE_TOL = dict(rtol=1e-3, atol=1e-3)


def _pair(x):
    """The same bf16 values as a JAX array and a torch CPU tensor."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(t):
    return t.detach().float().cpu().numpy()


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s", [(2, 24), (3, 64), (1, 200)])
def test_bsh_plain_rounds_p_as_jax(b, s, causal):
    """The lane-packed twin against ``_run_fwd_bsh``: hidden 128 = 2 heads
    of 64, so the JAX side packs both heads in one lane group; 24 and 200
    are not tile multiples."""
    hidden, heads = 128, 2
    rng = np.random.default_rng(1000 + b * s + causal)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal((b, s, hidden))) for _ in range(3))
    d, g, n_grp = jfa._group_geometry(hidden, heads)
    out_j, lse_j = jfa._run_fwd_bsh(qj, kj, vj, None, None, 1 / d ** 0.5,
                                    causal, d, g, n_grp)
    out_t, lse_t = tk.flash_attention_bsh_plain(qt, kt, vt, num_heads=heads,
                                                causal=causal)
    assert out_t.dtype == torch.bfloat16
    assert _max_err(_np(out_t), out_j) <= OUT_ATOL
    np.testing.assert_allclose(
        _np(lse_t), np.asarray(lse_j).reshape(b, heads, s), **LSE_TOL)
    # the op takes the twin on CPU tensors
    op_out, op_lse = tk.flash_attention_bsh_fwd(qt, kt, vt, num_heads=heads,
                                                causal=causal)
    assert torch.equal(op_out, out_t) and torch.equal(op_lse, lse_t)


def _hm_case(case: str, d: int):
    """(bh, sq, sk, causal, n_rep, lens, segs) of one head-major case, the
    aux operands as numpy arrays (or None)."""
    rng = np.random.default_rng(d)
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


@pytest.mark.parametrize("case", ["lens", "segs", "nrep2"])
@pytest.mark.parametrize("d", [64, 80])
def test_hm_plain_rounds_p_as_jax(d, case):
    """The head-major twin against ``_run_fwd`` (interpret mode): every
    mask of ``_valid_cols``, and the rows a kv length of 0 leaves with no
    column (out 0, lse ``-1e30 + log(1e-30)`` on both sides)."""
    bh, sq, sk, causal, n_rep, lens, segs = _hm_case(case, d)
    rng = np.random.default_rng(10 * d + len(case))
    (qj, qt), = (_pair(rng.standard_normal((bh, sq, d))),)
    (kj, kt), (vj, vt) = (_pair(rng.standard_normal((bh, sk, d)))
                          for _ in range(2))
    scale = 1 / d ** 0.5
    lens_j = None if lens is None else jnp.asarray(lens)
    segs_j = None if segs is None else tuple(jnp.asarray(x) for x in segs)
    out_j, lse_j = jfa._run_fwd(qj, kj, vj, lens_j, segs_j, scale, causal,
                                n_rep=n_rep)
    lens_t = None if lens is None else torch.from_numpy(lens)
    segs_t = None if segs is None else tuple(torch.from_numpy(x)
                                             for x in segs)
    out_t, lse_t = tk.flash_attention_fwd_plain(
        qt, kt, vt, causal=causal, scale=scale, lens=lens_t, segs=segs_t,
        n_rep=n_rep)
    assert out_t.dtype == torch.bfloat16
    assert _max_err(_np(out_t), out_j) <= OUT_ATOL
    np.testing.assert_allclose(_np(lse_t), np.asarray(lse_j)[..., 0],
                               **LSE_TOL)
    if lens is not None:
        empty = torch.from_numpy(lens == 0)
        assert bool((out_t[empty] == 0).all())
        assert bool((lse_t[empty] == -1e30 + np.log(1e-30)).all())
    op_out, op_lse = tk.flash_attention_fwd(
        qt, kt, vt, causal=causal, scale=scale, lens=lens_t, segs=segs_t,
        n_rep=n_rep)
    assert torch.equal(op_out, out_t) and torch.equal(op_lse, lse_t)


def test_plain_twins_keep_p_in_fp32_for_fp32_and_fp16():
    """fp32 keeps ``p`` in fp32; the 16-bit dtypes round it before ``P
    V``, fp16 since the tensor-core kernel takes fp16 (JAX widens fp16,
    so its ``p`` stays fp32: ``tests/test_torch_port_flash_f16_tc.py``).
    The fp16 twin is the fp32 formula with ``p`` rounded to fp16: the
    same lse, and out within one fp16 ulp plus 1e-3 of the widened twin's
    (2.6e-4 past the ulp at most here), but not equal to it."""
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(rng.standard_normal((2, 40, 128)).astype(
        np.float32)) for _ in range(3)]
    # fp32 is the unrounded formula itself
    got, _ = tk.flash_attention_bsh_plain(*x, num_heads=2, causal=True)
    qh, kh, vh = (t.reshape(2, 40, 2, 64).transpose(1, 2) for t in x)
    p = torch.softmax((qh @ kh.transpose(-1, -2) / 8.0).masked_fill(
        ~torch.ones(40, 40, dtype=torch.bool).tril(), -1e30), -1)
    torch.testing.assert_close(
        got, (p @ vh).transpose(1, 2).reshape(2, 40, 128), rtol=1e-5,
        atol=1e-5)
    half = [t.half() for t in x]
    widened = [t.float() for t in half]
    for fwd, args in ((lambda *a: tk.flash_attention_bsh_plain(
            *a, num_heads=2, causal=True), half),
            (lambda *a: tk.flash_attention_fwd_plain(*a, causal=True),
             [t.reshape(4, 40, 64) for t in half])):
        got, got_lse = fwd(*args)
        want, want_lse = fwd(*(t.float() for t in args))
        assert got.dtype == torch.float16 and torch.equal(got_lse, want_lse)
        assert not torch.equal(got, want.half())
        torch.testing.assert_close(got.float(), want, rtol=2.0 ** -10,
                                   atol=1e-3)
    # and bf16 does round it: the same values through fp32 differ
    bf = [t.bfloat16() for t in x]
    got, _ = tk.flash_attention_bsh_plain(*bf, num_heads=2, causal=True)
    want, _ = tk.flash_attention_bsh_plain(*(t.float() for t in bf),
                                           num_heads=2, causal=True)
    assert not torch.equal(got, want.bfloat16())


# ---------------------------------------------------------------------------
# the kernel rule and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [32, 64, 72, 80, 128])
def test_tc_forward_takes_bf16_widths(d):
    """bf16 with a head width that is a multiple of 8 up to 128 runs the
    tensor-core kernel (padded to 64, 80 or 128 inside it)."""
    t = torch.zeros(2, 16, d, dtype=torch.bfloat16)
    assert tk.tc_route(d, t, t, t)


def _unaligned(shape):
    """A contiguous bf16 tensor whose data starts 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    off = next(i for i in range(8) if (buf.data_ptr() + 2 * i) % 16 == 2)
    return buf[off:off + n].view(shape)


@pytest.mark.parametrize("case", ["fp32", "fp16", "d100", "unaligned",
                                  "mixed"])
def test_tc_forward_leaves_the_rest_on_cuda_cores(case):
    """fp32, a width that is not a multiple of 8 and mixed dtypes stay on
    the CUDA-core kernels; fp16 takes the tensor cores at d = 64 and stays
    off them (widened to fp32 by the wrappers) at d = 100, and bf16 mixed
    with fp16 stays off. The rule looks at dtypes and the width alone: a
    bf16 operand off a 16-byte boundary goes to the tensor cores, and the
    op copies it once (``_aligned16``), leaving aligned operands as they
    are."""
    d = 100 if case == "d100" else 64
    dtype = {"fp32": torch.float32, "fp16": torch.float16}.get(
        case, torch.bfloat16)
    q = k = v = torch.zeros(2, 16, d, dtype=dtype)
    if case == "unaligned":
        q = _unaligned((2, 16, d))
        assert q.is_contiguous() and q.data_ptr() % 16
        assert tk.tc_route(d, q, k, v)
        copy = fa._aligned16(q)
        assert copy.data_ptr() % 16 == 0 and copy.data_ptr() != q.data_ptr()
        assert torch.equal(copy, q) and fa._aligned16(k) is k
        return
    if case == "fp16":
        assert tk.tc_route(d, q, k, v)
        w = torch.zeros(2, 16, 100, dtype=dtype)
        assert not tk.tc_route(100, w, w, w)
        assert not tk.tc_route(d, q, k, v.bfloat16())
        wide = fa._kernel_inputs(100, w, w, w)
        assert all(t.dtype == torch.float32 for t in wide)
        assert fa._kernel_inputs(d, q, k, v) == (q, k, v)
        return
    if case == "mixed":
        v = v.float()
    assert not tk.tc_route(d, q, k, v)


def test_cpu_tensors_count_no_tensor_core_launch():
    """bf16 CPU tensors take the plain twins through both forward ops and
    the public entries: no launch, tensor-core or other, is counted."""
    tk.reset_launch_counts()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 24, 128)).astype(
        np.float32)).bfloat16()
    tk.flash_attention_bsh(x, x, x, num_heads=2, causal=True)
    h = x.reshape(2, 24, 2, 64).transpose(1, 2)
    tk.flash_attention_with_lse(h, h, h, causal=True)
    tk.flash_attention_fwd(x.reshape(4, 24, 64), x.reshape(4, 24, 64),
                           x.reshape(4, 24, 64))
    counts = tk.launch_counts()
    assert counts["flash_attention_bsh_tc"] == counts["flash_attention_tc"] \
        == counts["flash_attention_bsh"] == counts["flash_attention"] == 0
    tk.flash_attention_bsh_fwd.tc_launches = 4
    tk.reset_launch_counts()
    assert tk.launch_counts()["flash_attention_bsh_tc"] == 0
