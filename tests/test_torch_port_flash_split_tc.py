"""The split dQ and dK/dV flash backwards as the tensor-core kernels
compute them, against the JAX package's split sweeps.

On the card, bf16 and fp16 split backwards run ``csrc/flash_bwd_dq_tc.cu``
(dQ) and ``csrc/flash_bwd_tc.cu`` without its dQ share (dK, dV). Both
recompute P and dS in fp32 and round them to the inputs' dtype before their
products, as JAX's ``_p_ds`` does for bf16
(``apex_tpu/kernels/flash_attention.py:188-189``). The split ops' plain
twins (``flash_attention_bwd_dq_plain``, ``flash_attention_bwd_dkdv_plain``,
through ``_p_ds_plain``) round at the same place, and ``chip_smoke.py``
holds the kernels against them on the card. Here the ops, on CPU tensors,
are held against JAX's ``_run_bwd`` run split (``APEX_TPU_FLASH_BWD=split``,
which it reads at call time; the ``_dq_kernel`` and ``_dkv_kernel``
``pallas_call``s in interpret mode), on the same numpy-seeded inputs, with
lse and delta from JAX's own forward: head widths 64, 80 and 128; kv
lengths holding a 0 (zero dK and dV); causal with segment ids; and two
heads sharing a batch row's segment ids (``n_rep = 2``).

Tolerances, as ``tests/test_torch_port_flash_bwd_tc.py`` states them for
the fused backward: both sides round the same fp32 P and dS to bf16, from
scores summed in another order, so a value within an fp32 rounding of a
bf16 boundary may land on either side, and the gradients are then rounded
to bf16. Every entry within one bf16 ulp plus ``GRAD_ATOL`` and the RMS of
the difference within ``GRAD_RMS`` of the RMS of JAX's gradient; the same
twins on the inputs widened to fp32 (P and dS unrounded) miss the RMS
bound on every case.

fp16: JAX widens it to fp32 (``widen_f16``), so its P and dS stay fp32,
while the kernels round them to fp16 (a difference by design). The split
ops equal the fp16-rounding twins bit for bit, and stay within one fp16
ulp plus ``F16_GRAD_ATOL`` of the largest entry (RMS ``F16_GRAD_RMS``) of
JAX's widened result, as ``tests/test_torch_port_flash_f16_tc.py`` holds
the fused op. Off the tensor-core route (fp16 at d = 100, fp32) the ops
still widen. Then the two C entries' signatures, the split sweeps'
tensor-core counters, and which entry each sweep launches for CUDA
tensors (the library and the device faked).
"""

import functools
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import _build

jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

torch.set_num_threads(1)

GRAD_ATOL = 3e-4
GRAD_RMS = 5e-4
BF16_ULP = 2.0 ** -7
F16_ULP = 2.0 ** -10
F16_GRAD_ATOL = 1e-3
F16_GRAD_RMS = 1e-3

CASES = [(d, case) for d in (64, 80, 128) for case in ("lens", "segs",
                                                       "nrep2")]


def _case(case: str, d: int):
    """(bh, sq, sk, causal, n_rep, lens, segs) of one case, the aux
    operands as numpy arrays (or None)."""
    rng = np.random.default_rng(d + 13)
    if case == "lens":
        return 4, 40, 56, False, 1, np.array([56, 0, 17, 40], np.int32), None
    if case == "segs":
        ids = rng.integers(0, 3, (3, 72)).astype(np.int32)
        return 3, 72, 72, True, 1, None, (ids, ids)
    # n_rep = 2: two heads share each batch row's segment ids, and one
    # batch row has no kv at all
    seg_q = rng.integers(0, 2, (2, 100)).astype(np.int32)
    seg_k = rng.integers(0, 2, (2, 136)).astype(np.int32)
    lens = np.array([136, 136, 0, 0], np.int32)
    return 4, 100, 136, False, 2, lens, (seg_q, seg_k)


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor: bf16 on both
    sides, or fp16 in torch and those values widened to fp32 in JAX (as
    JAX's public functions widen them)."""
    if dtype == torch.bfloat16:
        j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    h = np.asarray(x, np.float16)
    return jnp.asarray(h.astype(np.float32)), torch.from_numpy(h.copy())


def _jax_split(dtype):
    """{(d, case): (torch args, kwargs, JAX's split grads)}: JAX's forward
    for lse and delta, then ``_run_bwd`` under ``APEX_TPU_FLASH_BWD=split``
    with its ``pallas_call``s spied on (the dQ and dK/dV sweeps ran, not
    the fused one)."""
    out = {}
    seen = []
    orig = jfa.pl.pallas_call

    def spy(kernel, *a, **kw):
        # the body under functools.partial and _bind_aux's adapter
        f = kernel.func if isinstance(kernel, functools.partial) else kernel
        if f.__name__ == "<lambda>":
            f = inspect.getclosurevars(f).nonlocals["kernel"]
        seen.append(f.__name__)
        return orig(kernel, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("APEX_TPU_FLASH_BWD", "split")
        mp.setattr(jfa.pl, "pallas_call", spy)
        for d, case in CASES:
            bh, sq, sk, causal, n_rep, lens, segs = _case(case, d)
            rng = np.random.default_rng(40 * d + len(case))
            pairs = [_pair(rng.standard_normal((bh, s_, d)), dtype)
                     for s_ in (sq, sk, sk, sq)]
            qj, kj, vj, doj = (p[0] for p in pairs)
            scale = 1 / d ** 0.5
            lens_j = None if lens is None else jnp.asarray(lens)
            segs_j = None if segs is None else tuple(jnp.asarray(x)
                                                     for x in segs)
            o_j, lse_j = jfa._run_fwd(qj, kj, vj, lens_j, segs_j, scale,
                                      causal, n_rep=n_rep)
            delta_j = jnp.sum(o_j.astype(jnp.float32)
                              * doj.astype(jnp.float32), axis=-1,
                              keepdims=True)
            seen.clear()
            want = jfa._run_bwd(qj, kj, vj, doj, lse_j, delta_j, lens_j,
                                segs_j, scale, causal, n_rep=n_rep)
            assert seen == ["_dq_kernel", "_dkv_kernel"], seen
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


@pytest.fixture(scope="module")
def bf16_cases():
    return _jax_split(torch.bfloat16)


@pytest.fixture(scope="module")
def f16_cases():
    return _jax_split(torch.float16)


def _np(t):
    return t.detach().float().cpu().numpy()


def _errs(got, want, ulp, rel_to_top=False):
    """(max |got - want| less one ulp of want, over want's largest entry
    if ``rel_to_top``; RMS of the difference over the RMS of want)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    over = float((diff - ulp * np.abs(want)).max())
    if rel_to_top:
        over /= max(float(np.abs(want).max()), 1e-30)
    rms = float(np.sqrt((diff ** 2).mean() / max((want ** 2).mean(), 1e-30)))
    return over, rms


def _split(args, kw):
    dq = tk.flash_attention_bwd_dq(*args, **kw)
    dk, dv = tk.flash_attention_bwd_dkdv(*args, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# bf16: the split ops round P and dS as JAX's split sweeps do
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,case", CASES)
def test_split_bf16_rounds_p_and_ds_as_jax(bf16_cases, d, case):
    """The split ops on bf16 CPU tensors (their plain twins) against JAX's
    ``_dq_kernel`` and ``_dkv_kernel``: fp32 gradients cast to bf16, as
    the autograd formula casts them and as JAX does; a kv length of 0
    gives zero dK and dV."""
    args, kw, want = bf16_cases[(d, case)]
    got = _split(args, kw)
    assert all(t.dtype == torch.float32 for t in got)
    for g, w in zip(got, want):
        over, rms = _errs(_np(g.bfloat16()), w, BF16_ULP)
        assert over <= GRAD_ATOL and rms <= GRAD_RMS, (over, rms)
    if kw["lens"] is not None:
        empty = kw["lens"] == 0
        assert bool((got[1][empty] == 0).all() and (got[2][empty] == 0).all())
    assert torch.equal(got[0], tk.flash_attention_bwd_dq_plain(*args, **kw))
    dk, dv = tk.flash_attention_bwd_dkdv_plain(*args, **kw)
    assert torch.equal(got[1], dk) and torch.equal(got[2], dv)


def test_split_bf16_unrounded_twins_miss_jax(bf16_cases):
    """What the RMS bound tells apart: the split twins on the inputs
    widened to fp32 (P and dS kept in fp32, as the CUDA-core kernels
    compute them) are off JAX's split gradients by more than ``GRAD_RMS``
    on every case."""
    for key, (args, kw, want) in bf16_cases.items():
        wide = [t.float() for t in args[:4]] + args[4:]
        got = _split(wide, kw)
        rms = max(_errs(_np(g.bfloat16()), w, BF16_ULP)[1]
                  for g, w in zip(got, want))
        assert rms > GRAD_RMS, (key, rms)


def test_autograd_split_runs_the_split_ops(bf16_cases, monkeypatch):
    """Under ``APEX_TPU_FLASH_BWD=split`` the public API's backward is the
    split pair on the forward's own lse: its bf16 gradients are the split
    ops' fp32 ones cast to bf16."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", "split")
    args, kw, _ = bf16_cases[(80, "nrep2")]
    q, k, v, do = (t.clone().requires_grad_(t is not args[3])
                   for t in args[:4])
    out, lse = tk.flash_attention_fwd(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), do)
    delta = (out.detach().float() * do.float()).sum(-1)
    want = _split([t.detach() for t in (q, k, v, do)] + [lse.detach(), delta],
                  kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w.bfloat16())


# ---------------------------------------------------------------------------
# fp16: rounded to fp16 as the kernels do, within an ulp of JAX's widened
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,case", CASES)
def test_split_f16_rounds_as_the_twins(f16_cases, d, case):
    """The split ops on fp16 CPU tensors, unwidened: equal to the
    fp16-rounding twins bit for bit (not to the widened ones), and their
    gradients, cast to fp16, within one fp16 ulp of JAX's split sweeps on
    the same values widened."""
    args, kw, want = f16_cases[(d, case)]
    got = _split(args, kw)
    assert torch.equal(got[0], tk.flash_attention_bwd_dq_plain(*args, **kw))
    dk, dv = tk.flash_attention_bwd_dkdv_plain(*args, **kw)
    assert torch.equal(got[1], dk) and torch.equal(got[2], dv)
    wide = _split([t.float() for t in args[:4]] + args[4:], kw)
    assert not any(torch.equal(a.half(), w.half())
                   for a, w in zip(got, wide))
    for g, w in zip(got, want):
        w16 = np.asarray(w, np.float32).astype(np.float16).astype(np.float32)
        over, rms = _errs(_np(g.half()), w16, F16_ULP, rel_to_top=True)
        assert over <= F16_GRAD_ATOL and rms <= F16_GRAD_RMS, (over, rms)


# ---------------------------------------------------------------------------
# off the route, the entries, the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d", [(torch.float16, 100),
                                     (torch.float32, 64)])
def test_split_off_the_route_widens(dtype, d):
    """Where ``tc_route`` says no, the split ops run the CUDA-core
    kernels' arithmetic: fp16 at a head width that is not a multiple of 8
    is widened to fp32 (P and dS unrounded), and fp32 stays fp32."""
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 24, d)).astype(
        np.float32)).to(dtype) for _ in range(4))
    lse = torch.from_numpy(rng.standard_normal((2, 24)).astype(
        np.float32)) + 3.0
    delta = torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))
    assert not tk.tc_route(d, q, k, v, do)
    wide = [t.float() for t in (q, k, v, do)]
    got = _split([q, k, v, do, lse, delta], dict(causal=True))
    want = _split(wide + [lse, delta], dict(causal=True))
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    if dtype == torch.float16:
        rounded = tk.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                  causal=True)
        assert not torch.equal(got[0], rounded)


def test_split_entries_take_the_head_major_arguments():
    """The two tensor-core split entries are declared with the head-major
    backward entries' argument list: twelve pointers, five ints, the
    scale, causal, the dtype code and the stream."""
    hm = _build._SIGNATURES["apex_tpu_torch_flash_bwd_hm_fused"]
    assert len(hm) == 21
    for name in ("apex_tpu_torch_flash_bwd_hm_dq_tc",
                 "apex_tpu_torch_flash_bwd_hm_dkdv_tc"):
        assert _build._SIGNATURES[name] == hm == \
            _build._SIGNATURES["apex_tpu_torch_flash_bwd_hm_tc"]


def test_cpu_split_counts_no_tensor_core_launch(monkeypatch):
    """bf16 CPU tensors take the split twins, through autograd and
    directly: no launch, tensor-core or other, is counted, and
    ``reset_launch_counts`` zeroes the split sweeps' tensor-core
    counts."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", "split")
    tk.reset_launch_counts()
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((1, 2, 24, 64)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    tk.flash_attention_with_lse(h, h, h, causal=True)[0].sum().backward()
    assert h.grad is not None
    counts = tk.launch_counts()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        assert counts[name] == counts[f"{name}_tc"] == 0
    tk.flash_attention_bwd_dq.tc_launches = 3
    tk.flash_attention_bwd_dkdv.tc_launches = 2
    tk.reset_launch_counts()
    counts = tk.launch_counts()
    assert counts["flash_attention_bwd_dq_tc"] == \
        counts["flash_attention_bwd_dkdv_tc"] == 0


class _FakeLibrary:
    """Stands in for the kernel library: records each entry called, with
    its dtype code and q's pointer, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name[len("apex_tpu_torch_"):], args[-2],
                               args[0]))
            return 0
        return entry


@pytest.mark.parametrize("dtype,d,tc", [(torch.bfloat16, 80, True),
                                        (torch.float16, 64, True),
                                        (torch.float16, 100, False),
                                        (torch.float32, 128, False)])
def test_kernel_route_of_each_sweep(monkeypatch, dtype, d, tc):
    """What a CUDA tensor launches, with the library and the device faked
    (so the wrappers' dispatch runs here): each sweep its tensor-core
    entry where ``tc_route`` says yes, with the 16-bit dtype's code and
    an operand off a 16-byte boundary copied once, else its CUDA-core
    entry (fp16 widened to fp32's code); one launch counted each, and
    the tensor-core ones also in ``tc_launches``. The counters the faked
    launches move are put back afterwards (other tests in the process
    read them)."""
    lib = _FakeLibrary()
    for fn in tk.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
    for fn in tk.TC_COUNTERS.values():
        monkeypatch.setattr(fn, "tc_launches", fn.tc_launches)
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)
    buf = torch.zeros(2 * 24 * d + 1, dtype=dtype)
    q = buf[1:].view(2, 24, d)                 # off a 16-byte boundary
    k, v, do = (torch.zeros(2, 24, d, dtype=dtype) for _ in range(3))
    lse, delta = torch.zeros(2, 24), torch.zeros(2, 24)
    tk.reset_launch_counts()
    # the fused op as the autograd formula calls it: fp16 off the tensor
    # cores arrives widened (it takes no fp16 there)
    fused = (q, k, v, do) if tc else (t.float() for t in (q, k, v, do))
    tk.flash_attention_bwd(*fused, lse, delta)
    tk.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True)
    tk.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=True)
    code = (_build.TC_DTYPE_CODES[dtype] if tc
            else _build.DTYPE_CODES[torch.float32])
    suffix = "_tc" if tc else ""
    assert [c[:2] for c in lib.calls] == [
        ("flash_bwd_hm_tc" if tc else "flash_bwd_hm_fused", code),
        (f"flash_bwd_hm_dq{suffix}", code),
        (f"flash_bwd_hm_dkdv{suffix}", code)]
    if tc:
        assert all(ptr % 16 == 0 for _, _, ptr in lib.calls)
    counts = tk.launch_counts()
    for name in ("flash_attention_bwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv"):
        assert counts[name] == 1 and counts[f"{name}_tc"] == int(tc)

