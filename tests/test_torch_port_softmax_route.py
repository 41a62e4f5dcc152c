"""The softmax forward's two CUDA routes (``csrc/softmax.cu``) on the CPU.

``kernels/softmax.py:fwd_route`` picks, by dtype, row length and pointer
alignment alone, the kernel ``softmax_fwd`` launches for CUDA tensors:
1, the row-in-registers kernel (``softmax_fwd_rows_kernel``: fp32 or
bf16, sk a multiple of the V = 16 / itemsize values of a 16-byte vector
and at most ``_build.SOFTMAX_ROWS_MAX_COLS``, x and y on a 16-byte
boundary, the byte mask on a V-byte one); 0, the general kernel
(``softmax_fwd_kernel``), for everything else.

Oracles:

- the rule itself over fp32 and bf16 at sk in {6, 8, 17, 24, 1000, 1024,
  cap, cap + V, 2500}, with and without a mask; other dtypes; x, y or
  the mask one element off its boundary;
- with the kernel library and the device faked, so that the wrappers'
  CUDA branch runs here: ``softmax_fwd``, ``scaled_masked_softmax``,
  ``scaled_upper_triang_masked_softmax`` and ``FusedScaleMaskSoftmax``'s
  fused path hand the C entry route 1 at the 355M's causal bf16 rows and
  BERT-large's padded fp16 ones (widened to fp32, the mask tiled over 16
  heads), and route 0 at sk = 17 and on a misaligned view, one counted
  launch each and no plain twin reached. The batch is cut to one (the
  route reads no batch size), so the tensors stay small;
- the C signature carries the route between the dtype code and the
  stream, and the cap in ``_build`` is the source's ``kRowsMaxCols``.

No JAX: ``tests/test_torch_port_softmax.py`` holds the plain twins
against the Pallas kernels, and ``chip_smoke.py`` phase 30 holds both
routes against the plain twin on the card.
"""

import ctypes
import re

import pytest
import torch

from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import _build
from apex_tpu_torch.kernels import softmax as tsm
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

CAP = _build.SOFTMAX_ROWS_MAX_COLS
V = {torch.float32: 4, torch.bfloat16: 8}
SKS = [6, 8, 17, 24, 1000, 1024, CAP, "cap+V", 2500]


def _sk(sk, dtype):
    return CAP + V[dtype] if sk == "cap+V" else sk


def _off(shape, dtype, offset):
    """A contiguous ``shape`` tensor whose data starts ``offset`` elements
    into a fresh (aligned) storage."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sk", SKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_route_by_dtype_and_row_length(dtype, sk, masked):
    """Route 1 exactly where sk is a multiple of V and at most the cap,
    with or without a mask (aligned operands)."""
    sk = _sk(sk, dtype)
    x = torch.zeros(1, 2, sk, dtype=dtype)
    m = torch.zeros(1, 2, sk, dtype=torch.bool) if masked else None
    want = int(sk % V[dtype] == 0 and sk <= CAP)
    assert tsm.fwd_route(x, torch.empty_like(x), m) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_fwd_route_other_dtypes_take_route_0(dtype):
    """Only the kernel's fp32 and bf16 take route 1 (float16 reaches the
    kernel widened to fp32, by the public functions)."""
    x = torch.zeros(1, 2, 1024, dtype=dtype)
    assert tsm.fwd_route(x, torch.empty_like(x)) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["x", "y", "mask"])
def test_fwd_route_misaligned_operand_takes_route_0(dtype, which):
    """x or y one element off its 16-byte boundary, or the byte mask one
    byte off a V-byte one: route 0 (sk = 1024 would take route 1)."""
    shape = (2, 4, 1024)
    x = _off(shape, dtype, 1 if which == "x" else 0)
    y = _off(shape, dtype, 1 if which == "y" else 0)
    m = _off(shape, torch.bool, 1 if which == "mask" else 0)
    assert tsm.fwd_route(x, y, m) == 0
    aligned = (_off(shape, dtype, 0), _off(shape, dtype, 0),
               _off(shape, torch.bool, 0))
    assert tsm.fwd_route(*aligned) == 1
    # a mask V bytes off keeps route 1: the kernel loads it V bytes at a time
    assert tsm.fwd_route(aligned[0], aligned[1],
                         _off(shape, torch.bool, V[dtype])) == 1


def test_route_conditions_agree_with_the_source():
    """The cap in ``_build`` is ``csrc/softmax.cu``'s ``kRowsMaxCols``, the
    C entry re-checks route 1's conditions and refuses a route it cannot
    run (cudaErrorInvalidValue, never the other route)."""
    src = (_build.CSRC_DIR / "softmax.cu").read_text()
    cap = re.search(r"constexpr int kRowsMaxCols = (\d+);", src)
    assert cap and int(cap.group(1)) == CAP
    assert ("if (!rows_route_ok<T>(x, mask, y, sk)) return "
            "cudaErrorInvalidValue;") in src
    assert "(route != 0 && route != 1))" in src


def test_softmax_fwd_entry_declares_the_route():
    """``apex_tpu_torch_softmax_fwd``: x, mask, y, rows, sq, sk, ratio,
    scale, causal, the dtype code, the route, the stream."""
    sig = _build._SIGNATURES["apex_tpu_torch_softmax_fwd"]
    assert len(sig) == 12
    assert sig[9] is sig[10] is ctypes.c_int
    assert sig[-1] is ctypes.c_void_p


# ---------------------------------------------------------------------------
# the wrappers' CUDA branch, with the library and the device faked
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Stands in for the kernel library: records each softmax forward call
    with its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name[len("apex_tpu_torch_"):], args))
            return 0
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: ``on_cuda`` says yes, the
    library records its calls, and the plain twins raise. Every launch
    counter is put back afterwards (other tests in the process read
    them)."""
    lib = _FakeLibrary()
    for fn in tk.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain twin")

    for name in ("softmax_fwd_plain", "softmax_bwd_plain"):
        monkeypatch.setattr(tsm, name, refuse)
    return lib


def _hold(lib, routes, *, ratios=None, causal=None):
    """The softmax forwards the library was called for: their routes
    (argument 10), mask ratios (6) and causal flags (8); the stream
    last."""
    calls = lib.calls
    assert [name for name, _ in calls] == ["softmax_fwd"] * len(routes)
    assert [args[10] for _, args in calls] == routes
    assert all(len(args) == 12 and args[-1] == 0 for _, args in calls)
    if ratios is not None:
        assert [args[6] for _, args in calls] == ratios
    if causal is not None:
        assert [args[8] for _, args in calls] == causal


#: the 355M's causal scores and BERT-large's padded ones, batch cut to 1
GPT = (1, 16, 1024, 1024)
BERT = (1, 16, 512, 512)


def _bert_pad():
    pad = torch.zeros(BERT[0], 1, 1, BERT[3], dtype=torch.bool)
    pad[..., 400:] = True
    return pad


def test_softmax_fwd_passes_its_route(fake_cuda):
    """``softmax_fwd``: route 1 at the 355M's causal bf16 rows (code 1),
    route 0 at sk = 17 and on a view one element off its boundary."""
    x = torch.zeros(GPT[1], GPT[2], GPT[3], dtype=torch.bfloat16)
    launches = tk.softmax_fwd.launches
    tk.softmax_fwd(x, None, scale=0.125, causal=True)
    tk.softmax_fwd(torch.zeros(3, 17, 17), None, scale=0.5, causal=True)
    tk.softmax_fwd(_off((2, 64, 64), torch.bfloat16, 1), None, scale=0.5)
    _hold(fake_cuda, [1, 0, 0], causal=[1, 1, 0])
    assert fake_cuda.calls[0][1][9] == _build.DTYPE_CODES[torch.bfloat16]
    assert tk.softmax_fwd.launches == launches + 3


def test_public_functions_pass_route_1(fake_cuda):
    """``scaled_upper_triang_masked_softmax`` on the 355M's bf16 scores and
    ``scaled_masked_softmax`` on BERT-large's fp16 ones (widened to fp32,
    code 0, one mask batch for 16 heads): route 1 both."""
    tk.scaled_upper_triang_masked_softmax(
        torch.zeros(GPT, dtype=torch.bfloat16), scale=0.125)
    tk.scaled_masked_softmax(torch.zeros(BERT, dtype=torch.float16),
                             _bert_pad(), scale=0.125)
    _hold(fake_cuda, [1, 1], ratios=[1, BERT[1]], causal=[1, 0])
    assert fake_cuda.calls[1][1][9] == _build.DTYPE_CODES[torch.float32]


def test_fused_scale_mask_softmax_passes_route_1(fake_cuda):
    """``FusedScaleMaskSoftmax``'s fused path, causal on the 355M's scores
    and padding on BERT-large's, as ``chip_smoke.py`` phase 30 drives it:
    two forwards, route 1 both; its unfused path launches nothing."""
    launches = tk.softmax_fwd.launches
    for kind, x, m in ((AttnMaskType.causal,
                        torch.zeros(GPT, dtype=torch.bfloat16), None),
                       (AttnMaskType.padding,
                        torch.zeros(BERT, dtype=torch.float16), _bert_pad())):
        FusedScaleMaskSoftmax(attn_mask_type=kind, scale=0.125)(x, m)
    _hold(fake_cuda, [1, 1], ratios=[1, BERT[1]], causal=[1, 0])
    assert tk.softmax_fwd.launches == launches + 2
    FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal,
                          scaled_masked_softmax_fusion=False, scale=0.125)(
        torch.zeros(1, 2, 8, 8))
    assert len(fake_cuda.calls) == 2
