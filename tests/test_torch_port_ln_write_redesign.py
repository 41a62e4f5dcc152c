"""The LayerNorm backward's two routes (row 26 of the kernel table) and the
quantized column writes' row groups (rows 9, 11, 14 and 16), on the CPU.

Oracles:

- ``kernels/layer_norm.py:bwd_route`` and ``bwd_geometry``, the host side
  of ``csrc/layer_norm.cu``'s backward: route 1 exactly at hidden = NC x
  32 x the values of a 16-byte vector for the chunk counts the source
  instantiates, route 0 everywhere else; the partial rows of each route
  from the source's constants (parsed, as
  ``tests/test_torch_port_l2norm_tiles.py`` parses ``flat_ops.cu``'s);
  every row in exactly one warp's stride;
- with the kernel library and the device faked, so that the wrapper's
  CUDA branch runs here: ``layer_norm_bwd`` makes one C call with the
  route and the partial rows of ``bwd_geometry``, a workspace of ``[partial
  rows, 2, hidden]`` fp32, one count in ``layer_norm_bwd.launches``, and
  raises on a non-zero return; every counter the fake moves is put back;
- ``layer_norm_bwd_plain`` (the twin both routes are held against on the
  card) against JAX's ``_bwd`` in interpret mode at route 1's widths 256
  and 1024, in bf16 and fp32, for LayerNorm and RMSNorm, on the same mean
  and rstd. Tolerances: fp32 ``rtol=atol=1e-5`` (the same fp32 formula,
  sums in another order over 8 rows or 1024 columns); bf16 dx ``2e-2``
  (one bf16 ulp, 2^-7, where the fp32 values before rounding differ in
  their last bits: ``tests/test_layer_norm.py``'s band), dw and db fp32
  sums ``1e-5``;
- ``kernels/decode_attention.py:quant_write_geometry``, the quantized
  writes' layout: over the grid ``(b, T, blocks)`` of
  ``kQuantWriteThreads`` threads, every unit of every (b, j, head, K/V)
  row is taken by exactly one lane, at d 32, 64, 80, 100 and 128, h 1, 16
  and 32, T 1 and 4, in fp32, bf16 and fp16; the unit is the widest the
  row's bytes divide into and the group of lanes a power of two.
"""

import ctypes
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import _build

jln = importlib.import_module("apex_tpu.kernels.layer_norm")
tln = importlib.import_module("apex_tpu_torch.kernels.layer_norm")
tdec = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


def _const(src: str, name: str) -> int:
    """``constexpr int name = N;`` or ``= N * kLnSms;`` of a CUDA source."""
    m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\w+))?;", src)
    assert m, name
    return int(m[1]) * (_const(src, m[2]) if m[2] else 1)


LN_SRC = Path(_build.CSRC_DIR, "layer_norm.cu").read_text()
DEC_SRC = Path(_build.CSRC_DIR, "decode_attention.cu").read_text()


# ---------------------------------------------------------------------------
# the LayerNorm backward's route and geometry
# ---------------------------------------------------------------------------

def test_ln_constants_match_the_cuda_source():
    """``_build``'s LayerNorm backward constants are ``layer_norm.cu``'s,
    and the chunk counts route 1 takes are the ones it instantiates."""
    assert _const(LN_SRC, "kLnWarps") == _build.LN_BWD_ROWS_WARPS
    assert _const(LN_SRC, "kLnBwdBlocks") == _build.LN_BWD_ROWS_MAX_BLOCKS
    assert _const(LN_SRC, "kRegWarps") == _build.LN_BWD_REG_WARPS
    assert _const(LN_SRC, "kRegLaneCols") == _build.LN_BWD_REG_LANE_COLS
    assert _const(LN_SRC, "kRegBlocksPerSm") == \
        _build.LN_BWD_REG_BLOCKS_PER_SM
    assert _const(LN_SRC, "kRegBlocksPerSmWide") == \
        _build.LN_BWD_REG_BLOCKS_PER_SM_WIDE
    assert _const(LN_SRC, "kLnSms") == _build.LN_SMS
    built = sorted(int(n) for n in re.findall(r"case (\d+): APEX_LN_REG\(\1\)",
                                              LN_SRC))
    assert tuple(built) == _build.LN_BWD_REG_CHUNKS
    assert max(built) == _const(LN_SRC, "kRegMaxChunks")


@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=["f32", "bf16",
                                                         "f16"])
def test_ln_route_is_one_exactly_at_the_built_widths(dtype):
    """Route 1 at hidden NC x 32 x V (V = 4 fp32, 8 bf16 values a 16-byte
    vector; NC 1, 2, 4, 8): 128..1024 in fp32, 256..2048 in bf16; route 0
    at every other hidden up to 4096, and for fp16 (widened to fp32 before
    the kernel)."""
    v = {F32: 4, BF16: 8}.get(dtype)
    want = {n * 32 * v for n in (1, 2, 4, 8)} if v else set()
    got = {h for h in range(1, 4097) if tln.bwd_route(h, dtype) == 1}
    assert got == want
    assert all(tln.bwd_route(h, dtype) in (0, 1) for h in range(1, 4097))


@pytest.mark.parametrize("rows", [1, 3, 4, 5, 37, 1583, 1584, 1585, 16384])
@pytest.mark.parametrize("hidden,dtype", [(1024, BF16), (1024, F32),
                                          (2048, BF16), (128, F32),
                                          (513, F32), (1000, BF16)])
def test_ln_geometry_and_row_cover(rows, hidden, dtype):
    """Route 1: a block a kRegWarps rows, at most kRegBlocksPerSm x 132
    blocks (kRegBlocksPerSmWide where a lane owns more than 32 columns:
    bf16 at 2048); route 0: a block a kLnWarps rows, at most
    kLnBwdBlocks. Warp w of block k takes rows k W + w, + nblk W, ...:
    every row exactly once."""
    route, nblk = tln.bwd_geometry(rows, hidden, dtype)
    assert route == tln.bwd_route(hidden, dtype)
    if route:
        warps = _build.LN_BWD_REG_WARPS
        per_sm = (_build.LN_BWD_REG_BLOCKS_PER_SM_WIDE
                  if (hidden, dtype) == (2048, BF16)
                  else _build.LN_BWD_REG_BLOCKS_PER_SM)
        cap = per_sm * _build.LN_SMS
    else:
        warps, cap = _build.LN_BWD_ROWS_WARPS, _build.LN_BWD_ROWS_MAX_BLOCKS
    assert nblk == min(-(-rows // warps), cap) >= 1
    owners = np.zeros(rows, np.int64)
    for first in range(nblk * warps):
        owners[first::nblk * warps] += 1
    assert (owners == 1).all()
    # a forced route takes that route's geometry
    assert tln.bwd_geometry(rows, hidden, dtype, route=0) == \
        (0, min(-(-rows // _build.LN_BWD_ROWS_WARPS),
                _build.LN_BWD_ROWS_MAX_BLOCKS))


def test_ln_c_signature():
    """The backward entry takes the route and the partial rows after the
    dtype codes, and the old ``*_bwd_blocks`` query is gone."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    sig = _build._SIGNATURES
    assert sig["apex_tpu_torch_layer_norm_bwd"] == [vp] * 9 + [ci] * 7 + [vp]
    assert "apex_tpu_torch_layer_norm_bwd_blocks" not in sig


# ---------------------------------------------------------------------------
# the backward wrapper's CUDA branch, with the library and the device faked
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """Stands in for the kernel library: records each entry called with
    its arguments, and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def apex_tpu_torch_error_string(self, code):
        return b"invalid argument"

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name[len("apex_tpu_torch_"):], args))
            return self.rc
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: ``on_cuda`` says yes, the
    library records its calls, the plain twin raises, and every
    ``torch.empty`` is recorded. The launch counters are put back
    afterwards (other tests in the process read them)."""
    lib = _FakeLibrary()
    for fn in tk.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached the plain twin")

    monkeypatch.setattr(tln, "layer_norm_bwd_plain", refuse)
    empties = []
    real_empty = torch.empty

    def spy_empty(*size, **kw):
        out = real_empty(*size, **kw)
        empties.append(out)
        return out

    monkeypatch.setattr(torch, "empty", spy_empty)
    lib.empties = empties
    return lib


def _ln_operands(rows, hidden, dtype, w_dtype=F32):
    x = torch.zeros(rows, hidden, dtype=dtype)
    return (x, torch.zeros(hidden, dtype=w_dtype),
            torch.zeros(rows), torch.ones(rows), torch.zeros_like(x))


@pytest.mark.parametrize("rows,hidden,dtype,w_dtype", [
    (64, 1024, BF16, F32), (2000, 1024, BF16, F32), (2000, 1024, F32, F32),
    (9, 2048, BF16, BF16), (37, 513, F32, F32), (5, 96, BF16, F32)])
@pytest.mark.parametrize("sub", [True, False], ids=["ln", "rms"])
def test_ln_bwd_one_c_call_on_its_route(fake_cuda, rows, hidden, dtype,
                                        w_dtype, sub):
    """One C call a backward: the operands' pointers, rows, hidden, the
    statistic, the dtype codes, ``bwd_geometry``'s route and partial rows,
    and the workspace the wrapper allocated, ``[partial rows, 2, hidden]``
    fp32; one count in ``layer_norm_bwd.launches``."""
    x, w, mean, rstd, dy = _ln_operands(rows, hidden, dtype, w_dtype)
    before = tk.layer_norm_bwd.launches
    dx, dw, db = tk.layer_norm_bwd(x, w, mean, rstd, dy, subtract_mean=sub)
    assert tk.layer_norm_bwd.launches == before + 1
    (name, args), = fake_cuda.calls
    assert name == "layer_norm_bwd"
    route, nblk = tln.bwd_geometry(rows, hidden, dtype)
    assert args[9:16] == (rows, hidden, int(sub), _build.DTYPE_CODES[dtype],
                          _build.DTYPE_CODES[w_dtype], route, nblk)
    assert args[:5] == tuple(t.data_ptr() for t in (x, w, mean, rstd, dy))
    work = [t for t in fake_cuda.empties if t.data_ptr() == args[8]]
    assert len(work) == 1 and work[0].shape == (nblk, 2, hidden)
    assert work[0].dtype == F32
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dw.shape == db.shape == (hidden,) and dw.dtype == db.dtype == F32


def test_ln_bwd_raises_on_a_failed_launch(fake_cuda):
    """A non-zero return from the C entry raises, naming the wrapper, and
    counts no launch."""
    fake_cuda.rc = 1
    before = tk.layer_norm_bwd.launches
    with pytest.raises(RuntimeError, match="layer_norm_bwd: CUDA error 1"):
        tk.layer_norm_bwd(*_ln_operands(8, 1024, BF16))
    assert tk.layer_norm_bwd.launches == before


# ---------------------------------------------------------------------------
# the plain twin against JAX's _bwd in interpret mode
# ---------------------------------------------------------------------------

LN_CASES = [(8, 256, "f32"), (8, 1024, "f32"), (8, 256, "bf16"),
            (8, 1024, "bf16")]
JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TD = {"f32": F32, "bf16": BF16}


def _ln_case(rows, hidden, dt):
    """x and dy in ``dt`` (rounded once, as numpy fp32), fp32 w and b."""
    rng = np.random.default_rng(rows * 7919 + hidden)
    rnd = lambda *s: np.array(jnp.asarray(rng.standard_normal(s), JD[dt])
                              .astype(jnp.float32))
    x = rnd(rows, hidden) * 2 + 0.5
    x = np.array(jnp.asarray(x, JD[dt]).astype(jnp.float32))
    return (x, rng.standard_normal(hidden).astype(np.float32),
            rng.standard_normal(hidden).astype(np.float32),
            rnd(rows, hidden))


@pytest.fixture(scope="module")
def jax_bwd():
    """JAX's ``_fwd`` statistics and ``_bwd`` (Pallas in interpret mode)
    for every case and statistic, computed once."""
    out = {}
    for rows, hidden, dt in LN_CASES:
        x, w, b, dy = _ln_case(rows, hidden, dt)
        for sub in (True, False):
            xj, dyj = jnp.asarray(x, JD[dt]), jnp.asarray(dy, JD[dt])
            _, mean, rstd = jln._fwd(xj, jnp.asarray(w), jnp.asarray(b),
                                     1e-5, sub)
            dx, dw, db = jln._bwd(xj, jnp.asarray(w), mean, rstd, dyj, sub)
            out[rows, hidden, dt, sub] = [
                np.array(t, np.float32) for t in (mean[:, 0], rstd[:, 0],
                                                    dx, dw, db)]
    return out


@pytest.mark.parametrize("sub", [True, False], ids=["ln", "rms"])
@pytest.mark.parametrize("rows,hidden,dt", LN_CASES)
def test_ln_bwd_plain_matches_jax(jax_bwd, rows, hidden, dt, sub):
    """dx, dw and db of the plain twin on JAX's mean and rstd against
    JAX's ``_bwd`` (``db`` of RMSNorm included: the kernels compute it,
    the autograd formula replaces it by zeros)."""
    x, w, _, dy = _ln_case(rows, hidden, dt)
    assert tln.bwd_route(hidden, TD[dt]) == 1
    mean, rstd, *want = jax_bwd[rows, hidden, dt, sub]
    got = tln.layer_norm_bwd_plain(
        torch.from_numpy(x).to(TD[dt]), torch.from_numpy(w),
        torch.from_numpy(mean), torch.from_numpy(rstd),
        torch.from_numpy(dy).to(TD[dt]), sub)
    assert got[0].dtype == TD[dt] and got[1].dtype == got[2].dtype == F32
    dx_tol = 1e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(got[0].float().numpy(), want[0], rtol=dx_tol,
                               atol=dx_tol)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w_).max()))


# ---------------------------------------------------------------------------
# the quantized writes' row groups
# ---------------------------------------------------------------------------

def test_quant_write_threads_match_the_cuda_source():
    assert _const(DEC_SRC, "kQuantWriteThreads") == \
        _build.QUANT_WRITE_THREADS


@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=["f32", "bf16",
                                                         "f16"])
@pytest.mark.parametrize("d", [32, 64, 80, 100, 128])
def test_quant_write_groups_cover_every_row_once(d, dtype):
    """Over the grid (b, T, blocks) of QUANT_WRITE_THREADS threads, lane t
    of the group of row r = z * per_block + tid // group takes units t, t +
    group, ... of that row: every unit of every (b, j, head, K/V) row
    exactly once, no lane on a row past 2h; the unit is the widest of 16,
    8, 4, 2 bytes dividing the row, the group the units rounded up to a
    power of two (at most 32)."""
    unit, units, group, per_block, blocks = tdec.quant_write_geometry(
        16, d, dtype)
    row_bytes = d * dtype.itemsize
    assert row_bytes % unit == 0 and units == row_bytes // unit
    assert all(row_bytes % u for u in (16, 8, 4, 2) if u > unit)
    assert group & (group - 1) == 0 and group <= 32
    assert group >= min(units, 32) and (group == 1 or group // 2 < units)
    tid = np.arange(_build.QUANT_WRITE_THREADS)
    for h in (1, 16, 32):
        _, _, g_, per_block, blocks = tdec.quant_write_geometry(h, d, dtype)
        assert per_block * g_ == _build.QUANT_WRITE_THREADS
        for t in (1, 4):
            b = 3
            cover = np.zeros((b, t, 2 * h, units), np.int64)
            for bb in range(b):
                for j in range(t):
                    for z in range(blocks):
                        r = z * per_block + tid // g_
                        lane = tid % g_
                        live = r < 2 * h
                        for k in range(-(-units // g_)):
                            u = lane + k * g_
                            ok = live & (u < units)
                            np.add.at(cover[bb, j], (r[ok], u[ok]), 1)
            assert (cover == 1).all(), (h, t)
            assert blocks == -(-2 * h // per_block)
