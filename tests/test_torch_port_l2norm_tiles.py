"""apex_tpu_torch's single-launch global L2 norm (``l2norm_flat``, row 21
of the kernel table) and the by-value scalars of ``axpby_flat`` (row 20),
on the CPU.

Oracles:

- ``l2norm_geometry``, the layout the wrapper hands ``csrc/flat_ops.cu``'s
  ``l2norm_kernel``: every element of every buffer lies in exactly one
  block's range, the ranges of a buffer are contiguous and in order, a
  block's chunk is a whole number of tiles, a buffer's blocks and chunk
  depend on its n and dtype alone, the launches take the buffers in
  list order up to ``_build.L2NORM_MAX_BUFFERS`` each, and the workspace
  holds every word the kernel indexes; the constants agree with the
  CUDA source's;
- with the kernel library and the device faked, so that the wrappers'
  CUDA branch runs here: ``l2norm_flat`` makes one C call a launch of
  the geometry (one a call up to the cap), with the geometry's arrays, a
  workspace of its size and one count in ``l2norm_flat.launches`` a
  call, and raises on a non-zero return; ``axpby_flat`` passes Python
  numbers by value and no device scalars, and 0-d tensors as a device
  buffer;
- ``l2norm_flat`` on CPU buffers (its plain twin) against JAX's
  ``l2norm_flat`` run as the JAX package's own tests run it on the CPU
  (Pallas in interpret mode), at the kernel's tail shapes in fp32, bf16
  and fp16 and in mixed lists, within ``rtol=1e-6`` (fp32 sums of
  squares in two orders over at most 8,196 elements). JAX's kernel
  takes multiples of 128 elements only, so its buffers are padded with
  zeros, which add nothing to a sum of squares (``multi_tensor.pack``
  pads the same way).
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

# the modules (both kernel packages re-export functions of these names)
jflat = importlib.import_module("apex_tpu.kernels.flat_ops")
tflat = importlib.import_module("apex_tpu_torch.kernels.flat_ops")

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
CAP = _build.L2NORM_MAX_BUFFERS


def tile(dtype) -> int:
    """Elements of one tile: ``L2NORM_UNROLL`` 16-byte vectors of each of
    the block's threads."""
    return _build.L2NORM_UNROLL * (16 // dtype.itemsize) \
        * _build.L2NORM_THREADS


def tail_ns(dtype):
    """The tail shapes: n not a multiple of the vector, a range that ends
    mid-tile, a tile +- 4."""
    return (1, 7, 8, 4097, tile(dtype) - 4, tile(dtype) + 4)


# ---------------------------------------------------------------------------
# the geometry
# ---------------------------------------------------------------------------

def _ranges(n, blocks, chunk):
    return [(j * chunk, min((j + 1) * chunk, n)) for j in range(blocks)]


def _hold_buffer(n, dtype, blocks, chunk):
    assert 1 <= blocks <= _build.L2NORM_MAX_BLOCKS
    assert chunk > 0 and chunk % tile(dtype) == 0
    ranges = _ranges(n, blocks, chunk)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2, "ranges not contiguous and in order"
    if n:
        assert all(lo < hi for lo, hi in ranges), "an empty block"
    else:
        assert blocks == 1
    if n <= 1 << 16:              # element by element where it is cheap
        owners = np.zeros(n, np.int64)
        for lo, hi in ranges:
            owners[lo:hi] += 1
        assert (owners == 1).all()


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [0, 1, 7, 8, 4097, 4092, 4100, 8188, 8196,
                               9_000_007, 335_216_640])
def test_geometry_covers_each_element_once(n, dtype):
    """Every element in exactly one non-empty block range, the ranges
    contiguous and in order, whole tiles a block, at most
    ``L2NORM_MAX_BLOCKS`` blocks."""
    geo = tflat.l2norm_geometry([n], [dtype])
    assert geo.launches == ((0, 1),)
    _hold_buffer(n, dtype, geo.blocks[0], geo.chunks[0])


def test_geometry_at_the_bert_group():
    """BERT-large's padded fp32 group: 81,840 tiles dealt 155 a block to
    528 blocks (4 an SM); in bf16 40,920 tiles, 78 a block to 525 blocks,
    the last taking 48."""
    n = 335_216_640
    geo = tflat.l2norm_geometry([n], [F32])
    assert geo.blocks == (528,) and geo.chunks == (155 * 4096,)
    assert geo.words == 1 + 1 + 528
    geo = tflat.l2norm_geometry([n], [BF16])
    assert geo.blocks == (525,) and geo.chunks == (78 * 8192,)
    assert n - (geo.blocks[0] - 1) * geo.chunks[0] == 48 * 8192
    assert geo.words == 1 + 1 + 525


def test_geometry_depends_on_n_and_dtype_alone():
    """A buffer's blocks and chunk are the same alone and in any list."""
    rng = np.random.default_rng(0)
    ns = [int(x) for x in rng.integers(0, 3_000_000, 45)] + [1, 7, 4097]
    dts = [(F32, BF16)[i % 2] for i in range(len(ns))]
    geo = tflat.l2norm_geometry(ns, dts)
    perm = rng.permutation(len(ns))
    shuffled = tflat.l2norm_geometry([ns[i] for i in perm],
                                     [dts[i] for i in perm])
    for k, i in enumerate(perm):
        alone = tflat.l2norm_geometry([ns[i]], [dts[i]])
        assert (geo.blocks[i], geo.chunks[i]) == (alone.blocks[0],
                                                  alone.chunks[0])
        assert (shuffled.blocks[k], shuffled.chunks[k]) == \
            (alone.blocks[0], alone.chunks[0])
        _hold_buffer(ns[i], dts[i], geo.blocks[i], geo.chunks[i])


@pytest.mark.parametrize("groups", [1, 5, CAP, CAP + 1, 2 * CAP + 3])
def test_geometry_launches_and_workspace(groups):
    """The launches take the buffers in list order, at most the cap each;
    the workspace holds the ticket, one sum a buffer and one partial a
    block of the largest launch, and every index the kernel forms lies
    in it: ``ws[0]``, ``ws[1 + first + g]``, ``ws[1 + total + b]``."""
    ns = [1 + 4099 * i for i in range(groups)]
    dts = [(F32, BF16)[i % 3 == 0] for i in range(groups)]
    geo = tflat.l2norm_geometry(ns, dts)
    want = tuple((a, min(a + CAP, groups)) for a in range(0, groups, CAP))
    assert geo.launches == want
    biggest = 0
    for start, stop in geo.launches:
        launch_blocks = sum(geo.blocks[start:stop])
        biggest = max(biggest, launch_blocks)
        assert 1 + (stop - 1) < 1 + groups                 # the sums
        assert 1 + groups + launch_blocks - 1 < geo.words  # the partials
    assert geo.words == 1 + groups + biggest


def test_constants_match_the_cuda_source():
    """``_build``'s geometry constants are ``csrc/flat_ops.cu``'s."""
    src = Path(_build.CSRC_DIR, "flat_ops.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kL2Threads") == _build.L2NORM_THREADS
    assert const("kL2U") == _build.L2NORM_UNROLL
    assert const("kL2BlocksPerSm") * const("kSms") == \
        _build.L2NORM_MAX_BLOCKS
    assert const("kL2MaxBuffers") == _build.L2NORM_MAX_BUFFERS


def test_c_signatures():
    """The L2 norm entry takes five host arrays, three counts, the
    workspace, the output and the stream, and the old ``*_blocks`` query
    is gone; axpby takes a and b as floats after the scalars' pointer."""
    sig = _build._SIGNATURES
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert sig["apex_tpu_torch_l2norm_flat"] == [vp] * 5 + [ci] * 3 + \
        [vp] * 3
    assert "apex_tpu_torch_l2norm_blocks" not in sig
    assert sig["apex_tpu_torch_axpby_flat"] == [
        vp, vp, vp, vp, cf, cf, vp, ctypes.c_longlong, ci, ci, ci, vp]


# ---------------------------------------------------------------------------
# the wrappers' CUDA branch, with the library and the device faked
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
    """The wrappers' CUDA branch on CPU tensors: ``on_cuda`` says yes,
    the library records its calls, every plain twin raises, and every
    ``torch.empty`` is recorded. The launch counters the faked launches
    move are put back afterwards (other tests in the process read
    them)."""
    lib = _FakeLibrary()
    for fn in tk.KERNEL_WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda: 0)

    def refuse(*a, **k):
        raise AssertionError("a CUDA call reached a plain twin")

    for name in dir(tflat):
        if name.endswith("_plain"):
            monkeypatch.setattr(tflat, name, refuse)
    empties = []
    real_empty = torch.empty

    def spy_empty(*size, **kw):
        out = real_empty(*size, **kw)
        empties.append(out)
        return out

    monkeypatch.setattr(torch, "empty", spy_empty)
    lib.empties = empties
    return lib


def _read(ptr, ctype, n):
    return list(ctypes.cast(ptr, ctypes.POINTER(ctype))[:n])


def _buffers(ns, dtypes):
    return [torch.zeros(n, dtype=dt) for n, dt in zip(ns, dtypes)]


@pytest.mark.parametrize("groups", [1, 5, CAP, CAP + 1, 2 * CAP + 3])
def test_l2norm_one_c_call_a_launch(fake_cuda, groups):
    """One C call per launch of the geometry (one a call up to the cap),
    each with its buffers' pointers, counts, dtype codes (fp16 widened
    to fp32), blocks and chunks, its place in the call and one
    workspace of the geometry's size; one launch counted a call."""
    ns = [1 + 4099 * i for i in range(groups)]
    dts = [(F32, BF16, F16)[i % 3] for i in range(groups)]
    bufs = _buffers(ns, dts)
    before = tk.l2norm_flat.launches
    out = tk.l2norm_flat(bufs)
    assert tk.l2norm_flat.launches == before + 1
    assert out.shape == () and out.dtype == torch.float32
    wide = [F32 if dt == F16 else dt for dt in dts]
    geo = tflat.l2norm_geometry(ns, wide)
    calls = fake_cuda.calls
    assert [c[0] for c in calls] == ["l2norm_flat"] * len(geo.launches)
    work = [t for t in fake_cuda.empties if t.data_ptr() == calls[0][1][8]]
    assert len(work) == 1 and work[0].shape == (geo.words,)
    assert work[0].dtype == torch.float32
    for (_, args), (start, stop) in zip(calls, geo.launches):
        k = stop - start
        ptrs, n_arr, codes, blocks, chunks = args[:5]
        assert args[5:8] == (k, start, groups)
        assert args[8] == calls[0][1][8] and args[9] == out.data_ptr()
        assert _read(n_arr, ctypes.c_longlong, k) == ns[start:stop]
        assert _read(codes, ctypes.c_int, k) == [
            _build.DTYPE_CODES[dt] for dt in wide[start:stop]]
        assert _read(blocks, ctypes.c_int, k) == list(geo.blocks[start:stop])
        assert _read(chunks, ctypes.c_longlong, k) == \
            list(geo.chunks[start:stop])
        got_ptrs = _read(ptrs, ctypes.c_void_p, k)
        for i, p in zip(range(start, stop), got_ptrs):
            if dts[i] != F16:     # a widened fp16 buffer is a new tensor
                assert p == bufs[i].data_ptr()


def test_l2norm_raises_on_a_failed_launch(fake_cuda):
    """A non-zero return from the C entry raises, naming the wrapper."""
    fake_cuda.rc = 1
    with pytest.raises(RuntimeError, match="l2norm_flat: CUDA error 1"):
        tk.l2norm_flat([torch.zeros(64)])


def test_l2norm_refuses_what_the_kernel_does_not_take(fake_cuda):
    """A 2-D buffer or a dtype the kernel has no code for raises before
    any C call."""
    with pytest.raises(ValueError, match="shape"):
        tk.l2norm_flat([torch.zeros(4, 16)])
    with pytest.raises(TypeError, match="l2norm_flat buffer 0"):
        tk.l2norm_flat([torch.zeros(64, dtype=torch.float64)])
    assert fake_cuda.calls == []


@pytest.mark.parametrize("a,b", [(0.5, 1.0), (1.0 / 4096, 1.0), (3, -2.5)])
def test_axpby_numbers_go_by_value(fake_cuda, a, b):
    """Python numbers reach the kernel by value: the scalars' pointer is
    null and no device scalar is built; the flag is one bool, returned
    as found_inf without another kernel; one launch a pair."""
    x, y = torch.zeros(64), torch.zeros(64, dtype=BF16)
    before = tk.axpby_flat.launches
    outs, found = tk.axpby_flat(a, [x, x], b, [y, y])
    assert tk.axpby_flat.launches == before + 2
    assert [c[0] for c in fake_cuda.calls] == ["axpby_flat"] * 2
    for _, args in fake_cuda.calls:
        assert args[3] is None
        assert args[4:6] == (float(a), float(b))
        assert args[7:11] == (64, 0, 1, 0)
    flags = [t for t in fake_cuda.empties if t.dtype == torch.bool]
    assert found.dtype == torch.bool and found.shape == ()
    assert all(args[6] == fake_cuda.calls[0][1][6]
               for _, args in fake_cuda.calls)
    assert not flags or all(t.numel() == 1 for t in flags)


def test_axpby_tensor_scalars_stay_on_the_device(fake_cuda):
    """A 0-d tensor a (a schedule's value on the device) goes to the
    kernel as the [a, b] device buffer."""
    x = torch.zeros(64)
    tk.axpby_flat(torch.tensor(0.25), [x], 2.0, [x])
    (_, args), = fake_cuda.calls
    assert args[3] is not None and args[3] != 0


# ---------------------------------------------------------------------------
# the plain path against JAX
# ---------------------------------------------------------------------------

def _pad128(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.zeros(-len(x) % 128, x.dtype)])


def _cases():
    rng = np.random.default_rng(16)
    mk = lambda n, dt: (rng.standard_normal(n) * 0.5).astype(dt)
    cases = {}
    for name, np_dt in (("f32", np.float32), ("bf16", np.float32),
                        ("f16", np.float16)):
        dt = {"f32": F32, "bf16": BF16, "f16": F16}[name]
        for n in tail_ns(F32 if name == "f16" else dt):
            cases[f"{name}-{n}"] = [(mk(n, np_dt), name)]
    cases["mixed"] = [(mk(7, np.float32), "f32"), (mk(4097, np.float32),
                                                   "bf16"),
                      (mk(4100, np.float16), "f16"), (mk(1, np.float32),
                                                      "bf16"),
                      (mk(8196, np.float32), "f32")]
    return cases


CASES = _cases()


def _as_torch(x, name):
    t = torch.from_numpy(x.copy())
    return t.to(BF16) if name == "bf16" else t


def _as_jax(x, name):
    return jnp.asarray(_pad128(x), jnp.bfloat16 if name == "bf16" else None)


@pytest.fixture(scope="module")
def jax_norms():
    """JAX's ``l2norm_flat`` on every case, computed once."""
    return {key: float(jflat.l2norm_flat([_as_jax(x, nm) for x, nm in bufs]))
            for key, bufs in CASES.items()}


@pytest.mark.parametrize("key", sorted(CASES))
def test_l2norm_tails_match_jax(jax_norms, key):
    """The port's ``l2norm_flat`` on CPU buffers within ``rtol=1e-6`` of
    JAX's at the kernel's tail shapes, fp16 widened as JAX widens it."""
    got = tk.l2norm_flat([_as_torch(x, nm) for x, nm in CASES[key]])
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), jax_norms[key], rtol=1e-6)
