"""The port's kernel modules vs the JAX package's Pallas kernels.

``apex_tpu_torch.kernels`` wraps CUDA kernels; on CPU tensors each
wrapper runs its plain PyTorch twin, which is what these tests hold
against the JAX kernels (run in interpret mode on the CPU, as the JAX
package's own tests run them) on the same numpy-seeded inputs. The CUDA
kernels themselves are held against the same plain versions on the card
by ``chip_smoke.py``.

Tolerances: fp32 ``rtol=atol=1e-5`` (both sides fp32, summation order
differs); bf16 inputs compared in fp32 at ``2e-2`` (the outputs are
rounded to bf16, 2^-8 relative, at different points of the two
computations). Cache writes are compared bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.kernels import decode_attention as j_decode_attention
from apex_tpu_torch import kernels as tk
from apex_tpu_torch.kernels import _build

# the module (apex_tpu.kernels re-exports a function of the same name)
jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(t):
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# flash_attention_bsh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s", [(2, 24), (1, 8), (3, 64)])
def test_flash_bsh_plain_matches_jax_kernel(dtype, causal, b, s):
    """out AND lse against ``_run_fwd_bsh`` (the Pallas kernel), at a
    ragged sequence (24 is not a tile multiple), the shortest bucket and
    a full one; hidden 128 = 2 heads of 64 so the JAX side packs g=2."""
    hidden, heads = 128, 2
    rng = np.random.default_rng(b * 100 + s)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal((b, s, hidden)), dtype) for _ in range(3))
    d, g, n_grp = jfa._group_geometry(hidden, heads)
    out_j, lse_j = jfa._run_fwd_bsh(qj, kj, vj, None, None, 1 / d ** 0.5,
                                    causal, d, g, n_grp)
    out_t, lse_t = tk.flash_attention_bsh_fwd(qt, kt, vt, num_heads=heads,
                                              causal=causal)
    assert out_t.dtype == qt.dtype and tuple(lse_t.shape) == (b, heads, s)
    np.testing.assert_allclose(
        _np(out_t), np.asarray(out_j, np.float32), **TOL[dtype])
    # JAX stats are [b * n_grp, g, s]: the same heads in the same order
    np.testing.assert_allclose(
        _np(lse_t), np.asarray(lse_j).reshape(b, heads, s), **TOL["f32"]
        if dtype == "f32" else dict(rtol=1e-3, atol=1e-3))
    # the public entry (what the model calls) is the out half
    pub = tk.flash_attention_bsh(qt, kt, vt, num_heads=heads, causal=causal)
    assert torch.equal(pub, out_t)
    want_pub = jfa.flash_attention_bsh(qj, kj, vj, num_heads=heads,
                                       causal=causal)
    np.testing.assert_allclose(
        _np(pub), np.asarray(want_pub, np.float32), **TOL[dtype])


def test_flash_bsh_pad_rows_stay_finite():
    """Right-padded prompts: rows past the real tokens attend only to
    earlier rows (causality) and stay finite, and the real rows do not
    see the padding."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 128))).float()
               for _ in range(3))
    out, lse = tk.flash_attention_bsh_fwd(q, k, v, num_heads=2, causal=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    k2, v2 = k.clone(), v.clone()
    k2[:, 5:] = 1e4
    v2[:, 5:] = -1e4
    out2, _ = tk.flash_attention_bsh_fwd(q, k2, v2, num_heads=2, causal=True)
    torch.testing.assert_close(out2[:, :5], out[:, :5], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _decode_inputs(dtype, b=4, h=2, S=40, d=64, seed=0):
    rng = np.random.default_rng(seed)
    pairs = [_pair(rng.standard_normal(shp) * 0.5, dtype) for shp in
             ((b, h, d), (b, h, d), (b, h, d), (b, h, S, d), (b, h, S, d))]
    return pairs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_plain_matches_jax_kernel(dtype):
    """Mixed positions (first, mid, chunk edge, last column); columns
    past each row's position hold NaN on both sides and stay masked; the
    written column lands and every other cache byte is unchanged."""
    b, h, S, d = 4, 2, 40, 64
    (qj, qt), (knj, knt), (vnj, vnt), (kcj, kct), (vcj, vct) = \
        _decode_inputs(dtype, b, h, S, d)
    pos = np.asarray([0, 17, 31, 39], np.int32)
    stale = np.arange(S)[None, :] > pos[:, None]                 # [b, S]
    stale4 = stale[:, None, :, None]
    kcj = jnp.where(stale4, jnp.nan, kcj)
    vcj = jnp.where(stale4, jnp.nan, vcj)
    st4 = torch.from_numpy(stale4)
    kct = kct.masked_fill(st4, float("nan"))
    vct = vct.masked_fill(st4, float("nan"))
    k_before, v_before = kct.clone(), vct.clone()

    out_j, kc_j, vc_j = j_decode_attention(qj, knj, vnj, kcj, vcj,
                                           jnp.asarray(pos))
    out_t = tk.decode_attention(qt, knt, vnt, kct, vct, torch.from_numpy(pos))

    assert torch.isfinite(out_t).all()
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j, np.float32),
                               **TOL[dtype])
    col = np.zeros((b, h, S, d), bool)
    col[np.arange(b), :, pos] = True
    for got, before, new, want in ((kct, k_before, knt, kc_j),
                                   (vct, v_before, vnt, vc_j)):
        got_np = _np(got)
        # the written column is exactly the new row
        np.testing.assert_array_equal(got_np[col], _np(new).reshape(-1))
        # every other byte is what it was (NaN included)
        np.testing.assert_array_equal(got_np[~col], _np(before)[~col])
        # and both frameworks agree on the whole cache
        np.testing.assert_array_equal(got_np, np.asarray(want, np.float32))


def test_decode_attention_ignores_stale_garbage():
    """The same query over a cache whose columns past ``pos`` hold huge
    values or NaN gives the same output as over zeros."""
    (_, q), (_, kn), (_, vn), (_, kc), (_, vc) = _decode_inputs("f32")
    pos = torch.tensor([3, 0, 20, 39], dtype=torch.int32)
    tail = (torch.arange(40)[None] > pos[:, None].long())[:, None, :, None]
    outs = []
    for fill in (0.0, 1e30, float("nan")):
        outs.append(tk.decode_attention(
            q, kn, vn, kc.masked_fill(tail, fill), vc.masked_fill(tail, fill),
            pos))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_plain_paths_launch_nothing_and_counts_reset():
    tk.reset_launch_counts()
    (_, q), (_, kn), (_, vn), (_, kc), (_, vc) = _decode_inputs("f32")
    tk.decode_attention(q, kn, vn, kc, vc, torch.zeros(4, dtype=torch.int32))
    x = torch.zeros(1, 8, 128)
    tk.flash_attention_bsh(x, x, x, num_heads=2, causal=True)
    # bf16 takes the tensor-core kernel on the card; on the CPU the plain twin
    xb = x.to(torch.bfloat16)
    assert tk.tc_route(64, xb, xb, xb)
    tk.flash_attention_bsh(xb, xb, xb, num_heads=2, causal=True)
    tk.flash_attention_fwd(xb, xb, xb, causal=True)
    tk.layer_norm(x)
    tk.l2norm_flat([x.reshape(-1)])
    pool = torch.zeros(5, 2, 8, 64)
    table = torch.tensor([[1, 2], [3, 4], [1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([0, 3, 9, 15], dtype=torch.int32)
    tk.paged_write_column(kn, vn, pool, pool.clone(), table, pos)
    tk.paged_attention(q, pool, pool, table, pos)
    new = torch.zeros(4, 2, 3, 64)
    tk.paged_write_columns(new, new, pool, pool.clone(), table, pos)
    tk.cache_write_columns(new, new, kc, vc, pos)
    tk.decode_verify_attention(new, new, new, kc, vc, pos)
    tk.paged_verify_attention(new, new, new, pool, pool.clone(), table, pos)
    kq, ks = tk.quantize_kv_rows(kc, "int8")
    pq, ps = tk.quantize_kv_rows(pool, "fp8")
    tk.decode_attention_quantized(q, kn, vn, kq, ks, kq.clone(), ks.clone(),
                                  pos)
    tk.cache_write_columns_quant(new, new, kq, ks, kq.clone(), ks.clone(),
                                 pos)
    tk.paged_write_column_quant(kn, vn, pq, ps, pq.clone(), ps.clone(),
                                table, pos)
    tk.paged_write_columns_quant(new, new, pq, ps, pq.clone(), ps.clone(),
                                 table, pos)
    tk.paged_attention_quantized(q, pq, ps, pq, ps, table, pos)
    logits, tgt = torch.zeros(3, 300), torch.tensor([0, -100, 299])
    loss, lse = tk.xentropy_fwd(logits, tgt)
    tk.xentropy_bwd(logits, tgt, lse, loss)
    buf = torch.zeros(64)
    tk.sgd_flat([buf], [buf.clone()], [buf.clone()], lr=0.1, momentum=0.9,
                dampening=0.0, weight_decay=0.0)
    hq = torch.zeros(4, 8, 80, requires_grad=True)
    out, lse = tk.flash_attention_fwd(hq, hq, hq, causal=True, n_rep=2)
    torch.autograd.grad(out.sum(), hq)
    delta = torch.zeros(4, 8)
    tk.flash_attention_bwd_dq(hq, hq, hq, hq, lse, delta, causal=True)
    tk.flash_attention_bwd_dkdv(hq, hq, hq, hq, lse, delta, causal=True)
    tk.scale_flat([buf], 0.5)
    tk.axpby_flat(0.5, [buf], 1.0, [buf])
    tk.adagrad_flat([buf], [buf.clone()], [buf.clone()], lr=0.1, eps=1e-10,
                    weight_decay=0.0)
    sx = torch.zeros(2, 4, 4, requires_grad=True)
    torch.autograd.grad(tk.scaled_masked_softmax(sx, causal=True).sum(), sx)
    assert tk.launch_counts() == {"flash_attention_bsh": 0,
                                  "decode_write_column": 0,
                                  "decode_attention": 0,
                                  "flash_attention_bsh_bwd": 0,
                                  "adam_flat": 0,
                                  "layer_norm_fwd": 0,
                                  "layer_norm_bwd": 0,
                                  "l2norm_flat": 0,
                                  "paged_write_column": 0,
                                  "paged_attention": 0,
                                  "cache_write_columns": 0,
                                  "paged_write_columns": 0,
                                  "decode_write_column_quant": 0,
                                  "decode_attention_quant": 0,
                                  "cache_write_columns_quant": 0,
                                  "paged_write_column_quant": 0,
                                  "paged_write_columns_quant": 0,
                                  "paged_attention_quant": 0,
                                  "xentropy_fwd": 0,
                                  "xentropy_bwd": 0,
                                  "sgd_flat": 0,
                                  "flash_attention": 0,
                                  "flash_attention_bwd": 0,
                                  "flash_attention_bwd_dq": 0,
                                  "flash_attention_bwd_dkdv": 0,
                                  "scale_flat": 0,
                                  "axpby_flat": 0,
                                  "adagrad_flat": 0,
                                  "softmax_fwd": 0,
                                  "softmax_bwd": 0,
                                  "decode_attention_write": 0,
                                  "paged_attention_write": 0,
                                  "decode_verify_attention": 0,
                                  "paged_verify_attention": 0,
                                  "flash_attention_bsh_tc": 0,
                                  "flash_attention_tc": 0,
                                  "flash_attention_bsh_bwd_tc": 0,
                                  "flash_attention_bwd_tc": 0,
                                  "flash_attention_bwd_dq_tc": 0,
                                  "flash_attention_bwd_dkdv_tc": 0}
    tk.write_column.launches = 3
    tk.flash_attention_fwd.tc_launches = 2
    tk.reset_launch_counts()
    assert set(tk.launch_counts().values()) == {0}


def test_dispatch_refuses_other_devices():
    """CUDA tensors launch the kernel, CPU tensors take the plain
    version, and anything else (another device type, mixed devices)
    raises instead of silently taking either."""
    meta = torch.empty(1, 8, 128, device="meta")
    cpu = torch.zeros(1, 8, 128)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tk.flash_attention_bsh(meta, meta, meta, num_heads=2)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tk.flash_attention_bsh(cpu, meta, cpu, num_heads=2)
    assert _build.on_cuda(cpu) is False


@pytest.mark.parametrize("bad", ["shape", "pos"])
def test_decode_attention_rejects_bad_geometry(bad):
    (_, q), (_, kn), (_, vn), (_, kc), (_, vc) = _decode_inputs("f32")
    pos = torch.zeros(4, dtype=torch.int32)
    if bad == "shape":
        kc = kc[:, :, :, :32]
    else:
        pos = pos[:3]
    with pytest.raises(ValueError):
        tk.decode_attention(q, kn, vn, kc, vc, pos)


def test_check_positions_host_guard():
    from apex_tpu_torch.kernels.decode_attention import check_positions

    check_positions(torch.tensor([0, 39], dtype=torch.int32), 40)
    with pytest.raises(ValueError):
        check_positions(torch.tensor([0, 40], dtype=torch.int32), 40)
    with pytest.raises(ValueError):
        check_positions(torch.tensor([-1], dtype=torch.int32), 40)


def test_build_dir_is_content_addressed():
    """The build directory is keyed by the sources and flags, under the
    gitignored build/ at the repository root; computing it builds
    nothing."""
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "apex_tpu_torch")
    assert d == _build.build_dir()
    assert {p.name for p in _build._sources()} == {
        "flash_attention_bsh.cu", "decode_attention.cu",
        "flash_attention_bsh_bwd.cu", "flat_ops.cu", "layer_norm.cu",
        "xentropy.cu", "flash_attention.cu", "flash_attention_bwd.cu",
        "softmax.cu", "flash_fwd_tc.cu", "flash_bwd_tc.cu",
        "flash_bwd_dq_tc.cu", "decode_verify.cu",
        # sources that include decode_attention.cu and decode_verify.cu
        # for the instantiations nvcc compiles beside theirs
        "decode_attention_paged.cu", "decode_verify_rows8.cu",
        "decode_verify_paged.cu", "decode_verify_paged_rows8.cu"}
