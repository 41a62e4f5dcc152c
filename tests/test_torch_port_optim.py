"""The port's optimizer pieces vs the JAX package: flat packing, the
``adam_flat`` kernel's plain twin, ``fused_adam`` in both layouts, and
the loss scaler.

Same numpy-seeded inputs through both frameworks on the CPU; the JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them. The port's CUDA kernel is held against the same plain twin on the
card by ``chip_smoke.py``.

Tolerances: Adam in fp32 agrees to ``rtol=1e-5, atol=1e-6`` per step
(both sides compute the same fp32 expression; pow and the order of
fused operations may differ by an ulp); bf16 params to one bf16 ulp
(``rtol=1e-2``). Packing offsets and scaler sequences are compared
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import multi_tensor as jmt
from apex_tpu.kernels import flat_ops as jflat
from apex_tpu.optimizers import fused_adam as j_fused_adam
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch import amp as tamp
from apex_tpu_torch import multi_tensor as tmt
from apex_tpu_torch.kernels import adam_flat, adam_flat_plain
from apex_tpu_torch.kernels.flat_ops import adam_scalars
from apex_tpu_torch.optimizers import fused_adam as t_fused_adam

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=1e-4)


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tree(seed=0):
    """A small mixed tree: fp32 matrices and vectors, a bf16 leaf, nested
    dicts (JAX orders them by sorted key)."""
    rng = np.random.default_rng(seed)
    return {
        "dense": {"kernel": rng.standard_normal((64, 40)).astype(np.float32),
                  "bias": rng.standard_normal(40).astype(np.float32)},
        "emb": (rng.standard_normal((33, 8)) * 0.1).astype(np.float32),
        "half": rng.standard_normal((17, 5)).astype(np.float32),
    }


def _to_jax(tree, half=True):
    return {k: (_to_jax(v, half) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if half and k == "half"
                            else jnp.float32))
            for k, v in tree.items()}


def _to_torch(tree, half=True):
    return {k: (_to_torch(v, half) if isinstance(v, dict) else
                torch.from_numpy(v).to(torch.bfloat16 if half and k == "half"
                                       else torch.float32))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_pack_layout_matches_jax_and_round_trips():
    tree = _tree()
    jbufs, jl = jmt.pack(_to_jax(tree))
    tbufs, tl = tmt.pack(_to_torch(tree))
    assert tl.group_sizes == jl.group_sizes
    assert tl.group_used == jl.group_used
    assert [str(d).replace("torch.", "") for d in tl.group_dtypes] == [
        jnp.dtype(d).name for d in jl.group_dtypes]
    assert [(m.shape, m.group, m.offset, m.size) for m in tl.leaves] == [
        (m.shape, m.group, m.offset, m.size) for m in jl.leaves]
    assert all(s % (512 * 128) == 0 for s in tl.group_sizes)
    for jb, tb in zip(jbufs, tbufs):
        np.testing.assert_array_equal(_np(tb), np.asarray(jb, np.float32))
    back = tmt.unpack(tbufs, tl)
    for k in ("emb", "half"):
        assert torch.equal(back[k], _to_torch(tree)[k])
        assert back[k].data_ptr() != 0 and back[k]._base is not None
    assert torch.equal(back["dense"]["kernel"],
                       _to_torch(tree)["dense"]["kernel"])
    # fp32 master grads at the params' offsets
    g = tmt.pack_cast(_to_torch(tree), tl)
    jg = jmt.pack_cast(_to_jax(tree), jl)
    assert all(b.dtype == torch.float32 for b in g)
    for jb, tb in zip(jg, g):
        np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    with pytest.raises(ValueError):
        tmt.pack({"a": torch.zeros(3)}, tl)


# ---------------------------------------------------------------------------
# adam_flat
# ---------------------------------------------------------------------------

def _adam_flat_vs_jax(seed, **flags):
    """Two groups (fp32 and bf16 params), grad_scale 0.25, weight decay,
    bias corrections of step 3 — against the interpret-mode Pallas
    sweep."""
    rng = np.random.default_rng(seed)
    n = 2 * 128 * 8
    arrs = [rng.standard_normal(n).astype(np.float32) for _ in range(8)]
    arrs[3] = np.abs(arrs[3])
    arrs[7] = np.abs(arrs[7])
    hp = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              grad_scale=0.25, **flags)
    pj = [jnp.asarray(arrs[0]), jnp.asarray(arrs[4], jnp.bfloat16)]
    gj, mj, vj = ([jnp.asarray(arrs[i]), jnp.asarray(arrs[i + 4])]
                  for i in (1, 2, 3))
    want = jflat.adam_flat(pj, gj, mj, vj, **hp)
    pt = [torch.from_numpy(arrs[0].copy()),
          torch.from_numpy(np.asarray(pj[1], np.float32)).bfloat16()]
    gt, mt_, vt = ([torch.from_numpy(arrs[i].copy()),
                    torch.from_numpy(arrs[i + 4].copy())] for i in (1, 2, 3))
    p_before = [p.clone() for p in pt]
    got = adam_flat(pt, gt, mt_, vt, **hp)
    for wl, gl in zip(want, got):
        np.testing.assert_allclose(_np(gl[0]), np.asarray(wl[0]), **F32)
        np.testing.assert_allclose(_np(gl[1]),
                                   np.asarray(wl[1], np.float32), **BF16)
    # m and v are updated in place; the params too, unless the sweep
    # returns deltas, which go to new fp32 buffers and leave p as it was
    assert got[1][0] is mt_[0] and got[2][1] is vt[1]
    if flags.get("out_is_delta"):
        assert all(torch.equal(p, b) for p, b in zip(pt, p_before))
        assert all(d.dtype == torch.float32 for d in got[0])
    else:
        assert got[0][0] is pt[0]


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("out_is_delta", [False, True])
def test_adam_flat_plain_matches_jax_kernel(adam_w_mode, out_is_delta):
    _adam_flat_vs_jax(int(adam_w_mode) * 2 + int(out_is_delta),
                      adam_w_mode=adam_w_mode, out_is_delta=out_is_delta)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_flat_plain_without_grad_averaging_matches_jax_kernel(
        adam_w_mode):
    """``grad_averaging=False``: m takes the whole gradient, not
    ``(1 - b1)`` of it (NovoGrad/LAMB's option)."""
    _adam_flat_vs_jax(10 + int(adam_w_mode), adam_w_mode=adam_w_mode,
                      grad_averaging=False)


def test_adam_flat_skip_changes_nothing():
    rng = np.random.default_rng(5)
    bufs = [torch.from_numpy(rng.standard_normal(1024).astype(np.float32))
            for _ in range(4)]
    bufs[3] = bufs[3].abs()
    before = [b.clone() for b in bufs]
    adam_flat([bufs[0]], [bufs[1]], [bufs[2]], [bufs[3]], lr=1.0, b1=0.9,
              b2=0.99, eps=1e-8, weight_decay=0.1, bias_correction1=0.1,
              bias_correction2=0.01, skip=torch.tensor(True))
    for b, o in zip(bufs, before):
        assert torch.equal(b, o)
    adam_flat([bufs[0]], [bufs[1]], [bufs[2]], [bufs[3]], lr=1.0, b1=0.9,
              b2=0.99, eps=1e-8, weight_decay=0.1, bias_correction1=0.1,
              bias_correction2=0.01, skip=torch.tensor(False))
    assert not torch.equal(bufs[0], before[0])


def test_adam_flat_plain_takes_device_scalars():
    """Hyperparameters as 0-d tensors (a schedule's lr on the device)
    give the same sweep as Python numbers."""
    rng = np.random.default_rng(6)
    mk = lambda: [torch.from_numpy(np.abs(rng.standard_normal(512)).astype(
        np.float32)) for _ in range(4)]
    a = mk()
    b = [t.clone() for t in a]
    hp = dict(b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
              bias_correction1=0.1, bias_correction2=0.01)
    adam_flat([a[0]], [a[1]], [a[2]], [a[3]], lr=3e-3, **hp)
    s = adam_scalars(torch.tensor(3e-3), 0.9, 0.99, 1e-8, 0.0, 0.1, 0.01,
                     1.0, "cpu")
    adam_flat_plain([b[0]], [b[1]], [b[2]], [b[3]], s)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# fused_adam, both layouts, several steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_adam_runs():
    """Four steps of the JAX fused_adam in each layout on the mixed tree
    (AdamW, weight decay 0.01, lr schedule), params after every step."""
    params0 = _tree(1)
    grads = [_tree(10 + i) for i in range(4)]
    sched = lambda c: 1e-2 / jnp.sqrt(c.astype(jnp.float32))
    out = {}
    for layout in ("flat", "tree"):
        opt = j_fused_adam(sched, weight_decay=0.01, layout=layout)
        p = _to_jax(params0)
        st = opt.init(p)
        step = jax.jit(opt.step)
        traj = []
        for g in grads:
            p, st = step(_to_jax(g), st, p)
            traj.append(jax.tree.map(lambda x: np.asarray(x, np.float32), p))
        out[layout] = (traj, st)
    return params0, grads, out


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_fused_adam_matches_jax_over_steps(jax_adam_runs, layout):
    params0, grads, runs = jax_adam_runs
    traj_j, st_j = runs[layout]
    sched = lambda c: 1e-2 / torch.sqrt(c.float())
    opt = t_fused_adam(sched, weight_decay=0.01, layout=layout)
    p = _to_torch(params0)
    st = opt.init(p)
    for g, want in zip(grads, traj_j):
        p, st = opt.step(_to_torch(g), st, p)
        for k in ("emb", "half"):
            np.testing.assert_allclose(_np(p[k]), want[k],
                                       **(BF16 if k == "half" else F32))
        np.testing.assert_allclose(_np(p["dense"]["kernel"]),
                                   want["dense"]["kernel"], **F32)
    assert int(st.count) == int(st_j.count) == 4
    # moments: flat group buffers, or trees, in the same leaf order
    for mom_t, mom_j in ((st.m, st_j.m), (st.v, st_j.v)):
        got, want = ttree.leaves(mom_t), jax.tree.leaves(mom_j)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(b), **F32)


def test_fused_adam_flat_and_tree_agree():
    """The two layouts compute the same update; the flat one through the
    kernel's plain twin, the tree one leafwise. fp32 params only (a bf16
    leaf's rounding point differs by design)."""
    params0 = _to_torch(_tree(2), half=False)
    res = {}
    for layout in ("flat", "tree"):
        opt = t_fused_adam(3e-3, weight_decay=0.1, adam_w_mode=False,
                           layout=layout)
        p = {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in params0.items()}
        st = opt.init(p)
        for i in range(3):
            p, st = opt.step(_to_torch(_tree(20 + i), half=False), st, p,
                             grad_scale=0.5)
        res[layout] = p
    for k in ("emb", "half"):
        np.testing.assert_allclose(_np(res["flat"][k]), _np(res["tree"][k]),
                                   **F32)
    np.testing.assert_allclose(_np(res["flat"]["dense"]["kernel"]),
                               _np(res["tree"]["dense"]["kernel"]), **F32)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_fused_adam_update_returns_deltas_matching_jax(layout):
    """``update`` (deltas, the params left as they are) against the JAX
    ``update``; on fp32 leaves the params plus the deltas are what
    ``step`` writes."""
    params0, grads = _tree(7), _tree(8)
    jopt = j_fused_adam(1e-2, weight_decay=0.01, layout=layout)
    jp = _to_jax(params0)
    want, _ = jopt.update(_to_jax(grads), jopt.init(jp), jp)
    opt = t_fused_adam(1e-2, weight_decay=0.01, layout=layout)
    p = _to_torch(params0)
    got, st = opt.update(_to_torch(grads), opt.init(p), p)
    assert int(st.count) == 1
    for k in ("emb", "half"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k], np.float32),
                                   **(BF16 if k == "half" else F32))
    np.testing.assert_allclose(_np(got["dense"]["kernel"]),
                               np.asarray(want["dense"]["kernel"]), **F32)
    assert torch.equal(p["emb"], _to_torch(params0)["emb"])
    p2 = _to_torch(params0)
    stepped, _ = opt.step(_to_torch(grads), opt.init(p2), p2)
    torch.testing.assert_close(stepped["emb"], p["emb"] + got["emb"],
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(stepped["dense"]["kernel"],
                               p["dense"]["kernel"] + got["dense"]["kernel"],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_fused_adam_skip_leaves_state_bit_unchanged(layout):
    opt = t_fused_adam(1e-2, layout=layout)
    p = _to_torch(_tree(3))
    st = opt.init(p)
    p, st = opt.step(_to_torch(_tree(4)), st, p)
    snap = [x.clone() for x in ttree.leaves((p, st))]
    p2, st2 = opt.step(_to_torch(_tree(5)), st, p, skip=torch.tensor(True))
    after = ttree.leaves((p2, st2))
    assert len(after) == len(snap)
    for a, b in zip(after, snap):
        assert torch.equal(a, b)
    assert int(st2.count) == 1


# ---------------------------------------------------------------------------
# the loss scaler
# ---------------------------------------------------------------------------

FLAGS = [True, True, False, True, False, False, True, True, True, False,
         True, True, True, True, False, True]


@pytest.mark.parametrize("hysteresis", [1, 2])
def test_scaler_update_sequence_matches_jax(hysteresis):
    kw = dict(init_scale=2.0 ** 10, growth_interval=3, hysteresis=hysteresis,
              max_scale=2.0 ** 11, min_scale=2.0 ** 7, backoff_factor=0.25)
    jcfg, tcfg = jamp.ScalerConfig(**kw), tamp.ScalerConfig(**kw)
    js, ts = jcfg.init(), tcfg.init(device="cpu")
    for f in FLAGS:
        js = jamp.update(jcfg, js, jnp.bool_(f))
        ts = tamp.update(tcfg, ts, torch.tensor(f))
        assert float(ts.loss_scale) == float(js.loss_scale)
        assert int(ts.growth_count) == int(js.growth_count)
        assert int(ts.hysteresis_left) == int(js.hysteresis_left)
        assert ts.growth_count.dtype == torch.int32


def test_update_scale_hysteresis_matches_jax():
    j = (jnp.float32(2.0 ** 125), jnp.int32(0), jnp.int32(2))
    t = (torch.tensor(2.0 ** 125), torch.tensor(0, dtype=torch.int32),
         torch.tensor(2, dtype=torch.int32))
    for f in FLAGS + [True] * 6:
        found_inf = 0 if f else 1
        j = jamp.update_scale_hysteresis(*j, found_inf, growth_interval=2,
                                         hysteresis=2)
        t = tamp.update_scale_hysteresis(*t, found_inf, growth_interval=2,
                                         hysteresis=2)
        assert [float(x) for x in t] == [float(x) for x in j]
    assert not np.isinf(float(t[0]))


def test_scaler_helpers():
    cfg = tamp.ScalerConfig()
    st = cfg.init(device="cpu")
    assert float(st.loss_scale) == 2.0 ** 16
    assert float(tamp.ScalerConfig(enabled=False).init(
        device="cpu").loss_scale) == 1.0
    g = {"a": torch.ones(3, dtype=torch.bfloat16), "n": torch.tensor([1])}
    u = tamp.unscale(g, st)
    assert u["a"].dtype == torch.float32 and float(u["a"][0]) == 2.0 ** -16
    assert u["n"] is g["n"]
    assert bool(tamp.all_finite(g))
    assert not bool(tamp.all_finite({"x": torch.tensor([1.0, float("inf")])}))
    sel = tamp.apply_if_finite({"x": torch.ones(2)}, {"x": torch.zeros(2)},
                               torch.tensor(False))
    assert torch.equal(sel["x"], torch.zeros(2))
    assert float(tamp.scale_loss(torch.tensor(2.0, dtype=torch.bfloat16),
                                 st)) == 2.0 ** 17
