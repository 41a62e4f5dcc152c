"""The port's ResNet slice vs the JAX package: ``sgd_flat`` (the kernel's
plain twin against the interpret-mode Pallas kernel), FusedSGD in both
layouts, local ``sync_batch_norm``, ``normalize_images``, the ResNet
model (forward in training and eval, BN state, loss, gradients) and
``make_train_step`` with the BN statistics riding ``TrainState.extra``.

The model is ResNet-26 (one bottleneck per stage, the JAX tests'
smallest member) with 10 classes on 64x64 images, batch 4, fp32: an even
size, so the stem (2 before, 3 after) and every stride-2 3x3
convolution (0 before, 1 after) take XLA's asymmetric ``"SAME"``
padding. (At 32x32 and batch 2 the last stage's BatchNorm normalises 2
values per channel, where the gradient is ill-conditioned: the two
frameworks' fp32 gradients there differ by up to 60% of a leaf's
largest entry.) JAX runs on the CPU, its train step inside
``jax.shard_map`` over a one-device mesh; the port runs with
``device="cpu"``. Inputs are made with numpy from fixed seeds and cross
as numpy arrays.

Tolerances, each with its reason:

- ``sgd_flat`` and FusedSGD in fp32: ``rtol=1e-5, atol=1e-6`` (the same
  fp32 expression, fused multiply-adds in another order); bf16 params
  one bf16 ulp (``rtol=1e-2``);
- BatchNorm in fp32: ``rtol=atol=1e-5`` (two-pass sums in another
  order); bf16 outputs one ulp;
- the model in fp32: logits ``atol=1e-3`` (fp32 convolutions summed in
  another order by oneDNN and XLA, then divided by small batch standard
  deviations), BN state and loss ``1e-4``, gradients ``atol`` 1e-3 of
  each leaf's largest entry (1e-5 apart here);
- the train step at the example's lr 0.1: losses (2.6 to 0.004 in
  three steps on the repeated batch) and the BN state
  ``rtol=atol=1e-4``; params and momentum within 1e-4 of the farthest
  any leaf moved (see ``_jax_steps`` for the weights it starts from).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import data as jdata
from apex_tpu import mesh as mx
from apex_tpu.amp import ScalerConfig as JScalerConfig
from apex_tpu.kernels import flat_ops as jflat
from apex_tpu.models import resnet as jresnet
from apex_tpu.optimizers import fused_sgd as j_fused_sgd
from apex_tpu.parallel.sync_batchnorm import sync_batch_norm as j_sbn
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch import data as tdata
from apex_tpu_torch import kernels as tk
from apex_tpu_torch.amp import ScalerConfig as TScalerConfig
from apex_tpu_torch.kernels import flat_ops as tflat
from apex_tpu_torch.models import resnet as tresnet
from apex_tpu_torch.models import training as ttraining
from apex_tpu_torch.optimizers import fused_sgd as t_fused_sgd
from apex_tpu_torch.parallel import sync_batch_norm as t_sbn

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=1e-4)
IMAGE, BATCH, CLASSES = 64, 4, 10
SGD = dict(momentum=0.9, weight_decay=1e-4)
LR = 0.1


def _np(t):
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


@pytest.fixture(scope="module")
def mesh():
    return mx.build_mesh(tp=1, devices=jax.devices()[:1])


# ---------------------------------------------------------------------------
# sgd_flat and FusedSGD
# ---------------------------------------------------------------------------

def _bufs(seed, n=4096):
    """A fp32 group and a bf16 group (as the fp32 values it holds)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(n).astype(np.float32) for _ in range(6)]
    arrs[3] = np.asarray(jnp.asarray(arrs[3], jnp.bfloat16).astype(
        jnp.float32))
    return arrs


@pytest.mark.parametrize("first_step", [True, False])
@pytest.mark.parametrize("out_is_delta", [False, True])
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_flat_plain_matches_jax_kernel(nesterov, out_is_delta,
                                           first_step):
    """One sweep over an fp32 and a bf16 group with momentum, weight decay
    and a grad scale, the dampening zeroed as on step 0 or not, Nesterov
    or not, in place or as deltas."""
    p0, g0, m0, p1, g1, m1 = _bufs(int(nesterov) * 4 + int(out_is_delta) * 2
                                   + int(first_step))
    hp = dict(lr=LR, momentum=0.9, weight_decay=1e-4, grad_scale=0.5,
              dampening=0.0 if (first_step or nesterov) else 0.1,
              nesterov=nesterov, out_is_delta=out_is_delta)
    want_p, want_m = jflat.sgd_flat(
        [jnp.asarray(p0), jnp.asarray(p1, jnp.bfloat16)],
        [jnp.asarray(g0), jnp.asarray(g1)], [jnp.asarray(m0),
                                             jnp.asarray(m1)], **hp)
    pt = [torch.from_numpy(p0.copy()), torch.from_numpy(p1.copy()).bfloat16()]
    mt = [torch.from_numpy(m0.copy()), torch.from_numpy(m1.copy())]
    before = [p.clone() for p in pt]
    got_p, got_m = tk.sgd_flat(
        pt, [torch.from_numpy(g0), torch.from_numpy(g1)], mt, **hp)
    np.testing.assert_allclose(_np(got_p[0]), np.asarray(want_p[0]), **F32)
    # bf16 params: JAX returns the new params (or the deltas) in bf16,
    # the port's deltas stay fp32 until the optimizer casts them
    np.testing.assert_allclose(_np(got_p[1]), np.asarray(
        want_p[1], np.float32), **BF16)
    for a, b in zip(got_m, want_m):
        np.testing.assert_allclose(_np(a), np.asarray(b), **F32)
    assert got_m[0] is mt[0]
    if out_is_delta:
        assert all(torch.equal(p, b) for p, b in zip(pt, before))
        assert all(d.dtype == torch.float32 for d in got_p)
    else:
        assert got_p[0] is pt[0] and got_p[1] is pt[1]


def test_sgd_flat_widens_fp16_and_skips():
    """A float16 group is swept in fp32 and written back in float16 (the
    JAX function's ``widen_f16`` and narrow); ``skip`` leaves params and
    momentum bit for bit; the plain path launches nothing."""
    p0, g0, m0 = _bufs(9)[:3]
    hp = dict(lr=LR, momentum=0.9, dampening=0.0, weight_decay=1e-4)
    want_p, want_m = jflat.sgd_flat([jnp.asarray(p0, jnp.float16)],
                                    [jnp.asarray(g0)], [jnp.asarray(m0)],
                                    **hp)
    pt = torch.from_numpy(p0).half()
    mt = torch.from_numpy(m0.copy())
    got_p, got_m = tk.sgd_flat([pt], [torch.from_numpy(g0)], [mt], **hp)
    assert got_p[0] is pt and pt.dtype == torch.float16
    np.testing.assert_allclose(pt.float().numpy(), np.asarray(
        want_p[0], np.float32), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(mt.numpy(), np.asarray(want_m[0]), **F32)
    before = (pt.clone(), mt.clone())
    tk.sgd_flat([pt], [torch.from_numpy(g0)], [mt], **hp,
                skip=torch.tensor(True))
    assert torch.equal(pt, before[0]) and torch.equal(mt, before[1])
    assert tk.launch_counts()["sgd_flat"] == 0


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"conv": (rng.standard_normal((3, 3, 4, 8)) * 0.1
                     ).astype(np.float32),
            "bn": {"scale": rng.standard_normal(8).astype(np.float32)},
            "fc": rng.standard_normal((8, 5)).astype(np.float32)}


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_fused_sgd_matches_jax(layout, nesterov):
    """Three optimizer steps of JAX's and the port's ``fused_sgd`` from the
    same tree and gradients: the first step's zero dampening
    (``damp_eff``), momentum, Nesterov, weight decay; the momentum
    buffers too."""
    kw = dict(learning_rate=LR, momentum=0.9, weight_decay=1e-3,
              dampening=0.0 if nesterov else 0.2, nesterov=nesterov)
    p0 = _opt_tree(0)
    grads = [_opt_tree(10 + i) for i in range(3)]
    jo, to = j_fused_sgd(**kw, layout=layout), t_fused_sgd(**kw,
                                                           layout=layout)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = ttree.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.step(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.step(ttree.tree_map(torch.from_numpy, g), ts, tp)
    for a, b in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **F32)
    for a, b in zip(ttree.leaves(ts.momentum), jax.tree.leaves(js.momentum)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **F32)
    assert int(ts.count) == int(js.count) == 3


def test_fused_sgd_update_skip_and_validation():
    """``update`` returns deltas in the params' dtype that equal the
    step's change; a skipped step leaves params, momentum and the count
    as they were (so the next step is still the first); Nesterov without
    momentum, or with dampening, raises; an unknown layout raises."""
    for layout in ("flat", "tree"):
        opt = t_fused_sgd(LR, momentum=0.9, dampening=0.5, layout=layout)
        p = ttree.tree_map(torch.from_numpy, _opt_tree(1))
        g = ttree.tree_map(torch.from_numpy, _opt_tree(2))
        upd, _ = opt.update(g, opt.init(p), p)
        new, st = opt.step(g, opt.init(p), p)
        for u, a, b in zip(ttree.leaves(upd), ttree.leaves(new),
                           ttree.leaves(p)):
            assert u.dtype == b.dtype
            torch.testing.assert_close(b + u, a, rtol=1e-6, atol=1e-6)
        st0 = opt.init(p)
        kept, st1 = opt.step(g, st0, ttree.tree_map(torch.clone, p),
                             skip=torch.tensor(True))
        assert int(st1.count) == 0
        for a, b in zip(ttree.leaves((kept, st1.momentum)),
                        ttree.leaves((p, st0.momentum))):
            assert torch.equal(a, b)
    for bad in (dict(nesterov=True), dict(nesterov=True, momentum=0.9,
                                          dampening=0.1)):
        with pytest.raises(ValueError, match="nesterov"):
            t_fused_sgd(**bad)
    with pytest.raises(ValueError, match="layout"):
        t_fused_sgd(layout="rows")


# ---------------------------------------------------------------------------
# BatchNorm and the input normalisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("channel_axis", [1, -1])
@pytest.mark.parametrize("training", [True, False])
def test_sync_batch_norm_local_matches_jax(training, channel_axis, dtype):
    """``axis=None``: two-pass batch moments (an offset mean, where the
    one-pass form would cancel), the unbiased running variance, fp32
    output math cast to x's dtype; eval uses the running statistics and
    returns them unchanged."""
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(int(training) * 2 + (channel_axis == 1))
    shape = (3, 6, 5, 4) if channel_axis == 1 else (3, 5, 4, 6)
    x = np.array(jnp.asarray(rng.standard_normal(shape) * 0.5 + 20.0,
                             jd).astype(jnp.float32))
    sc, bi, rm = (rng.standard_normal(6).astype(np.float32)
                  for _ in range(3))
    rv = rng.random(6).astype(np.float32) + 0.5
    kw = dict(momentum=0.1, eps=1e-5, training=training,
              channel_axis=channel_axis)
    yj, rmj, rvj = j_sbn(jnp.asarray(x, jd), jnp.asarray(sc),
                         jnp.asarray(bi), jnp.asarray(rm), jnp.asarray(rv),
                         axis=None, **kw)
    rm_t, rv_t = torch.from_numpy(rm), torch.from_numpy(rv)
    y, rm2, rv2 = t_sbn(torch.from_numpy(x.copy()).to(td),
                        torch.from_numpy(sc),
                        torch.from_numpy(bi), rm_t, rv_t, **kw)
    assert y.dtype == td
    np.testing.assert_allclose(_np(y), np.asarray(yj, np.float32),
                               **(dict(rtol=1e-5, atol=1e-4) if dtype == "f32"
                                  else BF16))
    np.testing.assert_allclose(_np(rm2), np.asarray(rmj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(rv2), np.asarray(rvj), rtol=1e-5,
                               atol=1e-5)
    if not training:
        assert rm2 is rm_t and rv2 is rv_t
    with pytest.raises(ValueError, match="distributed slice"):
        t_sbn(torch.from_numpy(x), None, None, axis="dp")


def test_normalize_images_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (2, 4, 4, 3), np.uint8)
    want = jdata.normalize_images(jnp.asarray(img))
    got = tdata.normalize_images(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert tdata.IMAGENET_MEAN == jdata.IMAGENET_MEAN
    assert tdata.IMAGENET_STD == jdata.IMAGENET_STD


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cfgs(**over):
    kw = dict(depth=26, num_classes=CLASSES, **over)
    return (jresnet.ResNetConfig(**kw, compute_dtype=jnp.float32),
            tresnet.ResNetConfig(**kw, compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def model():
    """JAX's ResNet-26 weights and BN state as numpy, and a batch."""
    jcfg, _ = _cfgs()
    p, s = jresnet.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, BATCH).astype(np.int32)
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), x, y


def test_params_match_the_jax_tree(model):
    """``init`` has the JAX trees' names, shapes and leaf order;
    ``param_count`` is the leaves' total (25,557,032 at ResNet-50); the
    bridge round-trips; SAME padding splits as XLA does; ``bn_axis``
    raises."""
    p_np, s_np, _, _ = model
    _, tcfg = _cfgs()
    tp, ts = tresnet.init(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    for got, want in ((tp, p_np), (ts, s_np)):
        assert [tuple(x.shape) for x in ttree.leaves(got)] == [
            x.shape for x in jax.tree.leaves(want)]
        assert jax.tree.structure(tresnet.params_to_numpy(got)) == \
            jax.tree.structure(want)
    assert tcfg.param_count() == sum(x.numel() for x in ttree.leaves(tp))
    assert tresnet.ResNetConfig().param_count() == 25_557_032
    back = tresnet.params_to_numpy(tresnet.params_from_numpy(p_np,
                                                             device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p_np)):
        np.testing.assert_array_equal(a, b)
    assert tresnet._same_pads(224, 7, 2) == (2, 3)
    assert tresnet._same_pads(56, 3, 2) == (0, 1)
    assert tresnet._same_pads(57, 3, 2) == (1, 1)
    assert tresnet._same_pads(56, 3, 1) == (1, 1)
    assert tresnet._same_pads(56, 1, 2) == (0, 0)
    with pytest.raises(ValueError, match="distributed slice"):
        tresnet.ResNetConfig(bn_axis="dp")
    with pytest.raises(ValueError, match="depth"):
        _ = tresnet.ResNetConfig(depth=34).stages


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(model, training):
    """Logits and the new BN state, in training (batch moments, updated
    running statistics) and in eval (running statistics, returned as
    they were), and the stage feature maps' shapes."""
    p_np, s_np, x, _ = model
    jcfg, tcfg = _cfgs()
    (lj, nsj), feats_j = jax.jit(
        lambda p, s, a: (jresnet.forward(jcfg, p, s, a, training=training),
                         jresnet.features(jcfg, p, s, a,
                                          training=training)[0]))(
        p_np, s_np, x)
    tp = tresnet.params_from_numpy(p_np, device="cpu")
    ts = tresnet.state_from_numpy(s_np, device="cpu")
    lt, nst = tresnet.forward(tcfg, tp, ts, torch.from_numpy(x),
                              training=training)
    feats_t, _ = tresnet.features(tcfg, tp, ts, torch.from_numpy(x),
                                  training=training)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=1e-3)
    for a, b in zip(jax.tree.leaves(tresnet.state_to_numpy(nst)),
                    jax.tree.leaves(nsj)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    assert {k: tuple(v.shape) for k, v in feats_t.items()} == {
        k: v.shape for k, v in feats_j.items()}
    if not training:
        assert all(a is b for a, b in zip(ttree.leaves(nst),
                                          ttree.leaves(ts)))


def test_resnet50_forward_matches_jax():
    """ResNet-50's forward in training mode (its later blocks take the
    identity shortcut, which ResNet-26's single blocks never do): logits
    and the new BN state, fp32, at the model fixture's 64x64 and batch 4.
    (Its fp32 gradients there are not well conditioned, in either
    framework: each is up to 20% of a leaf's largest entry from an fp64
    run, at other leaves.)"""
    jcfg = jresnet.ResNetConfig(depth=50, num_classes=CLASSES,
                                compute_dtype=jnp.float32)
    tcfg = tresnet.ResNetConfig(depth=50, num_classes=CLASSES,
                                compute_dtype=torch.float32)
    p, s = jresnet.init(jcfg, jax.random.PRNGKey(1))
    x = np.random.default_rng(1).standard_normal(
        (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    lj, nsj = jax.jit(lambda p_, s_, a: jresnet.forward(jcfg, p_, s_, a))(
        p, s, x)
    lt, nst = tresnet.forward(
        tcfg, tresnet.params_from_numpy(jax.tree.map(np.asarray, p),
                                        device="cpu"),
        tresnet.state_from_numpy(jax.tree.map(np.asarray, s), device="cpu"),
        torch.from_numpy(x))
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=1e-3)
    for a, b in zip(ttree.leaves(nst), jax.tree.leaves(nsj)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_loss_and_grads_match_jax(model, mesh):
    p_np, s_np, x, y = model
    jcfg, tcfg = _cfgs()
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jresnet.loss(jcfg, p, s_np, x, y), has_aux=True))(p_np)
    tp = tresnet.params_from_numpy(p_np, device="cpu")
    ts = tresnet.state_from_numpy(s_np, device="cpu")
    leaves, spec = ttree.flatten(tp)
    diff = [t.requires_grad_(True) for t in leaves]
    lt, _ = tresnet.loss(tcfg, ttree.unflatten(spec, diff), ts,
                         torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(lt, diff)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    for g, w in zip(grads, jax.tree.leaves(gj)):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-3 * float(np.abs(w).max()))


def _jax_steps(mesh, model, layout):
    """JAX's ``make_train_step`` state, its params and BN state those of
    the ``model`` fixture (``init`` under key 0). The train step's own
    init under key 0 draws other weights, with which one layer-4
    pre-ReLU activation lies 4.6e-7 from the kink: fp32 rounding then
    decides its gate, the port and JAX take different sides (an fp64
    run takes JAX's) and the layer-4 bias gradient moves by 10%. The
    fixture's weights have no such tie; through them the port agrees
    with an fp64 run as closely as JAX does (1e-5)."""
    p_np, s_np, _, _ = model
    jcfg, _ = _cfgs()
    init_fn, step_fn = jresnet.make_train_step(
        jcfg, mesh, j_fused_sgd(LR, **SGD, layout=layout),
        JScalerConfig(enabled=False))
    state = init_fn(jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(jnp.asarray, p_np),
                           extra=jax.tree.map(jnp.asarray, s_np))
    return jax.tree.map(np.asarray, state), step_fn, state


@pytest.fixture(scope="module")
def jax_tree_run(mesh, model):
    _, _, x, y = model
    init_np, step_fn, state = _jax_steps(mesh, model, "tree")
    losses, states = [], []
    for _ in range(3):
        state, m = step_fn(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
        states.append(jax.tree.map(np.asarray, state))
    return init_np, losses, states


def _port_steps(init_np, layout, x, y, steps=3, scaler=None):
    _, tcfg = _cfgs()
    _, step_fn = tresnet.make_train_step(
        tcfg, t_fused_sgd(LR, **SGD, layout=layout),
        scaler or TScalerConfig(enabled=False), device="cpu")
    state = ttraining.train_state_from_numpy(init_np, device="cpu")
    losses, states = [], []
    for _ in range(steps):
        state, m = step_fn(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(m["loss"]))
        states.append(ttraining.train_state_to_numpy(state))
    return losses, states


def _assert_moved_alike(got, want, init):
    """Every leaf within 1e-4 of the farthest any leaf of JAX's run moved
    from ``init`` (0.13 here: 1.3e-5; the runs are 7e-7 apart): a wrong
    update rule misses by the leaf's own movement."""
    want = [np.asarray(b) for b in want]
    moved = max(float(np.abs(b - np.asarray(c)).max())
                for b, c in zip(want, init))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * moved)


def test_train_step_tree_layout_matches_jax(jax_tree_run, model):
    """Three steps of ``make_train_step`` with the example's tree-layout
    FusedSGD from JAX's initial state (params, momentum, BN state crossed
    by ``train_state_from_numpy``): losses, params, momentum and the BN
    state after every step."""
    _, _, x, y = model
    init_np, losses_j, states_j = jax_tree_run
    losses, states = _port_steps(init_np, "tree", x, y)
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4, atol=1e-4)
    for st, sj in zip(states, states_j):
        _assert_moved_alike(ttree.leaves(st.params),
                            jax.tree.leaves(sj.params),
                            jax.tree.leaves(init_np.params))
        for a, b in zip(ttree.leaves(st.extra), jax.tree.leaves(sj.extra)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-4)
        _assert_moved_alike(ttree.leaves(st.opt_state.momentum),
                            jax.tree.leaves(sj.opt_state.momentum),
                            [0.0] * len(ttree.leaves(st.opt_state.momentum)))
        assert int(st.step) == int(sj.step)
        assert int(st.opt_state.count) == int(sj.opt_state.count)


def test_train_step_flat_layout_matches_jax(mesh, model, jax_tree_run):
    """The flat layout (the ``sgd_flat`` kernel's plain twin, once a step)
    against JAX's flat layout (the interpret-mode kernel) over 3 steps,
    and against the port's tree run: the same update in another
    layout."""
    _, _, x, y = model
    init_np, step_fn, state = _jax_steps(mesh, model, "flat")
    losses_j = []
    for _ in range(3):
        state, m = step_fn(state, jnp.asarray(x), jnp.asarray(y))
        losses_j.append(float(m["loss"]))
    calls = []
    orig = tflat.sgd_flat_plain

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(tflat, "sgd_flat_plain", counted)
    try:
        losses, states = _port_steps(init_np, "flat", x, y)
    finally:
        mp.undo()
    assert len(calls) == 3
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4, atol=1e-4)
    _assert_moved_alike(ttree.leaves(states[-1].params),
                        jax.tree.leaves(state.params),
                        jax.tree.leaves(init_np.params))
    _assert_moved_alike(states[-1].opt_state.momentum,
                        state.opt_state.momentum,
                        [0.0] * len(state.opt_state.momentum))
    tree_losses = jax_tree_run[1]
    np.testing.assert_allclose(losses, tree_losses, rtol=1e-4, atol=1e-4)


def test_overflow_step_keeps_bn_state(model):
    """A dynamic scaler from ``init_scale=inf``: the step is skipped, and
    the BN statistics revert with the params (``TrainState.extra``);
    ``init_extra`` also takes a callable, and ``extra_pspecs`` raises."""
    p_np, s_np, x, y = model
    _, tcfg = _cfgs()
    init_fn, step_fn = tresnet.make_train_step(
        tcfg, t_fused_sgd(LR, **SGD, layout="tree"),
        TScalerConfig(init_scale=float("inf")), device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    before = ttraining.train_state_to_numpy(state)
    state, m = step_fn(state, torch.from_numpy(x), torch.from_numpy(y))
    assert int(m["grads_finite"]) == 0
    after = ttraining.train_state_to_numpy(state)
    for a, b in zip(ttree.leaves((after.params, after.extra)),
                    ttree.leaves((before.params, before.extra))):
        np.testing.assert_array_equal(a, b)

    def loss_fn(p, extra, xb):
        return (p["w"] * xb).sum() + extra["n"], {"n": extra["n"] + 1}

    init_fn, step_fn = ttraining.make_loss_train_step(
        loss_fn, t_fused_sgd(LR),
        init_params=lambda g: {"w": torch.ones(3)},
        init_extra=lambda g: {"n": torch.zeros(())}, n_batch_args=1,
        device="cpu")
    state = init_fn(torch.Generator())
    for _ in range(2):
        state, m = step_fn(state, torch.ones(3))
    # the second step's loss: 3 weights of 1 - lr, plus the first n
    assert float(state.extra["n"]) == 2.0
    assert abs(float(m["loss"]) - (3 * (1 - LR) + 1)) < 1e-6
    with pytest.raises(ValueError, match="distributed slice"):
        ttraining.make_loss_train_step(loss_fn, t_fused_sgd(),
                                       init_params=None, extra_pspecs={},
                                       device="cpu")
    with pytest.raises(ValueError, match="init_extra"):
        ttraining.make_loss_train_step(loss_fn, t_fused_sgd(),
                                       init_params=None, init_extra="both",
                                       device="cpu")


def test_uint8_images_are_normalised_in_the_step(model):
    """uint8 batches (the native loader's wire format) are dequantised and
    normalised on the device: the step's loss equals the loss of the
    normalised float batch."""
    _, _, _, y = model
    img = np.random.default_rng(2).integers(0, 256, (BATCH, IMAGE, IMAGE, 3),
                                            np.uint8)
    _, tcfg = _cfgs()
    losses = []
    for batch in (torch.from_numpy(img),
                  tdata.normalize_images(torch.from_numpy(img))):
        init_fn, step_fn = tresnet.make_train_step(
            tcfg, t_fused_sgd(LR, **SGD, layout="tree"), device="cpu")
        state = init_fn(torch.Generator().manual_seed(0))
        _, m = step_fn(state, batch, torch.from_numpy(y))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
