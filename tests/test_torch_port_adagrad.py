"""The port's FusedAdagrad slice vs the JAX package: ``adagrad_flat`` (the
kernel's plain twin against the interpret-mode Pallas kernel),
FusedAdagrad and FusedNovoGrad in both layouts, ``larc_transform``, the
``skip`` no-op flag, the state bridge, a tiny GPT's
``make_train_step`` with FusedAdagrad, and the apex L3 loop that
``chip_smoke.py`` drives on the card (two micro-batches accumulated
through ``MultiTensorApply`` with ``scale_flat`` and ``axpby_flat``,
``clip_grad_norm_``, a flat FusedAdagrad step), composed in both
packages.

Inputs are made with numpy from fixed seeds (the GPT's weights from
JAX's key 0) and cross as numpy arrays; JAX runs on the CPU, its train
step inside ``jax.shard_map`` over a one-device mesh, Pallas in interpret
mode; the port runs with ``device="cpu"``, where its wrappers take the
plain versions.

Tolerances, each with its reason:

- ``adagrad_flat``, FusedAdagrad, FusedNovoGrad and LARC on given
  gradients, fp32: ``rtol=1e-5, atol=1e-6`` (the same fp32 expressions,
  fused multiply-adds and per-leaf norms taken in another order); bf16
  params one bf16 ulp (``rtol=1e-2``); the port's own flat == tree: the
  JAX test's ``rtol=5e-5, atol=5e-6``;
- the GPT step and the L3 loop, fp32, with Adagrad's ``eps`` at 1e-6
  (see ``EPS``): losses ``rtol=1e-5``; params
  within 2e-5 but for at most one weight in 10^4 of the model's, those
  within 2 * lr * steps (Adagrad's first step moves a weight by about lr * sign(g), and
  for a gradient component near zero the order of sums decides the
  sign); the sums of squares ``h`` to ``rtol=1e-4`` of each leaf's
  largest (gradients summed in another order, squared);
- a skipped step: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu import multi_tensor as jmt
from apex_tpu import optimizers as jopt
from apex_tpu.amp import ScalerConfig as JScalerConfig
from apex_tpu.contrib import clip_grad_norm_ as j_clip
from apex_tpu.kernels import flat_ops as jflat
from apex_tpu.models import gpt as jgpt
from apex_tpu.models import training as jtraining
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch import multi_tensor as tmt
from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.amp import ScalerConfig as TScalerConfig
from apex_tpu_torch.contrib import clip_grad_norm_ as t_clip
from apex_tpu_torch.kernels import flat_ops as tflat
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models import training as ttraining

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=1e-4)


def _np(t):
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _to_torch(tree):
    return ttree.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32),
        {k: v for k, v in tree.items()})


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# adagrad_flat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("delta", [False, True])
def test_adagrad_flat_matches_jax(dtype, delta):
    """Two sweeps from h = 0 with weight decay and a grad scale: params
    (or the delta) and h. The port updates p and h in place (a float16
    group is widened and written back); JAX returns new buffers."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16),
              "f16": (jnp.float16, torch.float16)}[dtype]
    rng = np.random.default_rng(0)
    n = 8192
    p0 = (rng.standard_normal(n) * 0.1).astype(np.float32)
    jp = jnp.asarray(p0).astype(jd)
    tp = torch.from_numpy(p0).to(td)
    jh = jnp.zeros(n, jnp.float32)
    th = torch.zeros(n)
    hp = dict(lr=5e-2, eps=1e-10, weight_decay=1e-2, grad_scale=0.5,
              out_is_delta=delta)
    for step in range(2):
        g = (rng.standard_normal(n) * 2).astype(np.float32)
        (jout,), (jh,) = jflat.adagrad_flat([jp], [jnp.asarray(g)], [jh],
                                            **hp)
        (tout,), (th_out,) = tflat.adagrad_flat([tp], [torch.from_numpy(g)],
                                                [th], **hp)
        assert th_out is th
        _close(th, jh, **F32)
        if delta:
            assert tout.dtype == torch.float32
            _close(tout, jout.astype(jnp.float32),
                   **(F32 if dtype == "f32" else BF16))
            assert torch.equal(tp, torch.from_numpy(p0).to(td))
        else:
            assert tout is tp and tp.dtype == td
            _close(tp, jout, **(F32 if dtype == "f32" else BF16))
            jp = jout


# ---------------------------------------------------------------------------
# FusedAdagrad and FusedNovoGrad in both layouts
# ---------------------------------------------------------------------------

def _tree(seed):
    """The JAX tests' ``make_tree`` with a bf16 leaf (a second group)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"w": jax.random.normal(k1, (7, 13)),
            "b": jax.random.normal(k2, (13,)),
            "emb": jax.random.normal(k3, (3, 5)).astype(jnp.bfloat16)}


def _grads(params, seed):
    key = jax.random.PRNGKey(seed)
    return {k: (jax.random.normal(jax.random.fold_in(key, i), v.shape)
                ).astype(v.dtype) for i, (k, v) in
            enumerate(sorted(params.items()))}


def _two_steps(jx, tx, params_j, grads, grad_scale=None):
    """Two ``step`` calls in each package, the second on other grads."""
    js, ts = jx.init(params_j), tx.init(_to_torch(params_j))
    jp, tp = params_j, _to_torch(params_j)
    for g in grads:
        jp, js = jx.step(g, js, jp, grad_scale=grad_scale)
        tp, ts = tx.step(_to_torch(g), ts, tp, grad_scale=grad_scale)
    return (jp, js), (tp, ts)


OPTS = {
    "adagrad": (jopt.fused_adagrad, topt.fused_adagrad,
                dict(learning_rate=5e-2, weight_decay=1e-2)),
    "novograd": (jopt.fused_novograd, topt.fused_novograd,
                 dict(learning_rate=1e-2, weight_decay=1e-3)),
}


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_jax(name, layout):
    jmk, tmk, kw = OPTS[name]
    params = _tree(1)
    (jp, js), (tp, ts) = _two_steps(
        jmk(layout=layout, **kw), tmk(layout=layout, **kw), params,
        [_grads(params, 2), _grads(params, 3)], grad_scale=0.5)
    for k in params:
        assert tp[k].dtype == _to_torch(params)[k].dtype
        _close(tp[k], jp[k], **(BF16 if k == "emb" else F32))
    assert int(ts.count) == int(js.count) == 2
    for a, b in zip(ttree.leaves(ts[1:]), jax.tree.leaves(js[1:])):
        _close(a, b, **F32)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_tree_layout_matches_flat(name):
    """The reference's own ``test_tree_layout_matches_flat``, re-pointed:
    fp32 params, two steps on the same grads, both layouts agree."""
    _, tmk, kw = OPTS[name]
    params = {k: v.astype(jnp.float32) for k, v in _tree(23).items()}
    g = _to_torch(_grads(params, 29))
    out = {}
    for lay in ("flat", "tree"):
        tx = tmk(layout=lay, **{**kw, "learning_rate": 1e-2})
        p = _to_torch(params)
        state = tx.init(p)
        p, state = tx.step(g, state, p)
        p, _ = tx.step(g, state, p)
        out[lay] = p
    for k in params:
        _close(out["flat"][k], _np(out["tree"][k]), rtol=5e-5, atol=5e-6)


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_update_matches_jax(name, layout):
    """``update`` (the optax contract): deltas in the params' dtypes."""
    jmk, tmk, kw = OPTS[name]
    params = _tree(4)
    g = _grads(params, 5)
    jx, tx = jmk(layout=layout, **kw), tmk(layout=layout, **kw)
    ju, _ = jx.update(g, jx.init(params), params)
    tu, _ = tx.update(_to_torch(g), tx.init(_to_torch(params)),
                      _to_torch(params))
    for k in params:
        assert tu[k].dtype == _to_torch(params)[k].dtype
        _close(tu[k], ju[k], **(BF16 if k == "emb" else F32))


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_skip_leaves_everything_unchanged(name, layout):
    """``step(..., skip=True)`` (apex's noop_flag, which the JAX function
    does not have): params, state and count bit for bit; ``skip=False``
    is the plain step."""
    _, tmk, kw = OPTS[name]
    params = _to_torch(_tree(6))
    g = _to_torch(_grads(_tree(6), 7))
    tx = tmk(layout=layout, **kw)
    p1, s1 = tx.step(g, tx.init(params), {k: v.clone() for k, v in
                                           params.items()})
    keep_p = {k: v.clone() for k, v in p1.items()}
    keep_s = [x.clone() for x in ttree.leaves(s1)]
    p2, s2 = tx.step(g, s1, p1, skip=torch.tensor(True))
    for k in params:
        assert torch.equal(p2[k], keep_p[k])
    for a, b in zip(ttree.leaves(s2), keep_s):
        assert torch.equal(a, b)
    p3, s3 = tx.step(g, s2, p2, skip=torch.tensor(False))
    assert int(s3.count) == 2
    assert not torch.equal(p3["w"], keep_p["w"])


@pytest.mark.parametrize("clip", [True, False])
def test_larc_transform_matches_jax(clip):
    """Per-leaf adaptive rates with weight decay; a zero leaf (rate 1)
    and a bf16 gradient that stays bf16."""
    params = _tree(8)
    params["z"] = jnp.zeros((4,), jnp.float32)
    g = _grads(params, 9)
    want = jopt.larc_transform(g, params, learning_rate=0.1, clip=clip,
                               weight_decay=1e-3)
    got = topt.larc_transform(_to_torch(g), _to_torch(params),
                              learning_rate=0.1, clip=clip,
                              weight_decay=1e-3)
    for k in params:
        assert got[k].dtype == _to_torch(g)[k].dtype
        _close(got[k], want[k], **(BF16 if k == "emb" else F32))
    _close(got["z"], g["z"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the tiny GPT: state bridge, make_train_step, the L3 loop
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
            seq_len=32, remat=False, attn_impl="xla")
BATCH, STEPS, LR, S = 4, 2, 1e-2, 2.0 ** 12
#: Adagrad's eps in the model-level checks. At the default 1e-10 a
#: gradient component that is zero in exact arithmetic (the key bias:
#: softmax ignores a shift shared by every key) comes out of each
#: framework as rounding noise of either sign, and Adagrad turns noise of
#: any size into a step of +-lr: 127 of the 384 qkv biases differed by up
#: to 1.8e-3 after one step. At 1e-6 components below about 1e-6, where
#: the two frameworks' fp32 sums disagree in sign, are damped, and the
#: comparison holds the gradients that carry signal.
EPS = 1e-6


@pytest.fixture(scope="module")
def mesh():
    return mx.build_mesh(tp=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def batch():
    tok = np.random.default_rng(11).integers(0, TINY["vocab_size"],
                                             (BATCH, TINY["seq_len"]))
    return tok, np.roll(tok, -1, axis=1)


def _cfgs():
    return (jgpt.GPTConfig(**TINY, compute_dtype=jnp.float32),
            tgpt.GPTConfig(**TINY, compute_dtype=torch.float32))


def _assert_params_close(got, want, steps=STEPS, lr=LR):
    """Every weight within 2e-5 but for at most one in 10^4 of the
    model's (about 11 of its 114k); those within the most Adagrad moves
    a weight in ``steps`` steps."""
    far, total = 0, 0
    for a, b in zip(ttree.leaves(got), jax.tree.leaves(want)):
        diff = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert float(diff.max()) <= 2 * lr * steps, float(diff.max())
        far += int((diff > 2e-5).sum())
        total += diff.size
    assert far <= 1e-4 * total, (far, total)


def _assert_h_close(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=1e-4 * max(float(np.abs(b).max()),
                                                   1e-30))


@pytest.mark.parametrize("opt", ["adagrad_flat", "adagrad_tree",
                                 "novograd_flat", "novograd_tree"])
def test_state_bridge_round_trips(mesh, opt):
    """A JAX ``TrainState`` holding each new optimizer state crosses to
    the port and back unchanged: its type by name, every field."""
    name, layout = opt.split("_")
    jcfg, _ = _cfgs()
    jmk, tmk, kw = OPTS[name]
    init_fn, _ = jtraining.make_train_step(jcfg, mesh, jmk(layout=layout,
                                                           **kw))
    state_np = jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0)))
    ported = ttraining.train_state_from_numpy(state_np, device="cpu")
    assert type(ported.opt_state).__name__ == type(
        state_np.opt_state).__name__
    back = ttraining.train_state_to_numpy(ported)
    for a, b in zip(ttree.leaves(back), jax.tree.leaves(state_np)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32)
                                      if np.asarray(b).dtype.name ==
                                      "bfloat16" else b)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_gpt_train_step_with_adagrad_matches_jax(mesh, batch, layout):
    """The port's ``make_train_step`` with ``fused_adagrad(1e-2)`` — the
    355M trainer's optimizer in phase 31 of the smoke — against the JAX
    step, from bridged weights and state, over two fp32 steps."""
    jcfg, tcfg = _cfgs()
    init_fn, jstep = jtraining.make_train_step(
        jcfg, mesh, jopt.fused_adagrad(LR, eps=EPS, layout=layout),
        JScalerConfig(enabled=False))
    state = init_fn(jax.random.PRNGKey(0))
    tstate = ttraining.train_state_from_numpy(
        jax.tree.map(np.asarray, state), device="cpu")
    _, tstep = ttraining.make_train_step(
        tcfg, topt.fused_adagrad(LR, eps=EPS, layout=layout),
        TScalerConfig(enabled=False), device="cpu")
    tok, tgt = batch
    for _ in range(STEPS):
        state, mj = jstep(state, jnp.asarray(tok), jnp.asarray(tgt))
        tstate, mt = tstep(tstate, torch.as_tensor(tok),
                           torch.as_tensor(tgt))
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
    _assert_params_close(tstate.params, state.params)
    assert int(tstate.opt_state.count) == int(state.opt_state.count) == 2
    _assert_h_close(ttree.leaves(tstate.opt_state.sum_sq),
                    jax.tree.leaves(state.opt_state.sum_sq))


def _jax_l3_step(mesh, jcfg, params, state, tok, tgt, tx):
    """One step of the L3 loop in JAX: two micro-batches' gradients of
    ``loss * S``, unscaled into the accumulator through
    ``MultiTensorApply`` (``scale_flat``, then ``axpby_flat(1/S, g, 1,
    acc)``), clipped to norm 1, then a flat FusedAdagrad step."""
    vg = jax.jit(jax.shard_map(
        jax.value_and_grad(lambda p, t, y: jgpt.loss(jcfg, p, t, y) * S),
        mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P(), P()),
        out_specs=(P(), jgpt.param_specs(jcfg)), check_vma=False))
    mta = jmt.MultiTensorApply()
    acc, losses, found = None, [], False
    half = BATCH // 2
    for i in range(2):
        sl = slice(i * half, (i + 1) * half)
        val, g = vg(params, jnp.asarray(tok[sl]), jnp.asarray(tgt[sl]))
        losses.append(float(val) / S)
        leaves, treedef = jax.tree.flatten(g)
        if acc is None:
            [acc], f = mta(jflat.scale_flat, None, [leaves], 1.0 / S)
        else:
            [acc], f = mta(lambda x, y: jflat.axpby_flat(1.0 / S, x, 1.0, y),
                           None, [leaves, acc])
        found = found or bool(f)
    clipped, norm = j_clip(jax.tree.unflatten(treedef, acc), 1.0)
    params, state = tx.step(clipped, state, params)
    return params, state, losses, found, float(norm)


def _port_l3_step(tcfg, params, state, tok, tgt, tx, poison=False):
    """The same step in the port; the overflow flag becomes ``skip``.
    ``poison`` puts an inf into one gradient leaf of the second
    micro-batch."""
    leaves, spec = ttree.flatten(params)
    mta = tmt.MultiTensorApply()
    acc, losses, found = None, [], None
    half = BATCH // 2
    for i in range(2):
        sl = slice(i * half, (i + 1) * half)
        diff = [x.detach().requires_grad_(True) for x in leaves]
        loss = tgpt.loss(tcfg, ttree.unflatten(spec, diff),
                         torch.as_tensor(tok[sl]), torch.as_tensor(tgt[sl]))
        g = list(torch.autograd.grad(loss * S, diff))
        losses.append(float(loss.detach()))
        if poison and i == 1:
            g[0].view(-1)[3] = float("inf")
        if acc is None:
            [acc], f = mta(tflat.scale_flat, None, [g], 1.0 / S)
        else:
            [acc], f = mta(lambda x, y: tflat.axpby_flat(1.0 / S, x, 1.0, y),
                           None, [g, acc])
        found = f if found is None else found | f
    clipped, norm = t_clip(ttree.unflatten(spec, acc), 1.0)
    params, state = tx.step(clipped, state, params, skip=found)
    return params, state, losses, bool(found), float(norm)


def test_l3_loop_matches_jax(mesh, batch):
    """The apex L3 loop of the smoke's phase 32 at the tiny size: every
    micro-batch's loss, the pre-clip norm, params and h after each of two
    steps against JAX's; then a step with an inf in one gradient is
    flagged and skipped, params and h bit for bit unchanged."""
    jcfg, tcfg = _cfgs()
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    jtx = jopt.fused_adagrad(LR, eps=EPS, layout="flat")
    ttx = topt.fused_adagrad(LR, eps=EPS, layout="flat")
    jstate, tstate = jtx.init(params), ttx.init(tparams)
    tok, tgt = batch
    for _ in range(STEPS):
        params, jstate, jl, jf, jn = _jax_l3_step(mesh, jcfg, params, jstate,
                                                  tok, tgt, jtx)
        tparams, tstate, tl, tf, tn = _port_l3_step(tcfg, tparams, tstate,
                                                    tok, tgt, ttx)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(tn, jn, rtol=1e-5)
        assert tf is jf is False
        assert tn > 1.0            # the clip is active
    _assert_params_close(tparams, params)
    _assert_h_close(tstate.sum_sq, jstate.sum_sq)
    keep_p = [x.clone() for x in ttree.leaves(tparams)]
    keep_h = [x.clone() for x in tstate.sum_sq]
    tparams, tstate, _, found, _ = _port_l3_step(tcfg, tparams, tstate, tok,
                                                 tgt, ttx, poison=True)
    assert found
    assert int(tstate.count) == STEPS
    for a, b in zip(ttree.leaves(tparams), keep_p):
        assert torch.equal(a, b)
    for a, b in zip(tstate.sum_sq, keep_h):
        assert torch.equal(a, b)
