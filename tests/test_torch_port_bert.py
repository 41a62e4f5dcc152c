"""The port's BERT slice vs the JAX package: FusedLAMB in both layouts,
the MLM loss and its gradients, and ``make_mlm_train_step`` as a whole.

The JAX side runs as its own tests run it: its Pallas kernels in
interpret mode on the CPU, the train step inside ``jax.shard_map`` over a
one-device tp=1 mesh. The port runs with ``device="cpu"``, where its
kernel wrappers take their plain PyTorch versions. Weights and states
cross as numpy arrays.

The model is BERT cut to vocab 512, hidden 128, 2 layers of 2 heads of
64, seq 64, fp32, batch 2; the MLM batch is drawn as
``examples/bert_pretrain.py`` draws it (``RandomState(0)``: uniform
tokens, ``mlm_mask = rand < 0.15``, ``targets = tokens``).

Tolerances, each with its reason:

- LAMB on a small tree: ``rtol=2e-4, atol=2e-5`` after 3 steps
  (``tests/test_optimizers.py``'s band for the JAX LAMB);
- the MLM loss in fp32: ``rtol=1e-5`` (sums in another order); its
  gradients ``rtol=1e-4`` with ``atol=1e-4`` of the largest entry;
- the train step: losses and grad norms ``rtol=1e-5``; params within
  ``2e-5`` but for at most one in 10^4 (a gradient component near zero
  whose sign the order of sums decides moves its weight the other way,
  by at most ``2 * lr * ratio``; the leaves' trust ratios stay below 2
  here, so within ``4 * lr * steps``); moments ``atol=2e-5``; a skipped
  step bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.amp import ScalerConfig as JScalerConfig
from apex_tpu.models import bert as jbert
from apex_tpu.optimizers import fused_lamb as j_fused_lamb
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch import kernels as tk
from apex_tpu_torch.amp import ScalerConfig as TScalerConfig
from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.models import training as ttraining
from apex_tpu_torch.optimizers import fused_lamb as t_fused_lamb

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=64)
#: run (a) of the card's smoke (every kernel) and run (b) (the example's
#: own choice: tree LAMB, the "xla" LayerNorm in the blocks)
RUNS = {"flat": dict(ln_impl="pallas", attn_impl="flash"),
        "tree": dict(ln_impl="xla", attn_impl="auto")}
BATCH = 2
STEPS = 3
LR = 1e-3


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.fixture(scope="module")
def mesh():
    return mx.build_mesh(tp=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def mlm_batch():
    rng = np.random.RandomState(0)
    tok = rng.randint(0, SMALL["vocab_size"], (BATCH, SMALL["seq_len"]))
    mask = (rng.rand(BATCH, SMALL["seq_len"]) < 0.15).astype(np.int32)
    return tok, tok, mask


def _jcfg(**over):
    return jbert.BertConfig(**{**SMALL, **over}, compute_dtype=jnp.float32)


def _tcfg(**over):
    return tbert.BertConfig(**{**SMALL, **over}, compute_dtype=torch.float32)


def _jax_run(mesh, batch, layout, *, steps=STEPS, scaler=None, **over):
    """``steps`` JAX MLM steps → (initial state as numpy, metrics per
    step, numpy state after every step)."""
    init_fn, step_fn = jbert.make_mlm_train_step(
        _jcfg(**RUNS[layout], **over), mesh, j_fused_lamb(LR, layout=layout),
        scaler or JScalerConfig(enabled=False))
    state = init_fn(jax.random.PRNGKey(0))
    init_np = jax.tree.map(np.asarray, state)
    args = [jnp.asarray(x) for x in batch]
    metrics, states = [], []
    for _ in range(steps):
        state, m = step_fn(state, *args)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, state))
    return init_np, metrics, states


def _port_run(state_np, batch, layout, *, steps=STEPS, scaler=None,
              **over):
    _, step_fn = tbert.make_mlm_train_step(
        _tcfg(**RUNS[layout], **over), t_fused_lamb(LR, layout=layout),
        scaler or TScalerConfig(enabled=False), device="cpu")
    state = ttraining.train_state_from_numpy(state_np, device="cpu")
    args = [torch.as_tensor(np.array(x)) for x in batch]
    metrics, states = [], []
    for _ in range(steps):
        state, m = step_fn(state, *args)
        metrics.append({k: _np(v) for k, v in m.items()})
        states.append(ttraining.train_state_to_numpy(state))
    return metrics, states


@pytest.fixture(scope="module")
def jax_runs(mesh, mlm_batch):
    return {layout: _jax_run(mesh, mlm_batch, layout) for layout in RUNS}


# ---------------------------------------------------------------------------
# FusedLAMB
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    """A stacked [L, ...] leaf like the model's, a matrix, a vector."""
    rng = np.random.default_rng(seed)
    return {"layers": {"w": (rng.standard_normal((3, 8, 16)) * 0.05
                             ).astype(np.float32)},
            "dense": rng.standard_normal((12, 10)).astype(np.float32),
            "bias": rng.standard_normal(10).astype(np.float32)}


def _steps_both(layout, steps=3, seed=0, **kw):
    """``steps`` optimizer steps of JAX's and the port's ``fused_lamb``
    from the same tree and numpy gradients → (JAX params, port params)."""
    p0 = _opt_tree(seed)
    grads = [_opt_tree(100 + i) for i in range(steps)]
    jo, to = j_fused_lamb(**kw, layout=layout), t_fused_lamb(**kw,
                                                             layout=layout)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = ttree.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    js, ts = jo.init(jp), to.init(tp)
    step = jax.jit(lambda g, s, p: jo.step(g, s, p))
    for g in grads:
        jp, js = step(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.step(ttree.tree_map(torch.from_numpy, g), ts, tp)
    return jp, tp, ts


@pytest.mark.parametrize("layout", ["flat", "tree"])
@pytest.mark.parametrize("grad_averaging", [True, False])
def test_fused_lamb_matches_jax(layout, grad_averaging):
    """Three steps with the global clip, weight decay and bias
    correction, through the kernels' plain versions (flat) or leafwise
    (tree)."""
    jp, tp, ts = _steps_both(layout, learning_rate=1e-2, weight_decay=0.01,
                             max_grad_norm=1.0,
                             grad_averaging=grad_averaging)
    for a, b in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    assert int(ts.count) == 3
    opt = t_fused_lamb(layout=layout)
    assert opt.per_leaf_norms == (layout == "tree")


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_lamb_trust_ratio_is_per_stacked_leaf(layout):
    """One trust ratio per stacked ``[L, ...]`` leaf, as in JAX (upstream
    apex has one per layer's tensor): the layers of a leaf whose scales
    differ 100-fold all move by the same ratio. ``update`` returns
    ``-lr * ratio * u``; a numpy NVLAMB with one whole-leaf ratio matches
    it, and one with per-layer ratios does not."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 8, 16)).astype(np.float32)
    w *= np.array([1.0, 10.0, 0.1], np.float32)[:, None, None]
    g = rng.standard_normal((3, 8, 16)).astype(np.float32)
    kw = dict(learning_rate=0.1, weight_decay=0.01, max_grad_norm=None)
    opt = t_fused_lamb(**kw, layout=layout)
    p = {"w": torch.from_numpy(w.copy())}
    upd, _ = opt.update({"w": torch.from_numpy(g)}, opt.init(p), p)
    u = 0.1 * g / (np.sqrt(0.001 * g * g / 0.001) + 1e-6) / 0.1 + 0.01 * w
    whole = np.linalg.norm(w) / np.linalg.norm(u)
    per_layer = (np.linalg.norm(w, axis=(1, 2)) / np.linalg.norm(
        u, axis=(1, 2)))[:, None, None]
    np.testing.assert_allclose(_np(upd["w"]), -0.1 * whole * u, rtol=1e-5,
                               atol=1e-7)
    assert not np.allclose(_np(upd["w"]), -0.1 * per_layer * u, rtol=1e-2)
    jo = j_fused_lamb(**kw, layout=layout)
    jw = {"w": jnp.asarray(w)}
    jupd, _ = jo.update({"w": jnp.asarray(g)}, jo.init(jw), jw)
    np.testing.assert_allclose(_np(upd["w"]), np.asarray(jupd["w"]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_lamb_without_weight_decay_applies_no_trust_ratio(layout):
    """``weight_decay=0`` with ``always_adapt=False`` (apex's
    ``use_nvlamb=False``) is plain Adam with LAMB's eps: the update is
    ``-lr * u`` with no ratio, as JAX's; ``always_adapt=True`` applies
    the ratio, so the steps differ."""
    kw = dict(learning_rate=1e-2, weight_decay=0.0, max_grad_norm=1.0)
    jp, tp, _ = _steps_both(layout, steps=2, seed=5, **kw)
    for a, b in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    p0 = _opt_tree(5)
    g = ttree.tree_map(torch.from_numpy, _opt_tree(100))
    tree = ttree.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    plain = t_fused_lamb(**kw, layout=layout)
    upd, _ = plain.update(g, plain.init(tree), tree)
    # the first step of Adam: u = g / (|g| + eps) after the clip, 1e-2 each
    for a in ttree.leaves(upd):
        assert float(a.abs().max()) <= 1e-2 * (1 + 1e-6)
    adapt = t_fused_lamb(**kw, always_adapt=True, layout=layout)
    upd2, _ = adapt.update(g, adapt.init(tree), tree)
    assert not torch.allclose(upd2["dense"], upd["dense"])


# ---------------------------------------------------------------------------
# the MLM loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ln_impl", ["xla", "pallas"])
def test_mlm_loss_and_gradients_match_jax(mesh, mlm_batch, ln_impl):
    """``bert.mlm_loss`` on the JAX ``bert.init`` weights crossed by
    ``params_from_numpy``, and its gradients (flash attention, the port's
    plain kernels) against ``jax.value_and_grad`` of the JAX loss
    (interpret-mode Pallas LayerNorm and flash)."""
    jcfg = _jcfg(ln_impl=ln_impl, attn_impl="flash")
    params = jbert.init(jcfg, jax.random.PRNGKey(1))
    args = [jnp.asarray(x) for x in mlm_batch]
    val_j, grads_j = jax.jit(jax.shard_map(
        jax.value_and_grad(lambda p, *a: jbert.mlm_loss(jcfg, p, *a)),
        mesh=mesh, in_specs=(jbert.param_specs(jcfg),) + (P(),) * 3,
        out_specs=(P(), jbert.param_specs(jcfg)), check_vma=False))(
            params, *args)
    tcfg = _tcfg(ln_impl=ln_impl, attn_impl="flash")
    tparams = tbert.params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu")
    leaves, spec = ttree.flatten(tparams)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    loss = tbert.mlm_loss(tcfg, ttree.unflatten(spec, diff),
                          *(torch.as_tensor(np.array(x)) for x in mlm_batch))
    grads = torch.autograd.grad(loss, diff)
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=1e-5)
    want = jax.tree.leaves(grads_j)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_bert_params_match_the_jax_tree():
    """``init`` has the JAX tree's names, shapes and leaf order, and
    ``param_count`` is the leaves' total (335.2M at BERT-large)."""
    tcfg = _tcfg()
    tp = tbert.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jbert.init(_jcfg(), jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in ttree.leaves(tp)] == [
        x.shape for x in jax.tree.leaves(jp)]
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == \
        jax.tree.structure(tbert.params_to_numpy(tp))
    assert tcfg.param_count() == sum(x.numel() for x in ttree.leaves(tp))
    assert tbert.BertConfig().param_count() == 335_182_656
    with pytest.raises(ValueError, match="distributed slice"):
        tbert.BertConfig(sequence_parallel=True)
    with pytest.raises(ValueError, match="distributed slice"):
        ttraining.make_loss_train_step(lambda p: p, t_fused_lamb(),
                                       init_params=None, fsdp=True,
                                       device="cpu")


# ---------------------------------------------------------------------------
# the MLM train step
# ---------------------------------------------------------------------------

def _assert_params_close(got, want, steps=STEPS):
    for a, b in zip(ttree.leaves(got), jax.tree.leaves(want)):
        diff = np.abs(a - np.asarray(b, np.float32))
        assert float(diff.max()) <= 4 * LR * steps, float(diff.max())
        assert float((diff > 2e-5).mean()) <= 1e-4


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_mlm_train_step_matches_jax(jax_runs, mlm_batch, layout):
    """Three fp32 MLM steps from the JAX initial state: flat LAMB with
    the LayerNorm kernel in every block and flash attention (the card's
    run (a)), or tree LAMB with the example's defaults (run (b))."""
    init_np, metrics_j, states_j = jax_runs[layout]
    metrics, states = _port_run(init_np, mlm_batch, layout)
    losses = [float(m["loss"]) for m in metrics]
    assert losses[-1] < losses[0]
    for mt, mj in zip(metrics, metrics_j):
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
        assert int(mt["grads_finite"]) == int(mj["grads_finite"]) == 1
    for st, sj in zip(states, states_j):
        _assert_params_close(st.params, sj.params)
        assert int(st.opt_state.count) == int(sj.opt_state.count)
    for a, b in zip(ttree.leaves((states[-1].opt_state.m,
                                  states[-1].opt_state.v)),
                    jax.tree.leaves((states_j[-1].opt_state.m,
                                     states_j[-1].opt_state.v))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_state_bridge_resumes_a_jax_run(jax_runs, mlm_batch, layout):
    """A JAX ``TrainState`` after one step (moments non-zero) crosses into
    the port and back unchanged, field by field; one port step from it
    equals the JAX run's second step."""
    _, metrics_j, states_j = jax_runs[layout]
    st = ttraining.train_state_from_numpy(states_j[0], device="cpu")
    assert type(st.opt_state).__name__ == type(states_j[0].opt_state).__name__
    back = ttraining.train_state_to_numpy(st)
    want = jax.tree.leaves((states_j[0].step, states_j[0].params,
                            states_j[0].opt_state, states_j[0].scaler))
    got = ttree.leaves((back.step, back.params, back.opt_state, back.scaler))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    metrics, states = _port_run(states_j[0], mlm_batch, layout, steps=1)
    np.testing.assert_allclose(metrics[0]["loss"], metrics_j[1]["loss"],
                               rtol=1e-5)
    _assert_params_close(states[0].params, states_j[1].params, steps=1)
    assert int(states[0].step) == 2


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_overflow_step_changes_nothing(mesh, mlm_batch, layout):
    """A dynamic scaler from ``init_scale=inf``: the first step's
    gradients overflow, so the step is skipped, as JAX's is (the same
    ``(grads_finite, loss_scale)``), and params, m, v and the count stay
    bit for bit as they were."""
    kw = dict(init_scale=float("inf"), backoff_factor=2.0 ** -100)
    init_np, metrics_j, _ = _jax_run(mesh, mlm_batch, layout, steps=1,
                                     scaler=JScalerConfig(**kw))
    metrics, states = _port_run(init_np, mlm_batch, layout, steps=1,
                                scaler=TScalerConfig(**kw))
    seq = lambda ms: [(int(m["grads_finite"]), float(m["loss_scale"]))
                      for m in ms]
    assert seq(metrics) == seq(metrics_j) and seq(metrics)[0][0] == 0
    before = ttraining.train_state_to_numpy(
        ttraining.train_state_from_numpy(init_np, device="cpu"))
    after = states[0]
    for a, b in zip(ttree.leaves((after.params, after.opt_state)),
                    ttree.leaves((before.params, before.opt_state))):
        np.testing.assert_array_equal(a, b)
    assert int(after.opt_state.count) == 0 and int(after.step) == 1


def test_run_a_goes_through_every_kernel_wrapper(mlm_batch):
    """One step of run (a) on the CPU calls each wrapper the card's run
    counts: per step, with remat's replay of every block, flash forward
    2L, flash backward L, LayerNorm forward 3 + 2 * 2L, LayerNorm
    backward 3 + 2L, ``l2norm_flat`` and ``adam_flat`` once each. The
    wrappers on the CPU run their plain versions and count nothing, so
    the calls are counted here through the plain functions."""
    fa = importlib.import_module("apex_tpu_torch.kernels.flash_attention")
    ln = importlib.import_module("apex_tpu_torch.kernels.layer_norm")
    fo = importlib.import_module("apex_tpu_torch.kernels.flat_ops")
    names = {(fa, "flash_attention_bsh_plain"): "flash_fwd",
             (fa, "flash_attention_bsh_bwd_plain"): "flash_bwd",
             (ln, "layer_norm_fwd_plain"): "ln_fwd",
             (ln, "layer_norm_bwd_plain"): "ln_bwd",
             (fo, "l2norm_flat_plain"): "l2norm",
             (fo, "adam_flat_plain"): "adam"}
    calls = dict.fromkeys(names.values(), 0)
    mp = pytest.MonkeyPatch()
    for (mod, attr), key in names.items():
        orig = getattr(mod, attr)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)
        mp.setattr(mod, attr, counted)
    try:
        init_fn, step_fn = tbert.make_mlm_train_step(
            _tcfg(**RUNS["flat"]), t_fused_lamb(LR), device="cpu")
        state = init_fn(torch.Generator().manual_seed(0))
        step_fn(state, *(torch.as_tensor(np.array(x)) for x in mlm_batch))
    finally:
        mp.undo()
    L = SMALL["num_layers"]
    assert calls == {"flash_fwd": 2 * L, "flash_bwd": L,
                     "ln_fwd": 3 + 4 * L, "ln_bwd": 3 + 2 * L,
                     "l2norm": 1, "adam": 1}
    assert sum(tk.launch_counts().values()) == 0
