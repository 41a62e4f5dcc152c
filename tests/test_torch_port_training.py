"""The port's training slice vs the JAX package: the flash-attention
backward, the vocab-parallel cross entropy, remat, and the fused GPT
train step as a whole.

The JAX side runs as its own tests run it: its Pallas kernels in
interpret mode on the CPU, the model inside ``jax.shard_map`` over a
one-device tp=1 mesh (``make_train_step``). The port runs with
``device="cpu"``, where its kernel wrappers take their plain PyTorch
versions; the CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py``.

The train-step oracle is the configuration vocab 1024, hidden 256, 4
layers of 4 heads, seq 256, batch 4, ``ce_chunk=128``, flash attention
under ``remat_policy="qkv_fc1_attn"``, ``fused_adam(1e-3,
layout="flat")`` and ``clip_grad_norm=1.0``, in fp32, from the JAX
initial state of key 0 crossed over by ``train_state_from_numpy``. The
batch is bench.py's recipe (``jax.random.randint`` under key 1, targets
rolled by one), handed to both sides as numpy; on it JAX's losses are
6.98074 → 6.43215 → 5.88367.

Tolerances: fp32 losses and grad norms to 1e-5 relative (only the order
of sums differs); params after each Adam step to ``atol=2e-5`` but for at
most one weight in 10^4 (Adam's first steps move a weight by about
lr * sign(g), so a gradient component near zero, whose sign the order of
sums decides, may move its weight the other way; those stay within
2 * lr * steps); scaler sequences exactly; a skipped step bit for bit.
"""

import collections
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu import mesh as mx
from apex_tpu.amp import ScalerConfig as JScalerConfig
from apex_tpu.models import gpt as jgpt
from apex_tpu.models import training as jtraining
from apex_tpu.optimizers import fused_adam as j_fused_adam
from apex_tpu.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy as j_vpce,
)
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch import kernels as tk
from apex_tpu_torch.amp import ScalerConfig as TScalerConfig
from apex_tpu_torch.kernels import flash_attention as tfa
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models import training as ttraining
from apex_tpu_torch.optimizers import fused_adam as t_fused_adam
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy as t_vpce,
)

# the module (apex_tpu.kernels re-exports a function of the same name)
jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

ORACLE = dict(vocab_size=1024, hidden_size=256, num_layers=4, num_heads=4,
              seq_len=256, remat=True, ce_chunk=128, attn_impl="flash",
              remat_policy="qkv_fc1_attn")
JAX_LOSSES = [6.98074, 6.43215, 5.88367]
BATCH = 4
STEPS = 3


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.fixture(scope="module")
def mesh():
    return mx.build_mesh(tp=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def batch():
    tok = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (BATCH, ORACLE["seq_len"]), 0,
        ORACLE["vocab_size"]))
    return tok, np.roll(tok, -1, axis=1)


def _jax_run(mesh, batch, *, layout, steps=STEPS, scaler=None, clip=1.0,
             **over):
    """``steps`` JAX train steps → (initial state as numpy, metrics per
    step as numpy, numpy state after every step)."""
    cfg = jgpt.GPTConfig(**{**ORACLE, **over}, compute_dtype=jnp.float32)
    init_fn, step_fn = jtraining.make_train_step(
        cfg, mesh, j_fused_adam(1e-3, layout=layout),
        scaler or JScalerConfig(enabled=False), clip_grad_norm=clip)
    state = init_fn(jax.random.PRNGKey(0))
    init_np = jax.tree.map(np.asarray, state)
    tok, tgt = (jnp.asarray(x) for x in batch)
    metrics, states = [], []
    for _ in range(steps):
        state, m = step_fn(state, tok, tgt)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, state))
    return init_np, metrics, states


def _port_run(init_np, batch, *, layout, steps=STEPS, scaler=None, clip=1.0,
              **over):
    cfg = tgpt.GPTConfig(**{**ORACLE, **over}, compute_dtype=torch.float32)
    _, step_fn = ttraining.make_train_step(
        cfg, t_fused_adam(1e-3, layout=layout),
        scaler or TScalerConfig(enabled=False), clip_grad_norm=clip,
        device="cpu")
    state = ttraining.train_state_from_numpy(init_np, device="cpu")
    tok, tgt = (torch.as_tensor(np.array(x)) for x in batch)
    metrics, states = [], []
    for _ in range(steps):
        state, m = step_fn(state, tok, tgt)
        metrics.append({k: _np(v) for k, v in m.items()})
        states.append(ttraining.train_state_to_numpy(state))
    return metrics, states


@pytest.fixture(scope="module")
def jax_flat(mesh, batch):
    return _jax_run(mesh, batch, layout="flat")


# ---------------------------------------------------------------------------
# the flash-attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s", [(2, 96), (1, 128)])
def test_flash_backward_matches_jax_vjp(dtype, b, s, causal):
    """dQ/dK/dV through the port's custom op (its autograd calls the
    backward op, here the plain backward) against ``jax.vjp`` of the
    interpret-mode JAX kernel, causal (GPT) and bidirectional (BERT);
    s=96 is not a multiple of the CUDA kernel's 64-row tile. hidden 128 =
    2 heads of 64 (the JAX side packs them into one lane group). bf16: JAX
    rounds P and dS to bf16 before its products, the port keeps them in
    fp32, and every gradient is rounded to bf16: 3e-2 of the largest
    gradient."""
    hidden, heads = 128, 2
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(b * 1000 + s)
    arrs = [np.asarray(jnp.asarray(rng.standard_normal((b, s, hidden)),
                                   jd).astype(jnp.float32))
            for _ in range(4)]
    qj, kj, vj, doj = (jnp.asarray(a, jd) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bsh(
        q, k, v, num_heads=heads, causal=causal), qj, kj, vj)
    want = vjp(doj)
    q, k, v, do = (torch.from_numpy(a.copy()).to(td) for a in arrs)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = tk.flash_attention_bsh(q, k, v, num_heads=heads, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), do)
    for g, w in zip(got, want):
        assert g.dtype == td
        w = np.asarray(w, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=0,
                                       atol=3e-2 * np.abs(w).max())


def test_flash_backward_wrapper_is_the_plain_formula():
    """The backward wrapper (the op the autograd formula calls) equals
    autograd through the plain forward, in fp32, non-causal too: the
    written-out formula and the framework's own derivative agree."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 40, 128))
                                    ).float() for _ in range(4))
    for causal in (True, False):
        qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
        out, lse = tk.flash_attention_bsh_plain(qa, ka, va, num_heads=2,
                                                causal=causal)
        want = torch.autograd.grad(out, (qa, ka, va), do)
        delta = (out.detach() * do).reshape(2, 40, 2, 64).sum(-1)
        got = tk.flash_attention_bsh_bwd(q, k, v, do, lse.detach(),
                                         delta.transpose(1, 2).contiguous(),
                                         num_heads=2, causal=causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def small_model():
    """A 2-layer fp32 model and a batch, for the model-level checks."""
    cfg = tgpt.GPTConfig(vocab_size=128, hidden_size=128, num_layers=2,
                         num_heads=2, seq_len=32, ce_chunk=16,
                         compute_dtype=torch.float32, remat=False)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, 128, (2, 32)))
    return cfg, params, tok, torch.roll(tok, -1, 1)


def _grads(cfg, params, tok, tgt):
    leaves, spec = ttree.flatten(params)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    loss = tgpt.loss(cfg, ttree.unflatten(spec, diff), tok, tgt)
    return loss, torch.autograd.grad(loss, diff)


def test_flash_path_gradients_equal_xla_path(small_model):
    """The repair of the detached flash output: gradients of the loss
    through ``attn_impl="flash"`` (the custom ops) equal those through
    the materialised-scores ``"xla"`` path, and the flash path calls the
    forward op once per layer and the backward op once per layer — the
    ops whose CUDA bodies are the kernels."""
    cfg, params, tok, tgt = small_model
    log = _OpLog()
    with log:
        lf, gf = _grads(dataclasses.replace(cfg, attn_impl="flash"), params,
                        tok, tgt)
    lx, gx = _grads(dataclasses.replace(cfg, attn_impl="xla"), params, tok,
                    tgt)
    torch.testing.assert_close(lf, lx, rtol=1e-6, atol=1e-6)
    for a, b in zip(gf, gx):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert log.ops.count(tfa.FLASH_FWD_OP) == cfg.num_layers
    bwd = torch.ops.apex_tpu_torch.flash_attention_bsh_bwd.default
    assert log.ops.count(bwd) == cfg.num_layers
    assert any(float(g.abs().max()) > 0 for g in gf)


@pytest.mark.parametrize("remat,policy,fwd_calls", [
    (False, None, 1), (True, None, 2), (True, "qkv_fc1_attn", 1),
    (True, "fc1_attn", 1), (True, "dots", 2), (True, "qkv_fc1", 2)])
def test_remat_policies_give_identical_gradients(small_model, monkeypatch,
                                                 remat, policy, fwd_calls):
    """Every remat choice computes the same gradients, bit for bit on the
    CPU; the forward attention runs once per layer unless the policy
    lets the backward replay it (None, and the policies that do not pin
    the flash outputs, as in JAX)."""
    cfg, params, tok, tgt = small_model
    calls = []
    plain = tfa.flash_attention_bsh_plain
    monkeypatch.setattr(tfa, "flash_attention_bsh_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    base = dataclasses.replace(cfg, attn_impl="flash")
    _, want = _grads(base, params, tok, tgt)
    calls.clear()
    loss, got = _grads(dataclasses.replace(
        base, remat=remat, remat_policy=policy), params, tok, tgt)
    assert len(calls) == fwd_calls * cfg.num_layers
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _MmLog(TorchDispatchMode):
    """Every ``aten.mm`` whose right operand is a view of one of
    ``leaves``, keyed by (leaf index, element offset, strides): which
    weight slab, and whether as the weight (a forward matmul) or its
    transpose (a gradient matmul)."""

    def __init__(self, leaves):
        super().__init__()
        self.leaves = leaves
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            w = args[1]
            ptr = w.untyped_storage().data_ptr()
            for i, leaf in enumerate(self.leaves):
                if leaf.untyped_storage().data_ptr() == ptr:
                    off = (w.data_ptr() - leaf.data_ptr()) // w.element_size()
                    self.seen[(i, off, w.stride())] += 1
        return func(*args, **(kwargs or {}))


def _backward_mms(cfg, params, tok, tgt):
    leaves, spec = ttree.flatten(params)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    loss = tgpt.loss(cfg, ttree.unflatten(spec, diff), tok, tgt)
    log = _MmLog(diff)
    with log:
        torch.autograd.grad(loss, diff)
    return log.seen


@pytest.mark.parametrize("policy,ffn", [
    ("qkv_fc1_attn", None), ("fc1_attn", None), ("qkv_fc1", None),
    ("qkv_fc1_attn", 128)])
def test_remat_policy_saves_the_named_matmuls(small_model, policy, ffn):
    """The matmuls the backward replays under a policy are those that
    ``remat_policy=None`` replays less exactly the QKV slab and fc1
    matmuls the policy saves, one of each per layer, counted by their
    weight operand; ``ffn == hidden`` (128) too."""
    cfg, params, tok, tgt = small_model
    saved = policy.split("_")
    base = dataclasses.replace(cfg, attn_impl="flash", remat=True,
                               ffn_hidden_size=ffn)
    if ffn is not None:
        params = tgpt.init(base, torch.Generator().manual_seed(0),
                           device="cpu")
    full = _backward_mms(base, params, tok, tgt)
    sel = _backward_mms(dataclasses.replace(base, remat_policy=policy),
                        params, tok, tgt)
    lay = params["layers"]
    idx = {id(t): i for i, t in enumerate(ttree.leaves(params))}
    h, f = base.hidden_size, base.ffn
    want = collections.Counter()
    for l in range(base.num_layers):
        if "qkv" in saved:
            for j in range(3):
                want[(idx[id(lay["attn"]["qkv"]["kernel"])],
                      l * h * 3 * h + j * h, (3 * h, 1))] += 1
        if "fc1" in saved:
            want[(idx[id(lay["mlp"]["fc1"]["kernel"])], l * h * f,
                  (f, 1))] += 1
    assert full - sel == want
    assert not sel - full


def test_remat_policy_validation():
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=64, num_layers=1,
                         num_heads=1, seq_len=16, remat_policy="qkv_fc1_attn",
                         attn_impl="xla")
    with pytest.raises(ValueError, match="requires attn_impl='flash'"):
        tgpt._remat_policy(cfg)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tgpt._remat_policy(dataclasses.replace(cfg, remat_policy="nope"))
    # fc1 is named where it is issued, not told apart by its weight's
    # shape, so ffn == hidden is accepted
    assert callable(tgpt._remat_policy(dataclasses.replace(
        cfg, attn_impl="flash", ffn_hidden_size=64)))
    with pytest.raises(ValueError, match="xentropy"):
        tgpt.GPTConfig(ce_impl="fused")
    with pytest.raises(ValueError, match="distributed slice"):
        ttraining.make_train_step(
            dataclasses.replace(cfg, remat_policy=None), t_fused_adam(),
            n_chunks=2, device="cpu")
    assert tgpt.GPTConfig().param_count() == jgpt.GPTConfig().param_count()


# ---------------------------------------------------------------------------
# vocab-parallel cross entropy at tp=1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(mesh, label_smoothing):
    """Per-token loss and the gradient of a weighted sum of it, against
    the JAX ``vocab_parallel_cross_entropy`` on a 1-device tp mesh;
    fp32, ``rtol=atol=1e-5``."""
    rng = np.random.default_rng(int(label_smoothing * 10))
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    target = rng.integers(0, 50, (3, 7))
    w = rng.standard_normal((3, 7)).astype(np.float32)

    def jloss(lg, tg, wt):
        return jnp.sum(j_vpce(lg, tg, label_smoothing, "tp") * wt)

    val_j, grad_j = jax.jit(jax.shard_map(
        jax.value_and_grad(jloss), mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(), P()), check_vma=False))(logits, target, w)
    per_tok_j = jax.jit(jax.shard_map(
        lambda lg, tg: j_vpce(lg, tg, label_smoothing, "tp"), mesh=mesh,
        in_specs=(P(), P()), out_specs=P(), check_vma=False))(logits, target)
    lg = torch.from_numpy(logits).requires_grad_(True)
    per_tok = t_vpce(lg, torch.from_numpy(target), label_smoothing)
    (grad,) = torch.autograd.grad((per_tok * torch.from_numpy(w)).sum(), lg)
    np.testing.assert_allclose(_np(per_tok), np.asarray(per_tok_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float((per_tok.detach() * w).sum()),
                               float(val_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(grad), np.asarray(grad_j), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the train step as a whole
# ---------------------------------------------------------------------------

def _assert_params_close(got_params, want_params, steps=STEPS, lr=1e-3):
    """Every weight within 2e-5 but for at most one in 10^4; those (a
    gradient component near zero whose sign the order of sums decides)
    within the most that Adam can move a weight in ``steps`` steps."""
    for a, b in zip(ttree.leaves(got_params), jax.tree.leaves(want_params)):
        diff = np.abs(a - np.asarray(b, np.float32))
        assert float(diff.max()) <= 2 * lr * steps, float(diff.max())
        assert float((diff > 2e-5).mean()) <= 1e-4


def test_train_step_matches_jax(jax_flat, batch):
    """Three fp32 steps, flat Adam through the kernel's plain twin,
    flash under ``qkv_fc1_attn``, global-norm clip: losses and grad norms
    to 1e-5 relative, params after each step to 2e-5, the flat moment
    buffers likewise."""
    init_np, metrics_j, states_j = jax_flat
    np.testing.assert_allclose([float(m["loss"]) for m in metrics_j],
                               JAX_LOSSES, rtol=1e-5)
    metrics, states = _port_run(init_np, batch, layout="flat")
    for mt, mj in zip(metrics, metrics_j):
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"],
                                   rtol=1e-5)
        assert int(mt["grads_finite"]) == int(mj["grads_finite"]) == 1
        assert float(mt["loss_scale"]) == float(mj["loss_scale"]) == 1.0
    for st, sj in zip(states, states_j):
        _assert_params_close(st.params, sj.params)
        assert int(st.step) == int(sj.step)
        assert int(st.opt_state.count) == int(sj.opt_state.count)
    for a, b in zip(states[-1].opt_state.m + states[-1].opt_state.v,
                    states_j[-1].opt_state.m + states_j[-1].opt_state.v):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)


def test_train_step_tree_layout_xla_attention_matches_jax(mesh, batch):
    """The bench's own optimizer layout (tree, leafwise) with the
    materialised-scores attention under ``remat_policy="qkv_fc1"``."""
    over = dict(attn_impl="xla", remat_policy="qkv_fc1")
    init_np, metrics_j, states_j = _jax_run(mesh, batch, layout="tree",
                                            **over)
    metrics, states = _port_run(init_np, batch, layout="tree", **over)
    for mt, mj in zip(metrics, metrics_j):
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"],
                                   rtol=1e-5)
    _assert_params_close(states[-1].params, states_j[-1].params)
    for a, b in zip(ttree.leaves(states[-1].opt_state.v),
                    jax.tree.leaves(states_j[-1].opt_state.v)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)


@pytest.mark.parametrize("init_scale,first", [
    (2.0 ** 127, (1, 2.0 ** 127)), (float("inf"), (0, 2.0 ** 24))])
def test_scaler_in_the_step_matches_jax(mesh, batch, init_scale, first):
    """Dynamic loss scaling, ``backoff_factor=2^-100``,
    ``growth_interval=2``: ``(grads_finite, loss_scale)`` over three steps
    must be JAX's exactly. From 2^127 the scaled loss is inf but the
    gradients stay finite in both frameworks (the backward's seed is the
    finite scale, and no gradient grows 2^10 times past it), so nothing
    is skipped and growth past fp32 clamps to max_scale 2^24. From an
    infinite scale the gradients overflow: the first step is skipped,
    must leave params and optimizer state bit for bit as they were, and
    the scale backs off (clamped to 2^24)."""
    kw = dict(init_scale=init_scale, backoff_factor=2.0 ** -100,
              growth_interval=2)
    init_np, metrics_j, _ = _jax_run(mesh, batch, layout="flat", steps=3,
                                     scaler=JScalerConfig(**kw), clip=None)
    metrics, states = _port_run(init_np, batch, layout="flat", steps=3,
                                scaler=TScalerConfig(**kw), clip=None)
    seq = lambda ms: [(int(m["grads_finite"]), float(m["loss_scale"]))
                      for m in ms]
    assert seq(metrics) == seq(metrics_j)
    assert seq(metrics)[0] == first
    before = ttraining.train_state_to_numpy(
        ttraining.train_state_from_numpy(init_np, device="cpu"))
    after = states[0]
    same = [np.array_equal(a, b) for a, b in zip(
        ttree.leaves((after.params, after.opt_state)),
        ttree.leaves((before.params, before.opt_state)))]
    assert all(same) if first[0] == 0 else not any(same)
    assert int(after.step) == 1


def test_micro_batches_accumulate_the_same_gradient(jax_flat, batch):
    """``n_micro=2`` (two sequential halves, each replayed in the
    backward) takes the same step as the whole batch at once."""
    init_np = jax_flat[0]
    cfg = tgpt.GPTConfig(**ORACLE, compute_dtype=torch.float32)
    tok, tgt = (torch.as_tensor(np.array(x)) for x in batch)
    out = []
    for n_micro in (1, 2):
        _, step_fn = ttraining.make_train_step(
            cfg, t_fused_adam(1e-3), n_micro=n_micro, clip_grad_norm=1.0,
            device="cpu")
        st = ttraining.train_state_from_numpy(init_np, device="cpu")
        st, m = step_fn(st, tok, tgt)
        out.append((m, ttraining.train_state_to_numpy(st)))
    (m1, s1), (m2, s2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for a, b in zip(ttree.leaves(s2.params), ttree.leaves(s1.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def test_train_state_crosses_both_ways(jax_flat):
    """JAX state → port → numpy keeps every field and value; the numpy
    form has the JAX TrainState's field names and leaf order."""
    init_np = jax_flat[0]
    st = ttraining.train_state_from_numpy(init_np, device="cpu")
    back = ttraining.train_state_to_numpy(st)
    assert back._fields[:4] == type(init_np)._fields[:4]
    assert type(back.opt_state).__name__ == "FusedAdamState"
    want = jax.tree.leaves((init_np.step, init_np.params, init_np.opt_state,
                            init_np.scaler))
    got = ttree.leaves((back.step, back.params, back.opt_state, back.scaler))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert st.opt_state.m[0].dtype == torch.float32
    assert st.scaler.growth_count.dtype == torch.int32
