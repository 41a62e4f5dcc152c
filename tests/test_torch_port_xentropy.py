"""The port's fused cross entropy and its fp16 flash path vs the JAX
package: ``softmax_cross_entropy`` (the xentropy kernels' plain twins
against the interpret-mode Pallas kernels), GPT with
``ce_impl="fused"`` (loss, gradients and a 3-step train step), and
float16 through ``flash_attention_bsh``.

The JAX side runs as its own tests run it: Pallas in interpret mode on
the CPU, the model inside ``jax.shard_map`` over a one-device tp=1 mesh.
The port runs on the CPU, where its wrappers take their plain versions;
``chip_smoke.py`` holds the CUDA kernels against the same plain versions
on the card. Inputs are made with numpy from fixed seeds and cross as
numpy arrays.

Tolerances, each with its reason:

- fp32 losses and lse ``rtol=atol=1e-5`` (the same fp32 formula, sums
  in another order); fp32 gradients ``rtol=1e-5, atol=1e-6``;
- bf16 and fp16 gradients: both sides compute the same fp32 value and
  round it once to the logits' dtype, so within one ulp of the dtype
  (``rtol`` 1e-2 for bf16's 8 bits, 2e-3 for fp16's 11);
- the GPT loss in fp32 ``rtol=1e-5``, its gradients ``rtol=1e-4`` with
  ``atol`` 1e-5 of the largest entry; the train step as
  ``tests/test_torch_port_training.py`` holds it;
- flash in fp16: the output is the fp32 kernel's rounded once to fp16 on
  both sides: within one fp16 ulp (``rtol=atol=2e-3``).
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
from apex_tpu.models import gpt as jgpt
from apex_tpu.models import training as jtraining
from apex_tpu.optimizers import fused_adam as j_fused_adam
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch import kernels as tk
from apex_tpu_torch.amp import ScalerConfig as TScalerConfig
from apex_tpu_torch.kernels import xentropy as txe
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models import training as ttraining
from apex_tpu_torch.optimizers import fused_adam as t_fused_adam

jxe = importlib.import_module("apex_tpu.kernels.xentropy")
jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

# one intra-op thread, as in the other port suites that run steps (xdist
# workers each import every module)
torch.set_num_threads(1)

#: a vocab that is not a multiple of the JAX kernel's 128 lanes, and the
#: targets of the six rows: in range, ignored, the last column, past the
#: vocab, negative but not ignore_index, in range
V = 300
TARGETS = [5, -100, 299, 300, -7, 17]
DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-6)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=1e-2, atol=1e-6)),
          "f16": (jnp.float16, torch.float16, dict(rtol=2e-3, atol=1e-6))}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)

#: the GPT oracle: vocab 300, 2 layers of 2 heads of 64, seq 64, chunked
#: CE in 2 chunks, fp32, flat Adam, batch 2
GPT = dict(vocab_size=V, hidden_size=128, num_layers=2, num_heads=2,
           seq_len=64, ce_chunk=32, remat=True, attn_impl="xla",
           ce_impl="fused")
BATCH = 2


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.fixture(scope="module")
def mesh():
    return mx.build_mesh(tp=1, devices=jax.devices()[:1])


def _inputs(dtype, seed):
    """Logits in ``dtype`` (as numpy fp32 values it holds exactly), the
    targets, an upstream gradient."""
    jd = DTYPES[dtype][0]
    rng = np.random.default_rng(seed)
    x = np.array(jnp.asarray(rng.standard_normal((len(TARGETS), V)) * 3,
                             jd).astype(jnp.float32))
    g = rng.standard_normal(len(TARGETS)).astype(np.float32)
    return x, np.asarray(TARGETS, np.int32), g


# ---------------------------------------------------------------------------
# the kernels' plain twins vs the interpret-mode Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_softmax_cross_entropy_matches_jax(dtype, smoothing):
    """Per-row loss and the gradient under a random upstream gradient,
    through the port's ``autograd.Function`` (forward and backward plain
    twins) against ``jax.vjp`` of the JAX ``custom_vjp``: V = 300,
    an ignored row (zero loss, zero gradient), a target past the vocab
    and a negative one (``x[t]`` read as 0), fp16 widened and its
    gradient cast back."""
    jd, td, tol = DTYPES[dtype]
    x, t, g = _inputs(dtype, seed=int(smoothing * 10) + len(dtype))
    loss_j, vjp = jax.vjp(lambda a: jxe.softmax_cross_entropy(
        a, jnp.asarray(t), smoothing), jnp.asarray(x, jd))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    loss = txe.softmax_cross_entropy(xt, torch.from_numpy(t), smoothing)
    (dx,) = torch.autograd.grad(loss, xt, torch.from_numpy(g))
    assert loss.dtype == torch.float32 and dx.dtype == td
    np.testing.assert_allclose(_np(loss), np.asarray(loss_j), **LOSS_TOL)
    np.testing.assert_allclose(_np(dx), np.asarray(dx_j, np.float32), **tol)
    assert float(loss[1].detach()) == 0.0 and not _np(dx)[1].any()
    assert np.isfinite(_np(loss)).all()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_xentropy_fwd_and_bwd_match_the_jax_kernels(smoothing):
    """The two wrappers (CPU: the plain twins) against ``_run_fwd`` and
    ``_run_bwd`` themselves: loss and lse, then ``dx`` from that lse, in
    fp32."""
    x, t, g = _inputs("f32", seed=3)
    loss_j, lse_j = jxe._run_fwd(jnp.asarray(x), jnp.asarray(t), smoothing,
                                 -100)
    dx_j = jxe._run_bwd(jnp.asarray(x), jnp.asarray(t), lse_j,
                        jnp.asarray(g), smoothing, -100)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    loss, lse = tk.xentropy_fwd(xt, tt, smoothing=smoothing)
    dx = tk.xentropy_bwd(xt, tt, lse, torch.from_numpy(g),
                         smoothing=smoothing)
    np.testing.assert_allclose(_np(loss), np.asarray(loss_j), **LOSS_TOL)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_j)[:, 0],
                               **LOSS_TOL)
    np.testing.assert_allclose(_np(dx), np.asarray(dx_j), rtol=1e-5,
                               atol=1e-6)
    assert tk.launch_counts()["xentropy_fwd"] == 0


def test_xentropy_ignore_index_and_errors():
    """A custom ``ignore_index`` that is a real column: that row's loss
    and gradient are zero while its lse is still the row's; a 1-D input
    raises."""
    x, _, g = _inputs("f32", seed=4)
    t = torch.tensor([0, 3, 3, 1, 2, 3], dtype=torch.int64)
    loss, lse = tk.xentropy_fwd(torch.from_numpy(x), t, ignore_index=3)
    dx = tk.xentropy_bwd(torch.from_numpy(x), t, lse, torch.from_numpy(g),
                         ignore_index=3)
    assert [float(v) == 0.0 for v in loss] == [False, True, True, False,
                                               False, True]
    assert not dx[t == 3].any() and dx[t != 3].abs().sum() > 0
    want = torch.logsumexp(torch.from_numpy(x), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        tk.xentropy_fwd(torch.zeros(V), torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# GPT with ce_impl="fused"
# ---------------------------------------------------------------------------

def _batch(seed=1):
    tok = np.random.default_rng(seed).integers(0, V, (BATCH, GPT["seq_len"]))
    return tok.astype(np.int32), np.roll(tok, -1, axis=1).astype(np.int32)


def _jax_loss_grads(mesh, over):
    cfg = jgpt.GPTConfig(**{**GPT, **over}, compute_dtype=jnp.float32)
    params = jgpt.init(cfg, jax.random.PRNGKey(0))
    tok, tgt = _batch()
    val, grads = jax.jit(jax.shard_map(
        jax.value_and_grad(lambda p, a, b: jgpt.loss(cfg, p, a, b)),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=(P(), P()),
        check_vma=False))(params, tok, tgt)
    return (jax.tree.map(np.asarray, params), float(val),
            [np.asarray(x) for x in jax.tree.leaves(grads)])


def _port_loss_grads(params_np, **over):
    cfg = tgpt.GPTConfig(**{**GPT, **over}, compute_dtype=torch.float32)
    params = tgpt.params_from_numpy(params_np, device="cpu")
    leaves, spec = ttree.flatten(params)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    tok, tgt = (torch.from_numpy(a) for a in _batch())
    loss = tgpt.loss(cfg, ttree.unflatten(spec, diff), tok, tgt)
    grads = torch.autograd.grad(loss, diff)
    return float(loss.detach()), [_np(g) for g in grads]


@pytest.mark.parametrize("ce_chunk", [0, 32])
def test_fused_ce_loss_and_grads_match_jax(mesh, ce_chunk):
    """The mean CE of the tied head through the fused kernels, whole and
    in checkpointed chunks, against JAX's fused branch; and the port's
    fused CE equals its own "xla" CE."""
    params_np, loss_j, grads_j = _jax_loss_grads(mesh, dict(ce_chunk=ce_chunk))
    loss, grads = _port_loss_grads(params_np, ce_chunk=ce_chunk)
    loss_x, grads_x = _port_loss_grads(params_np, ce_chunk=ce_chunk,
                                       ce_impl="xla")
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    np.testing.assert_allclose(loss, loss_x, rtol=1e-6)
    for a, b, c in zip(grads, grads_j, grads_x):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6 * scale)


def test_fused_ce_train_step_matches_jax(mesh):
    """Three fp32 steps of ``make_train_step`` with ``ce_impl="fused"``,
    flat Adam and a global-norm clip: losses and grad norms to 1e-5
    relative, every param within 2e-5 but for one in 10^4 (within the
    most Adam moves a weight in 3 steps), as the GPT step's oracle."""
    cfg_j = jgpt.GPTConfig(**GPT, compute_dtype=jnp.float32)
    init_fn, step_fn = jtraining.make_train_step(
        cfg_j, mesh, j_fused_adam(1e-3, layout="flat"),
        JScalerConfig(enabled=False), clip_grad_norm=1.0)
    state = init_fn(jax.random.PRNGKey(0))
    init_np = jax.tree.map(np.asarray, state)
    tok, tgt = _batch()
    metrics_j, params_j = [], []
    for _ in range(3):
        state, m = step_fn(state, jnp.asarray(tok), jnp.asarray(tgt))
        metrics_j.append({k: float(v) for k, v in m.items()})
        params_j.append(jax.tree.map(np.asarray, state.params))

    _, tstep = ttraining.make_train_step(
        tgpt.GPTConfig(**GPT, compute_dtype=torch.float32),
        t_fused_adam(1e-3, layout="flat"), TScalerConfig(enabled=False),
        clip_grad_norm=1.0, device="cpu")
    tstate = ttraining.train_state_from_numpy(init_np, device="cpu")
    for mj, pj in zip(metrics_j, params_j):
        tstate, m = tstep(tstate, torch.from_numpy(tok),
                          torch.from_numpy(tgt))
        np.testing.assert_allclose(float(m["loss"]), mj["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), mj["grad_norm"],
                                   rtol=1e-5)
        for a, b in zip(ttree.leaves(tgpt.params_to_numpy(tstate.params)),
                        jax.tree.leaves(pj)):
            diff = np.abs(a - b)
            assert float(diff.max()) <= 2 * 1e-3 * 3, float(diff.max())
            assert float((diff > 2e-5).mean()) <= 1e-4


def test_fused_ce_calls_per_step(monkeypatch):
    """One step with ``ce_chunk`` = seq / 2 calls the forward twice per
    chunk (the forward, then the chunk checkpoint's replay in the
    backward) and the backward once per chunk: 4 and 2, the counts the
    card's run asserts through the launch counters."""
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "xentropy_fwd_plain"),
                      ("bwd", "xentropy_bwd_plain")):
        orig = getattr(txe, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(txe, name, counted)
    cfg = tgpt.GPTConfig(**GPT, compute_dtype=torch.float32)
    init_fn, step_fn = ttraining.make_train_step(
        cfg, t_fused_adam(1e-3), device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    step_fn(state, *(torch.from_numpy(a) for a in _batch()))
    chunks = GPT["seq_len"] // GPT["ce_chunk"]
    assert calls == {"fwd": 2 * chunks, "bwd": chunks}
    assert sum(tk.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# float16 through the flash kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_fp16_matches_jax_and_widens(causal):
    """float16 q/k/v: the output and dQ/dK/dV come back in float16, equal
    within one fp16 ulp to JAX's (which widens to f32 at the kernel
    boundary), and equal bit for bit to the fp16 twins the tensor-core
    kernels follow (P and dS rounded to fp16, delta from the fp16 output;
    the port no longer widens here), which differ from the fp32 path on
    the widened inputs."""
    b, s, hidden, heads = 2, 80, 128, 2
    rng = np.random.default_rng(11 + causal)
    arrs = [np.asarray(jnp.asarray(rng.standard_normal((b, s, hidden)),
                                   jnp.float16).astype(jnp.float32))
            for _ in range(4)]
    qj, kj, vj, doj = (jnp.asarray(a, jnp.float16) for a in arrs)
    out_j, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_bsh(
        q, k, v, num_heads=heads, causal=causal), qj, kj, vj)
    grads_j = vjp(doj)
    q, k, v, do = (torch.from_numpy(a.copy()).half() for a in arrs)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = tk.flash_attention_bsh(q, k, v, num_heads=heads, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert out.dtype == torch.float16
    assert all(g.dtype == torch.float16 for g in grads)
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(out.float()), np.asarray(out_j,
                                                            np.float32), **tol)
    for g, w in zip(grads, grads_j):
        np.testing.assert_allclose(_np(g.float()), np.asarray(w, np.float32),
                                   rtol=2e-3, atol=2e-3 * float(
                                       np.abs(np.asarray(w)).max()))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    twin, lse = tk.flash_attention_bsh_plain(qd, kd, vd, num_heads=heads,
                                             causal=causal)
    assert torch.equal(out, twin)
    delta = (twin.float() * do.float()).reshape(
        b, s, heads, hidden // heads).sum(-1).transpose(1, 2).contiguous()
    want = tk.flash_attention_bsh_bwd_plain(qd, kd, vd, do, lse, delta,
                                            num_heads=heads, causal=causal)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    q32, k32, v32 = (t.detach().float().requires_grad_(True)
                     for t in (q, k, v))
    out32 = tk.flash_attention_bsh(q32, k32, v32, num_heads=heads,
                                   causal=causal)
    grads32 = torch.autograd.grad(out32, (q32, k32, v32), do.float())
    assert not torch.equal(out, out32.half())
    assert not any(torch.equal(g, g32.half())
                   for g, g32 in zip(grads, grads32))
