"""The port's head-major attention path in GPT and BERT vs the JAX
package, and ``apex_tpu_torch.examples.gpt_train``.

Megatron-GPT 2.7B has heads of 80, which the lane-packed kernels do not
take: in both packages its attention splits heads to ``[b, h, s, d]``
and runs the head-major flash kernels. These oracles hold, on the CPU
(the port's kernel wrappers taking their plain versions, JAX's Pallas
kernels in interpret mode, the JAX model inside ``jax.shard_map`` over a
one-device tp=1 mesh):

- a narrow GPT with heads of 80 (vocab 512, hidden 160, 2 layers of 2
  heads, seq 64, fp32, ``attn_impl="flash"``): the loss and its
  gradients, and one ``make_train_step`` step with tree Adam, from the
  JAX ``init`` weights crossed as numpy;
- the attention dispatch (lane-packed or head-major) against the kernel
  JAX traces, on a table of head widths, layouts and
  ``APEX_TPU_FLASH_BWD``;
- a narrow GPT-2-like model (2 heads of 64) and a narrow BERT with
  ``attn_layout="bhsd"``;
- the example at ``--preset tiny --device cpu`` and its refusal of every
  flag that needs a module not yet ported.

Tolerances: fp32 losses ``rtol=1e-5``; gradients ``rtol=1e-4`` with
``atol`` 1e-4 of the leaf's largest entry (sums in another order); after
the Adam step, weights within 2e-5 but for at most one in 10^4 (a
gradient component near zero, whose sign the order of sums decides,
moves its weight the other way by at most 2 lr).
"""

import functools
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu import mesh as mx
from apex_tpu.amp import ScalerConfig as JScalerConfig
from apex_tpu.models import bert as jbert
from apex_tpu.models import gpt as jgpt
from apex_tpu.models import training as jtraining
from apex_tpu.optimizers import fused_adam as j_fused_adam
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch.amp import ScalerConfig as TScalerConfig
from apex_tpu_torch.examples import gpt_train
from apex_tpu_torch.kernels import flash_attention as tfa
from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models import training as ttraining
from apex_tpu_torch.optimizers import fused_adam as t_fused_adam

jfa = importlib.import_module("apex_tpu.kernels.flash_attention")

torch.set_num_threads(1)

HEADS80 = dict(vocab_size=512, hidden_size=160, num_layers=2, num_heads=2,
               seq_len=64, attn_impl="flash")
BATCH = 2
LR = 1e-3


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.fixture(scope="module")
def mesh():
    return mx.build_mesh(tp=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    tok = rng.integers(0, HEADS80["vocab_size"], (BATCH, HEADS80["seq_len"]))
    return tok, np.roll(tok, -1, axis=1)


def _kernel_name(kernel):
    f = kernel.func if isinstance(kernel, functools.partial) else kernel
    if f.__name__ == "<lambda>":
        f = inspect.getclosurevars(f).nonlocals["kernel"]
    return f.__name__


@pytest.fixture
def pallas_spy(monkeypatch):
    """The kernel body of every ``pallas_call`` JAX traces."""
    seen = []
    orig = jfa.pl.pallas_call

    def spy(kernel, *a, **kw):
        seen.append(_kernel_name(kernel))
        return orig(kernel, *a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    return seen


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


_HM = tfa.FLASH_HM_FWD_OP
_BSH = tfa.FLASH_FWD_OP


def _jax_value_and_grad(mesh, jcfg, params, *batch):
    return jax.jit(jax.shard_map(
        jax.value_and_grad(lambda p, *a: jgpt.loss(jcfg, p, *a)), mesh=mesh,
        in_specs=(jgpt.param_specs(jcfg),) + (P(),) * len(batch),
        out_specs=(P(), jgpt.param_specs(jcfg)), check_vma=False))(
            params, *(jnp.asarray(x) for x in batch))


def _port_value_and_grad(tcfg, params_np, *batch):
    params = tgpt.params_from_numpy(params_np, device="cpu")
    leaves, spec = ttree.flatten(params)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    log = _OpLog()
    with log:
        loss = tgpt.loss(tcfg, ttree.unflatten(spec, diff),
                         *(torch.as_tensor(np.array(x)) for x in batch))
        grads = torch.autograd.grad(loss, diff)
    return loss, grads, log.ops


def _assert_grads(grads, want_tree):
    want = jax.tree.leaves(want_tree)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("over", [dict(), dict(attn_layout="bhsd"),
                                  dict(remat=True, remat_policy="fc1_attn")],
                         ids=["auto", "bhsd", "remat-fc1_attn"])
def test_heads_of_80_loss_and_gradients_match_jax(mesh, batch, pallas_spy,
                                                   over):
    """The loss and every gradient of the heads-of-80 GPT: both packages
    run the head-major kernels (JAX traces ``_fwd_kernel`` and its fused
    backward, the port calls the head-major op). Under full remat (the
    default, and the 2.7B example's) the backward replays each layer's
    forward, so the op runs twice a layer; ``fc1_attn`` saves its output,
    so once."""
    jcfg = jgpt.GPTConfig(**HEADS80, compute_dtype=jnp.float32, **over)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    val_j, grads_j = _jax_value_and_grad(mesh, jcfg, params, *batch)
    assert set(pallas_spy) == {"_fwd_kernel", "_dqkv_kernel"}
    tcfg = tgpt.GPTConfig(**HEADS80, compute_dtype=torch.float32, **over)
    loss, grads, ops = _port_value_and_grad(
        tcfg, jax.tree.map(np.asarray, params), *batch)
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=1e-5)
    _assert_grads(grads, grads_j)
    fwd_calls = 1 if tcfg.remat_policy else 2
    assert ops.count(_HM) == fwd_calls * tcfg.num_layers and _BSH not in ops
    assert ops.count(torch.ops.apex_tpu_torch.flash_attention_bwd.default) \
        == tcfg.num_layers


def test_heads_of_80_tree_adam_step_matches_jax(mesh, batch):
    """One ``make_train_step`` step with ``fused_adam(layout="tree")`` (the
    2.7B example's optimizer) from the JAX initial state crossed by
    ``train_state_from_numpy``: the loss, and params and moments after the
    step. The port's tree Adam updates the moments in place."""
    jcfg = jgpt.GPTConfig(**HEADS80, compute_dtype=jnp.float32)
    init_fn, step_fn = jtraining.make_train_step(
        jcfg, mesh, j_fused_adam(LR, layout="tree"),
        JScalerConfig(enabled=False))
    state = init_fn(jax.random.PRNGKey(0))
    init_np = jax.tree.map(np.asarray, state)
    state, m_j = step_fn(state, *(jnp.asarray(x) for x in batch))
    tcfg = tgpt.GPTConfig(**HEADS80, compute_dtype=torch.float32)
    _, tstep = ttraining.make_train_step(
        tcfg, t_fused_adam(LR, layout="tree"), TScalerConfig(enabled=False),
        device="cpu")
    tstate = ttraining.train_state_from_numpy(init_np, device="cpu")
    m0 = tstate.opt_state.m
    tstate, m_t = tstep(tstate, *(torch.as_tensor(np.array(x))
                                  for x in batch))
    assert tstate.opt_state.m is not m0
    assert all(a is b for a, b in zip(ttree.leaves(tstate.opt_state.m),
                                      ttree.leaves(m0)))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    got = ttraining.train_state_to_numpy(tstate)
    for a, b in zip(ttree.leaves(got.params), jax.tree.leaves(state.params)):
        diff = np.abs(a - np.asarray(b, np.float32))
        assert float(diff.max()) <= 2 * LR, float(diff.max())
        assert float((diff > 2e-5).mean()) <= 1e-4
    for a, b in zip(ttree.leaves((got.opt_state.m, got.opt_state.v)),
                    jax.tree.leaves((state.opt_state.m, state.opt_state.v))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-12))


#: (hidden, heads, attn_layout, APEX_TPU_FLASH_BWD) → the attention JAX
#: and the port run: "bsh" (lane-packed) or "hm" (head-major)
DISPATCH = [
    (128, 2, "auto", "auto", "bsh", "bsh"),      # heads of 64
    (160, 2, "auto", "auto", "hm", "hm"),        # heads of 80 (the 2.7B)
    (128, 2, "bhsd", "auto", "hm", "hm"),        # forced head-major
    (128, 2, "auto", "split", "hm", "hm"),       # the split backward
    (256, 2, "auto", "auto", "bsh", "hm"),       # heads of 128: JAX packs
    (128, 4, "auto", "auto", "bsh", "hm"),       # heads of 32: JAX packs
    (192, 3, "auto", "auto", "hm", "hm"),        # 192 is no lane multiple
]


@pytest.mark.parametrize("hidden,heads,layout,mode,jax_path,port_path",
                         DISPATCH)
def test_attention_dispatch_matches_jax(mesh, monkeypatch, pallas_spy,
                                        hidden, heads, layout, mode,
                                        jax_path, port_path):
    """Which flash attention a layer runs, lane-packed or head-major, in
    both packages (JAX's traced abstractly by ``jax.eval_shape``): equal
    wherever the port's lane-packed kernels take the head width (64), and
    head-major in the port at the widths JAX packs and the port's
    lane-packed kernels are not built for."""
    monkeypatch.setenv("APEX_TPU_FLASH_BWD", mode)
    shape = dict(vocab_size=64, hidden_size=hidden, num_layers=1,
                 num_heads=heads, seq_len=64, attn_impl="flash",
                 attn_layout=layout, remat=False)
    jcfg = jgpt.GPTConfig(**shape, compute_dtype=jnp.float32)
    params = jax.eval_shape(lambda: jgpt.init(jcfg, jax.random.PRNGKey(0)))
    tok = jax.ShapeDtypeStruct((1, 64), jnp.int32)
    jax.eval_shape(jax.shard_map(
        lambda p, t: jgpt.loss(jcfg, p, t, t), mesh=mesh,
        in_specs=(jgpt.param_specs(jcfg), P(), ), out_specs=P(),
        check_vma=False), params, tok)
    fwd = [k for k in pallas_spy if k.startswith("_fwd_kernel")]
    assert fwd == ["_fwd_kernel_bsh" if jax_path == "bsh" else "_fwd_kernel"]
    tcfg = tgpt.GPTConfig(**shape, compute_dtype=torch.float32)
    tp = tgpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    t = torch.zeros(1, 64, dtype=torch.long)
    log = _OpLog()
    with log:
        tgpt.loss(tcfg, tp, t, t)
    want = _BSH if port_path == "bsh" else _HM
    assert log.ops.count(want) == 1 and log.ops.count(
        _HM if want is _BSH else _BSH) == 0


def test_gpt2_like_bhsd_matches_jax(mesh, batch):
    """The GPT-2 geometry (heads of 64) forced head-major with
    ``attn_layout="bhsd"`` under the bench's ``qkv_fc1_attn`` policy: the
    loss and gradients against JAX's, the head-major forward once a layer
    (the policy saves its output)."""
    shape = dict(HEADS80, hidden_size=128, attn_layout="bhsd", remat=True,
                 remat_policy="qkv_fc1_attn")
    jcfg = jgpt.GPTConfig(**shape, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(2))
    val_j, grads_j = _jax_value_and_grad(mesh, jcfg, params, *batch)
    tcfg = tgpt.GPTConfig(**shape, compute_dtype=torch.float32)
    loss, grads, ops = _port_value_and_grad(
        tcfg, jax.tree.map(np.asarray, params), *batch)
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=1e-5)
    _assert_grads(grads, grads_j)
    assert ops.count(_HM) == tcfg.num_layers and _BSH not in ops


def test_bert_bhsd_matches_jax(mesh):
    """A narrow BERT (vocab 512, hidden 128, 2 layers of 2 heads, seq 64)
    with ``attn_layout="bhsd"``: the MLM loss and its gradients against
    JAX's; bidirectional head-major attention."""
    shape = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                 seq_len=64, attn_impl="flash", attn_layout="bhsd")
    jcfg = jbert.BertConfig(**shape, compute_dtype=jnp.float32)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 512, (2, 64))
    mask = (rng.rand(2, 64) < 0.15).astype(np.int32)
    params = jbert.init(jcfg, jax.random.PRNGKey(1))
    val_j, grads_j = jax.jit(jax.shard_map(
        jax.value_and_grad(lambda p, *a: jbert.mlm_loss(jcfg, p, *a)),
        mesh=mesh, in_specs=(jbert.param_specs(jcfg),) + (P(),) * 3,
        out_specs=(P(), jbert.param_specs(jcfg)), check_vma=False))(
            params, jnp.asarray(tok), jnp.asarray(tok), jnp.asarray(mask))
    tcfg = tbert.BertConfig(**shape, compute_dtype=torch.float32)
    tparams = tbert.params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu")
    leaves, spec = ttree.flatten(tparams)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    log = _OpLog()
    with log:
        loss = tbert.mlm_loss(tcfg, ttree.unflatten(spec, diff),
                              *(torch.as_tensor(x) for x in (tok, tok, mask)))
        grads = torch.autograd.grad(loss, diff)
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=1e-5)
    want = jax.tree.leaves(grads_j)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    assert log.ops.count(_HM) >= tcfg.num_layers and _BSH not in log.ops


def test_config_takes_bhsd_and_head_widths_to_128():
    for hidden, heads in ((2560, 32), (768, 8), (1536, 12), (512, 4)):
        cfg = tgpt.GPTConfig(hidden_size=hidden, num_heads=heads,
                             attn_layout="bhsd")
        assert cfg.head_dim == hidden // heads
    with pytest.raises(ValueError, match="attn_layout"):
        tgpt.GPTConfig(attn_layout="bshd")
    assert tbert.BertConfig(attn_layout="bhsd").core().attn_layout == "bhsd"
    # the kernels stop at 128: their wrappers raise on a CUDA tensor
    with pytest.raises(ValueError, match="head_dim 160 > 128"):
        tfa._hm_check_kernel(torch.zeros(1, 4, 160), "flash_attention")


def test_example_tiny_runs_on_the_cpu(capsys):
    """``python -m apex_tpu_torch.examples.gpt_train --preset tiny --steps 2
    --device cpu``: a finite loss printed per step and the tokens/s
    line; the 2.7B preset's config is the JAX script's."""
    out = gpt_train.main(["--preset", "tiny", "--steps", "2", "--device",
                          "cpu"])
    text = capsys.readouterr().out
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "step 0 loss" in text and "step 1 loss" in text
    assert "tokens/s on cpu" in text
    cfg = gpt_train.config(gpt_train.parse_args(["--preset", "2p7b"]))
    assert (cfg.hidden_size, cfg.num_heads, cfg.num_layers, cfg.seq_len,
            cfg.vocab_size) == (2560, 32, 32, 1024, 50304)
    assert cfg.ce_chunk == 512 and cfg.remat and cfg.remat_policy is None
    assert cfg.param_count() == jgpt.GPTConfig(
        **gpt_train.PRESETS["2p7b"]).param_count() == 2_649_052_160
    assert gpt_train.config(gpt_train.parse_args(
        ["--remat-policy", "qkv_fc1_attn"])).attn_impl == "flash"


@pytest.mark.parametrize("flags,needle", [
    (["--tp", "2"], "--tp 2"), (["--pp", "2"], "--pp 2"),
    (["--cp", "2"], "--cp 2"), (["--experts", "8"], "--experts 8"),
    (["--ep", "2"], "--ep 2"), (["--n-micro", "4"], "--n-micro 4"),
    (["--vpp", "2"], "--vpp 2"), (["--fsdp"], "--fsdp"),
    (["--data", "tokens.bin"], "--data"), (["--ckpt", "x.atck"], "--ckpt"),
    (["--metrics", "m.jsonl"], "--metrics")])
def test_example_refuses_unported_flags(flags, needle):
    with pytest.raises(SystemExit, match="ROADMAP queue 1 item") as e:
        gpt_train.build(gpt_train.parse_args(flags + ["--device", "cpu"]))
    assert needle in str(e.value)


def test_example_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_train.build(gpt_train.parse_args([]))
