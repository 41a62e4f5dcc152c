"""The port's amp vs the JAX package: the opt-level policies, ``initialize``
in every loss-scale mode, the checkpoint helpers, and BERT in float16
under the dynamic scaler (``examples/bert_pretrain.py --fp16``).

JAX runs on the CPU, its Pallas kernels in interpret mode and its train
step inside ``jax.shard_map`` over a one-device mesh; the port runs with
``device="cpu"`` (its kernels' plain versions). Weights and states cross
as numpy arrays.

Tolerances, each with its reason:

- policies and scaler configurations are compared field by field,
  exactly;
- the fp16 BERT step: every step's ``grads_finite`` and ``loss_scale``
  exactly (the scale trajectory is the contract); the loss to ``rtol
  1e-4`` (float16 activations rounded at other places by XLA and
  PyTorch over two layers: 1.4e-5 apart here); a skipped step leaves
  params and LAMB state bit for bit as they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu import mesh as mx
from apex_tpu.models import bert as jbert
from apex_tpu.optimizers import fused_lamb as j_fused_lamb
from apex_tpu_torch import _tree as ttree
from apex_tpu_torch import amp as tamp
from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.models import training as ttraining
from apex_tpu_torch.optimizers import fused_lamb as t_fused_lamb

torch.set_num_threads(1)

LEVELS = ["O0", "O1", "O2", "O3"]
HALVES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
TO_JAX = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}


def _policy_fields(p, to_jax=False):
    d = dataclasses.asdict(p)
    if to_jax:
        d = {k: TO_JAX.get(v, v) for k, v in d.items()}
    return {k: (jnp.dtype(v) if k.endswith("dtype") else v)
            for k, v in d.items()}


@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("level", LEVELS)
def test_get_policy_matches_jax(level, half):
    jd, td = HALVES[half]
    want = jamp.get_policy(level, jd)
    got = tamp.get_policy(level, td)
    assert _policy_fields(got, to_jax=True) == _policy_fields(want)
    assert got.requires_loss_scaling == want.requires_loss_scaling
    assert tamp.get_policy(level.lower(), td) == got


def test_get_policy_refuses_what_jax_refuses():
    for call in (lambda m: m.get_policy("O4"),):
        with pytest.raises(ValueError, match="opt_level"):
            call(jamp)
        with pytest.raises(ValueError, match="opt_level"):
            call(tamp)
    with pytest.raises(ValueError, match="half_dtype"):
        tamp.get_policy("O1", torch.float32)
    assert tamp.HALF_DTYPES == (torch.float16, torch.bfloat16)


def test_policy_casts_and_overrides():
    """``cast_to_*`` cast floating leaves only; ``cast_norms`` keeps fp32
    unless the policy drops fp32 norms; ``with_`` replaces fields."""
    pol = tamp.get_policy("O2", torch.float16)
    tree = {"w": torch.ones(2), "i": torch.arange(3), "s": 2.0}
    half = pol.cast_to_compute(tree)
    assert half["w"].dtype == torch.float16 and half["i"].dtype == torch.int64
    assert half["s"].dtype == torch.float16
    assert pol.cast_to_output(half)["w"].dtype == torch.float32
    assert pol.cast_to_param(tree)["w"].dtype == torch.float16
    assert pol.cast_norms(half)["w"].dtype == torch.float32
    o3 = tamp.get_policy("O3", torch.bfloat16)
    assert o3.cast_norms(tree)["w"].dtype == torch.bfloat16
    assert pol.with_(keep_norms_fp32=False).cast_norms(tree)["w"].dtype \
        == torch.float16
    assert tamp.get_policy("O0").cast_to_compute(tree)["w"].dtype \
        == torch.float32


def _scaler_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("loss_scale", ["policy", "dynamic", 128.0, None])
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("level", LEVELS)
def test_initialize_matches_jax(level, half, loss_scale):
    """The policy and the scaler configuration for every opt level, half
    dtype and loss-scale mode: ``"policy"`` (dynamic for float16 at
    O1–O3, off otherwise), ``"dynamic"``, a static 128 (never grows or
    backs off) and None (off)."""
    jd, td = HALVES[half]
    jctx, _ = jamp.initialize(opt_level=level, half_dtype=jd,
                              loss_scale=loss_scale)
    tctx, wrapped = tamp.initialize(opt_level=level, half_dtype=td,
                                    loss_scale=loss_scale)
    assert wrapped is None
    assert _policy_fields(tctx.policy, to_jax=True) == \
        _policy_fields(jctx.policy)
    assert _scaler_fields(tctx.scaler) == _scaler_fields(jctx.scaler)


def test_initialize_wraps_the_apply_fn():
    """The wrapped apply casts params and inputs to the compute dtype and
    the result to the output dtype; overrides reach the policy."""
    seen = {}

    def apply_fn(params, x):
        seen["dtypes"] = (params["w"].dtype, x.dtype)
        return params["w"] * x

    ctx, fn = tamp.initialize(apply_fn, "O1", half_dtype=torch.float16,
                              keep_norms_fp32=False)
    out = fn({"w": torch.ones(3)}, torch.full((3,), 2.0))
    assert seen["dtypes"] == (torch.float16, torch.float16)
    assert out.dtype == torch.float32 and out.tolist() == [2.0] * 3
    assert ctx.policy.keep_norms_fp32 is False
    assert ctx.scaler == tamp.ScalerConfig()


def test_scaler_checkpoint_and_master_params():
    """``state_dict``/``load_state_dict`` round trip (module level and on
    ``Amp``), ``init_scaler_state`` and ``update_scaler`` as the config
    says, and ``master_params`` of a tree and of an O2-style state."""
    ctx, _ = tamp.initialize(opt_level="O2", half_dtype=torch.float16)
    st = ctx.init_scaler_state(device="cpu")
    st = ctx.update_scaler(st, torch.tensor(False))
    d = tamp.state_dict(st)
    assert d == {"loss_scale": 2.0 ** 15, "growth_count": 0,
                 "hysteresis_left": 1}
    back = tamp.load_state_dict(d, device="cpu")
    assert tamp.Amp.state_dict(back) == d
    assert back.growth_count.dtype == torch.int32
    jd = jamp.state_dict(jamp.update(jamp.ScalerConfig(),
                                     jamp.ScalerConfig().init(), False))
    assert jd == d
    tree = {"w": torch.ones(2)}
    assert tamp.master_params(tree) is tree

    class O2State:
        master_params = {"w": torch.zeros(2)}

    assert tamp.master_params(O2State()) is O2State.master_params


# ---------------------------------------------------------------------------
# BERT in float16 under the dynamic scaler
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=64, attn_impl="flash")
BATCH = 2
STEPS = 4
#: the forced overflow: the first step runs at 2^40 (float16 gradients
#: overflow there on both sides), backs off to 2^16 and grows every 2
#: clean steps
SCALER = dict(backoff_factor=2.0 ** -24, growth_interval=2)
FIRST_SCALE = 2.0 ** 40


def _mlm_batch():
    rng = np.random.RandomState(0)
    tok = rng.randint(0, SMALL["vocab_size"], (BATCH, SMALL["seq_len"]))
    mask = (rng.rand(BATCH, SMALL["seq_len"]) < 0.15).astype(np.int32)
    return tok, tok, mask


def test_bert_fp16_dynamic_scaler_matches_jax():
    """Four fp16 MLM steps with tree LAMB (the example's) from the same
    initial state, the first at a loss scale where the fp16 gradients
    overflow: ``(grads_finite, loss_scale)`` at every step exactly JAX's
    (skip, backoff, growth), the loss within 1e-4, and the skipped step
    leaves params, LAMB moments and count bit for bit; the scaler of
    ``amp.initialize("O2", float16)`` is the example's
    ``ScalerConfig()``."""
    ctx, _ = tamp.initialize(opt_level="O2", half_dtype=torch.float16)
    assert ctx.scaler == tamp.ScalerConfig()
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    init_fn, step_fn = jbert.make_mlm_train_step(
        jbert.BertConfig(**SMALL, compute_dtype=jnp.float16), mesh,
        j_fused_lamb(1e-3, layout="tree"), jamp.ScalerConfig(**SCALER))
    state = init_fn(jax.random.PRNGKey(0))
    state = state._replace(scaler=state.scaler._replace(
        loss_scale=jnp.float32(FIRST_SCALE)))
    init_np = jax.tree.map(np.asarray, state)
    batch = _mlm_batch()
    want = []
    for _ in range(STEPS):
        state, m = step_fn(state, *(jnp.asarray(x) for x in batch))
        want.append((int(m["grads_finite"]), float(m["loss_scale"]),
                     float(m["loss"])))

    _, tstep = tbert.make_mlm_train_step(
        tbert.BertConfig(**SMALL, compute_dtype=torch.float16),
        t_fused_lamb(1e-3, layout="tree"),
        dataclasses.replace(ctx.scaler, **SCALER), device="cpu")
    tstate = ttraining.train_state_from_numpy(init_np, device="cpu")
    before = ttraining.train_state_to_numpy(tstate)
    got = []
    for i in range(STEPS):
        tstate, m = tstep(tstate, *(torch.as_tensor(x) for x in batch))
        got.append((int(m["grads_finite"]), float(m["loss_scale"]),
                    float(m["loss"])))
        if i == 0:
            after = ttraining.train_state_to_numpy(tstate)
            for a, b in zip(ttree.leaves((after.params, after.opt_state)),
                            ttree.leaves((before.params, before.opt_state))):
                np.testing.assert_array_equal(a, b)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [g[:2] for g in got] == [(0, 2.0 ** 16), (1, 2.0 ** 16),
                                    (1, 2.0 ** 17), (1, 2.0 ** 17)]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-4)
    assert int(tstate.opt_state.count) == STEPS - 1
