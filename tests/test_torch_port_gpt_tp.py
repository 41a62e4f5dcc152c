"""The port's GPT train step over a {dp, tp} mesh vs JAX's ``make_train_step``.

The port runs gloo ranks on the CPU (``apex_tpu_torch.testing``'s
``gpt_step`` worker: one rig of two ranks and one of four, started
together by the module fixture, each running all of its cases in one
spawn); JAX runs ``apex_tpu.models.training.make_train_step`` over a
mesh of the same shape on the conftest's CPU devices. Both start from
JAX's initial state (``init_fn`` under key 0, crossed over by
``train_state_from_numpy(..., mesh=)``) and take the same global batch
(``jax.random.randint`` under key 1, targets rolled by one).

The model is 4 layers of width 64 (4 heads of 16, ffn 256, vocab 256,
seq 32), fp32, full remat, the materialised-scores attention. The
cases: tp=2 with sequence parallelism on and off, and under the
selective remat policy ``qkv_fc1`` (its named matmuls on the local
slabs, the gathers replayed); tp=2 x dp=2 (the rank
order a wrong unravel breaks only there); the global-norm clip; two
microbatches; tree and flat Adam; a dynamic loss scaler with an
overflow injected on one rank only, which skips the step on every rank.
The tolerances are ``test_torch_port_training.py``'s: losses and grad
norms to 1e-5 relative, params after each of 2 Adam steps to 2e-5 (but
for at most one weight in 10^4, within Adam's largest move), the flat
moments to 2e-5.

The example, ``gpt_train --preset tiny --tp 2`` at a world of four
(bf16, sequence parallel, tree Adam), is held against JAX's step at
tp=2 x dp=2 from the example's own initial weights and batch, within
2e-3 relative on the loss (bf16 compute: both frameworks round the
activations to bf16, in different orders).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as jmx
from apex_tpu.amp import ScalerConfig as JScalerConfig
from apex_tpu.models import gpt as jgpt
from apex_tpu.models import training as jtraining
from apex_tpu.optimizers import fused_adam as j_fused_adam
from apex_tpu_torch import testing as ttesting
from apex_tpu_torch.kernels import flash_bsh_eligible
from apex_tpu_torch.models import gpt as tgpt

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
             seq_len=32, remat=True, attn_impl="xla")
BATCH = 8
LR = 1e-3


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    tp: int
    dp: int
    sp: bool = True
    layout: str = "flat"
    clip: float = None
    n_micro: int = 1
    steps: int = 2
    scaled: bool = False     # dynamic scaler, overflow on rank 1 at step 0
    ce_chunk: int = 0
    policy: str = None       # remat_policy

    @property
    def world(self):
        return self.tp * self.dp


CASES = [
    Case("tp2_sp", 2, 1, sp=True, layout="flat"),
    Case("tp2_nosp", 2, 1, sp=False, layout="tree"),
    Case("tp2_sp_qkv_fc1", 2, 1, sp=True, layout="tree",
         policy="qkv_fc1"),
    Case("tp2dp2_sp", 2, 2, sp=True, layout="flat", ce_chunk=16),
    Case("tp2dp2_nosp_tree", 2, 2, sp=False, layout="tree"),
    Case("tp2dp2_clip", 2, 2, sp=True, layout="flat", clip=1.0),
    Case("tp2dp2_micro2", 2, 2, sp=True, layout="tree", n_micro=2,
         clip=1.0),
    Case("tp2dp2_overflow", 2, 2, sp=True, layout="flat", scaled=True),
]
#: the scaler of the overflow case: a one-rank overflow backs it off once
SCALER = dict(init_scale=2.0 ** 15, backoff_factor=0.5, hysteresis=1,
              growth_interval=1000)
EXAMPLE = ["--preset", "tiny", "--tp", "2", "--steps", "2", "--device",
           "cpu", "--dist-backend", "gloo"]


def _cfg_kw(case):
    return dict(MODEL, sequence_parallel=case.sp, ce_chunk=case.ce_chunk,
                remat_policy=case.policy)


@functools.lru_cache(maxsize=None)
def _batch():
    tok = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                        (BATCH, MODEL["seq_len"]), 0,
                                        MODEL["vocab_size"]))
    return tok, np.roll(tok, -1, axis=1)


def _jax_mesh(tp, dp):
    return jmx.build_mesh(tp=tp, dp=dp, devices=jax.devices()[:tp * dp])


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """JAX's initial state and (metrics, state) after each step, numpy.
    The overflow case's reference is JAX's run without a scaler: the
    port's second step must equal its first."""
    cfg = jgpt.GPTConfig(**_cfg_kw(case), compute_dtype=jnp.float32)
    init_fn, step_fn = jtraining.make_train_step(
        cfg, _jax_mesh(case.tp, case.dp),
        j_fused_adam(LR, layout=case.layout), JScalerConfig(enabled=False),
        n_micro=case.n_micro, clip_grad_norm=case.clip)
    state = init_fn(jax.random.PRNGKey(0))
    init_np = jax.tree.map(np.asarray, state)
    tok, tgt = (jnp.asarray(x) for x in _batch())
    out = []
    for _ in range(case.steps):
        state, m = step_fn(state, tok, tgt)
        out.append(({k: np.asarray(v) for k, v in m.items()},
                    jax.tree.map(np.asarray, state)))
    return init_np, out


def _payload_case(case):
    init_np, _ = _jax_run(case)
    state = ttesting.plain_state(init_np)
    if case.scaled:   # the scaler's own initial state, not the identity's
        state["scaler"] = {
            "loss_scale": np.asarray(SCALER["init_scale"], np.float32),
            "growth_count": np.asarray(0, np.int32),
            "hysteresis_left": np.asarray(SCALER["hysteresis"], np.int32)}
    return {"name": case.name, "world": case.world, "tp": case.tp,
            "dp": case.dp, "cfg": _cfg_kw(case),
            "opt": {"learning_rate": LR, "layout": case.layout},
            "clip": case.clip, "n_micro": case.n_micro,
            "scaler": SCALER if case.scaled else None,
            "poison": 1 if case.scaled else None,
            "state": state,
            "batch": _batch(), "steps": case.steps}


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    """Both rigs at once: the world-2 and world-4 cases, and the example
    at world 4."""
    import threading

    payload = {"cases": [_payload_case(c) for c in CASES],
               "example": {"world": 4, "argv": EXAMPLE}}
    results, errors = {}, []

    def run(world):
        try:
            results[world] = ttesting.run_ranks(
                "gpt_step", world, payload,
                str(tmp_path_factory.mktemp(f"rig_gpt{world}")),
                timeout=150)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _assert_params_close(got, want, steps):
    """Every weight within 2e-5 but for at most one in 10^4; those (a
    gradient component near zero whose sign the order of sums decides)
    within the most that Adam can move a weight in ``steps`` steps."""
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        diff = np.abs(np.asarray(a) - np.asarray(b, np.float32))
        assert float(diff.max()) <= 2 * LR * steps, float(diff.max())
        assert float((diff > 2e-5).mean()) <= 1e-4


def _port(rigs, case):
    res = rigs[case.world]
    assert [r["jax_loaded"] for r in res] == [False] * case.world
    return [r["result"][case.name] for r in res]


@pytest.mark.parametrize("case", [c for c in CASES if not c.scaled],
                         ids=lambda c: c.name)
def test_mesh_step_matches_jax(rigs, case):
    _, want = _jax_run(case)
    ranks = _port(rigs, case)
    for r, got in enumerate(ranks):
        assert got["coords"]["tp"] == r % case.tp
        assert got["coords"]["dp"] == r // case.tp
    got = ranks[0]
    for i, ((mj, sj), mt, st) in enumerate(zip(want, got["metrics"],
                                               got["states"])):
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-5)
        if case.clip is not None:
            np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"],
                                       rtol=1e-5)
        assert int(mt["grads_finite"]) == int(mj["grads_finite"]) == 1
        _assert_params_close(st.params, sj.params, i + 1)
        assert int(st.opt_state.count) == int(sj.opt_state.count) == i + 1
    for a, b in zip(jax.tree.leaves((got["states"][-1].opt_state.m,
                                     got["states"][-1].opt_state.v)),
                    jax.tree.leaves((want[-1][1].opt_state.m,
                                     want[-1][1].opt_state.v))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)
    # every rank reports the same metrics and gathers the same state
    for other in ranks[1:]:
        for ma, mb in zip(other["metrics"], got["metrics"]):
            assert {k: float(v) for k, v in ma.items()} == \
                {k: float(v) for k, v in mb.items()}
        for a, b in zip(jax.tree.leaves(other["states"][-1].params),
                        jax.tree.leaves(got["states"][-1].params)):
            np.testing.assert_array_equal(a, b)


def test_one_rank_overflow_skips_the_step_everywhere(rigs):
    """The QKV kernel's gradient turns inf on rank 1 alone at step 0 (the
    kernel is tp-sharded, so nothing but the vote carries it to rank 0,
    and the dp average carries it to rank 3 only). Every rank skips:
    ``grads_finite`` 0, params and optimizer state bit for bit the
    initial ones, the scale backed off once (2^15 → 2^14). The next step
    is JAX's first (the scale is a power of two, so unscaled gradients
    are the unscaled ones)."""
    case = next(c for c in CASES if c.scaled)
    init_np, want = _jax_run(case)
    for got in _port(rigs, case):
        seq = [(int(m["grads_finite"]), float(m["loss_scale"]))
               for m in got["metrics"]]
        assert seq == [(0, 2.0 ** 14), (1, 2.0 ** 14)]
        skipped = got["states"][0]
        for a, b in zip(jax.tree.leaves((skipped.params, skipped.opt_state)),
                        jax.tree.leaves((init_np.params, init_np.opt_state))):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(got["metrics"][1]["loss"],
                                   want[0][0]["loss"], rtol=1e-5)
        _assert_params_close(got["states"][1].params, want[0][1].params, 1)


def test_example_matches_jax_at_tp2_dp2(rigs):
    """``gpt_train --preset tiny --tp 2`` at a world of four ranks (dp 2,
    SP on, bf16, tree Adam at 3e-4): its losses against JAX's step from
    the same initial weights and batch."""
    ex = [r["result"]["example"] for r in rigs[4]]
    assert all(e["losses"] == ex[0]["losses"] for e in ex)
    init, (tok, tgt) = ex[0]["init"], ex[0]["batch"]
    cfg = jgpt.GPTConfig(sequence_parallel=True, remat=True,
                         compute_dtype=jnp.bfloat16,
                         **{k: v for k, v in _tiny().items()})
    init_fn, step_fn = jtraining.make_train_step(
        cfg, _jax_mesh(2, 2), j_fused_adam(3e-4, layout="tree"),
        JScalerConfig(enabled=False))
    state = init_fn(jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(
        lambda a, ref: jax.device_put(jnp.asarray(a), ref.sharding),
        init, state.params))
    losses = []
    for _ in range(2):
        state, m = step_fn(state, jnp.asarray(tok), jnp.asarray(tgt))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(ex[0]["losses"], losses, rtol=2e-3)


def _tiny():
    from apex_tpu_torch.examples import gpt_train

    return gpt_train.PRESETS["tiny"]


def test_param_specs_and_masks_match_jax():
    """The port's specs and SP mask are JAX's (without pipeline/fsdp)."""
    cfg = tgpt.GPTConfig(**MODEL)
    jcfg = jgpt.GPTConfig(**MODEL)
    got = jax.tree.leaves(tgpt.param_specs(cfg),
                          is_leaf=lambda x: isinstance(x, tuple))
    want = jax.tree.leaves(jgpt.param_specs(jcfg),
                           is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(g) for g in got] == [tuple(w) for w in want]
    assert jax.tree.leaves(tgpt.seq_partial_grad_mask(cfg)) == \
        jax.tree.leaves(jgpt.seq_partial_grad_mask(jcfg))


def test_local_slabs_keep_the_lane_packed_kernels():
    """The 355M at tp=2: 8 heads of 64 a rank (local hidden 512) stay on
    the lane-packed flash kernels, as the whole model's 16 do."""
    assert flash_bsh_eligible(1024, 16, 1024)
    assert flash_bsh_eligible(512, 8, 1024)


def test_ce_fused_refuses_a_vocab_shard():
    """``ce_impl="fused"`` needs the whole vocab on the rank, as JAX's."""
    cfg = tgpt.GPTConfig(**MODEL, ce_impl="fused",
                         compute_dtype=torch.float32)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["embedding"]["word"]["table"] = \
        params["embedding"]["word"]["table"][:128]
    h = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="tp == 1"):
        tgpt._ce_of_hidden(cfg, params, h, torch.zeros(1, 4,
                                                       dtype=torch.long))
