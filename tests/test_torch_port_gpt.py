"""apex_tpu_torch.models.gpt vs the JAX reference ``apex_tpu.models.gpt``.

Same weights (the JAX ``gpt.init`` tree, crossed over by
``params_from_numpy``) and the same inputs (numpy, seeded) through both
frameworks on the CPU. fp32 agreement is to ``atol=1e-4`` (both sides
compute in fp32; only summation order differs). bf16 runs agree within
a band stated at the test: bf16 keeps 8 mantissa bits and the two
frameworks round at different places. Greedy ``generate`` is held to
token identity — never to an agreement fraction.

The JAX side runs as its own tests run it: inside ``jax.shard_map``
over a one-device tp=1 mesh; its Pallas kernels run in interpret mode
on the CPU. The port side runs with ``device="cpu"``, where its kernel
wrappers take their plain PyTorch versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu_torch.models import gpt as tgpt

SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=64, remat=False)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(dtype="f32", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    return (jgpt.GPTConfig(**SMALL, compute_dtype=jd, **kw),
            tgpt.GPTConfig(**SMALL, compute_dtype=td, **kw))


@pytest.fixture(scope="module")
def mesh():
    return mx.build_mesh(tp=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def weights():
    """(JAX params, numpy tree) of the small config."""
    jcfg, _ = _cfgs()
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def lively_weights():
    """Weights at init_std 0.2, whose greedy streams move: at the default
    0.02 the tied embedding dominates and a random model repeats its last
    prompt token, which would make token identity an empty check."""
    jcfg, _ = _cfgs(init_std=0.2)
    params = jgpt.init(jcfg, jax.random.PRNGKey(1))
    return params, jax.tree.map(np.asarray, params)


def _port_params(tree):
    return tgpt.params_from_numpy(tree, device="cpu")


def _run_jax(mesh, cfg, fn, params, *args, out_specs=P()):
    return jax.jit(jax.shard_map(
        lambda p, *a: fn(cfg, p, *a), mesh=mesh,
        in_specs=(jgpt.param_specs(cfg),) + (P(),) * len(args),
        out_specs=out_specs, check_vma=False))(params, *args)


def _np(t):
    return t.detach().float().cpu().numpy()


def test_bridge_round_trips(weights):
    _, tree = weights
    back = tgpt.params_to_numpy(_port_params(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_port_init_matches_the_reference_tree(weights):
    _, tree = weights
    _, tcfg = _cfgs()
    mine = tgpt.params_to_numpy(
        tgpt.init(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    ref = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(mine)
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        # same distribution: std within 10% of the reference leaf's
        if a.std() > 0:
            assert abs(b.std() / a.std() - 1) < 0.1, path
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_logits_match_jax_fp32(mesh, weights, attn_impl):
    params, tree = weights
    jcfg, tcfg = _cfgs(attn_impl=attn_impl)
    toks = np.random.default_rng(1).integers(0, 256, (2, 24), np.int32)
    want = np.asarray(_run_jax(mesh, jcfg, jgpt.logits, params, toks))
    got = tgpt.logits(tcfg, _port_params(tree), torch.as_tensor(toks))
    np.testing.assert_allclose(_np(got), want, **FP32_TOL)


@pytest.mark.parametrize("score_dtype", ["f32", "compute"])
def test_logits_match_jax_bf16(mesh, weights, score_dtype):
    """bf16 band: logits here have std ~0.23; the two frameworks round
    activations to bf16 at different places (2^-8 relative each); the
    measured worst case is one bf16 ulp at the logits' scale (7.8e-3),
    so the band is 2.5 ulp, and the mean error stays ~1e-3."""
    params, tree = weights
    jcfg, tcfg = _cfgs("bf16", attn_impl="xla",
                       attn_score_dtype=score_dtype)
    toks = np.random.default_rng(2).integers(0, 256, (2, 16), np.int32)
    want = np.asarray(_run_jax(mesh, jcfg, jgpt.logits, params, toks),
                      np.float32)
    got = _np(tgpt.logits(tcfg, _port_params(tree), torch.as_tensor(toks)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert np.abs(got - want).mean() < 3e-3


def _padded_prompts(rng, lens, width):
    out = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        out[i, :n] = rng.integers(0, 256, n)
    return out


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_many_matches_jax(mesh, weights, attn_impl):
    params, tree = weights
    jcfg, tcfg = _cfgs(attn_impl=attn_impl)
    prompts = _padded_prompts(np.random.default_rng(3), [5, 16, 1], 16)
    last = np.asarray([4, 15, 0], np.int32)
    j_cache, j_lg = _run_jax(
        mesh, jcfg, lambda c, p, t, l: jgpt.prefill_many(
            c, p, t, l, max_len=24), params, prompts, last,
        out_specs=(P(), P()))
    t_cache, t_lg = tgpt.prefill_many(
        tcfg, _port_params(tree), torch.as_tensor(prompts),
        torch.as_tensor(last), max_len=24)
    np.testing.assert_allclose(_np(t_lg), np.asarray(j_lg), **FP32_TOL)
    np.testing.assert_allclose(_np(t_cache), np.asarray(j_cache), **FP32_TOL)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_decode_step_vector_pos_matches_jax(mesh, weights, impl):
    """Prefill a [3, 8] batch, then one decode step at per-row positions
    (mid, first-after-prompt, deep): logits AND the updated cache."""
    params, tree = weights
    jcfg, tcfg = _cfgs(decode_attn_impl=impl)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, (3, 8), np.int32)
    tok = rng.integers(0, 256, (3,), np.int32)
    pos = np.asarray([8, 3, 20], np.int32)

    def jrun(cfg, p, t, tk, ps):
        cache, _ = jgpt.prefill(cfg, p, t, max_len=32)
        return jgpt.decode_step(cfg, p, cache, tk, ps)

    j_lg, j_cache = _run_jax(mesh, jcfg, jrun, params, prompt, tok, pos,
                             out_specs=(P(), P()))
    tp = _port_params(tree)
    cache, _ = tgpt.prefill(tcfg, tp, torch.as_tensor(prompt), max_len=32)
    t_lg, t_cache = tgpt.decode_step(tcfg, tp, cache, torch.as_tensor(tok),
                                     torch.as_tensor(pos))
    np.testing.assert_allclose(_np(t_lg), np.asarray(j_lg), **FP32_TOL)
    np.testing.assert_allclose(_np(t_cache), np.asarray(j_cache), **FP32_TOL)


def test_decode_step_bf16_matches_jax(mesh, weights):
    """bf16 band of the decode step, the same 2.5-ulp band as the logits
    (the cache entries are bf16 K/V of the same scale)."""
    params, tree = weights
    jcfg, tcfg = _cfgs("bf16", decode_attn_impl="xla")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, (2, 8), np.int32)
    tok = rng.integers(0, 256, (2,), np.int32)
    pos = np.asarray([8, 5], np.int32)

    def jrun(cfg, p, t, tk, ps):
        cache, _ = jgpt.prefill(cfg, p, t, max_len=16)
        return jgpt.decode_step(cfg, p, cache, tk, ps)

    j_lg, j_cache = _run_jax(mesh, jcfg, jrun, params, prompt, tok, pos,
                             out_specs=(P(), P()))
    tp = _port_params(tree)
    cache, _ = tgpt.prefill(tcfg, tp, torch.as_tensor(prompt), max_len=16)
    t_lg, t_cache = tgpt.decode_step(tcfg, tp, cache, torch.as_tensor(tok),
                                     torch.as_tensor(pos))
    np.testing.assert_allclose(_np(t_lg), np.asarray(j_lg, np.float32),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(_np(t_cache), np.asarray(j_cache, np.float32),
                               rtol=0, atol=2e-2)


def _top2_gap(cfg, params, prefix):
    lg, _ = tgpt.prefill(cfg, params, torch.as_tensor([prefix]))
    top = torch.topk(lg[0], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("eos", [None, 7])
def test_greedy_generate_token_identical_to_jax(mesh, lively_weights, eos):
    params, tree = lively_weights
    jcfg, tcfg = _cfgs(init_std=0.2)
    rng = np.random.default_rng(6)
    tp = _port_params(tree)
    n_new = 12
    for p_len in (1, 5, 11):
        prompt = rng.integers(0, 256, (1, p_len), np.int32)
        want = np.asarray(_run_jax(
            mesh, jcfg, lambda c, p, t: jgpt.generate(
                c, p, t, n_new, eos_token_id=eos), params, prompt))[0]
        got = tgpt.generate(tcfg, tp, torch.as_tensor(prompt), n_new,
                            eos_token_id=eos, device="cpu")[0].tolist()
        if got != want.tolist():
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            gap = _top2_gap(tcfg, tp, prompt[0].tolist() + got[:i])
            pytest.fail(f"p_len={p_len}: port {got} != jax {want.tolist()} "
                        f"from step {i}; top-2 logit gap there {gap:.3e}")


#: fields that raised until their slice was ported, and now build
PORTED_FIELDS = {("ln_impl", "pallas")}    # the LayerNorm kernels' slice


@pytest.mark.parametrize("field,value", [
    ("context_parallel", True), ("fsdp", True), ("num_experts", 4),
    ("kv_cache_dtype", "int8"), ("kv_cache_dtype", "fp8"),
    ("ln_impl", "pallas"), ("ce_impl", "fused"),
    ("attn_impl", "xla_chunked"), ("attn_layout", "bhsd"),
    ("attn_impl", "bogus"), ("ln_impl", "bogus")])
def test_unsupported_config_fields_raise(field, value):
    if (field, value) in PORTED_FIELDS:
        assert getattr(tgpt.GPTConfig(**SMALL, **{field: value}),
                       field) == value
        return
    with pytest.raises(ValueError):
        tgpt.GPTConfig(**SMALL, **{field: value})


def test_sequence_parallel_is_stripped_on_decode(weights):
    _, tree = weights
    _, tcfg = _cfgs()
    tp = _port_params(tree)
    prompt = torch.as_tensor(
        np.random.default_rng(7).integers(0, 256, (1, 6), np.int32))
    plain = tgpt.generate(tcfg, tp, prompt, 4, device="cpu")
    sp = tgpt.generate(dataclasses.replace(tcfg, sequence_parallel=True),
                       tp, prompt, 4, device="cpu")
    assert plain.tolist() == sp.tolist()


def test_decode_kernel_and_xla_impls_agree(weights):
    """Port-internal: the kernel impl (its plain version on the CPU) and
    the one-hot/materialised impl give the same logits and cache in
    fp32, with stale NaN columns in the cache past every row's
    position left out of the result."""
    _, tree = weights
    _, tcfg = _cfgs()
    tp = _port_params(tree)
    prompt = torch.as_tensor(
        np.random.default_rng(8).integers(0, 256, (2, 6), np.int32))
    outs = {}
    for impl in ("kernel", "xla"):
        cfg = dataclasses.replace(tcfg, decode_attn_impl=impl)
        cache, lg = tgpt.prefill(cfg, tp, prompt, max_len=16)
        if impl == "kernel":
            cache[:, :, :, :, 7:] = float("nan")
        tok = lg.argmax(-1)
        lg2, cache = tgpt.decode_step(cfg, tp, cache, tok,
                                      torch.tensor([6, 6]))
        outs[impl] = (lg2, cache[:, :, :, :, :7])
    np.testing.assert_allclose(_np(outs["kernel"][0]), _np(outs["xla"][0]),
                               **FP32_TOL)
    np.testing.assert_allclose(_np(outs["kernel"][1]), _np(outs["xla"][1]),
                               **FP32_TOL)
