"""The port's tensor-parallel core vs the JAX package's, at tp=4.

The port runs four gloo ranks on the CPU (``apex_tpu_torch.testing``'s
``tp_core`` worker, one spawn for the file); JAX runs the same
functions inside ``jax.shard_map`` over a tp=4 mesh of the conftest's
CPU devices, on the same numpy inputs, device r taking the blocks rank r
takes. Following ``tests/test_transformer_tp.py``:

- the seven mappings, forward and backward: each rank's output and the
  gradient of ``sum(out * w)`` against ``jax.vjp`` of JAX's mapping
  (inputs differ per rank, so a reduction shows), ``tp_grad`` both ways;
- the column/row-parallel pair with and without sequence parallelism
  (the MLP's shape), every rank's gradient of every operand, and
  ``gather_output``;
- the vocab-parallel embedding and cross entropy (smoothing 0 and 0.1);
- the parallel state's sizes, ranks and group names on a tp=2 x dp=2
  mesh; the RNG streams' structure (distinct per tp rank, equal across
  dp; a tracker forks purely); ``broadcast_data``.

Data movement is bit for bit; sums over four ranks within 1e-6
(gloo's ring adds in another order than XLA), and products through
matmuls within 1e-5 (values of order 1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as jmx
from apex_tpu.transformer.tensor_parallel import cross_entropy as jce
from apex_tpu.transformer.tensor_parallel import layers as jtpl
from apex_tpu.transformer.tensor_parallel import mappings as jmp
from apex_tpu_torch import testing as ttesting
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.tensor_parallel import random as trandom

TP = 4
RANK_SCALE = 0.5
_rng = np.random.default_rng(1)
_f32 = lambda *s: _rng.standard_normal(s).astype(np.float32)
X = _f32(2, 8, 12)
W = {"copy": _f32(2, 8, 12), "reduce": _f32(2, 8, 12),
     "scatter": _f32(2, 8, 12), "gather": _f32(2, 8, 12),
     "seq_scatter": _f32(2, 8, 12), "seq_gather": _f32(2, 8, 12),
     "seq_gather_nogradreduce": _f32(2, 8, 12),
     "seq_reduce_scatter": _f32(2, 8, 12)}
LINEAR = {"x": _f32(8, 2, 6), "k1": _f32(6, 16), "b1": _f32(16),
          "k2": _f32(16, 6), "b2": _f32(6), "w": _f32(8, 2, 6)}
EMB = {"ids": _rng.integers(0, 16, (2, 5)), "table": _f32(16, 6),
       "w": _f32(2, 5, 6)}
CE = {"logits": _f32(4, 2, 16) * 3, "target": _rng.integers(0, 16, (4, 2)),
      "w": _f32(4, 2)}

#: mapping → (JAX function, the dim x arrives sharded on, the dim of
#: w (= the output) that is sharded), as the worker cuts them
MAPPINGS = {
    "copy": (jmp.copy_to_tensor_model_parallel_region, None, None),
    "reduce": (jmp.reduce_from_tensor_model_parallel_region, None, None),
    "scatter": (jmp.scatter_to_tensor_model_parallel_region, None, -1),
    "gather": (jmp.gather_from_tensor_model_parallel_region, -1, None),
    "seq_scatter": (lambda x: jmp.scatter_to_sequence_parallel_region(
        x, "tp", 1), None, 1),
    "seq_gather": (lambda x: jmp.gather_from_sequence_parallel_region(
        x, "tp", True, 1), 1, None),
    "seq_gather_nogradreduce": (
        lambda x: jmp.gather_from_sequence_parallel_region(
            x, "tp", False, 1), 1, None),
    "seq_reduce_scatter": (
        lambda x: jmp.reduce_scatter_to_sequence_parallel_region(
            x, "tp", 1), None, 1),
}


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    payload = {"tp": TP, "x": X, "w": W, "rank_scale": RANK_SCALE,
               "linear": LINEAR, "emb": EMB, "ce": CE}
    return ttesting.run_ranks("tp_core", TP, payload,
                              str(tmp_path_factory.mktemp("rig_tp")),
                              timeout=90)


@functools.lru_cache(maxsize=None)
def _mesh():
    return jmx.build_mesh(tp=TP, devices=jax.devices()[:TP])


def _spec(dim, ndim):
    if dim is None:
        return P()
    parts = [None] * ndim
    parts[dim % ndim] = "tp"
    return P(*parts)


def _smap(f, in_specs, out_specs):
    return jax.jit(jax.shard_map(f, mesh=_mesh(), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _stacked(fn, in_specs, args):
    """Per-device outputs of ``fn`` stacked on a new leading dim."""
    def f(*a):
        return jax.tree.map(lambda t: t[None], fn(*a))
    return jax.tree.map(np.asarray, _smap(f, in_specs, P("tp"))(*args))


def _close(got, want, *, summed=False, matmul=False):
    assert got.shape == want.shape, (got.shape, want.shape)
    if matmul:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif summed:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_rig_children_import_no_jax(rig):
    assert [r["jax_loaded"] for r in rig] == [False] * TP


@pytest.mark.parametrize("name", list(MAPPINGS))
def test_mapping_forward_and_backward_match_jax_vjp(rig, name):
    fn, x_dim, w_dim = MAPPINGS[name]

    def f(x, w):
        x = x + RANK_SCALE * lax.axis_index("tp").astype(x.dtype)
        y, vjp = jax.vjp(fn, x)
        return y, vjp(w)[0]

    y, g = _stacked(f, (_spec(x_dim, 3), _spec(w_dim, 3)),
                    (jnp.asarray(X), jnp.asarray(W[name])))
    summed = name in ("copy", "reduce", "seq_reduce_scatter", "seq_gather")
    for r, res in enumerate(rig):
        got = res["result"][name]
        _close(got["y"], y[r], summed=summed)
        _close(got["g"], g[r], summed=summed)


@pytest.mark.parametrize("sp", [False, True])
def test_column_row_pair_matches_jax(rig, sp):
    """The MLP shape: column-parallel (local ``[in, out/tp]`` block) →
    tanh → row-parallel; the output and every rank's gradient of x, both
    kernels and both biases (with SP the row bias's gradient is this
    rank's partial, JAX's too)."""
    def pair(x, k1, b1, k2, b2):
        h = jtpl.column_parallel_linear(x, k1, b1, sequence_parallel=sp)
        return jtpl.row_parallel_linear(jnp.tanh(h), k2, b2,
                                        sequence_parallel=sp)

    def f(x, k1, b1, k2, b2, w):
        y, vjp = jax.vjp(pair, x, k1, b1, k2, b2)
        return y, vjp(w)

    xs = P("tp") if sp else P()
    y, gs = _stacked(f, (xs, P(None, "tp"), P("tp"), P("tp", None), P(), xs),
                     tuple(jnp.asarray(LINEAR[k]) for k in
                           ("x", "k1", "b1", "k2", "b2", "w")))
    for r, res in enumerate(rig):
        got = res["result"][f"pair_sp{int(sp)}"]
        _close(got["y"], y[r], matmul=True)
        for a, b in zip(got["g"], gs):
            _close(a, b[r], matmul=True)


def test_gather_output_matches_jax(rig):
    out = _stacked(lambda x, k: jtpl.column_parallel_linear(
        x, k, None, gather_output=True), (P(), P(None, "tp")),
        (jnp.asarray(LINEAR["x"]), jnp.asarray(LINEAR["k1"])))
    for r, res in enumerate(rig):
        _close(res["result"]["gather_output"], out[r], matmul=True)


def test_vocab_parallel_embedding_matches_jax(rig):
    def f(table, w):
        y, vjp = jax.vjp(lambda t: jtpl.vocab_parallel_embedding(
            jnp.asarray(EMB["ids"]), t), table)
        return y, vjp(w)[0]

    y, g = _stacked(f, (P("tp", None), P()),
                    (jnp.asarray(EMB["table"]), jnp.asarray(EMB["w"])))
    for r, res in enumerate(rig):
        _close(res["result"]["emb"]["y"], y[r], summed=True)
        _close(res["result"]["emb"]["g"], g[r])


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(rig, eps):
    def f(lg, w):
        y, vjp = jax.vjp(lambda l: jce.vocab_parallel_cross_entropy(
            l, jnp.asarray(CE["target"]), eps), lg)
        return y, vjp(w)[0]

    y, g = _stacked(f, (P(None, None, "tp"), P()),
                    (jnp.asarray(CE["logits"]), jnp.asarray(CE["w"])))
    for r, res in enumerate(rig):
        got = res["result"][f"ce{eps}"]
        np.testing.assert_allclose(got["y"], y[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["g"], g[r], rtol=1e-5, atol=1e-6)


def test_parallel_state_sizes_and_ranks(rig):
    """``initialize_model_parallel(2, 1)`` over four ranks: tp 2, pp 1,
    dp 2 (JAX's ``test_parallel_state_sizes`` shape), tp rank innermost;
    the group handle is the axis name; a destroyed state raises."""
    for r, res in enumerate(rig):
        assert res["result"]["state"] == (2, 1, 2, 4, r % 2, r // 2, "tp")
        assert res["result"]["destroyed_raises"]


def test_rng_streams_distinct_per_tp_rank_equal_across_dp(rig):
    draws = {}
    for res in rig:
        tp_i, dp_i, d = res["result"]["rng_tp"]
        draws.setdefault(tp_i, []).append(d)
    for tp_i, ds in draws.items():
        assert all(np.array_equal(ds[0], d) for d in ds)
    assert not np.array_equal(draws[0][0], draws[1][0])
    forks = [res["result"]["rng_fork"] for res in rig]
    assert all(f[0] and f[1] for f in forks)
    assert len({f[2] for f in forks}) == 1   # the replicated stream


def test_rng_tracker_is_functional():
    """JAX's ``test_rng_tracker_fork_is_functional``, on integer keys."""
    tr = trandom.RNGStatesTracker().add("a", 0)
    k1, tr2 = tr.fork("a")
    k2, _ = tr.fork("a")
    assert k1 == k2
    k3, _ = tr2.fork("a")
    assert k1 != k3
    with pytest.raises(ValueError):
        tr.add("a", 1)
    with pytest.raises(ValueError):
        tr.fork("missing")
    assert tr2.set_states(tr2.get_states()).get_states().keys() == {"a"}


def test_checkpoint_matches_uncheckpointed():
    import torch

    x = torch.from_numpy(np.random.default_rng(9).standard_normal(8)
                         ).float().requires_grad_(True)
    block = lambda x: (torch.tanh(x) ** 2).sum()
    g1, = torch.autograd.grad(block(x), x)
    g2, = torch.autograd.grad(ttp.checkpoint(block)(x), x)
    g3, = torch.autograd.grad(trandom.checkpoint_call(block, x), x)
    g4, = torch.autograd.grad(trandom.checkpoint(
        block, policy=trandom.save_dots)(x), x)
    for g in (g2, g3, g4):
        torch.testing.assert_close(g, g1, rtol=1e-6, atol=0)


def test_broadcast_data_from_tp_rank0(rig):
    for res in rig:
        np.testing.assert_array_equal(res["result"]["broadcast_data"],
                                      np.zeros(3, np.int32))


def test_utils_and_attributes_match_jax():
    from apex_tpu.transformer.tensor_parallel import utils as jutils

    for args in ((16, 0, 4), (16, 3, 4)):
        assert (ttp.VocabUtility.vocab_range_from_global_vocab_size(*args)
                == jutils.VocabUtility.vocab_range_from_global_vocab_size(
                    *args))
    assert ttp.divide(12, 4) == 3
    with pytest.raises(ValueError):
        ttp.divide(10, 4)
    import torch
    parts = ttp.split_tensor_along_last_dim(torch.arange(12.).reshape(2, 6),
                                            3)
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 3
    for spec, par, dim in (((None,), True, 1), ((None, None), False, 0),
                           ((), True, 0)):
        got = ttp.set_tensor_model_parallel_attributes(spec, par, dim)
        want = jtpl.set_tensor_model_parallel_attributes(P(*spec), par, dim)
        assert tuple(got) == tuple(want)
        assert ttp.param_is_tensor_parallel(got) == \
            jtpl.param_is_tensor_parallel(want)
    lin = ttp.ColumnParallelLinear(6, 8)
    assert lin.specs == {"kernel": (None, "tp"), "bias": ("tp",)}
    p = lin.init(torch.Generator().manual_seed(0))
    assert p["kernel"].shape == (6, 8) and not p["bias"].any()
    assert ttp.RowParallelLinear(8, 6).specs["kernel"] == ("tp", None)
    assert ttp.VocabParallelEmbedding(16, 6).specs == {"table": ("tp", None)}
