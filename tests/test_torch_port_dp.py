"""The port's data-parallel runtime vs the JAX package's, at dp=4.

The port runs four gloo ranks on the CPU (``apex_tpu_torch.testing``'s
``ddp`` worker, one spawn for the file); JAX runs
``apex_tpu.parallel`` inside ``jax.shard_map`` over a dp=4 mesh of the
conftest's CPU devices, each device holding rank r's block of the same
numpy inputs. Following ``tests/test_parallel_dp.py``: the averaged and
summed ``allreduce_gradients``, the fp32 upcast of fp16 gradients
(whose fp16 sum overflows to inf where the fp32 one does not),
``flat_dist_call`` (pmean, psum, broadcast from rank 1) equal to the
per-tensor reduction, ``no_sync`` accumulation through
``DistributedDataParallel``, ``delay_allreduce``, the initial parameter
broadcast and ``Reducer``.

Data movement and fp16 results are held bit for bit; fp32 sums over four
ranks within 1e-6 (gloo's ring adds in another order than XLA).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as jmx
from apex_tpu import parallel as jpar
from apex_tpu_torch import testing as ttesting

DP = 4
_rng = np.random.default_rng(2)
GRADS = {"a": _rng.standard_normal((DP, 3, 5)).astype(np.float32),
         "b": _rng.standard_normal((DP, 7)).astype(np.float32)}
#: fp16 gradients whose sum over the ranks passes 65504
HALF = {"a": np.full((DP, 6), 30000.0, np.float32)}
PARAMS = {"w": np.array([0.5, -1.0, 2.0], np.float32),
          "b": np.array([0.25, 0.75], np.float32)}
XA = _rng.standard_normal((DP, 3)).astype(np.float32)
XB = _rng.standard_normal((DP, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    payload = {"dp": DP, "grads": GRADS, "half": HALF, "params": PARAMS,
               "xa": XA, "xb": XB}
    return ttesting.run_ranks("ddp", DP, payload,
                              str(tmp_path_factory.mktemp("rig_dp")),
                              timeout=90)


def _loss(p, x):
    return (jnp.sum(p["w"] * x) + jnp.sum(p["b"])) ** 2


@functools.lru_cache(maxsize=None)
def _jax():
    m = jmx.build_mesh(dp=DP, devices=jax.devices()[:DP])
    r = lambda t: t[0]
    grad = jax.grad(_loss)

    def f(g, half, xa, xb):
        g = jax.tree.map(r, g)
        half = jax.tree.map(lambda t: r(t).astype(jnp.float16), half)
        xa, xb = r(xa), r(xb)
        p = jax.tree.map(jnp.asarray, PARAMS)
        ddp = jpar.DistributedDataParallel()
        g1 = ddp.no_sync(grad)(p, xa)
        rank = jax.lax.axis_index("dp").astype(jnp.float32)
        red = jpar.Reducer()
        out = {
            "mean": jpar.allreduce_gradients(g),
            "sum": jpar.allreduce_gradients(g, gradient_average=False),
            "fp16": jpar.allreduce_gradients(half),
            "fp16_fp32": jpar.allreduce_gradients(
                half, allreduce_always_fp32=True),
            "flat_pmean": jpar.flat_dist_call(g, op="pmean"),
            "flat_psum": jpar.flat_dist_call(g, op="psum"),
            "flat_broadcast": jpar.flat_dist_call(g, op="broadcast", src=1),
            "no_sync": g1,
            "accumulated": ddp.wrap_grad_fn(grad)(p, xb, accumulated=g1),
            "delay": jpar.DistributedDataParallel(
                delay_allreduce=True).wrap_grad_fn(grad)(p, xb),
            "bcast": ddp.broadcast_params({"w": p["w"] + rank}),
            "reducer": red.reduce(g),
            "reducer_bcast": red.broadcast(g, src=2),
        }
        return jax.tree.map(lambda t: t[None], out)

    every = P("dp")
    out = jax.jit(jax.shard_map(f, mesh=m, in_specs=every, out_specs=every,
                                check_vma=False))(GRADS, HALF, XA, XB)
    return jax.tree.map(lambda t: np.asarray(t, np.float32), out)


KEYS = ["mean", "sum", "fp16", "fp16_fp32", "flat_pmean", "flat_psum",
        "flat_broadcast", "no_sync", "accumulated", "delay", "bcast",
        "reducer", "reducer_bcast"]


def test_rig_children_import_no_jax(rig):
    assert [r["jax_loaded"] for r in rig] == [False] * DP


@pytest.mark.parametrize("key", KEYS)
def test_ddp_matches_jax(rig, key):
    want = _jax()[key]
    exact = key in ("fp16", "fp16_fp32", "flat_broadcast", "no_sync",
                    "delay", "bcast", "reducer_bcast")
    for r, res in enumerate(rig):
        got = res["result"][key]
        assert sorted(got) == sorted(want)
        for k in got:
            g = np.asarray(got[k], np.float32)
            if exact:
                np.testing.assert_array_equal(g, want[k][r])
            else:
                np.testing.assert_allclose(g, want[k][r], rtol=1e-6,
                                           atol=1e-6)


def test_fp32_upcast_avoids_the_fp16_overflow(rig):
    """The fp16 mean sums past 65504 (inf); the fp32 one is 30000, and
    the reduced leaves keep their fp16 dtype."""
    for res in rig:
        assert np.isinf(res["result"]["fp16"]["a"]).all()
        np.testing.assert_array_equal(res["result"]["fp16_fp32"]["a"],
                                      np.full(6, 30000.0, np.float16))
        assert res["result"]["fp16_dtype"] == "torch.float16"


def test_flat_call_equals_per_tensor_reduce(rig):
    """The overlap-equivalence regression: one flat-buffer reduction is
    the per-tensor one, bit for bit."""
    for res in rig:
        for k in GRADS:
            np.testing.assert_array_equal(res["result"]["flat_pmean"][k],
                                          res["result"]["mean"][k])
