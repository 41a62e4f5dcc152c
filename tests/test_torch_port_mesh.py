"""The port's mesh and collectives vs the JAX package's.

The port runs four gloo ranks on the CPU (``apex_tpu_torch.testing.
run_ranks``, one spawn for the whole file); the JAX package runs its
collectives inside ``jax.shard_map`` over the conftest's CPU devices on
a mesh of the same shape, device r standing where rank r stands. Every
rank gets its own block of one seeded numpy array, and every output of
every rank is held to JAX's bit for bit, except the sums over four
ranks: gloo adds them in its ring's order and XLA in its own, so they
agree within fp32 rounding (1e-6).

The cases: tp=4; tp=2 x dp=2 over tp, over dp, and over (dp, tp) —
the rank order a wrong unravel would get wrong only there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as jmx
from apex_tpu_torch import mesh as tmx
from apex_tpu_torch import testing as ttesting

WORLD = 4
X = np.random.default_rng(0).standard_normal((WORLD, 4, 8)).astype(
    np.float32)
CASES = {
    "tp4": ({"tp": 4}, "tp"),
    "tp2dp2_tp": ({"tp": 2, "dp": 2}, "tp"),
    "tp2dp2_dp": ({"tp": 2, "dp": 2}, "dp"),
    "tp2dp2_both": ({"tp": 2, "dp": 2}, ("dp", "tp")),
}
BAD = [{"tp": 3}, {"tp": 2, "pp": 2, "dp": 4}, {"tp": 0}]
OPS = ["psum", "pmean", "pmax", "pmin", "all_gather0", "all_gather1",
       "all_gather0_stacked", "all_gather1_stacked", "psum_scatter0",
       "reduce_scatter1", "ring", "edge", "back2", "a2a_0_1", "a2a_1_0",
       "bcast3"]


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    payload = {"cases": [{"name": n, "mesh": kw, "axis": ax, "x": X}
                         for n, (kw, ax) in CASES.items()],
               "bad_meshes": BAD}
    out = ttesting.run_ranks("collectives", WORLD, payload,
                             str(tmp_path_factory.mktemp("rig_mesh")),
                             timeout=90)
    return out


def _jax_ops(axis, x, size):
    return {
        "psum": jmx.psum(x, axis),
        "pmean": jmx.pmean(x, axis),
        "pmax": lax.pmax(x, axis),
        "pmin": lax.pmin(x, axis),
        "all_gather0": jmx.all_gather(x, axis, gather_axis=0),
        "all_gather1": jmx.all_gather(x, axis, gather_axis=1),
        "all_gather0_stacked": jmx.all_gather(x, axis, gather_axis=0,
                                              tiled=False),
        "all_gather1_stacked": jmx.all_gather(x, axis, gather_axis=1,
                                              tiled=False),
        "psum_scatter0": jmx.psum_scatter(x, axis),
        "reduce_scatter1": jmx.reduce_scatter(x, axis, scatter_axis=1),
        "ring": jmx.ppermute_shift(x, axis, 1, wrap=True),
        "edge": jmx.ppermute_shift(x, axis, 1, wrap=False),
        "back2": jmx.ppermute_shift(x, axis, -2, wrap=False),
        "a2a_0_1": jmx.all_to_all(x, axis, split_axis=0, concat_axis=1),
        "a2a_1_0": jmx.all_to_all(x, axis, split_axis=1, concat_axis=0),
        "bcast3": jmx.pbroadcast_from(x, axis, src_index=3 % size),
    }


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    kw, axis = CASES[name]
    m = jmx.build_mesh(devices=jax.devices()[:WORLD], **kw)
    every = P(tuple(m.axis_names))
    size = int(np.prod([jmx.mesh_shape_of(m)[a] for a in (
        (axis,) if isinstance(axis, str) else axis)]))

    def f(x):
        return {k: v[None] for k, v in _jax_ops(axis, x[0], size).items()}

    out = jax.jit(jax.shard_map(f, mesh=m, in_specs=every,
                                out_specs=every, check_vma=False))(
        jnp.asarray(X))
    ids = np.vectorize(lambda d: d.id)(m.devices)
    return {k: np.asarray(v) for k, v in out.items()}, ids, m


def test_rig_children_import_no_jax(rig):
    assert [r["jax_loaded"] for r in rig] == [False] * WORLD


@pytest.mark.parametrize("name", list(CASES))
def test_rank_coordinates_are_jax_device_places(rig, name):
    """Rank r sits where JAX's mesh puts device r (tp innermost), and its
    index along the case's axes is JAX's ``axis_index``."""
    want, ids, m = _jax_case(name)
    kw, axis = CASES[name]
    for r, res in enumerate(rig):
        got = res["result"][name]
        place = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(got["coords"][a] for a in m.axis_names) == place
        axes = (axis,) if isinstance(axis, str) else axis
        idx = 0
        for a in axes:
            idx = idx * jmx.mesh_shape_of(m)[a] + got["coords"][a]
        assert got["index"] == idx
        assert got["size"] == int(np.prod([jmx.mesh_shape_of(m)[a]
                                           for a in axes]))
        assert got["untouched"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", list(CASES))
def test_collective_matches_jax(rig, name, op):
    """Each rank's output of ``op`` equals JAX's on device r: the same
    shape and the same bits, but for sums over four ranks (within
    1e-6)."""
    want, ids, m = _jax_case(name)
    summed = op in ("psum", "pmean", "psum_scatter0", "reduce_scatter1")
    for r, res in enumerate(rig):
        got = res["result"][name][op]
        w = want[op][r]
        assert got.shape == w.shape, (op, got.shape, w.shape)
        if summed and res["result"][name]["size"] > 2:
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("kw", BAD, ids=str)
def test_bad_factorizations_raise_jax_errors(rig, kw):
    """The factorisation errors of ``MeshConfig.resolve_dp``, word for
    word."""
    cfg = jmx.MeshConfig(**kw)
    with pytest.raises(ValueError) as want:
        cfg.resolve_dp(WORLD)
    assert rig[0]["result"]["_errors"][repr(kw)] == str(want.value)
    with pytest.raises(ValueError) as got:
        tmx.MeshConfig(**kw).resolve_dp(WORLD)
    assert str(got.value) == str(want.value)


def test_tp_innermost_default_order():
    assert tmx.DEFAULT_AXIS_ORDER == jmx.topology.DEFAULT_AXIS_ORDER
    assert tmx.__all__ == jmx.__all__
    with pytest.raises(NotImplementedError, match="later distributed"):
        tmx.build_hybrid_mesh(tp=2)


def test_collectives_need_a_mesh():
    import torch

    with pytest.raises(RuntimeError, match="no mesh"):
        tmx.psum(torch.ones(2), "tp")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmx.build_mesh(tp=1, device="cpu")
