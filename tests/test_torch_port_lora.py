"""apex_tpu_torch: batched multi-LoRA serving on the CPU, against the JAX
package.

Oracles, on one set of weights (a 2-layer GPT, hidden 64, 4 heads, vocab
96, fp32; JAX's init crossed over through numpy) and the adapters of
seeds 7 and 9 at rank 4, alpha 8:

- ``init_lora_weights`` bit-equal to JAX's; ``_lora_delta`` in its 2-D
  and 3-D branches within 1e-6 of JAX's in fp32 and within a bf16 ulp in
  bf16; ``init_lora_pool`` + ``lora_set_row`` and ``merge_lora`` equal to
  JAX's through the state bridge;
- ``decode_step``, ``prefill_many``, ``decode_verify`` and
  ``prefill_extend`` with the heterogeneous ids ``[0, 1, 2]`` against
  JAX's with ``lora=`` (JAX's pool crossed over), within fp32 rounding;
- the engine: base streams on a pool engine equal a pool-less engine's
  and JAX's solo ``generate``; adapter streams equal JAX's ``generate``
  over JAX's ``merge_lora``, token for token; a mixed batch equals each
  request served alone; paged + int8 + ``spec_k=2`` equals contiguous
  plain int8 with adapters; no ``lora=`` bundle reaches a forward while
  every row carries the base adapter;
- JAX's validation wording: a disabled pool, ids out of range, wrong
  shapes, a full pool, idempotent names, exactly one of ``weights`` and
  ``seed``; the scheduler's prefix exclusion; ``/v1/models``' adapter
  rows and routing by model name over a real socket.
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
)
from apex_tpu_torch.serving.api import start_api_server
from apex_tpu_torch.serving.engine import Admission

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 96
# init_std 0.2: at the default 0.02 a random model's greedy stream repeats
# its last prompt token, which would make token identity an empty check
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=48, remat=False, init_std=0.2)
RANK, ALPHA = 4, 8.0
SEEDS = (7, 9)
GEOM = dict(slots=3, max_prompt_len=10, max_seq_len=24, decode_chunk=2,
            adapter_slots=4, adapter_rank=RANK, adapter_alpha=ALPHA)
P_LEN, N_NEW = 6, 8
#: fp32 on both sides, the matmuls summed in other orders
TOL = dict(rtol=1e-4, atol=1e-4)


def _tcfg(**over):
    return tgpt.GPTConfig(**{**SMALL, "compute_dtype": torch.float32,
                             **over})


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, mesh, port params, JAX pool, numpy weights)."""
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    weights = [jgpt.init_lora_weights(jcfg, RANK, s) for s in SEEDS]
    pool = jgpt.init_lora_pool(jcfg, params, 3, RANK)
    for i, w in enumerate(weights):
        pool = jgpt.lora_set_row(pool, w, i + 1)
    return jcfg, params, mesh, tparams, pool, weights


def _run_jax(mesh, fn, *args):
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(),) * len(args), out_specs=P(),
        check_vma=False))(*args)


def _np(t):
    return t.detach().float().cpu().numpy()


# -- the primitives ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_init_lora_weights_bit_equal(model, seed):
    jcfg = model[0]
    want = jgpt.init_lora_weights(jcfg, RANK, seed)
    got = tgpt.init_lora_weights(_tcfg(), RANK, seed)
    assert got.keys() == want.keys()
    for site in want:
        for part in ("a", "b"):
            assert got[site][part].dtype == np.float32
            np.testing.assert_array_equal(got[site][part], want[site][part])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_lora_delta_matches_jax(ndim, dtype):
    rng = np.random.default_rng(5)
    shape = (3, 5, 64) if ndim == 3 else (3, 64)
    x = rng.normal(size=shape).astype(np.float32)
    a = rng.normal(0, 0.3, (4, RANK, 64)).astype(np.float32)
    b = rng.normal(0, 0.3, (4, RANK, 48)).astype(np.float32)
    ids = np.array([0, 3, 1], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jgpt._lora_delta(
        jnp.asarray(x, jd), jnp.asarray(a, jd), jnp.asarray(b, jd), ids,
        ALPHA / RANK).astype(jnp.float32))
    got = tgpt._lora_delta(torch.tensor(x).to(td), torch.tensor(a).to(td),
                           torch.tensor(b).to(td), torch.tensor(ids),
                           ALPHA / RANK)
    assert got.dtype == td and got.shape == want.shape
    if dtype == "float32":
        # fp32 rounding of sums in another order, at the delta's scale
        np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    else:
        # the same products rounded once to bf16, then the scale: at most
        # one bf16 ulp apart where the fp32 sums round to either side
        np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7, atol=0)


def test_pool_and_merge_match_jax_through_the_bridge(model):
    jcfg, params, _, tparams, pool, weights = model
    tpool = tgpt.init_lora_pool(_tcfg(), tparams, 3, RANK)
    for i, w in enumerate(weights):
        tgpt.lora_set_row(tpool, w, i + 1)
    want = jax.tree.map(np.asarray, pool)
    got = tgpt.lora_pool_to_numpy(tpool)
    for site in want:
        for part in ("a", "b"):
            np.testing.assert_array_equal(got[site][part], want[site][part])
            assert not got[site][part][:, 0].any()
    back = tgpt.lora_pool_from_numpy(want, device="cpu")
    assert all(torch.equal(back[s][p], tpool[s][p])
               for s in want for p in ("a", "b"))
    for w in weights:
        jm = jax.tree.map(np.asarray, jgpt.merge_lora(jcfg, params, w,
                                                      ALPHA))
        tm = tgpt.params_to_numpy(tgpt.merge_lora(_tcfg(), tparams, w,
                                                  ALPHA))
        leaves = jax.tree_util.tree_leaves_with_path(jm)
        for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(tm)):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=str(path))
    # the merge copies: the original params are untouched
    np.testing.assert_array_equal(
        _np(tparams["layers"]["mlp"]["fc1"]["kernel"]),
        np.asarray(params["layers"]["mlp"]["fc1"]["kernel"]))


# -- the forwards with lora=, against JAX's --------------------------------

@pytest.fixture(scope="module")
def forwards(model):
    """JAX's prefill_many, decode_step, decode_verify and prefill_extend
    with ``lora=(pool, [0, 1, 2], alpha / r)``."""
    jcfg, params, mesh, _, pool, _ = model
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, VOCAB, (3, 8)).astype(np.int32)
    last = np.array([7, 3, 5], np.int32)
    ids = np.array([0, 1, 2], np.int32)
    step = rng.integers(0, VOCAB, (3,)).astype(np.int32)
    verify = rng.integers(0, VOCAB, (3, 3)).astype(np.int32)
    tail = rng.integers(0, VOCAB, (3, 4)).astype(np.int32)
    sc = ALPHA / RANK
    lora = lambda pl, i: (pl, i, sc)
    cache, lg0 = _run_jax(mesh, lambda p, t, l, pl, i: jgpt.prefill_many(
        jcfg, p, t, l, max_len=16, lora=lora(pl, i)), params, prompts,
        last, pool, ids)
    lg1, cache1 = _run_jax(mesh, lambda p, c, t, ps, pl, i: jgpt.decode_step(
        jcfg, p, c, t, ps, lora=lora(pl, i)), params, cache, step,
        last + 1, pool, ids)
    lg2, cache2 = _run_jax(
        mesh, lambda p, c, t, ps, pl, i: jgpt.decode_verify(
            jcfg, p, c, t, ps, lora=lora(pl, i)), params, cache1, verify,
        last + 2, pool, ids)
    prefix = np.asarray(cache)[:, :, :, :, :8]
    tkv, lg3 = _run_jax(
        mesh, lambda p, kv, t, l, pl, i: jgpt.prefill_extend(
            jcfg, p, kv, t, l, prefix_len=8, lora=lora(pl, i)), params,
        prefix, tail, np.array([3, 1, 2], np.int32), pool, ids)
    ins = dict(prompts=prompts, last=last, ids=ids, step=step,
               verify=verify, tail=tail, prefix=prefix)
    outs = dict(cache=cache, lg0=lg0, lg1=lg1, cache1=cache1, lg2=lg2,
                cache2=cache2, tkv=tkv, lg3=lg3)
    return ins, jax.tree.map(np.asarray, outs)


def test_forwards_with_lora_match_jax(model, forwards):
    _, _, _, tparams, pool, _ = model
    ins, want = forwards
    cfg = _tcfg()
    t = lambda a: torch.as_tensor(a).long()
    lora = (tgpt.lora_pool_from_numpy(jax.tree.map(np.asarray, pool),
                                      device="cpu"),
            torch.as_tensor(ins["ids"]), ALPHA / RANK)
    cache, lg0 = tgpt.prefill_many(cfg, tparams, t(ins["prompts"]),
                                   t(ins["last"]), max_len=16, lora=lora)
    np.testing.assert_allclose(_np(lg0), want["lg0"], **TOL)
    np.testing.assert_allclose(_np(cache), want["cache"], **TOL)
    lg1, cache = tgpt.decode_step(cfg, tparams, cache, t(ins["step"]),
                                  t(ins["last"] + 1), lora=lora)
    np.testing.assert_allclose(_np(lg1), want["lg1"], **TOL)
    np.testing.assert_allclose(_np(cache), want["cache1"], **TOL)
    lg2, cache = tgpt.decode_verify(cfg, tparams, cache, t(ins["verify"]),
                                    t(ins["last"] + 2), lora=lora)
    np.testing.assert_allclose(_np(lg2), want["lg2"], **TOL)
    np.testing.assert_allclose(_np(cache), want["cache2"], **TOL)
    tkv, lg3 = tgpt.prefill_extend(
        cfg, tparams, torch.tensor(ins["prefix"]), t(ins["tail"]),
        torch.tensor([3, 1, 2]), prefix_len=8, lora=lora)
    np.testing.assert_allclose(_np(lg3), want["lg3"], **TOL)
    np.testing.assert_allclose(_np(tkv), want["tkv"], **TOL)
    # the base row is the base model's, the adapter rows move
    _, base = tgpt.prefill_many(cfg, tparams, t(ins["prompts"]),
                                t(ins["last"]), max_len=16)
    assert torch.equal(base[0], lg0[0])
    assert all(float((base[i] - lg0[i]).abs().max()) > 1e-3 for i in (1, 2))


# -- the engine --------------------------------------------------------------

def _trace(adapters, n=6, sampled=False):
    reqs = []
    for i in range(n):
        prompt = np.random.default_rng(500 + i).integers(
            0, VOCAB, P_LEN).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=7, seed=17 + i)
              if sampled and i % 3 == 1 else SamplingParams())
        reqs.append(Request(f"r{i}", prompt, max_tokens=N_NEW, sampling=sp,
                            adapter=adapters[i % len(adapters)]))
    return reqs


def _clone(reqs):
    return [dataclasses.replace(r, arrival_time=None) for r in reqs]


def _engine(tparams, cfg=None, **over):
    eng = Engine(cfg or _tcfg(), tparams, EngineConfig(**{**GEOM, **over}),
                 device="cpu")
    if eng.adapter_pool_enabled:
        for s in SEEDS:
            eng.register_adapter(seed=s)
    return eng


def _serve(engine, reqs, **kw):
    sched = Scheduler(engine, **kw)
    for r in _clone(reqs):
        sched.submit(r)
    sched.run_until_idle()
    return {k: c.tokens for k, c in sched.completions.items()}


@pytest.fixture(scope="module")
def jax_solo(model):
    """JAX's greedy ``generate`` of the trace's prompts (one batch) over
    the base params and over each adapter's ``merge_lora``."""
    jcfg, params, mesh, _, _, weights = model
    prompts = np.stack([r.prompt for r in _trace((0,))]).astype(np.int32)
    gen = jax.jit(jax.shard_map(
        lambda p, t: jgpt.generate(jcfg, p, t, N_NEW), mesh=mesh,
        in_specs=(jgpt.param_specs(jcfg), P()), out_specs=P(),
        check_vma=False))
    out = {0: np.asarray(gen(params, prompts)).tolist()}
    for i, w in enumerate(weights):
        merged = jgpt.merge_lora(jcfg, params, w, ALPHA)
        out[i + 1] = np.asarray(gen(merged, prompts)).tolist()
    return out


def test_base_streams_on_a_pool_engine(model, jax_solo):
    tparams = model[3]
    reqs = _trace((0,))
    pool = _serve(_engine(tparams), reqs)
    plain = _serve(_engine(tparams, adapter_slots=0), reqs)
    assert pool == plain
    assert [pool[r.request_id] for r in reqs] == jax_solo[0]


@pytest.mark.parametrize("adapter", [1, 2])
def test_adapter_streams_match_jax_merged_generate(model, jax_solo,
                                                   adapter):
    tparams = model[3]
    reqs = _trace((adapter,))
    got = _serve(_engine(tparams), reqs)
    assert [got[r.request_id] for r in reqs] == jax_solo[adapter]
    # the delta moves tokens: the base streams differ somewhere
    assert [got[r.request_id] for r in reqs] != jax_solo[0]


def test_mixed_batch_equals_solo_runs(model, jax_solo):
    tparams = model[3]
    reqs = _trace((0, 1, 2), sampled=True)
    eng = _engine(tparams)
    mixed = _serve(eng, reqs)
    for i, r in enumerate(reqs):
        assert _serve(eng, [r])[r.request_id] == mixed[r.request_id]
        if r.sampling.temperature == 0.0:
            assert mixed[r.request_id] == jax_solo[r.adapter][i]


def test_paged_int8_spec_equals_contiguous_int8_with_adapters(model):
    tparams = model[3]
    cfg = _tcfg(kv_cache_dtype="int8")
    reqs = _trace((0, 1, 2), n=3)
    plain = _serve(_engine(tparams, cfg, slots=2), reqs)
    spec = _serve(_engine(tparams, cfg, slots=2, page_size=8, spec_k=2,
                          spec_hist=12), reqs)
    assert spec == plain


def test_base_traffic_passes_no_bundle(model, monkeypatch):
    """Every forward of base-only traffic on a pool engine runs without
    ``lora=`` (launch for launch a pool-less engine's); a live adapter row
    turns the decode bundle on, its release turns it off again."""
    tparams = model[3]
    seen = []
    for name in ("decode_steps", "prefill_many"):
        real = getattr(tgpt, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, kw.get("lora") is not None))
            return _real(*a, **kw)

        monkeypatch.setattr(tgpt, name, spy)
    eng = _engine(tparams)
    _serve(eng, _trace((0,), n=3))
    assert seen and not any(on for _, on in seen)
    assert eng.adapter_id_uploads == 0
    seen.clear()
    sched = Scheduler(eng)
    sched.submit(Request("a", [1, 2, 3], max_tokens=N_NEW, adapter=2))
    sched.step()
    assert ("prefill_many", True) in seen and ("decode_steps", True) in seen
    assert eng._adapter_ids.tolist() == [2, 0, 0]
    sched.run_until_idle()
    assert eng._adapter_ids.tolist() == [0, 0, 0]
    seen.clear()
    _serve(eng, _trace((0,), n=2))
    assert not any(on for _, on in seen)
    assert eng.adapter_id_uploads == 1


# -- validation ---------------------------------------------------------------

def test_engine_adapter_validation(model):
    jcfg, tparams = model[0], model[3]
    eng = _engine(tparams)
    assert eng.adapters_registered == 2
    assert eng.adapter_names == {"adapter-seed-7": 1, "adapter-seed-9": 2}
    assert eng.register_adapter(seed=7) == 1          # idempotent
    assert eng.register_adapter(
        tgpt.init_lora_weights(_tcfg(), RANK, 1), name="x") == 3
    assert eng.register_adapter(seed=2, name="x") == 3
    assert eng.adapter_bytes() == sum(
        4 * 4 * RANK * n for n in (64 + 3 * 64, 64 + 64, 64 + 256,
                                   256 + 64)) * 2
    assert [a["id"] for a in eng.describe()["adapters"]] == [1, 2, 3]
    with pytest.raises(ValueError, match="exactly one"):
        eng.register_adapter()
    with pytest.raises(ValueError, match="exactly one"):
        eng.register_adapter(tgpt.init_lora_weights(_tcfg(), RANK, 1),
                             seed=1)
    bad = jgpt.init_lora_weights(jcfg, RANK + 1, 0)
    with pytest.raises(ValueError, match="ADAPTER-STATIC"):
        eng.register_adapter(bad, name="bad-rank")
    good = tgpt.init_lora_weights(_tcfg(), RANK, 3)
    with pytest.raises(ValueError, match="missing site 'proj'"):
        eng.register_adapter({"qkv": good["qkv"]}, name="no-sites")
    # a malformed adapter fails as malformed even on a full pool
    with pytest.raises(ValueError, match="full"):
        eng.register_adapter(seed=99)
    with pytest.raises(ValueError, match="ADAPTER-STATIC"):
        eng.register_adapter(bad, name="bad-rank")
    with pytest.raises(ValueError, match="registered rows"):
        eng.admit_many([Admission(slot=0, prompt=[1, 2], max_tokens=2,
                                  adapter=4)])
    plain = _engine(tparams, adapter_slots=0)
    assert not plain.adapter_pool_enabled and plain.adapter_bytes() == 0
    with pytest.raises(ValueError, match="adapter pool disabled"):
        plain.register_adapter(seed=1)
    with pytest.raises(ValueError, match="adapter pool is disabled"):
        plain.admit_many([Admission(slot=0, prompt=[1, 2], max_tokens=2,
                                    adapter=1)])
    with pytest.raises(ValueError, match="adapter_slots -1"):
        _engine(tparams, adapter_slots=-1)
    with pytest.raises(ValueError, match="adapter_rank 0"):
        _engine(tparams, adapter_rank=0)


def test_scheduler_adapter_validation_and_prefix_exclusion(model):
    tparams = model[3]
    sched = Scheduler(_engine(tparams, adapter_slots=0))
    with pytest.raises(ValueError, match="adapter pool is disabled"):
        sched.submit(Request("a", [1, 2], max_tokens=2, adapter=1))
    eng = _engine(tparams, prefix_pool_slots=1, max_prompt_len=16,
                  max_seq_len=32)
    sched = Scheduler(eng)
    assert sched.summary()["adapters_registered"] == 2.0
    for bad in (3, -1):
        with pytest.raises(ValueError, match=r"registered ids \[1, 2\]"):
            sched.submit(Request("b", [1, 2], max_tokens=2, adapter=bad))
    template = list(range(1, 9))
    sched.register_prefix(template)
    sched.submit(Request("base", template + [5, 6], max_tokens=3))
    sched.submit(Request("lora", template + [5, 6], max_tokens=3,
                         adapter=1))
    assert set(sched._prefix_hits) == {"base"}
    s = sched.summary()
    assert s["prefix_hits"] == 1.0 and s["prefix_misses"] == 0.0
    sched.run_until_idle()
    assert eng.prefix_admits == 1
    # the adapter stream is its cold admission's
    cold = _serve(_engine(tparams, max_prompt_len=16, max_seq_len=32),
                  [Request("lora", template + [5, 6], max_tokens=3,
                           adapter=1)])
    assert sched.completions["lora"].tokens == cold["lora"]
    page, split = eng.match_prefix(template + [5, 6])
    with pytest.raises(ValueError, match="base adapter"):
        eng.admit_many([Admission(slot=0, prompt=template + [5, 6],
                                  max_tokens=2, adapter=1,
                                  prefix_page=page, prefix_len=split)])


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def test_models_list_and_routing_by_name():
    cfg = _tcfg(vocab_size=320, seq_len=64)
    params = tgpt.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    eng = Engine(cfg, params, EngineConfig(
        slots=2, max_prompt_len=32, max_seq_len=48, adapter_slots=3,
        adapter_rank=RANK, adapter_alpha=ALPHA), device="cpu")
    sched = Scheduler(eng)
    # factors at std 0.2, whose delta moves this model's greedy tokens
    names = ("ft-a", "ft-b")
    ids = [sched.register_adapter(
        {site: {k: 10 * v for k, v in parts.items()} for site, parts in
         tgpt.init_lora_weights(cfg, RANK, s).items()}, name=n)
        for s, n in zip(SEEDS, names)]
    server = start_api_server(sched, port=0, model="base-gpt")
    try:
        status, models = _http(server.port, "GET", "/v1/models")
        assert status == 200
        assert models["data"] == [
            {"id": "base-gpt", "object": "model", "owned_by": "apex_tpu"}] + [
            {"id": n, "object": "model", "owned_by": "apex_tpu",
             "parent": "base-gpt", "adapter": i}
            for n, i in zip(names, ids)]
        got = {}
        for name in ("ft-b", "base-gpt", "no-such-model"):
            status, d = _http(server.port, "POST", "/v1/completions", {
                "model": name, "prompt": [5, 17, 3, 250], "max_tokens": 8,
                "return_token_ids": True})
            assert status == 200 and d["model"] == name
            got[name] = d["choices"][0]["token_ids"]
    finally:
        server.stop()
    direct = Scheduler(eng)
    for a in (0, ids[1]):
        direct.submit(Request(f"d{a}", [5, 17, 3, 250], max_tokens=8,
                              adapter=a))
    direct.run_until_idle()
    assert got["ft-b"] == direct.completions[f"d{ids[1]}"].tokens
    assert got["base-gpt"] == got["no-such-model"] == \
        direct.completions["d0"].tokens
    assert got["ft-b"] != got["base-gpt"]
