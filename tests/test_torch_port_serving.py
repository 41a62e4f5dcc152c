"""apex_tpu_torch.serving — sampling, Engine and Scheduler on the CPU.

Oracles:

- the top-k/top-p filters (static and per-row forms) equal the JAX
  package's on the same logits;
- greedy streams through the port's ``Scheduler`` + ``Engine`` (fewer
  slots than requests, prompts across two buckets, decode chunks 1 and
  4, an eos case) are token-identical to the JAX package's solo
  ``gpt.generate`` of each request — the reference's documented
  continuous-batching contract;
- sampled streams through the engine are identical to the port's own
  solo ``generate`` with the same seed (the port's random bits are its
  own, see ``apex_tpu_torch.serving.sampling``);
- budget and finish semantics (``max_tokens`` 1, eos as the first token,
  an eos-terminal prompt, deadlines).
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
from apex_tpu.serving import sampling as jsampling
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
    sampling,
)
from apex_tpu_torch.serving.engine import Admission
from apex_tpu_torch.serving.request import (
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_TIMEOUT,
)

VOCAB = 256
# init_std 0.2: at the default 0.02 the tied embedding dominates and a
# random model's greedy stream repeats its last prompt token, which would
# make token identity an empty check
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=64, remat=False, init_std=0.2)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, mesh, port cfg, port params) — one set of
    weights, the JAX init tree crossed over."""
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    return jcfg, params, mesh, tcfg, tparams


_SOLO_CACHE = {}


def _jax_solo(model, prompt, n_new, eos=None):
    """JAX solo greedy ``gpt.generate`` of one request, truncated at its
    eos (inclusive) — the engine releases the slot there."""
    key = (tuple(prompt), n_new, eos)
    if key not in _SOLO_CACHE:
        jcfg, params, mesh, _, _ = model
        out = jax.jit(jax.shard_map(
            lambda p, t: jgpt.generate(jcfg, p, t, n_new, eos_token_id=eos,
                                       pad_token_id=0),
            mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P()),
            out_specs=P(), check_vma=False))(
                params, jnp.asarray([prompt], jnp.int32))
        toks = [int(t) for t in np.asarray(out)[0]]
        if eos is not None and eos in toks:
            toks = toks[:toks.index(eos) + 1]
        _SOLO_CACHE[key] = toks
    return _SOLO_CACHE[key]


def _port_solo(model, prompt, n_new, sp: SamplingParams, eos=None):
    _, _, _, tcfg, tparams = model
    out = tgpt.generate(tcfg, tparams, torch.tensor([prompt]), n_new,
                        temperature=sp.temperature, top_k=sp.top_k,
                        top_p=sp.top_p, seed=sp.seed, eos_token_id=eos,
                        device="cpu")[0].tolist()
    if eos is not None and eos in out:
        out = out[:out.index(eos) + 1]
    return out


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    # lengths span both buckets of max_prompt_len 16: (8, 16)
    lens = [1 + (7 * i + 3) % 16 for i in range(n)]
    return [rng.integers(0, VOCAB, n_).tolist() for n_ in lens]


def _serve(model, reqs, impls=None, **ecfg_kw):
    _, _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, **(impls or {}))
    ecfg = EngineConfig(slots=3, max_prompt_len=16, max_seq_len=32,
                        **ecfg_kw)
    sched = Scheduler(Engine(cfg, tparams, ecfg, device="cpu"))
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return sched


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [0, 5, 40])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5])
def test_filter_logits_matches_jax(top_k, top_p):
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    lg = (rng.standard_normal((3, 64)) * 3).astype(np.float32)
    want = np.asarray(jsampling.filter_logits(jnp.asarray(lg), top_k, top_p))
    got = sampling.filter_logits(torch.from_numpy(lg), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    want_t = np.asarray(jax.vmap(jsampling._filter_logits_traced)(
        jnp.asarray(lg)[:, None], jnp.full((3,), top_k, jnp.int32),
        jnp.full((3,), top_p, jnp.float32))[:, 0])
    got_t = sampling.filter_logits_traced(
        torch.from_numpy(lg), torch.full((3,), top_k),
        torch.full((3,), top_p)).numpy()
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_t, got)


def test_draw_depends_only_on_key_and_position():
    """A slot's draw is its solo draw whatever its batch-mates, and it
    changes with the position and the seed."""
    lg = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32))
    keys = torch.tensor([sampling.request_key(s, 0) for s in (1, 2, 3, 4)])
    t = torch.tensor([5, 5, 9, 9])
    temp = torch.full((4,), 1.0)
    batch = sampling.draw_slots(lg, keys, t, temp, torch.zeros(4),
                                torch.ones(4))
    for i, s in enumerate((1, 2, 3, 4)):
        solo = sampling.draw(lg[i:i + 1], int(t[i]), temperature=1.0, seed=s)
        assert int(solo[0]) == int(batch[i])
    draws = {int(sampling.draw(lg[:1], tt, temperature=1.0, seed=7)[0])
             for tt in range(40)}
    assert len(draws) > 5
    greedy = sampling.draw_slots(lg, keys, t, torch.zeros(4), torch.zeros(4),
                                 torch.ones(4))
    assert greedy.tolist() == lg.argmax(-1).tolist()


def test_gumbel_noise_is_standard_gumbel():
    keys = torch.tensor([sampling.request_key(3, 0)] * 4)
    g = sampling.gumbel_noise(keys, torch.arange(4), torch.zeros(4), 50000)
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean = Euler-Mascheroni 0.5772, var = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.02
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.05


# ---------------------------------------------------------------------------
# engine + scheduler vs solo generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,impls", [
    (1, {}), (4, {}),
    (4, {"attn_impl": "flash", "decode_attn_impl": "kernel"})])
def test_greedy_streams_match_jax_solo_generate(model, chunk, impls):
    """7 requests through 3 slots, prompts 1..16 tokens over buckets
    (8, 16), budgets 3..8: every stream equals the JAX solo generate of
    its request. The kernel impls run their plain versions here."""
    prompts = _prompts(7)
    reqs = [Request(f"r{i}", p, max_tokens=3 + i % 6)
            for i, p in enumerate(prompts)]
    sched = _serve(model, reqs, impls, decode_chunk=chunk)
    for r in reqs:
        comp = sched.completions[r.request_id]
        want = _jax_solo(model, list(r.prompt), r.max_tokens)
        assert comp.tokens == want, (r.request_id, comp.tokens, want)
        assert comp.finish_reason == FINISH_LENGTH
        assert len(comp.logprobs) == len(comp.tokens)
    s = sched.summary()
    assert s["requests_completed"] == 7
    assert s["admit_dispatches"] >= 3
    for k in ("tokens_per_sec", "decode_tokens_per_sec", "ttft_mean_ms",
              "ttft_p99_ms"):
        assert s[k] > 0, k


def test_greedy_eos_stream_matches_jax_solo_generate(model):
    """An eos taken from a solo stream's third token: the engine stops
    there (eos kept), as the truncated solo stream does."""
    prompt = _prompts(3, seed=1)[2]
    base = _jax_solo(model, prompt, 8)
    eos = next(t for t in base[2:] if t != prompt[-1])
    reqs = [Request("e0", prompt, max_tokens=8, eos_token_id=eos),
            Request("e1", _prompts(2, seed=2)[1], max_tokens=6,
                    eos_token_id=eos)]
    sched = _serve(model, reqs, decode_chunk=2)
    for r in reqs:
        comp = sched.completions[r.request_id]
        want = _jax_solo(model, list(r.prompt), r.max_tokens, eos)
        assert comp.tokens == want
        assert comp.finish_reason == (
            FINISH_EOS if want[-1] == eos else FINISH_LENGTH)
    assert sched.completions["e0"].finish_reason == FINISH_EOS


def test_sampled_streams_match_port_solo_generate(model):
    prompts = _prompts(6, seed=3)
    sps = [SamplingParams(temperature=0.9, top_k=40, seed=i) if i % 2
           else SamplingParams(temperature=0.7, top_p=0.8, seed=100 + i)
           for i in range(6)]
    reqs = [Request(f"s{i}", p, max_tokens=6, sampling=sp)
            for i, (p, sp) in enumerate(zip(prompts, sps))]
    sched = _serve(model, reqs, decode_chunk=3)
    for r in reqs:
        want = _port_solo(model, list(r.prompt), r.max_tokens, r.sampling)
        assert sched.completions[r.request_id].tokens == want


def test_budget_and_finish_semantics(model):
    prompt = _prompts(1, seed=4)[0]
    first = _jax_solo(model, prompt, 1)[0]
    reqs = [
        Request("one", prompt, max_tokens=1),
        Request("eos_first", prompt, max_tokens=5, eos_token_id=first),
        Request("eos_prompt", prompt, max_tokens=5,
                eos_token_id=prompt[-1]),
    ]
    sched = _serve(model, reqs)
    c = sched.completions
    assert c["one"].tokens == [first] and \
        c["one"].finish_reason == FINISH_LENGTH
    assert c["eos_first"].tokens == [first] and \
        c["eos_first"].finish_reason == FINISH_EOS
    assert c["eos_prompt"].tokens == [] and \
        c["eos_prompt"].finish_reason == FINISH_EOS
    events = [e for e in sched.pop_events() if e.request_id == "eos_prompt"]
    assert len(events) == 1 and events[0].finished and events[0].token is None


def test_admit_many_equals_single_admits(model):
    _, _, _, tcfg, tparams = model
    prompts = _prompts(4, seed=5)
    items = [Admission(slot=i, prompt=p, max_tokens=4)
             for i, p in enumerate(prompts)]
    ecfg = EngineConfig(slots=4, max_prompt_len=16, max_seq_len=32)
    many = Engine(tcfg, tparams, ecfg, device="cpu")
    res_many = many.admit_many(items)
    assert [r.group for r in res_many] == [0, 0, 0, 0]
    single = Engine(tcfg, tparams, ecfg, device="cpu")
    res_single = [single.admit_many([a])[0] for a in items]
    assert [r.first_token for r in res_many] == \
        [r.first_token for r in res_single]
    np.testing.assert_allclose([r.logprob for r in res_many],
                               [r.logprob for r in res_single], atol=1e-5)
    a, b = many.step(), single.step()
    assert a[0].tolist() == b[0].tolist()


def test_deadline_expires_queued_and_active(model):
    _, _, _, tcfg, tparams = model
    now = [0.0]
    sched = Scheduler(Engine(tcfg, tparams, EngineConfig(
        slots=1, max_prompt_len=16, max_seq_len=32), device="cpu"),
        clock=lambda: now[0])
    p = _prompts(2, seed=6)
    sched.submit(Request("a", p[0], max_tokens=10, deadline=5.0))
    sched.submit(Request("b", p[1], max_tokens=10, deadline=1.0))
    sched.step()                 # a admits and decodes; b waits
    now[0] = 2.0
    sched.step()                 # b's deadline passed while queued
    now[0] = 6.0
    sched.step()                 # a's deadline passed while active
    assert sched.completions["b"].finish_reason == FINISH_TIMEOUT
    assert sched.completions["b"].tokens == []
    assert sched.completions["a"].finish_reason == FINISH_TIMEOUT
    assert len(sched.completions["a"].tokens) >= 2
    assert sched.idle()


@pytest.mark.parametrize("field,value", [
    ("stop", [[1, 2]]), ("constraint", object()), ("tenant", "t1"),
    ("adapter", 1)])
def test_later_slice_request_fields_rejected(model, field, value):
    """Every request field of the JAX package is served now: stop
    sequences, constraints and tenants since the front-end slice, adapters
    since the multi-LoRA slice. A request carrying one is queued; an
    adapter needs an engine with an adapter pool (and the adapter
    registered), and a pool-less engine refuses it in JAX's words."""
    _, _, _, tcfg, tparams = model
    geom = dict(slots=1, max_prompt_len=16, max_seq_len=32)
    if field == "adapter":
        plain = Scheduler(Engine(tcfg, tparams, EngineConfig(**geom),
                                 device="cpu"))
        with pytest.raises(ValueError, match="adapter pool is disabled"):
            plain.submit(Request("x", [1, 2], max_tokens=2, adapter=value))
        geom["adapter_slots"] = 2
    sched = Scheduler(Engine(tcfg, tparams, EngineConfig(**geom),
                             device="cpu"))
    if field == "adapter":
        sched.register_adapter(seed=7)
    req = Request("x", [1, 2], max_tokens=2, **{field: value})
    sched.submit(req)
    assert list(sched.queue) == [req]


def test_engine_describe_and_buckets(model):
    _, _, _, tcfg, tparams = model
    eng = Engine(tcfg, tparams, EngineConfig(
        slots=2, max_prompt_len=16, max_seq_len=32), device="cpu")
    assert eng.prompt_buckets == (8, 16)
    assert eng.bucket_for(9) == 16 and eng.bucket_for(1) == 8
    assert eng.admit_batch_sizes == (1, 2)
    d = eng.describe()
    assert d["model"]["compute_dtype"] == "float32"
    assert d["engine"]["slots"] == 2
    with pytest.raises(ValueError):
        eng.bucket_for(17)
