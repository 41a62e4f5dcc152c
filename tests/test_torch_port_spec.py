"""apex_tpu_torch's speculative decoding against the JAX package, on the CPU.

Oracles:

- the plain twin of ``cache_write_columns`` against the Pallas kernel in
  interpret mode, bit for bit (lanes clamped past the horizon included),
  and ``cache_write_columns_xla`` (which drops them) against JAX's;
- ``gpt.ngram_drafts`` and ``gpt.shift_hist``: integer code, bit for bit;
- ``gpt.decode_verify`` (contiguous and paged) and
  ``gpt.decode_steps_spec``: logits and logprobs within ``1e-5`` of JAX's
  (fp32), tokens, ``valid``, ``finished`` and the state exactly, for both
  ``decode_attn_impl`` values;
- ``Engine`` + ``Scheduler`` with ``spec_k > 0``: greedy streams equal
  JAX's solo ``generate``; spec == plain, greedy and sampled, under the
  payoff gate and with every chunk speculative; paged + spec == plain;
- ``_SpecGate``: the same decisions as JAX's on one observation
  sequence.

Spec == plain holds here because both paths' logits agree far inside the
random model's token margins; the verify's batched matmuls round
differently from the single-row ones (see ``gpt.decode_verify``).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import scheduler as jsched
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
)
from apex_tpu_torch.serving import scheduler as tsched
from apex_tpu_torch.serving.engine import Admission

# the modules (both kernel packages re-export functions of these names)
jda = importlib.import_module("apex_tpu.kernels.decode_attention")
tda = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

VOCAB = 256
# init_std 0.2: at the default 0.02 a random model's greedy stream repeats
# its last prompt token, which would make token identity an empty check
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=64, remat=False, init_std=0.2)
IMPLS = ["kernel", "xla"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(t):
    return t.detach().float().cpu().numpy()


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


# ---------------------------------------------------------------------------
# the multi-column write
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cache_write_columns_plain_matches_jax_kernel(dtype):
    """Four columns per row from position 0, mid-horizon, one short of the
    end and at the last column: the lanes past the horizon clamp onto it
    (the last lane wins) — bit for bit the Pallas kernel's caches."""
    rng = np.random.default_rng(0)
    b, h, S, t, d = 4, 2, 10, 4, 64
    mk = lambda shp: _pair(rng.standard_normal(shp), dtype)
    (kcj, kct), (vcj, vct) = mk((b, h, S, d)), mk((b, h, S, d))
    (knj, knt), (vnj, vnt) = mk((b, h, t, d)), mk((b, h, t, d))
    pos = np.asarray([0, 4, 8, 9], np.int32)
    kj, vj = jda.cache_write_columns(knj, vnj, kcj, vcj, jnp.asarray(pos))
    tda.cache_write_columns(knt, vnt, kct, vct, torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(kct), np.asarray(kj, np.float32))
    np.testing.assert_array_equal(_np(vct), np.asarray(vj, np.float32))


def test_cache_write_columns_xla_matches_jax():
    """The XLA spelling drops the lanes past the horizon, bit for bit."""
    rng = np.random.default_rng(1)
    cache = rng.standard_normal((3, 2, 10, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    pos = np.asarray([0, 7, 9], np.int32)
    want = jda.cache_write_columns_xla(jnp.asarray(cache), jnp.asarray(new),
                                       jnp.asarray(pos))
    got = torch.from_numpy(cache.copy())
    tda.cache_write_columns_xla(got, torch.from_numpy(new),
                                torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the drafter and the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 5])
def test_ngram_drafts_matches_jax(k):
    """Rows with cycles, 2-token and 1-token suffix matches, no match at
    all, and ``-1`` sentinels: the same drafts, bit for bit."""
    rng = np.random.default_rng(k)
    hist = rng.integers(0, 6, (8, 12)).astype(np.int32)
    hist[0] = [1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3]
    hist[1, :9] = -1
    hist[2] = np.arange(12) + 20
    hist[3, :] = -1
    tok = rng.integers(0, 6, 8).astype(np.int32)
    tok[2] = 99
    want = jgpt.ngram_drafts(jnp.asarray(hist), jnp.asarray(tok), k)
    got = tgpt.ngram_drafts(torch.from_numpy(hist).long(),
                            torch.from_numpy(tok).long(), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shift_hist_matches_jax():
    rng = np.random.default_rng(2)
    hist = rng.integers(-1, 50, (5, 6)).astype(np.int32)
    toks = rng.integers(0, 50, (5, 4)).astype(np.int32)
    m = np.asarray([0, 1, 2, 4, 3], np.int32)
    want = jgpt.shift_hist(jnp.asarray(hist), jnp.asarray(toks),
                           jnp.asarray(m))
    got = tgpt.shift_hist(torch.from_numpy(hist).long(),
                          torch.from_numpy(toks).long(), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the verify forward and the speculative loop against JAX
# ---------------------------------------------------------------------------

def _geometry(paged: bool):
    """(batch, horizon, pool pages, page size, table or None): the paged
    table maps every row onto distinct scrambled pages."""
    b, S = 3, 32
    if not paged:
        return b, S, b, S, None
    p_sz, n_pages = 8, 16
    table = np.random.RandomState(3).permutation(np.arange(1, n_pages))[
        :b * (S // p_sz)].reshape(b, S // p_sz).astype(np.int32)
    return b, S, n_pages, p_sz, table


def _cache(cfg_l, n, p_sz, seed=6):
    """A finite random cache / pool [L, 2, n, heads, p_sz, d]."""
    heads, d = SMALL["num_heads"], SMALL["hidden_size"] // SMALL["num_heads"]
    return (np.random.default_rng(seed).standard_normal(
        (cfg_l, 2, n, heads, p_sz, d)) * 0.5).astype(np.float32)


def _jax_call(model, fn, args, out_specs):
    jcfg, params, mesh, _, _ = model
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(jgpt.param_specs(jcfg),)
        + (P(),) * len(args), out_specs=out_specs, check_vma=False))(
            params, *args)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_verify_matches_jax(model, impl, paged):
    """Four tokens per row at positions 0, 9 and 20 over a random cache:
    logits within 1e-5 of JAX's, and the written columns too."""
    jcfg, _, _, tcfg, tparams = model
    b, S, n, p_sz, table = _geometry(paged)
    cache = _cache(SMALL["num_layers"], n, p_sz)
    toks = np.random.default_rng(7).integers(0, VOCAB, (b, 4)).astype(
        np.int32)
    pos = np.asarray([0, 9, 20], np.int32)
    tbl = (jnp.asarray(table),) if paged else ()
    want, want_cache = _jax_call(
        model, lambda p, c, t, q, *tb: jgpt.decode_verify(
            jcfg, p, c, t, q, *tb),
        (jnp.asarray(cache), jnp.asarray(toks), jnp.asarray(pos)) + tbl,
        (P(), P()))
    cfg = dataclasses.replace(tcfg, decode_attn_impl=impl)
    got, got_cache = tgpt.decode_verify(
        cfg, tparams, torch.from_numpy(cache.copy()), torch.from_numpy(toks),
        torch.from_numpy(pos),
        torch.from_numpy(table) if paged else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_cache.numpy(), np.asarray(want_cache),
                               rtol=1e-5, atol=1e-5)


def _spec_state(b=3, h=8):
    """A greedy speculative state: one live row with a roomy budget, one
    that runs out mid-wave, one done."""
    hist = np.random.default_rng(8).integers(0, VOCAB, (b, h)).astype(
        np.int32)
    return dict(
        tok=np.asarray([3, 17, 5], np.int32),
        pos=np.asarray([4, 11, 7], np.int32),
        remaining=np.asarray([20, 3, 0], np.int32),
        done=np.asarray([False, False, True]),
        temp=np.zeros(b, np.float32), top_k=np.zeros(b, np.int32),
        top_p=np.ones(b, np.float32), key=np.zeros((b, 2), np.uint32),
        eos=np.asarray([-1, -1, -1], np.int32), hist=hist)


def _torch_state(st):
    tst = {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    for k in ("tok", "remaining", "top_k", "eos", "hist", "key"):
        tst[k] = tst[k].long()
    return tst


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("paged", [False, True])
def test_decode_steps_spec_matches_jax(model, impl, paged):
    """Three greedy waves of k=2 drafts: the wave-major tokens, ``valid``
    and ``finished`` exactly JAX's, logprobs within 1e-5, and the final
    state (token, position, budget, done, history) exactly."""
    jcfg, _, _, tcfg, tparams = model
    b, S, n, p_sz, table = _geometry(paged)
    cache = _cache(SMALL["num_layers"], n, p_sz, seed=9)
    st = _spec_state(b)
    tbl = (jnp.asarray(table),) if paged else ()
    ttbl = torch.from_numpy(table) if paged else None
    cfg = dataclasses.replace(tcfg, decode_attn_impl=impl)
    # row 0's history replays its own greedy continuation after the
    # current (prev, tok) pair, so its drafts land
    _, _, g, _, _ = tgpt.decode_steps(
        cfg, tparams, torch.from_numpy(cache.copy()), _torch_state(st), 5,
        table=ttbl)
    st["hist"][0] = [11, 3] + g[0].tolist() + [11]

    def run(p, c, s, *tb):
        c, s, toks, lps, fins, vals = jgpt.decode_steps_spec(
            jcfg, p, c, s, 3, spec_k=2, table=tb[0] if tb else None)
        return s, toks, lps, fins, vals

    want = _jax_call(model, run, (jnp.asarray(cache), jax.tree.map(
        jnp.asarray, st)) + tbl, P())
    _, got_st, toks, lps, fins, vals = tgpt.decode_steps_spec(
        cfg, tparams, torch.from_numpy(cache.copy()), _torch_state(st), 3,
        spec_k=2, table=ttbl)
    w_st, w_toks, w_lps, w_fins, w_vals = want
    np.testing.assert_array_equal(toks.numpy(), np.asarray(w_toks))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(w_vals))
    np.testing.assert_array_equal(fins.numpy(), np.asarray(w_fins))
    np.testing.assert_allclose(lps.numpy(), np.asarray(w_lps), rtol=1e-5,
                               atol=1e-5)
    for k in ("tok", "pos", "remaining", "done", "hist"):
        np.testing.assert_array_equal(got_st[k].numpy(),
                                      np.asarray(w_st[k]), err_msg=k)
    assert vals.numpy()[0].sum() > 3        # drafts landed on row 0
    assert not vals.numpy()[2].any()        # the done row emits nothing


# ---------------------------------------------------------------------------
# the speculative engine and scheduler
# ---------------------------------------------------------------------------

def _trace(n, sampled=True, seed=0, max_tokens=None):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = rng.integers(0, VOCAB, 1 + (7 * i + 3) % 16).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=20, seed=i)
              if sampled and i % 2 else SamplingParams())
        reqs.append(Request(f"r{i}", p, sampling=sp,
                            max_tokens=max_tokens or 6 + 3 * i))
    return reqs


def _engine(model, impl="xla", **ecfg_kw):
    _, _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, decode_attn_impl=impl)
    return Engine(cfg, tparams, EngineConfig(**{**dict(
        slots=3, max_prompt_len=16, max_seq_len=48), **ecfg_kw}),
        device="cpu")


def _serve(model, reqs, impl="xla", spec_gate=None, **ecfg_kw):
    sched = Scheduler(_engine(model, impl, **ecfg_kw), spec_gate=spec_gate)
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return sched


def _drive_spec(eng, reqs):
    """Every chunk speculative: admit into free slots in order, then
    ``step_async(spec=True)``, keeping only the ``valid`` columns."""
    queue, free = list(reqs), list(range(eng.slots))[::-1]
    active, out = {}, {r.request_id: [] for r in reqs}

    def release(slot):
        eng.free_slot(slot)
        del active[slot]
        free.append(slot)

    while queue or active:
        adm = []
        while queue and free:
            adm.append((free.pop(), queue.pop(0)))
        if adm:
            res = eng.admit_many([Admission(
                slot=s, prompt=r.prompt, max_tokens=r.max_tokens,
                temperature=r.sampling.temperature, top_k=r.sampling.top_k,
                seed=r.sampling.seed) for s, r in adm])
            for (s, r), a in zip(adm, res):
                out[r.request_id].append(a.first_token)
                active[s] = r
                if a.finished:
                    release(s)
        if not active:
            continue
        h = eng.step_async(spec=True)
        toks, _, fins = h.fetch()
        assert h.spec and h.ncols == toks.shape[1]
        for j in range(toks.shape[1]):
            for s in list(active):
                if h.valid[s, j]:
                    out[active[s].request_id].append(int(toks[s, j]))
                    if fins[s, j]:
                        release(s)
    return out


def _streams(sched):
    return {k: c.tokens for k, c in sched.completions.items()}


_SOLO = {}


def _jax_solo(model, prompt, n_new):
    key = (tuple(prompt), n_new)
    if key not in _SOLO:
        _SOLO[key] = [int(t) for t in np.asarray(_jax_call(
            model, lambda p, t: jgpt.generate(model[0], p, t, n_new,
                                              pad_token_id=0),
            (jnp.asarray([prompt], jnp.int32),), P()))[0]]
    return _SOLO[key]


@pytest.mark.parametrize("paged", [False, True])
def test_spec_greedy_streams_match_jax_solo_generate(model, paged):
    """Every chunk speculative (k=3, chunks of 2): greedy streams equal
    JAX's solo ``generate`` token for token."""
    reqs = _trace(4, sampled=False)
    eng = _engine(model, spec_k=3, decode_chunk=2,
                  page_size=8 if paged else 0)
    out = _drive_spec(eng, reqs)
    for r in reqs:
        assert out[r.request_id] == _jax_solo(model, list(r.prompt),
                                              r.max_tokens), r.request_id
    assert eng.spec_waves_taken > 0 and eng.decode_steps_taken == 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("paged", [False, True])
def test_spec_streams_equal_plain(model, impl, paged):
    """Greedy and sampled streams: spec == plain, both with every chunk
    speculative and under the scheduler's payoff gate (here set to probe
    every other chunk, so both chunk kinds interleave and the history
    ring crosses plain chunks); paged + spec == plain."""
    reqs = _trace(6)
    plain = _streams(_serve(model, _trace(6), impl, decode_chunk=2))
    page = dict(page_size=8) if paged else {}
    eng = _engine(model, impl, spec_k=3, decode_chunk=2, **page)
    assert _drive_spec(eng, reqs) == plain
    gate = tsched.SpecGateConfig(probe_every=1, min_probe_chunks=1)
    sched = _serve(model, _trace(6), impl, spec_gate=gate, spec_k=3,
                   decode_chunk=2, **page)
    assert _streams(sched) == plain
    s = sched.summary()
    assert s["spec_chunks"] >= 1 and s["spec_gate_plain_decisions"] >= 1
    assert 1.0 <= s["spec_tokens_per_wave"] <= 4.0
    assert all(len(c.tokens) == r.max_tokens
               for r, c in zip(reqs, sched.completions.values()))


def test_spec_engine_validation(model):
    _, _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="spec_hist"):
        _engine(model, spec_k=2, spec_hist=1)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(model).step_async(spec=True)
    with pytest.raises(ValueError, match="spec_gate"):
        Scheduler(_engine(model), spec_gate=tsched.SpecGateConfig())
    eng = _engine(model, spec_k=2, spec_hist=4)
    assert eng.describe()["spec_ks"] == [2]
    eng.admit_many([Admission(slot=1, prompt=[5, 6, 7, 8, 9],
                              max_tokens=4)])
    hist = eng.state["hist"][1].tolist()
    assert hist[:3] == [7, 8, 9] and len(hist) == 4
    h = eng.step_async()
    assert not h.spec and h.valid is None and h.ncols == 1


def test_spec_gate_matches_jax():
    """One sequence of observations through both gates: the same
    decision, state, break-even and acceptance EWMA after every step."""
    cfg = dict(ewma_alpha=0.5, margin=1.05, probe_every=3,
               min_probe_chunks=2)
    gates = [jsched._SpecGate(jsched.SpecGateConfig(**cfg), spec_k=3),
             tsched._SpecGate(tsched.SpecGateConfig(**cfg), spec_k=3)]
    obs = ([("plain", 0.010)] + [("spec", 0.015, 4.0)] * 2
           + [("spec", 0.015, 1.0)] * 3 + [("plain", 0.010)] * 3
           + [("spec", 0.015, 4.0), ("spec", 0.016, None)]
           + [("spec", 0.015, 4.0)] * 3 + [("plain", 0.011)]
           + [("spec", 0.02, 2.0)] * 4)
    seen = set()
    for o in obs:
        for g in gates:
            if o[0] == "plain":
                g.observe_plain(o[1])
            else:
                g.observe_spec(o[1], o[2])
        views = [(g.want_spec(), g.want_spec(spec_inflight=1), g.state(),
                  g.break_even(), g.accept_ewma) for g in gates]
        assert views[0] == views[1], o
        seen.add(views[1][2])
    # the sequence opens, closes and reopens the gate
    assert seen == {tsched.GATE_MEASURING, tsched.GATE_OPEN,
                    tsched.GATE_CLOSED}
