"""apex_tpu_torch's paged KV cache against the JAX package, on the CPU.

Oracles:

- ``PageAllocator``: one sequence of alloc / share / free / exhaust
  operations gives the same pages, stats and errors as JAX's;
- the plain twins of ``paged_write_column``, ``paged_write_columns`` and
  ``paged_attention`` against the Pallas kernels in interpret mode: the
  writes bit for bit (lanes clamped past the horizon included), the read
  at ``rtol=atol=1e-5`` in fp32 and ``2e-2`` in bf16 (the outputs are
  rounded to bf16 at different points), with NaN in every unwritten pool
  cell and in the sink page;
- the XLA spellings ``paged_gather_xla`` and ``paged_write_columns_xla``
  bit for bit against JAX's, a collision in the sink page included;
  ``cache_insert_pages`` bit for bit;
- ``gpt.decode_step(table=)``: logits of chained steps through a
  scrambled pool within ``1e-5`` of JAX's (fp32), for both
  ``decode_attn_impl`` values;
- ``Engine`` + ``Scheduler`` in paged mode: greedy streams equal JAX's
  solo ``generate``; paged streams equal contiguous ones, greedy and
  sampled; a small pool holds admissions back and still completes every
  request; the smallest pool serves a worst-case request.

The reference's own paged parity tests (``test_paged_cache.py::
test_paged_decode_logits_oracle``) are bit-parity contracts of the JAX
engine that fail on this host's jax; nothing here rests on them.
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
from apex_tpu.serving import pages as jpages
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    Scheduler,
)
from apex_tpu_torch.serving import pages as tpages
from apex_tpu_torch.serving.engine import Admission

# the modules (both kernel packages re-export functions of these names)
jda = importlib.import_module("apex_tpu.kernels.decode_attention")
tda = importlib.import_module("apex_tpu_torch.kernels.decode_attention")

VOCAB = 256
# init_std 0.2: at the default 0.02 a random model's greedy stream repeats
# its last prompt token, which would make token identity an empty check
SMALL = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
             seq_len=64, remat=False, init_std=0.2)
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
IMPLS = ["kernel", "xla"]


def _pair(x, dtype):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(t):
    return t.detach().float().cpu().numpy()


def _table(rng, b, mp, n_pages):
    """Distinct pages 1..n_pages-1 for every row, in random order."""
    return rng.permutation(np.arange(1, n_pages))[:b * mp].reshape(
        b, mp).astype(np.int32)


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
# the page allocator
# ---------------------------------------------------------------------------

def test_page_allocator_matches_jax():
    """The same operations on both allocators: the same pages in the same
    order, the same stats after every step, the same refusals."""
    allocs = [a(num_pages=9, page_size=8) for a in (jpages.PageAllocator,
                                                    tpages.PageAllocator)]
    assert tpages.SINK == jpages.SINK == 0

    def both(fn):
        outs = []
        for a, mod in zip(allocs, (jpages, tpages)):
            try:
                outs.append(("ok", fn(a)))
            except mod.PagesExhausted as e:
                outs.append(("exhausted", e.requested, e.free))
            except ValueError as e:
                outs.append(("value", str(e)))
        assert outs[0] == outs[1]
        assert allocs[0].stats() == allocs[1].stats()
        return outs[0]

    p1 = both(lambda a: a.alloc(3))[1]
    both(lambda a: a.share(p1[:1]))
    assert both(lambda a: a.alloc(6))[0] == "exhausted"
    both(lambda a: a.free(p1))
    both(lambda a: a.free(p1[:1]))
    assert both(lambda a: a.free(p1[:1]))[0] == "value"      # double free
    assert both(lambda a: a.share([tpages.SINK]))[0] == "value"
    p2 = both(lambda a: a.alloc(2))[1]
    for a in allocs:
        a.used_tokens += 10
    both(lambda a: a.fragmentation())
    both(lambda a: a.note_swap_out(2, 512))
    both(lambda a: a.note_swap_in(1, 256))
    both(lambda a: a.free(p2 + [tpages.SINK]))
    both(lambda a: a.reset())
    both(lambda a: a.alloc(8))
    assert both(lambda a: a.alloc(1))[0] == "exhausted"
    with pytest.raises(ValueError):
        tpages.PageAllocator(num_pages=1, page_size=8)


# ---------------------------------------------------------------------------
# the kernels' plain twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _pool_inputs(dtype, seed, b=3, h=2, n=13, p=4, mp=4, d=64, t=3):
    rng = np.random.default_rng(seed)
    mk = lambda shp: _pair(rng.standard_normal(shp) * 0.5, dtype)
    return (rng, mk((n, h, p, d)), mk((n, h, p, d)), mk((b, h, t, d)),
            mk((b, h, t, d)), _table(rng, b, mp, n))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_write_column_plain_matches_jax_kernel(dtype):
    """One column per row through the table (positions at a page's first
    and last offset and at the last column of the horizon): pools bit
    for bit equal to the Pallas kernel's."""
    _, (kpj, kpt), (vpj, vpt), (knj, knt), (vnj, vnt), table = \
        _pool_inputs(dtype, 0)
    pos = np.asarray([0, 7, 15], np.int32)
    kj, vj = jda.paged_write_column(knj[:, :, 0], vnj[:, :, 0], kpj, vpj,
                                    jnp.asarray(table), jnp.asarray(pos))
    tda.paged_write_column(knt[:, :, 0].contiguous(),
                           vnt[:, :, 0].contiguous(), kpt, vpt,
                           torch.from_numpy(table), torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(kpt), np.asarray(kj, np.float32))
    np.testing.assert_array_equal(_np(vpt), np.asarray(vj, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_write_columns_plain_matches_jax_kernel(dtype):
    """Three columns per row, one row starting at the last column of its
    horizon and one two short of it: the lanes past the horizon clamp
    onto its last column (the last lane wins), as in the Pallas grid."""
    _, (kpj, kpt), (vpj, vpt), (knj, knt), (vnj, vnt), table = \
        _pool_inputs(dtype, 1)
    pos = np.asarray([2, 15, 14], np.int32)
    kj, vj = jda.paged_write_columns(knj, vnj, kpj, vpj, jnp.asarray(table),
                                     jnp.asarray(pos))
    tda.paged_write_columns(knt, vnt, kpt, vpt, torch.from_numpy(table),
                            torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(kpt), np.asarray(kj, np.float32))
    np.testing.assert_array_equal(_np(vpt), np.asarray(vj, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_attention_plain_matches_jax_kernel(dtype):
    """The read through the table over ``0..pos`` (first column, a page
    edge, the last column) with NaN in every cell past each row's
    position, in the pages no row maps, and in the sink page."""
    rng, (kpj, kpt), (vpj, vpt), _, _, table = _pool_inputs(dtype, 2)
    b, h, d = 3, 2, 64
    qj, qt = _pair(rng.standard_normal((b, h, d)), dtype)
    pos = np.asarray([0, 7, 15], np.int32)
    n, _, p, _ = kpt.shape
    live = np.zeros((n, p), bool)
    for r in range(b):
        for c in range(pos[r] + 1):
            live[table[r, c // p], c % p] = True
    stale = ~live[:, None, :, None]
    kpj, vpj = (jnp.where(stale, jnp.nan, x) for x in (kpj, vpj))
    kpt = kpt.masked_fill(torch.from_numpy(stale), float("nan"))
    vpt = vpt.masked_fill(torch.from_numpy(stale), float("nan"))
    want = jda.paged_attention(qj, kpj, vpj, jnp.asarray(table),
                               jnp.asarray(pos))
    got = tda.paged_attention(qt, kpt, vpt, torch.from_numpy(table),
                              torch.from_numpy(pos))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_paged_xla_spellings_match_jax():
    """``paged_gather_xla`` and ``paged_write_columns_xla`` bit for bit:
    lanes past the horizon are dropped, and rows whose tables point at
    the sink collide there with the first hitter's value."""
    _, (kpj, kpt), _, (knj, knt), _, table = _pool_inputs("f32", 3)
    np.testing.assert_array_equal(
        _np(tda.paged_gather_xla(kpt, torch.from_numpy(table))),
        np.asarray(jda.paged_gather_xla(kpj, jnp.asarray(table))))
    for tbl, pos in ((table, [2, 15, 14]),
                     (np.where(np.arange(3)[:, None] < 2, 0, table).astype(
                         np.int32), [1, 1, 6])):
        pos = np.asarray(pos, np.int32)
        want = jda.paged_write_columns_xla(kpj, knj, jnp.asarray(tbl),
                                           jnp.asarray(pos))
        got = kpt.clone()
        tda.paged_write_columns_xla(got, knt, torch.from_numpy(tbl),
                                    torch.from_numpy(pos))
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_cache_insert_pages_matches_jax():
    """A [L, 2, k, h, span, d] block lands page by page, the sink-padded
    tail of a short row included."""
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((2, 2, 9, 2, 4, 8)).astype(np.float32)
    block = rng.standard_normal((2, 2, 2, 2, 8, 8)).astype(np.float32)
    pages = np.asarray([[3, 5], [7, 0]], np.int32)
    want = jgpt.cache_insert_pages(jnp.asarray(pool), jnp.asarray(block),
                                   jnp.asarray(pages), page_size=4)
    got = tgpt.cache_insert_pages(torch.from_numpy(pool.copy()),
                                  torch.from_numpy(block),
                                  torch.from_numpy(pages), page_size=4)
    keep = np.ones(9, bool)
    keep[0] = False                 # the sink holds garbage by contract
    np.testing.assert_array_equal(got.numpy()[:, :, keep],
                                  np.asarray(want)[:, :, keep])
    with pytest.raises(ValueError):
        tgpt.cache_insert_pages(torch.from_numpy(pool), torch.from_numpy(
            block[..., :6, :]), torch.from_numpy(pages), page_size=4)


# ---------------------------------------------------------------------------
# the model's paged decode against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_paged_matches_jax(model, impl):
    """Four chained ``decode_step(table=)`` calls from a zero pool through
    a scrambled table: logits within 1e-5 of JAX's at every step, and the
    pool's mapped pages equal JAX's pool."""
    jcfg, params, mesh, tcfg, tparams = model
    b, p_sz, mp, n_pages = 2, 8, 6, 16
    table = _table(np.random.RandomState(1), b, mp, n_pages)
    toks = np.random.default_rng(5).integers(0, VOCAB, (4, b)).astype(
        np.int32)

    def run(p, tk, tbl):
        pc = jgpt.init_cache(jcfg, p, n_pages, p_sz)
        pos = jnp.asarray([0, 3], jnp.int32)
        outs = []
        for j in range(tk.shape[0]):
            lg, pc = jgpt.decode_step(jcfg, p, pc, tk[j], pos + j, tbl)
            outs.append(lg)
        return jnp.stack(outs), pc

    want, want_pool = jax.jit(jax.shard_map(
        run, mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P(), P()),
        out_specs=(P(), jgpt.cache_specs(jcfg)), check_vma=False))(
            params, jnp.asarray(toks), jnp.asarray(table))
    cfg = dataclasses.replace(tcfg, decode_attn_impl=impl)
    pool = tgpt.init_cache(cfg, tparams, n_pages, p_sz)
    tbl = torch.from_numpy(table)
    pos = torch.tensor([0, 3], dtype=torch.int32)
    for j in range(toks.shape[0]):
        lg, pool = tgpt.decode_step(cfg, tparams, pool,
                                    torch.from_numpy(toks[j]), pos + j, tbl)
        np.testing.assert_allclose(lg.numpy(), np.asarray(want[j]),
                                   rtol=1e-5, atol=1e-5)
    mapped = np.unique(table)
    np.testing.assert_allclose(pool.numpy()[:, :, mapped],
                               np.asarray(want_pool)[:, :, mapped],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

_SOLO_CACHE = {}


def _jax_solo(model, prompt, n_new):
    """JAX solo greedy ``gpt.generate`` of one request."""
    key = (tuple(prompt), n_new)
    if key not in _SOLO_CACHE:
        jcfg, params, mesh, _, _ = model
        out = jax.jit(jax.shard_map(
            lambda p, t: jgpt.generate(jcfg, p, t, n_new, pad_token_id=0),
            mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P()),
            out_specs=P(), check_vma=False))(
                params, jnp.asarray([prompt], jnp.int32))
        _SOLO_CACHE[key] = [int(t) for t in np.asarray(out)[0]]
    return _SOLO_CACHE[key]


def _trace(n, sampled=True, seed=0, max_tokens=None):
    """Prompts across both buckets of max_prompt_len 16, odd requests
    sampled when ``sampled``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = rng.integers(0, VOCAB, 1 + (7 * i + 3) % 16).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=20, seed=i)
              if sampled and i % 2 else SamplingParams())
        reqs.append(Request(f"r{i}", p, sampling=sp,
                            max_tokens=max_tokens or 6 + 2 * i))
    return reqs


def _serve(model, reqs, impl="xla", **ecfg_kw):
    _, _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, decode_attn_impl=impl)
    ecfg = EngineConfig(**{**dict(slots=3, max_prompt_len=16,
                                  max_seq_len=40), **ecfg_kw})
    sched = Scheduler(Engine(cfg, tparams, ecfg, device="cpu"))
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    return sched


def _streams(sched):
    return {k: c.tokens for k, c in sched.completions.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_paged_greedy_streams_match_jax_solo_generate(model, impl):
    """Paged greedy streams (pages of 8, chunks of 2, more requests than
    slots) are JAX's solo ``generate`` token for token."""
    reqs = _trace(4, sampled=False)
    sched = _serve(model, reqs, impl, page_size=8, decode_chunk=2)
    for r in reqs:
        assert sched.completions[r.request_id].tokens == _jax_solo(
            model, list(r.prompt), r.max_tokens), r.request_id


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("page_size", [4, 8])
def test_paged_streams_equal_contiguous(model, impl, page_size):
    """Greedy and sampled streams and their logprobs: paged == contiguous
    (the gathered bytes and the read's expression are the same)."""
    reqs = _trace(6)
    contig = _serve(model, _trace(6), impl, decode_chunk=3)
    paged = _serve(model, reqs, impl, decode_chunk=3, page_size=page_size)
    assert _streams(paged) == _streams(contig)
    for k, c in contig.completions.items():
        assert paged.completions[k].logprobs == c.logprobs
    s = paged.summary()
    assert s["pages_in_use"] == 0.0 and s["pages_total"] > 0


def test_paged_backpressure_completes_everything(model):
    """An 11-page pool (10 allocatable; a long request takes up to 8) with
    3 slots: admissions wait for pages, every request completes in full,
    and the streams equal the contiguous engine's."""
    reqs = _trace(6, max_tokens=14)
    paged = _serve(model, reqs, page_size=4, num_pages=11)
    contig = _serve(model, _trace(6, max_tokens=14))
    assert _streams(paged) == _streams(contig)
    assert all(len(c.tokens) == 14 for c in paged.completions.values())
    s = paged.summary()
    assert s["page_deferrals"] > 0 and s["pages_exhausted_waits"] > 0
    assert paged.engine.page_allocator.free_pages == 10


def test_minimal_pool_serves_a_worst_case_request(model):
    """The smallest pool the engine accepts (one worst-case request plus
    the sink) serves a request that fills the whole horizon; one page
    less is refused at construction, so no request can be submitted that
    could never fit."""
    _, _, _, tcfg, tparams = model
    ecfg = EngineConfig(slots=2, max_prompt_len=16, max_seq_len=40,
                        page_size=8, num_pages=6)
    sched = Scheduler(Engine(tcfg, tparams, ecfg, device="cpu"))
    sched.submit(Request("a", [1] * 16, max_tokens=24))
    sched.submit(Request("b", [2] * 3, max_tokens=5))
    sched.run_until_idle()
    assert len(sched.completions["a"].tokens) == 24
    assert len(sched.completions["b"].tokens) == 5
    with pytest.raises(ValueError, match="worst-case"):
        Engine(tcfg, tparams, dataclasses.replace(ecfg, num_pages=5),
               device="cpu")


def test_paged_engine_geometry_and_release(model):
    """Auto-sized pool, table rows, release to the sink, the admission's
    all-or-nothing refusal and the fields that still raise."""
    _, _, _, tcfg, tparams = model
    ecfg = EngineConfig(slots=3, max_prompt_len=16, max_seq_len=40,
                        page_size=8)
    eng = Engine(tcfg, tparams, ecfg, device="cpu")
    d = eng.describe()
    assert (d["paged"], d["max_pages"], d["num_pages"]) == (True, 5, 16)
    assert tuple(eng.cache.shape) == (2, 2, 16, 4, 8, 16)
    assert eng.pages_needed(9, 8) == 3 and eng.can_admit_pages(16, 24)
    eng.admit_many([Admission(slot=1, prompt=[3] * 9, max_tokens=8)])
    row = eng._tables[1]
    assert (row[:3] > 0).all() and (row[3:] == tpages.SINK).all()
    assert eng.page_stats()["pages_in_use"] == 3
    eng.free_slot(1)
    assert (eng._tables[1] == tpages.SINK).all()
    assert eng.page_stats()["pages_in_use"] == 0
    small = Engine(tcfg, tparams, dataclasses.replace(ecfg, num_pages=11),
                   device="cpu")
    with pytest.raises(tpages.PagesExhausted):
        small.admit_many([Admission(slot=s, prompt=[3] * 16, max_tokens=24)
                          for s in range(3)])   # 3 x 5 pages > 10
    assert small.page_stats()["pages_in_use"] == 0
    assert small.admit_groups == 0
    with pytest.raises(ValueError, match="prefix"):
        eng.admit_many([Admission(slot=0, prompt=[3] * 9, max_tokens=8,
                                  prefix_page=1, prefix_len=8)])
    with pytest.raises(ValueError, match="num_pages"):
        Engine(tcfg, tparams, dataclasses.replace(ecfg, num_pages=5),
               device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        Engine(tcfg, tparams, dataclasses.replace(ecfg, page_size=0,
                                                  num_pages=9), device="cpu")
