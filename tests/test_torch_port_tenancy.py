"""apex_tpu_torch: tenant fair queueing and rate limits on the CPU, against
the JAX package.

Oracles:

- ``TenantBook`` (the port's copy of the stdlib module) gives JAX's
  picks, throttle waits, bucket levels, deficits, victims and summaries
  along a seeded sequence of calls under a fake clock; ``TenancyConfig``
  refuses what JAX's refuses, with its wording; ``admit_tenant`` folds
  new ids into the overflow tenant past ``max_tenants``;
- the port's ``Scheduler`` and JAX's, on one set of weights (a 2-layer
  GPT, JAX's init crossed over), stepped in lockstep by a fake clock:
  a two-tenant backlog at weights 3:1, the second tenant arriving late,
  admits in JAX's order with JAX's greedy streams and tenant summary;
  one backlogged tenant admits in strict FIFO order, as JAX does;
- a tenant over its token budget gets ``TenantThrottled`` with JAX's
  ``retry_after_s``, other tenants pass; ``QueueFull`` carries the queue
  depth and a retry hint and debits no bucket; an empty tenant becomes
  ``"default"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import tenancy as jtenancy
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.request import Request as JRequest
from apex_tpu.serving.scheduler import QueueFull as JQueueFull
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    QueueFull,
    Request,
    Scheduler,
    tenancy,
)

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

VOCAB = 256
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=64, remat=False, init_std=0.2)
GEOM = dict(slots=2, max_prompt_len=16, max_seq_len=32, decode_chunk=2,
            prompt_buckets=(16,), admit_batch_sizes=(1, 2))
#: the fake clock's tick (seconds), small against the aging slope
TICK = 0.05


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- the book ---------------------------------------------------------------

def _book_ops(mod, seed):
    """Drive a book through a seeded sequence of calls; return every
    result."""
    clock = Clock()
    book = mod.TenantBook(mod.TenancyConfig(
        weights={"a": 3.0, "b": 1.0}, rates={"a": 40.0, "c": 5.0},
        default_rate=None, burst_s=1.5, aging_per_s=2.0, max_tenants=5),
        clock)
    rng = np.random.default_rng(seed)
    out = []
    names = ["a", "b", "c", "d", "e", "f", "g"]
    for _ in range(200):
        clock.t += float(rng.random() * 0.2)
        op = int(rng.integers(0, 7))
        t = names[int(rng.integers(0, len(names)))]
        if op == 0:
            out.append(("admit", book.admit_tenant(t)))
            book.stats(book.admit_tenant(t)).submitted += 1
        elif op == 1:
            book.on_tokens(t, int(rng.integers(0, 9)))
        elif op == 2:
            waits = {x: float(rng.random()) for x in
                     rng.choice(names[:4], int(rng.integers(1, 4)),
                                replace=False).tolist()}
            out.append(("pick", book.pick(waits)))
        elif op == 3:
            out.append(("throttle", book.throttle(
                t, int(rng.integers(1, 60)))))
        elif op == 4:
            book.rejoin(t, float(rng.random() * 10))
        elif op == 5:
            out.append(("level", book.bucket_level(t)))
        else:
            svc = {x: book.service_of(x) for x in names[:4]}
            out.append(("victim", book.pick_victim(svc)))
    out.append(("summary", book.summary()))
    out.append(("seen", book.tenants_seen))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_tenant_book_matches_jax(seed):
    assert _book_ops(tenancy, seed) == _book_ops(jtenancy, seed)


@pytest.mark.parametrize("kw", [
    dict(max_tenants=0), dict(weights={"a": 0.0}), dict(default_weight=0),
    dict(rates={"a": -1.0}), dict(default_rate=0.0), dict(burst_s=0.0),
    dict(aging_per_s=-0.1)])
def test_tenancy_config_refusals_match_jax(kw):
    msgs = []
    for mod in (tenancy, jtenancy):
        with pytest.raises(ValueError) as e:
            mod.TenancyConfig(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_admit_tenant_folds_into_overflow():
    book = tenancy.TenantBook(tenancy.TenancyConfig(
        max_tenants=2, weights={"vip": 2.0}), Clock())
    for t in ("u1", "u2"):
        book.stats(book.admit_tenant(t))
    assert book.admit_tenant("u3") == tenancy.OVERFLOW_TENANT
    assert book.admit_tenant("u1") == "u1"
    assert book.admit_tenant("vip") == "vip"       # configured: kept


# -- the scheduler ------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    jeng = JEngine(jcfg, params, mesh, JEngineConfig(**GEOM))
    teng = Engine(tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32),
                  tparams, EngineConfig(**GEOM), device="cpu")
    return jeng, teng


def _prompt(i):
    return np.random.default_rng(800 + i).integers(
        0, VOCAB, 1 + i % 6).tolist()


def _drive(sched, clock, req_cls, arrivals):
    """Submit ``arrivals`` ({tick: [(rid, tenant, i)]}) at their ticks and
    step until idle, the clock one TICK a step; returns the admission
    order (first event of each request)."""
    order, tick = [], 0
    while True:
        for rid, tenant, i in arrivals.get(tick, ()):
            sched.submit(req_cls(rid, _prompt(i), max_tokens=4,
                                 tenant=tenant))
        if tick > max(arrivals) and sched.idle():
            break
        sched.step()
        for e in sched.pop_events():
            if e.request_id not in order:
                order.append(e.request_id)
        clock.t += TICK
        tick += 1
    return order


def _two_tenants():
    """Eight requests of tenant a at tick 0, eight of b at tick 2."""
    return {0: [(f"a{i}", "a", i) for i in range(8)],
            2: [(f"b{i}", "b", 8 + i) for i in range(8)]}


def _pair(model, arrivals, cfg_kw):
    jeng, teng = model
    out = []
    for sched_cls, eng, req_cls, mod in (
            (JScheduler, jeng, JRequest, jtenancy),
            (Scheduler, teng, Request, tenancy)):
        clock = Clock()
        sched = sched_cls(eng, clock=clock, pipeline_depth=1,
                          tenancy=mod.TenancyConfig(**cfg_kw))
        order = _drive(sched, clock, req_cls, arrivals)
        out.append((order, {k: c.tokens
                            for k, c in sched.completions.items()},
                    sched.tenant_summary()))
    return out


def test_two_tenant_wfq_order_matches_jax(model):
    (jorder, jtoks, jsum), (torder, ttoks, tsum) = _pair(
        model, _two_tenants(), dict(weights={"a": 3.0, "b": 1.0}))
    assert torder == jorder
    assert ttoks == jtoks
    assert tsum == jsum
    # the fair share: b (weight 1) interleaves behind a (weight 3)
    assert torder != sorted(torder, key=lambda r: (r[0], int(r[1:])))


def test_single_tenant_pops_fifo(model):
    arrivals = {0: [(f"r{i}", "solo", i) for i in range(7)],
                3: [(f"s{i}", "solo", 7 + i) for i in range(3)]}
    (jorder, jtoks, _), (torder, ttoks, _) = _pair(
        model, arrivals, dict(weights={"solo": 2.0}))
    fifo = [f"r{i}" for i in range(7)] + [f"s{i}" for i in range(3)]
    assert torder == jorder == fifo
    assert ttoks == jtoks


def test_throttle_and_queue_full_match_jax(model):
    jeng, teng = model
    res = []
    for sched_cls, eng, req_cls, mod, qf in (
            (JScheduler, jeng, JRequest, jtenancy, JQueueFull),
            (Scheduler, teng, Request, tenancy, QueueFull)):
        clock = Clock()
        sched = sched_cls(eng, clock=clock, max_queue=3,
                          tenancy=mod.TenancyConfig(rates={"t": 4.0},
                                                    burst_s=2.0))
        got = []
        # a bucket of 8 tokens: two budgets of 4 pass, the third waits
        for i in range(3):
            try:
                sched.submit(req_cls(f"t{i}", [1, 2], max_tokens=4,
                                     tenant="t"))
                got.append(None)
            except mod.TenantThrottled as e:
                got.append((e.tenant, e.retry_after_s))
        sched.submit(req_cls("free", [3], max_tokens=4, tenant="u"))
        with pytest.raises(qf) as e:                  # the queue is full
            sched.submit(req_cls("t9", [1], max_tokens=4, tenant="t"))
        got.append((e.value.queue_depth, e.value.retry_after_s))
        got.append(sched.tenants.bucket_level("t"))  # not debited
        clock.t = 0.25
        got.append(sched.tenants.throttle("t", 1))
        empty = req_cls("anon", [5], max_tokens=2, tenant="")
        sched.queue.clear()
        sched.submit(empty)
        got.append(empty.tenant)
        got.append(sched.summary()["tenant_throttled"])
        res.append(got)
    assert res[0] == res[1]
    assert res[1][2] == ("t", 1.0) and res[1][3] == (3, 0.0)
    assert res[1][-2] == "default"
