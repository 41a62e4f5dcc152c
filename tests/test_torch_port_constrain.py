"""apex_tpu_torch: schema-constrained decoding on the CPU, against JAX.

Oracles:

- the masked draw: ``draw_slots(..., masks=)`` equals JAX's in every
  greedy lane (seeded logits with ties broken away, random masks, a
  one-token row) and is the argmax of the masked logits; an all-True
  mask draws what no mask draws, bit for bit, greedy and sampled lanes
  alike; ``filter_logits(mask=)`` equals JAX's (values exactly, fp32);
- ``JsonSchemaConstraint`` (the port's copy) gives JAX's
  ``allowed_tokens`` at every step of seeded random walks over four
  schemas, ``json_object`` mode and a bare integer with an end token;
- constrained greedy streams through the port's ``Scheduler`` (a 2-layer
  GPT with JAX's weights, vocab 320, ``decode_chunk`` 1, depth 2) equal
  JAX's scheduler's event for event (logprobs within 1e-4, fp32), parse
  with ``json.loads`` and fit their schemas, beside an unconstrained
  request whose stream is unchanged;
- the engine passes the decode steps no mask while every row is all-True
  and the mask rows while one constrains; it uploads the rows only when
  one changed; a released slot's row resets; a speculative engine runs
  plain chunks while a constrained request is active (and refuses a
  speculative chunk with a constrained row); ``decode_chunk > 1`` is
  refused with JAX's wording.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu.serving import sampling as jsampling
from apex_tpu.serving.api.constrain import (
    JsonSchemaConstraint as JConstraint,
)
from apex_tpu.serving.engine import Engine as JEngine
from apex_tpu.serving.engine import EngineConfig as JEngineConfig
from apex_tpu.serving.request import Request as JRequest
from apex_tpu.serving.scheduler import Scheduler as JScheduler
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.serving import (
    Engine,
    EngineConfig,
    Request,
    Scheduler,
    sampling,
)
from apex_tpu_torch.serving.api.constrain import JsonSchemaConstraint
from apex_tpu_torch.serving.engine import Admission

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

#: the byte-level codec needs >= 256 ids; 300 is a non-byte end token
VOCAB = 320
END = 300
SMALL = dict(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
             seq_len=128, remat=False, init_std=0.2)
GEOM = dict(slots=3, max_prompt_len=16, max_seq_len=112, decode_chunk=1,
            prompt_buckets=(16,), admit_batch_sizes=(1, 2, 3))
#: fp32 on both sides: logprobs agree to rounding
LP_TOL = 1e-4

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 8},
        "age": {"type": "integer"},
        "tags": {"type": "array",
                 "items": {"type": "string", "maxLength": 6},
                 "minItems": 1, "maxItems": 2},
        "kind": {"enum": ["x", "y"]},
    },
    "required": ["name", "age", "tags", "kind"],
}
POINT = {"type": "object",
         "properties": {"x": {"type": "number"}, "ok": {"type": "boolean"},
                        "none": {"type": "null"}},
         "required": ["x", "ok"]}


# -- the masked draw ---------------------------------------------------------

def _draw_inputs(seed, b=6, v=VOCAB):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, v)).astype(np.float32) * 3
    masks = rng.random((b, v)) < 0.3
    masks[np.arange(b), rng.integers(0, v, b)] = True   # never empty
    masks[1] = False
    masks[1, 17] = True                                 # a one-token row
    masks[2] = True                                     # unconstrained
    temp = np.where(np.arange(b) % 2 == 0, 0.0, 0.9).astype(np.float32)
    top_k = np.where(np.arange(b) % 3 == 1, 20, 0)
    top_p = np.where(np.arange(b) % 3 == 2, 0.8, 1.0).astype(np.float32)
    t = np.arange(b) + 5
    return logits, masks, temp, top_k, top_p, t


def _torch_draw(logits, masks, temp, top_k, top_p, t):
    keys = torch.tensor([sampling.request_key(i, 0) for i in range(len(t))],
                        dtype=torch.int64)
    return sampling.draw_slots(
        torch.from_numpy(logits), keys, torch.from_numpy(t),
        torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p),
        masks=None if masks is None else torch.from_numpy(masks))


@pytest.mark.parametrize("seed", range(3))
def test_masked_draw_greedy_lanes_match_jax(seed):
    logits, masks, temp, top_k, top_p, t = _draw_inputs(seed)
    got = _torch_draw(logits, masks, temp, top_k, top_p, t).numpy()
    keys = jnp.stack([jax.random.key_data(jax.random.PRNGKey(i))
                      for i in range(len(t))])
    want = np.asarray(jsampling.draw_slots(
        jnp.asarray(logits), keys, jnp.asarray(t, jnp.int32),
        jnp.asarray(temp), jnp.asarray(top_k, jnp.int32),
        jnp.asarray(top_p), masks=jnp.asarray(masks)))
    greedy = temp <= 0
    assert (got[greedy] == want[greedy]).all()
    masked = np.where(masks, logits, np.finfo(np.float32).min)
    assert (got[greedy] == masked.argmax(-1)[greedy]).all()
    # every lane, sampled too, draws inside its mask; row 1 is forced
    assert masks[np.arange(len(t)), got].all()
    assert got[1] == 17


@pytest.mark.parametrize("seed", range(3))
def test_all_true_mask_is_bit_equal_to_no_mask(seed):
    logits, _, temp, top_k, top_p, t = _draw_inputs(seed)
    ones = np.ones_like(logits, dtype=bool)
    a = _torch_draw(logits, ones, temp, top_k, top_p, t)
    b = _torch_draw(logits, None, temp, top_k, top_p, t)
    assert torch.equal(a, b)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (20, 1.0), (0, 0.8),
                                         (20, 0.8)])
def test_filter_logits_mask_matches_jax(top_k, top_p):
    logits, masks, *_ = _draw_inputs(7)
    got = sampling.filter_logits(torch.from_numpy(logits), top_k, top_p,
                                 mask=torch.from_numpy(masks)).numpy()
    want = np.asarray(jsampling.filter_logits(
        jnp.asarray(logits), top_k, top_p, mask=jnp.asarray(masks)))
    np.testing.assert_array_equal(got, want)


# -- the automaton -------------------------------------------------------------

@pytest.mark.parametrize("schema,kw", [
    (SCHEMA, {}), (POINT, {}), ({"enum": [1, 12, 3.5, "ab", None]}, {}),
    ({"type": "array", "items": {"type": "integer"}, "maxItems": 3}, {}),
    (None, dict(max_string_len=6, max_keys=2, max_items=2, max_depth=2)),
    ({"type": "integer"}, dict(end_token_id=END))])
def test_constraint_walks_match_jax(schema, kw):
    rng = np.random.default_rng(11)
    tc, jc = JsonSchemaConstraint(schema, **kw), JConstraint(schema, **kw)
    assert tc.token_bound() == jc.token_bound()
    for _ in range(25):
        tc.reset()
        jc.reset()
        out = []
        while not jc.done:
            allowed = tc.allowed_tokens()
            assert allowed == jc.allowed_tokens()
            b = int(rng.choice(allowed))
            tc.advance(b)
            jc.advance(b)
            out.append(b)
        assert tc.done
        body = bytes(x for x in out if x < 256).decode()
        json.loads(body)


# -- constrained serving --------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**SMALL, compute_dtype=jnp.float32)
    params = jgpt.init(jcfg, jax.random.PRNGKey(0))
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    tparams = tgpt.params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")
    jeng = JEngine(jcfg, params, mesh, JEngineConfig(**GEOM))
    tcfg = tgpt.GPTConfig(**SMALL, compute_dtype=torch.float32)
    teng = Engine(tcfg, tparams, EngineConfig(**GEOM), device="cpu")
    return tcfg, tparams, jeng, teng, (jcfg, params, mesh)


def _trace(cons_cls, req_cls):
    """(request, schema): the object schema, the point schema, an enum
    the logits must be forced into, a bare integer ended by the non-byte
    eos, json_object mode, and an unconstrained request."""
    rng = np.random.default_rng(900)
    prompts = [rng.integers(0, 256, n).tolist() for n in (6, 3, 9, 4, 5, 7)]
    rows = [
        ("obj", SCHEMA, {}, None),
        ("point", POINT, {}, None),
        ("enum", {"enum": ["ab"]}, {}, None),
        ("int", {"type": "integer"}, dict(end_token_id=END), END),
        ("any", None, dict(max_string_len=6, max_keys=2, max_items=2,
                           max_depth=1), None),
    ]
    out = [(req_cls(rid, prompts[i], max_tokens=96,
                    constraint=cons_cls(schema, **kw), eos_token_id=eos),
            schema) for i, (rid, schema, kw, eos) in enumerate(rows)]
    out.append((req_cls("plain", prompts[5], max_tokens=10), None))
    return out


def _fits(v, schema):
    if schema is None:
        return isinstance(v, dict)
    if "enum" in schema:
        return v in schema["enum"]
    t = schema.get("type")
    if t == "object":
        return (isinstance(v, dict) and set(schema.get("required", ()))
                <= set(v) and all(_fits(v[k], schema["properties"][k])
                                  for k in v))
    if t == "array":
        return (isinstance(v, list)
                and schema.get("minItems", 0) <= len(v)
                <= schema.get("maxItems", len(v))
                and all(_fits(x, schema["items"]) for x in v))
    if t == "string":
        return isinstance(v, str) and len(v) <= schema.get("maxLength",
                                                           len(v))
    if t == "integer":
        return isinstance(v, int) and not isinstance(v, bool)
    if t == "number":
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if t == "boolean":
        return isinstance(v, bool)
    return v is None


def _serve(sched, trace):
    for r, _ in trace:
        sched.submit(r)
    sched.run_until_idle()
    return sched


def test_constrained_streams_match_jax_and_parse(model):
    _, _, jeng, teng, _ = model
    jt = _trace(JConstraint, JRequest)
    tt = _trace(JsonSchemaConstraint, Request)
    js = _serve(JScheduler(jeng, pipeline_depth=2), jt)
    ts = _serve(Scheduler(teng, pipeline_depth=2), tt)
    jev = [(e.request_id, e.token, e.finished, e.finish_reason, e.logprob)
           for e in js.pop_events()]
    tev = [(e.request_id, e.token, e.finished, e.finish_reason, e.logprob)
           for e in ts.pop_events()]
    assert [e[:4] for e in tev] == [e[:4] for e in jev]
    assert all(abs(a[4] - b[4]) <= LP_TOL for a, b in zip(tev, jev)
               if a[4] is not None)
    for (r, schema) in tt:
        c = ts.completions[r.request_id]
        assert c.tokens == js.completions[r.request_id].tokens
        if r.constraint is None:
            assert c.finish_reason == "length"
            continue
        assert c.finish_reason == "stop", r.request_id
        v = json.loads(bytes(t for t in c.tokens if t < 256).decode())
        assert _fits(v, schema), (r.request_id, v)
    assert ts.completions["enum"].tokens == list(b'"ab"')
    s = ts.summary()
    assert s["stop_finishes"] == 5.0
    # one upload a constrained admission group and one a mask change
    assert 0 < s["mask_uploads"] <= ts.summary()["tokens_emitted"] + 3


def test_unconstrained_steps_take_no_mask(model, monkeypatch):
    """All-True rows pass None to the decode steps (nothing launched for
    the mask); a constraining row passes the [B, vocab] rows, uploaded
    only when one changed; a released slot's row resets."""
    tcfg, tparams, _, _, _ = model
    seen = []
    real = tgpt.decode_steps

    def spy(*a, masks=None, **kw):
        seen.append(None if masks is None else masks.clone())
        return real(*a, masks=masks, **kw)

    monkeypatch.setattr(tgpt, "decode_steps", spy)
    eng = Engine(tcfg, tparams, EngineConfig(**GEOM), device="cpu")
    eng.admit_many([Admission(0, [1, 2, 3], 8), Admission(1, [4, 5], 8)])
    eng.step()
    assert seen == [None] and eng.mask_uploads == 0
    eng.set_slot_mask(1, [7, 8])
    eng.step()
    eng.step()
    assert eng.mask_uploads == 1                 # cached across steps
    assert seen[1].shape == (GEOM["slots"], VOCAB)
    assert seen[1][1].nonzero().flatten().tolist() == [7, 8]
    assert seen[1][[0, 2]].all()
    eng.set_slot_mask(1, [7, 8])                 # unchanged: no upload
    eng.step()
    assert eng.mask_uploads == 1
    eng.free_slot(1)
    eng.step()
    assert seen[-1] is None


def test_spec_engine_runs_plain_chunks_while_constrained(model):
    """Constrained traffic never dispatches a speculative chunk (the
    verify wave draws without masks), and the engine refuses one while a
    row constrains."""
    tcfg, tparams, _, _, _ = model
    spec = Engine(tcfg, tparams, EngineConfig(**GEOM, spec_k=2),
                  device="cpu")
    trace = [(Request(rid, p, max_tokens=12,
                      constraint=JsonSchemaConstraint({"enum": [word]})),
              None) for rid, p, word in (("a", [3, 4, 5], "abc"),
                                         ("b", [9, 8], "xy"))]
    sched = _serve(Scheduler(spec, pipeline_depth=2), trace)
    assert sched.completions["a"].tokens == list(b'"abc"')
    assert sched.completions["b"].tokens == list(b'"xy"')
    assert spec.spec_waves_taken == 0 and spec.decode_steps_taken > 0
    spec.admit_many([Admission(0, [1, 2], 4, allowed_tokens=[5])])
    with pytest.raises(ValueError, match="constrained slots"):
        spec.step_async(spec=True)


def test_constraint_needs_decode_chunk_1_as_jax(model):
    tcfg, tparams, _, _, (jcfg, params, mesh) = model
    geom = {**GEOM, "decode_chunk": 2}
    jeng2 = JEngine(jcfg, params, mesh, JEngineConfig(**geom))
    eng = Engine(tcfg, tparams, EngineConfig(**geom), device="cpu")
    errs = []
    for sched, req, cons in ((JScheduler(jeng2), JRequest, JConstraint),
                             (Scheduler(eng), Request,
                              JsonSchemaConstraint)):
        with pytest.raises(ValueError, match="decode_chunk == 1") as e:
            sched.submit(req("r", [3], max_tokens=4,
                             constraint=cons({"enum": ["a"]})))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_allowed_tokens_validation(model):
    _, _, _, teng, _ = model
    with pytest.raises(ValueError, match="non-empty subset"):
        teng.admit_many([Admission(0, [1], 2, allowed_tokens=[VOCAB])])
    with pytest.raises(ValueError, match="non-empty subset"):
        teng.set_slot_mask(0, [])
