"""apex_tpu_torch: beam search on the CPU, against the JAX package.

Oracles, on one set of weights (a 2-layer GPT, hidden 64, 4 heads, fp32;
JAX's init crossed over through numpy):

- ``num_beams=1`` is the port's greedy ``generate`` and JAX's
  ``beam_search``; at ``num_beams=3`` the sequences are JAX's and the
  scores within 1e-5; beams come back sorted;
- the exhaustive oracle (``tests/test_gpt_generate.py``'s): at vocab 8,
  a 2-token horizon and ``num_beams`` = vocab the top beam is the global
  argmax over brute-force teacher-forced scoring of all 64 continuations;
- with ``eos_token_id`` a frozen beam emits only pad after its eos and
  its score stops moving (k=1 equals greedy ``generate`` with eos; k=3
  equals JAX's);
- exact ties: the selection keeps the lower index first, as
  ``lax.top_k`` does, on crafted tied values and on a model whose tied
  embedding has duplicate rows (every step's logits tie exactly);
- JAX's ``ValueError``s; ``apex_tpu_torch.examples.generate --beams 2
  --device cpu`` and its refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu import mesh as mx
from apex_tpu.models import gpt as jgpt
from apex_tpu_torch.examples import generate as example
from apex_tpu_torch.models import gpt as tgpt

# every xdist worker imports this module: one intra-op thread each
torch.set_num_threads(1)

SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, remat=False,
             init_std=0.2)
VOCAB, SEQ, N_NEW = 96, 24, 6
#: fp32 on both sides: scores are sums of n_new log-probabilities
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**over):
    kw = {**SMALL, "vocab_size": VOCAB, "seq_len": SEQ, **over}
    return (jgpt.GPTConfig(**kw, compute_dtype=jnp.float32),
            tgpt.GPTConfig(**kw, compute_dtype=torch.float32))


def _weights(jcfg, seed=0, edit=None):
    params = jgpt.init(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, params)
    if edit is not None:
        edit(tree)
        params = jax.tree.map(jnp.asarray, tree)
    return params, tgpt.params_from_numpy(tree, device="cpu")


def _jax_beam(jcfg, params, prompt, n_new, k, **kw):
    mesh = mx.build_mesh(tp=1, devices=jax.devices()[:1])
    seqs, scores = jax.jit(jax.shard_map(
        lambda p, t: jgpt.beam_search(jcfg, p, t, n_new, num_beams=k, **kw),
        mesh=mesh, in_specs=(jgpt.param_specs(jcfg), P()),
        out_specs=(P(), P()), check_vma=False))(
            params, jnp.asarray(prompt, jnp.int32))
    return np.asarray(seqs), np.asarray(scores)


def _beam(tcfg, tparams, prompt, n_new, k, **kw):
    seqs, scores = tgpt.beam_search(tcfg, tparams, torch.as_tensor(prompt),
                                    n_new, num_beams=k, device="cpu", **kw)
    assert seqs.dtype == torch.int64 and scores.dtype == torch.float32
    return seqs.numpy(), scores.numpy()


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    params, tparams = _weights(jcfg)
    prompt = np.random.default_rng(1).integers(0, VOCAB, (3, 8))
    return jcfg, tcfg, params, tparams, prompt


def test_k1_is_greedy_generate_and_jax(model):
    jcfg, tcfg, params, tparams, prompt = model
    seqs, scores = _beam(tcfg, tparams, prompt, N_NEW, 1)
    greedy = tgpt.generate(tcfg, tparams, torch.as_tensor(prompt), N_NEW,
                           device="cpu").numpy()
    np.testing.assert_array_equal(seqs[:, 0], greedy)
    want, want_scores = _jax_beam(jcfg, params, prompt, N_NEW, 1)
    np.testing.assert_array_equal(seqs, want)
    np.testing.assert_allclose(scores, want_scores, **SCORE_TOL)


def test_k3_matches_jax(model):
    jcfg, tcfg, params, tparams, prompt = model
    seqs, scores = _beam(tcfg, tparams, prompt, N_NEW, 3)
    want, want_scores = _jax_beam(jcfg, params, prompt, N_NEW, 3)
    assert seqs.shape == (3, 3, N_NEW)
    np.testing.assert_array_equal(seqs, want)
    np.testing.assert_allclose(scores, want_scores, **SCORE_TOL)
    assert np.all(np.diff(scores, axis=1) <= 0)
    # every beam's score is its teacher-forced total log-probability
    for j in range(3):
        toks = torch.as_tensor(np.concatenate([prompt, seqs[:, j]], 1))
        lp = torch.log_softmax(tgpt.logits(tcfg, tparams, toks).float(), -1)
        tf = lp[:, prompt.shape[1] - 1:-1].gather(
            2, torch.as_tensor(seqs[:, j])[:, :, None])[..., 0].sum(1)
        np.testing.assert_allclose(tf.numpy(), scores[:, j], **SCORE_TOL)


def test_exhaustive_oracle():
    """vocab 8, a 2-token horizon, num_beams = vocab: the frontier holds
    every reachable prefix, so the top beam is the global argmax."""
    V, n_new = 8, 2
    jcfg, tcfg = _cfgs(vocab_size=V, seq_len=12, init_std=0.02)
    _, tparams = _weights(jcfg, seed=3)
    prompt = np.random.default_rng(4).integers(0, V, (2, 4))
    seqs, scores = _beam(tcfg, tparams, prompt, n_new, V)
    b, p_len = prompt.shape
    conts = np.array([(t0, t1) for t0 in range(V) for t1 in range(V)])
    toks = np.concatenate([np.repeat(prompt, len(conts), 0),
                           np.tile(conts, (b, 1))], 1)
    lp = torch.log_softmax(tgpt.logits(tcfg, tparams, torch.as_tensor(
        toks)).float(), -1).numpy().reshape(b, len(conts), p_len + 2, V)
    c = np.arange(len(conts))
    s = (lp[:, c, p_len - 1, conts[:, 0]] + lp[:, c, p_len, conts[:, 1]])
    best = s.argmax(1)
    np.testing.assert_array_equal(seqs[:, 0], conts[best])
    np.testing.assert_allclose(scores[:, 0], s[np.arange(b), best],
                               rtol=1e-4, atol=1e-5)
    assert np.all(np.diff(scores, axis=1) <= 1e-6)


def test_eos_freezes_beams(model):
    jcfg, tcfg, params, tparams, prompt = model
    greedy = tgpt.generate(tcfg, tparams, torch.as_tensor(prompt), N_NEW,
                           device="cpu").numpy()
    eos = int(greedy[0, 1])      # row 0's second token becomes the eos
    seqs, scores = _beam(tcfg, tparams, prompt, N_NEW, 1, eos_token_id=eos)
    greedy_eos = tgpt.generate(tcfg, tparams, torch.as_tensor(prompt),
                               N_NEW, eos_token_id=eos,
                               device="cpu").numpy()
    np.testing.assert_array_equal(seqs[:, 0], greedy_eos)
    assert np.all(seqs[0, 0, 2:] == 0)
    _, short = _beam(tcfg, tparams, prompt, 2, 1, eos_token_id=eos)
    assert scores[0, 0] == short[0, 0]
    # k=3: JAX's sequences and scores; a frozen beam emits only pad after
    # its eos
    seqs, scores = _beam(tcfg, tparams, prompt, N_NEW, 3, eos_token_id=eos)
    want, want_scores = _jax_beam(jcfg, params, prompt, N_NEW, 3,
                                  eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(seqs, want)
    np.testing.assert_allclose(scores, want_scores, **SCORE_TOL)
    frozen = [(i, j) for i in range(3) for j in range(3)
              if eos in seqs[i, j, :-1].tolist()]
    assert frozen
    for i, j in frozen:
        at = seqs[i, j].tolist().index(eos)
        assert np.all(seqs[i, j, at + 1:] == 0)


@pytest.mark.parametrize("kw,match", [
    (dict(num_beams=0), "num_beams must be >= 1"),
    (dict(num_beams=VOCAB + 1), "exceeds vocab_size"),
    (dict(num_beams=2, n_new=0), "n_new >= 1"),
    (dict(num_beams=2, n_new=SEQ), "seq_len"),
    (dict(num_beams=2, eos_token_id=VOCAB), "eos_token_id"),
])
def test_validation(model, kw, match):
    _, tcfg, _, tparams, prompt = model
    kw = {"n_new": 2, **kw}
    with pytest.raises(ValueError, match=match):
        tgpt.beam_search(tcfg, tparams, torch.as_tensor(prompt),
                         kw.pop("n_new"), device="cpu", **kw)


def test_selection_keeps_the_lower_index_among_ties():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 4, (5, 300)).astype(np.float32)   # dense ties
    x[0] = 1.0                                           # all tied
    vals, idx = tgpt._top_k_lower(torch.as_tensor(x), 7)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_tied_model_matches_jax():
    """Word-embedding rows 2i and 2i + 1 equal: the tied head gives the
    two tokens bit-equal logits at every step, so every candidate list is
    full of exact ties, and the port must keep JAX's picks."""
    jcfg, tcfg = _cfgs()

    def dup(tree):
        table = tree["embedding"]["word"]["table"]
        table[1::2] = table[0::2]

    params, tparams = _weights(jcfg, seed=5, edit=dup)
    prompt = np.random.default_rng(6).integers(0, VOCAB, (2, 5))
    seqs, scores = _beam(tcfg, tparams, prompt, 4, 4)
    want, want_scores = _jax_beam(jcfg, params, prompt, 4, 4)
    np.testing.assert_array_equal(seqs, want)
    np.testing.assert_allclose(scores, want_scores, **SCORE_TOL)
    # the ties are real: beams 2j and 2j + 1 share their score, and the
    # even token of a tied pair comes first
    assert np.all(scores[:, 0::2] == scores[:, 1::2])
    assert np.all(seqs[:, 0::2, -1] % 2 == 0)


def test_example_beams_on_the_cpu(capsys):
    out = example.main(["--beams", "2", "--device", "cpu", "--n-new", "5"])
    assert len(out) == 2 and all(len(row) == 5 for row in out)
    cfg = tgpt.GPTConfig(**example.TINY)
    params = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    seqs, _ = _beam(cfg, params, prompt, 5, 2)
    assert out == seqs[:, 0].tolist()
    assert capsys.readouterr().out.count("(logp ") == 2


@pytest.mark.parametrize("flags,match", [
    (["--beams", "2", "--top-k", "3"], "deterministic"),
    (["--beams", "2", "--temperature", "0.5"], "deterministic"),
    (["--tp", "2"], "ROADMAP queue 1 item 5"),
    (["--ckpt", "x.atck"], "ROADMAP queue 1 item 7"),
])
def test_example_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        example.main(flags + ["--device", "cpu"])
