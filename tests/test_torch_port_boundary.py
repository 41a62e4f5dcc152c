"""The port's boundary: what ``apex_tpu_torch`` imports, when it builds
and touches CUDA, and where it refuses to run.

- Every module of the package (the serving front end's too: the tenancy
  book, ``serving/api/*``, ``examples/serve_gpt.py`` and
  ``examples/generate.py``; the telemetry layer: ``telemetry/*``,
  ``serving/tuner.py``, ``profiler.py`` and ``_atomic.py``; and the
  resilience layer: ``serving/resilience.py``, ``serving/journal.py`` and
  ``serving/fleet.py``) imports in a subprocess whose
  ``sys.meta_path`` blocks ``jax``, ``jaxlib`` and ``apex_tpu`` (the exact
  name and the ``apex_tpu.`` prefix — not the string prefix, which would
  also block ``apex_tpu_torch``), and the import neither builds the
  kernels nor initialises CUDA.
- ``chip_smoke.py``, ``chip_serve_ab.py``, ``chip_l2norm_ab.py``,
  ``chip_decode_quant_ab.py`` and ``chip_verify_ab.py`` import nothing of
  JAX, and without a CUDA device they exit non-zero and print no result
  line.
- ``device=None`` means CUDA: without a CUDA device the engine and the
  model's entry points raise instead of running on the CPU.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from apex_tpu_torch import _capabilities, resolve_device
from apex_tpu_torch.amp import ScalerConfig
from apex_tpu_torch.models import bert as tbert
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.models import training as ttraining
from apex_tpu_torch.optimizers import fused_adam, fused_lamb
from apex_tpu_torch.serving import Engine, EngineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "apex_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import apex_tpu_torch
    names = ["apex_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(apex_tpu_torch.__path__,
                                              "apex_tpu_torch.")]
    for n in names:
        importlib.import_module(n)
    import torch
    from apex_tpu_torch.kernels import _build
    leaked = sorted(m for m in sys.modules if any(
        m == b or m.startswith(b + ".") for b in BLOCKED))
    print("MODULES", len(names))
    print("FRONTEND", all(n in names for n in (
        "apex_tpu_torch.serving.tenancy", "apex_tpu_torch.serving.hostswap",
        "apex_tpu_torch.serving.api",
        "apex_tpu_torch.serving.api.server",
        "apex_tpu_torch.serving.api.protocol",
        "apex_tpu_torch.serving.api.constrain",
        "apex_tpu_torch.serving.api.tokenizer",
        "apex_tpu_torch.examples.serve_gpt",
        "apex_tpu_torch.examples.generate")))
    print("TELEMETRY", all(n in names for n in (
        "apex_tpu_torch._atomic", "apex_tpu_torch.profiler",
        "apex_tpu_torch.serving.tuner", "apex_tpu_torch.telemetry",
        "apex_tpu_torch.telemetry.ring",
        "apex_tpu_torch.telemetry.registry",
        "apex_tpu_torch.telemetry.spans", "apex_tpu_torch.telemetry.slo",
        "apex_tpu_torch.telemetry.flightrec",
        "apex_tpu_torch.telemetry.http",
        "apex_tpu_torch.telemetry.replay")))
    print("RESILIENCE", all(n in names for n in (
        "apex_tpu_torch.serving.resilience",
        "apex_tpu_torch.serving.journal",
        "apex_tpu_torch.serving.fleet")))
    print("NO_RECOMPILE", "apex_tpu_torch.telemetry.recompile" not in names)
    print("LEAKED", leaked)
    print("BUILT", _build._info is not None or _build._lib is not None)
    print("CUDA_INIT", torch.cuda.is_initialized())
""")


def test_every_module_imports_without_jax_or_apex_tpu():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-4000:]
    out = dict(line.split(" ", 1) for line in res.stdout.splitlines())
    # the package, its fourteen subpackages and their fifty-seven modules
    # (serving/tenancy.py, serving/hostswap.py, serving/api/*,
    # examples/serve_gpt.py and examples/generate.py among them; the
    # telemetry package's seven, serving/tuner.py, profiler.py and
    # _atomic.py; serving/resilience.py, serving/journal.py and
    # serving/fleet.py)
    assert int(out["MODULES"]) == 72, out
    assert out["FRONTEND"] == "True"
    assert out["TELEMETRY"] == "True"
    assert out["RESILIENCE"] == "True"
    assert out["NO_RECOMPILE"] == "True"
    assert out["LEAKED"] == "[]"
    assert out["BUILT"] == "False"
    assert out["CUDA_INIT"] == "False"


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_and_chip_smoke_import_no_jax():
    """A static view of the same rule, over every file of the package and
    the chip scripts: an import inside a function counts too."""
    files = [os.path.join(REPO, f)
             for f in ("chip_smoke.py", "chip_serve_ab.py",
                       "chip_l2norm_ab.py", "chip_decode_quant_ab.py",
                       "chip_verify_ab.py")]
    for root, _, names in os.walk(os.path.join(REPO, "apex_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "apex_tpu"}
        assert not bad, (f, bad)


def test_chip_smoke_fails_without_a_card():
    """Here there is no CUDA device: the smoke must exit non-zero and must
    not print its result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_serve_ab_fails_without_a_card():
    """The serving A/B drives each turn through the smoke's device phase:
    without a CUDA device its first turn fails and so does the script,
    with no summary line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_serve_ab.py"), REPO,
         REPO], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "turn 0 (A) failed" in res.stdout
    assert "b_over_a" not in res.stdout


def test_chip_l2norm_ab_fails_without_a_card():
    """The row 21 / row 20 A/B starts with the smoke's device phase:
    without a CUDA device it exits non-zero with no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_l2norm_ab.py"), REPO],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stdout
    assert '"card"' not in res.stdout


def test_chip_decode_quant_ab_fails_without_a_card():
    """The decode reads' A/B starts with the smoke's device phase: without
    a CUDA device it exits non-zero with no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_decode_quant_ab.py"),
         REPO], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stdout
    assert '"card"' not in res.stdout


def test_chip_verify_ab_fails_without_a_card():
    """The verify launch's A/B starts with the smoke's device phase:
    without a CUDA device it exits non-zero with no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_verify_ab.py"), REPO],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stdout
    assert '"card"' not in res.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


SMALL = dict(vocab_size=64, hidden_size=64, num_layers=1, num_heads=1,
             seq_len=32, compute_dtype=torch.float32)
BERT_SMALL = dict(vocab_size=64, hidden_size=64, num_layers=1, num_heads=1,
                  seq_len=32, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def cpu_params():
    cfg = tgpt.GPTConfig(**SMALL)
    return cfg, tgpt.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


def test_resolve_device_is_the_one_rule(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="unsupported device"):
        resolve_device("meta")
    caps = _capabilities.capabilities()
    assert caps["cuda_available"] is False
    assert caps["kernels_supported"] is False
    assert caps["build_dir"].endswith(os.path.join("build", "apex_tpu_torch",
                                                   os.path.basename(
                                                       caps["build_dir"])))


@pytest.mark.parametrize("entry", ["init", "params_from_numpy", "generate",
                                   "engine", "make_train_step",
                                   "train_state_from_numpy", "scaler_init",
                                   "bert_init", "make_mlm_train_step"])
def test_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, cpu_params, entry):
    cfg, params = cpu_params
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "init":
            tgpt.init(cfg, torch.Generator().manual_seed(0))
        elif entry == "params_from_numpy":
            tgpt.params_from_numpy(tgpt.params_to_numpy(params))
        elif entry == "generate":
            tgpt.generate(cfg, params, torch.tensor([[1, 2]]), 2)
        elif entry == "make_train_step":
            ttraining.make_train_step(cfg, fused_adam())
        elif entry == "train_state_from_numpy":
            init_fn, _ = ttraining.make_train_step(cfg, fused_adam(),
                                                   device="cpu")
            ttraining.train_state_from_numpy(ttraining.train_state_to_numpy(
                init_fn(torch.Generator().manual_seed(0))))
        elif entry == "scaler_init":
            ScalerConfig().init()
        elif entry == "bert_init":
            tbert.init(tbert.BertConfig(**BERT_SMALL),
                       torch.Generator().manual_seed(0))
        elif entry == "make_mlm_train_step":
            tbert.make_mlm_train_step(tbert.BertConfig(**BERT_SMALL),
                                      fused_lamb())
        else:
            Engine(cfg, params, EngineConfig(slots=1, max_prompt_len=8,
                                             max_seq_len=16))


def test_explicit_cpu_runs(cpu_params):
    cfg, params = cpu_params
    out = tgpt.generate(cfg, params, torch.tensor([[1, 2, 3]]), 3,
                        device="cpu")
    assert tuple(out.shape) == (1, 3)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    eng = Engine(cfg, params, EngineConfig(slots=1, max_prompt_len=8,
                                           max_seq_len=16), device="cpu")
    assert eng.device == torch.device("cpu")


def test_auto_impls_resolve_per_device():
    """``"auto"`` is the kernel on CUDA at every length and horizon, the
    materialised form on the CPU; explicit choices pass through."""
    cfg = tgpt.GPTConfig(**SMALL)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tgpt._attn_impl(cfg, cuda) == "flash"
    assert tgpt._attn_impl(cfg, cpu) == "xla"
    assert tgpt._decode_attn_impl(cfg, cuda) == "kernel"
    assert tgpt._decode_attn_impl(cfg, cpu) == "xla"
    explicit = dataclasses.replace(cfg, attn_impl="flash",
                                   decode_attn_impl="kernel")
    assert tgpt._attn_impl(explicit, cpu) == "flash"
    assert tgpt._decode_attn_impl(explicit, cpu) == "kernel"


def test_cache_layout_and_in_place_insert(cpu_params):
    cfg, params = cpu_params
    cache = tgpt.init_cache(cfg, params, batch=3, max_len=16)
    assert tuple(cache.shape) == (1, 2, 3, 1, 16, 64)
    assert cache.dtype == cfg.compute_dtype
    block = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 2, 1, 1, 8, 64))
    ).float()
    ptr = cache.data_ptr()
    out = tgpt.cache_insert_slot(cache, block, 1)
    assert out.data_ptr() == ptr
    torch.testing.assert_close(cache[:, :, 1, :, :8], block[:, :, 0])
    assert not cache[:, :, [0, 2]].any() and not cache[:, :, 1, :, 8:].any()
