"""Multi-process test support: a rig of ranks over ``torch.distributed``.

Port of ``apex_tpu/testing.py`` and ``apex_tpu/transformer/testing``
for the PyTorch side. The JAX package simulates N devices in one
process; the port's collectives need N processes. :func:`run_ranks`
starts them (``python -m apex_tpu_torch.testing``), each joins a gloo
group through a ``file://`` rendezvous, runs one named worker of
:data:`WORKERS` on a pickled payload and pickles its result back; the
parent joins them under one deadline and kills every child when one
fails or the deadline passes, so a hang fails the caller instead of
stalling it. Children run one intra-op thread each, and import only
torch, numpy and this package (each result records whether JAX was
imported).

The workers hold the port's side of the tests of the mesh, the
tensor-parallel core, DDP and the GPT mesh step; they take and return
numpy arrays, so the caller compares them with the JAX package's
results on the same inputs.

This module imports nothing of JAX and nothing that builds a kernel or
initialises CUDA at import.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name → ``fn(payload, device) -> result``, run on every rank
WORKERS: Dict[str, Callable[[Any, Any], Any]] = {}


def worker(fn):
    WORKERS[fn.__name__] = fn
    return fn


class RigError(RuntimeError):
    """A rank failed, or the rig passed its deadline."""


def run_ranks(name: str, world: int, payload: Any, workdir: str, *,
              timeout: float = 120.0, backend: str = "gloo",
              device: str = "cpu", env: Optional[dict] = None) -> List[Any]:
    """Run worker ``name`` on ``world`` ranks; → each rank's result, in
    rank order. ``workdir`` (a fresh directory) holds the payload, the
    rendezvous file, the results and each rank's log. Raises
    :class:`RigError` with the failing ranks' log tails when a rank
    exits non-zero or the deadline passes; every child is dead by
    then."""
    if name not in WORKERS:
        raise ValueError(f"unknown worker {name!r}")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    rdzv = os.path.join(workdir, "rdzv")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    child_env = {**os.environ, **(env or {}), "OMP_NUM_THREADS": "1",
                 "PYTHONPATH": os.pathsep.join(
                     p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)}
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.testing", name, str(r),
             str(world), workdir, backend, device],
            stdout=log, stderr=subprocess.STDOUT, cwd=_REPO, env=child_env))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank(s) {bad} exited {[codes[r] for r in bad]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"deadline of {timeout:.0f} s passed"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if failed:
        tails = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r}\n" + f.read()[-3000:])
        raise RigError(f"worker {name!r} at world {world}: {failed}\n"
                       + "\n".join(tails))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _child(argv: List[str]) -> None:
    name, rank, world, workdir, backend, device = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from apex_tpu_torch.parallel.multiproc import (
        destroy_distributed,
        initialize_distributed,
    )

    dev = initialize_distributed(
        backend, rank=rank, world_size=world, local_rank=rank,
        init_method="file://" + os.path.join(workdir, "rdzv"),
        device=device, timeout_s=300.0)
    with open(os.path.join(workdir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    try:
        result = WORKERS[name](payload, dev)
    finally:
        destroy_distributed()
    jax_loaded = any(m == "jax" or m.startswith("jax.") or m == "apex_tpu"
                     or m.startswith("apex_tpu.") for m in sys.modules)
    tmp = os.path.join(workdir, f"out{rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump({"result": result, "jax_loaded": jax_loaded}, f)
    os.replace(tmp, os.path.join(workdir, f"out{rank}.pkl"))


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    from apex_tpu_torch.mesh.sharding import to_numpy

    return to_numpy(t)


def _t(a, dev):
    import torch

    return torch.as_tensor(np.array(a), device=dev)


@worker
def collectives(payload, dev):
    """Every collective of :mod:`apex_tpu_torch.mesh` on each case of the
    payload: ``{"mesh": kwargs of build_mesh, "x": [world, ...] per-rank
    inputs}`` → per case this rank's outputs, keyed by the op."""
    from apex_tpu_torch import mesh as mx

    out = {}
    for case in payload["cases"]:
        m = mx.build_mesh(device=dev, **case["mesh"])
        x = _t(case["x"][m.rank], dev)
        ax = case["axis"]
        res = {"coords": dict(m.coords), "index": mx.axis_index(ax, m),
               "size": mx.axis_size(ax, m)}
        with m:
            res["psum"] = _np(mx.psum(x, ax))
            res["pmean"] = _np(mx.pmean(x, ax))
            res["pmax"] = _np(mx.pmax(x, ax))
            res["pmin"] = _np(mx.pmin(x, ax))
            for g in (0, 1):
                res[f"all_gather{g}"] = _np(mx.all_gather(x, ax,
                                                          gather_axis=g))
                res[f"all_gather{g}_stacked"] = _np(mx.all_gather(
                    x, ax, gather_axis=g, tiled=False))
            res["psum_scatter0"] = _np(mx.psum_scatter(x, ax))
            res["reduce_scatter1"] = _np(mx.reduce_scatter(
                x, ax, scatter_axis=1))
            res["ring"] = _np(mx.ppermute_shift(x, ax, 1, wrap=True))
            res["edge"] = _np(mx.ppermute_shift(x, ax, 1, wrap=False))
            res["back2"] = _np(mx.ppermute_shift(x, ax, -2, wrap=False))
            res["a2a_0_1"] = _np(mx.all_to_all(x, ax, split_axis=0,
                                               concat_axis=1))
            res["a2a_1_0"] = _np(mx.all_to_all(x, ax, split_axis=1,
                                               concat_axis=0))
            res["bcast3"] = _np(mx.pbroadcast_from(x, ax, src_index=3 % res[
                "size"]))
            res["untouched"] = bool(np.array_equal(_np(x), case["x"][m.rank]))
        out[case["name"]] = res
    errors = {}
    for kw in payload["bad_meshes"]:
        try:
            mx.build_mesh(device=dev, **kw)
            errors[repr(kw)] = None
        except ValueError as e:
            errors[repr(kw)] = str(e)
    out["_errors"] = errors
    return out


def _grads_of(fn, xs):
    """(value, grads of ``sum(fn(*xs) * w)``) with ``w`` the last arg."""
    import torch

    leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in xs[:-1]]
    y = fn(*leaves)
    loss = (y * xs[-1]).sum()
    wrt = [x for x in leaves if x.requires_grad]
    gs = torch.autograd.grad(loss, wrt)
    return _np(y), [_np(g) for g in gs]


@worker
def tp_core(payload, dev):
    """The tensor-parallel core on a tp = world mesh: the seven mappings
    (forward and the gradient of a weighted sum), the column/row linear
    pairs with and without SP, the vocab-parallel embedding and cross
    entropy, the parallel state and the RNG streams. Inputs are global
    numpy arrays; this rank takes its blocks."""
    import torch

    from apex_tpu_torch import mesh as mx
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer import tensor_parallel as tpl
    from apex_tpu_torch.transformer.tensor_parallel import mappings as mp
    from apex_tpu_torch.transformer.tensor_parallel import random as tpr

    m = mx.build_mesh(tp=payload["tp"], device=dev)
    r, n = m.index("tp"), m.size("tp")
    blk = lambda a, d: np.array_split(a, n, axis=d)[r]
    out = {}
    for name, (fn, x_dim, w_dim) in {
        "copy": (mp.copy_to_tensor_model_parallel_region, None, None),
        "reduce": (mp.reduce_from_tensor_model_parallel_region, None, None),
        "scatter": (mp.scatter_to_tensor_model_parallel_region, None, -1),
        "gather": (mp.gather_from_tensor_model_parallel_region, -1, None),
        "seq_scatter": (lambda x, **k: mp.scatter_to_sequence_parallel_region(
            x, "tp", 1, **k), None, 1),
        "seq_gather": (lambda x, **k: mp.gather_from_sequence_parallel_region(
            x, "tp", True, 1, **k), 1, None),
        "seq_gather_nogradreduce": (
            lambda x, **k: mp.gather_from_sequence_parallel_region(
                x, "tp", False, 1, **k), 1, None),
        "seq_reduce_scatter": (
            lambda x, **k: mp.reduce_scatter_to_sequence_parallel_region(
                x, "tp", 1, **k), None, 1),
    }.items():
        # x: replicated, or this rank's block of dim x_dim; per-rank
        # inputs differ (x + rank) so a reduction is visible
        x = payload["x"] if x_dim is None else blk(payload["x"], x_dim)
        x = x + payload["rank_scale"] * r
        w = payload["w"][name]
        w = w if w_dim is None else blk(w, w_dim)
        y, (g,) = _grads_of(lambda t: fn(t, mesh=m),
                            [_t(x, dev), _t(w, dev)])
        out[name] = {"y": y, "g": g}
    # the column/row pairs, as JAX's test of the MLP shape
    pr = payload["linear"]
    for sp in (False, True):
        x = pr["x"] if not sp else blk(pr["x"], 0)

        def pair(x, k1, b1, k2, b2, sp=sp):
            h = tpl.column_parallel_linear(x, k1, b1, sequence_parallel=sp,
                                           mesh=m)
            return tpl.row_parallel_linear(torch.tanh(h), k2, b2,
                                           sequence_parallel=sp, mesh=m)

        args = [_t(x, dev), _t(blk(pr["k1"], 1), dev),
                _t(blk(pr["b1"], 0), dev), _t(blk(pr["k2"], 0), dev),
                _t(pr["b2"], dev),
                _t(pr["w"] if not sp else blk(pr["w"], 0), dev)]
        y, gs = _grads_of(pair, args)
        out[f"pair_sp{int(sp)}"] = {"y": y, "g": gs}
    g_out = tpl.column_parallel_linear(
        _t(pr["x"], dev), _t(blk(pr["k1"], 1), dev), None,
        gather_output=True, mesh=m)
    out["gather_output"] = _np(g_out)
    e = payload["emb"]
    y, (g,) = _grads_of(lambda tab: tpl.vocab_parallel_embedding(
        _t(e["ids"], dev), tab, mesh=m), [_t(blk(e["table"], 0), dev),
                                          _t(e["w"], dev)])
    out["emb"] = {"y": y, "g": g}
    ce = payload["ce"]
    for eps in (0.0, 0.1):
        y, (g,) = _grads_of(lambda lg: tpl.vocab_parallel_cross_entropy(
            lg, _t(ce["target"], dev), eps, mesh=m),
            [_t(blk(ce["logits"], -1), dev), _t(ce["w"], dev)])
        out[f"ce{eps}"] = {"y": y, "g": g}
    st = ps.initialize_model_parallel(payload["tp"] // 2, 1, device=dev) \
        if payload["tp"] % 2 == 0 else None
    out["state"] = (ps.get_tensor_model_parallel_world_size(),
                    ps.get_pipeline_model_parallel_world_size(),
                    ps.get_data_parallel_world_size(), st.world_size,
                    ps.get_tensor_model_parallel_rank(),
                    ps.get_data_parallel_rank(),
                    ps.get_tensor_model_parallel_group())
    ps.destroy_model_parallel()
    try:
        ps.get_mesh()
        out["destroyed_raises"] = False
    except RuntimeError:
        out["destroyed_raises"] = True
    key = tpr.model_parallel_rng_key(8, mesh=st.mesh)
    draw = torch.rand(4, generator=tpr.key_generator(key))
    out["rng_tp"] = (st.mesh.index("tp"), st.mesh.index("dp"), _np(draw))
    tr = tpr.get_rng_tracker(0, mesh=st.mesh)
    k1, tr2 = tr.fork()
    k2, _ = tr.fork()
    k3, _ = tr2.fork()
    d1, _ = tr.fork("default")
    out["rng_fork"] = (k1 == k2, k1 != k3, d1)
    data = tpl.broadcast_data(["a"], {"a": np.full(3, r)}, mesh=m)
    out["broadcast_data"] = _np(data["a"])
    return out


@worker
def ddp(payload, dev):
    """apex's DDP on a dp = world mesh: ``allreduce_gradients`` averaged
    and summed, fp32 upcast of half leaves, ``flat_dist_call`` (pmean,
    psum, broadcast), ``no_sync`` accumulation, ``Reducer``."""
    import torch

    from apex_tpu_torch import mesh as mx
    from apex_tpu_torch import parallel as par

    m = mx.build_mesh(dp=payload["dp"], device=dev)
    r = m.index("dp")
    conv = lambda tree, dt=None: {k: _t(v[r], dev) if dt is None else
                                  _t(v[r], dev).to(dt)
                                  for k, v in tree.items()}
    g = conv(payload["grads"])
    out = {}
    with m:
        out["mean"] = {k: _np(v) for k, v in
                       par.allreduce_gradients(g).items()}
        out["sum"] = {k: _np(v) for k, v in par.allreduce_gradients(
            g, gradient_average=False).items()}
        half = conv(payload["half"], torch.float16)
        out["fp16"] = {k: _np(v) for k, v in par.allreduce_gradients(
            half).items()}
        up = par.allreduce_gradients(half, allreduce_always_fp32=True)
        out["fp16_fp32"] = {k: _np(v) for k, v in up.items()}
        out["fp16_dtype"] = str(up["a"].dtype)
        for op in ("pmean", "psum", "broadcast"):
            out[f"flat_{op}"] = {k: _np(v) for k, v in par.flat_dist_call(
                g, op=op, src=1).items()}

    def grad_fn(params, x):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        loss = ((p["w"] * x).sum() + p["b"].sum()) ** 2
        gs = torch.autograd.grad(loss, list(p.values()))
        return dict(zip(p, gs))

    params = {k: _t(v, dev) for k, v in payload["params"].items()}
    xa, xb = (_t(payload[k][r], dev) for k in ("xa", "xb"))
    d = par.DistributedDataParallel(mesh=m)
    g1 = d.no_sync(grad_fn)(params, xa)
    out["no_sync"] = {k: _np(v) for k, v in g1.items()}
    acc = d.wrap_grad_fn(grad_fn)(params, xb, accumulated=g1)
    out["accumulated"] = {k: _np(v) for k, v in acc.items()}
    out["delay"] = {k: _np(v) for k, v in par.DistributedDataParallel(
        mesh=m, delay_allreduce=True).wrap_grad_fn(grad_fn)(
            params, xb).items()}
    out["bcast"] = {k: _np(v) for k, v in d.broadcast_params(
        {"w": _t(payload["params"]["w"] + r, dev)}).items()}
    red = par.Reducer(mesh=m)
    out["reducer"] = {k: _np(v) for k, v in red.reduce(g).items()}
    out["reducer_bcast"] = {k: _np(v) for k, v in red.broadcast(
        g, src=2 % m.size("dp")).items()}
    return out


@worker
def gpt_step(payload, dev):
    """The GPT mesh step on each case of the payload: ``{"name", "tp",
    "dp", "cfg" (GPTConfig kwargs), "opt" (fused_adam kwargs), "clip",
    "n_micro", "scaler" (ScalerConfig kwargs or None), "state" (JAX's
    global initial state as numpy), "batch" ((tokens, targets)), "steps",
    "poison" (a rank whose qkv gradient turns inf at step 0, or None)}``
    (the state as :func:`plain_state`)
    → per case the metrics of every step and the global state after
    each (gathered, on every rank)."""
    import torch

    from apex_tpu_torch import mesh as mx
    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.models import gpt, training
    from apex_tpu_torch.optimizers import fused_adam

    out = {}
    for case in payload["cases"]:
        if case.get("world", 0) not in (0, _world()):
            continue
        m = mx.build_mesh(tp=case["tp"], dp=case["dp"], device=dev)
        cfg = gpt.GPTConfig(**case["cfg"], compute_dtype=torch.float32)
        scaler = (ScalerConfig(**case["scaler"]) if case.get("scaler")
                  else ScalerConfig(enabled=False))
        vag = training.value_and_scaled_grad
        poison = case.get("poison")
        if poison is not None:
            training.value_and_scaled_grad = _poisoned(vag, poison, m)
        try:
            _, step_fn = training.make_train_step(
                cfg, fused_adam(**case["opt"]), scaler,
                n_micro=case.get("n_micro", 1),
                clip_grad_norm=case.get("clip"), mesh=m)
        finally:
            training.value_and_scaled_grad = vag
        state = training.train_state_from_numpy(
            state_from_plain(case["state"]), mesh=m)
        metrics, states = [], []
        for _ in range(case["steps"]):
            state, mt = step_fn(state, *case["batch"])
            metrics.append({k: _np(v) for k, v in mt.items()})
            states.append(training.train_state_to_numpy(state, mesh=m))
        out[case["name"]] = {"metrics": metrics, "states": states,
                             "coords": dict(m.coords)}
    if payload.get("example") and _world() == payload["example"]["world"]:
        # the example's own initial weights and batch, for the caller's
        # reference run, then the example itself
        from apex_tpu_torch.examples import gpt_train

        argv = payload["example"]["argv"]
        tr = gpt_train.build(gpt_train.parse_args(argv))
        st = tr.init_fn(torch.Generator(device=dev).manual_seed(0))
        init = gpt.gather_params(tr.cfg, st.params, tr.mesh)
        res = gpt_train.main(argv)
        out["example"] = {"losses": res["losses"], "init": init,
                          "batch": (_np(tr.tokens), _np(tr.targets))}
    return out


def _steps(step_fn, state, batch, steps: int):
    """``steps`` train steps on ``batch``; → (state, per-step metrics as
    floats, per-step seconds, each ended by a host read of the loss)."""
    import time as _time

    out, secs = [], []
    for _ in range(steps):
        t0 = _time.perf_counter()
        state, m = step_fn(state, *batch)
        out.append({k: float(v) for k, v in m.items()})
        secs.append(_time.perf_counter() - t0)
    return state, out, secs


@worker
def card_world1(payload, dev):
    """The mesh step at world 1 (an all-ones mesh, NCCL on the card)
    against the step without a mesh: the same weights and batch, params
    compared bit for bit; then every collective over
    the world-1 group (a real NCCL call each) against its identity.
    Params are compared after the last step."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch import mesh as mx
    from apex_tpu_torch.models import gpt, training
    from apex_tpu_torch.optimizers import fused_adam

    cfg = gpt.GPTConfig(**payload["cfg"])
    batch = tuple(_t(x, dev) for x in payload["batch"])
    mesh = mx.build_mesh(device=dev)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        init_fn, step_fn = training.make_train_step(
            cfg, fused_adam(payload["lr"], layout=payload["layout"]),
            n_micro=1, device=dev, mesh=m)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        state, metrics, secs = _steps(step_fn, state, batch,
                                      payload["steps"])
        runs[name] = ([x["loss"] for x in metrics], secs,
                      [v.detach().cpu() for v in _tree.leaves(state.params)])
        del state, step_fn, init_fn
        torch.cuda.empty_cache()
    same_params = all(torch.equal(a, b) for a, b in zip(
        runs["plain"][2], runs["mesh"][2]))
    x = torch.arange(24, dtype=torch.float32, device=dev).reshape(4, 6)
    coll = {}
    with mesh:
        for name, got in (
                ("psum", mx.psum(x, "tp")), ("pmean", mx.pmean(x, "dp")),
                ("pmax", mx.pmax(x, ("dp", "tp"))),
                ("pmin", mx.pmin(x, "tp")),
                ("all_gather", mx.all_gather(x, "tp", gather_axis=1)),
                ("psum_scatter", mx.psum_scatter(x, "dp")),
                ("all_to_all", mx.all_to_all(x, "tp", split_axis=0,
                                             concat_axis=1)),
                ("ppermute_shift", mx.ppermute_shift(x, "tp", 1)),
                ("pbroadcast_from", mx.pbroadcast_from(x, "dp"))):
            coll[name] = bool(torch.equal(got, x))
    return {"losses": {k: v[0] for k, v in runs.items()},
            "secs": {k: v[1] for k, v in runs.items()},
            "params_bit_equal": same_params, "collectives": coll,
            "group_is_world": mesh.group("tp") is not None}


@worker
def card_mesh_train(payload, dev):
    """The GPT mesh step on the card: ``payload["tp"]`` x ``["dp"]`` ranks,
    the global weights from seed 0, ``["steps"]`` steps on the global
    batch with the launch counts zeroed just before and read just after;
    → per-step metrics and seconds, this rank's counts, (rank 0 only)
    the parameters gathered into the global tree, and ``probe``: the
    metrics of one more step taken at those parameters (its update
    dropped), for the caller to hold against the one-device step at the
    same weights."""
    import torch

    from apex_tpu_torch import mesh as mx
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import gpt, training
    from apex_tpu_torch.optimizers import fused_adam

    cfg = gpt.GPTConfig(**payload["cfg"])
    batch = tuple(_t(x, dev) for x in payload["batch"])
    mesh = mx.build_mesh(tp=payload["tp"], dp=payload["dp"], device=dev)
    init_fn, step_fn = training.make_train_step(
        cfg, fused_adam(payload["lr"], layout=payload["layout"]),
        clip_grad_norm=payload["clip"], device=dev, mesh=mesh)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    reset_launch_counts()
    state, metrics, secs = _steps(step_fn, state, batch, payload["steps"])
    counts = launch_counts()
    params = gpt.gather_params(cfg, state.params, mesh)
    _, probe, _ = _steps(step_fn, state, batch, 1)
    return {"metrics": metrics, "secs": secs, "counts": counts,
            "probe": probe[0],
            "coords": dict(mesh.coords),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
            "params": params if mesh.rank == 0 else None}


def plain_state(state) -> dict:
    """A JAX ``TrainState`` with numpy leaves as plain dicts and numpy
    (the optimizer state's type by name), so that unpickling it in a
    rank imports nothing of JAX; :func:`state_from_plain` reads it
    back into the port's types."""
    opt = state.opt_state
    return {"step": state.step, "params": state.params,
            "opt": (type(opt).__name__,
                    {f: getattr(opt, f) for f in opt._fields}),
            "scaler": {f: getattr(state.scaler, f) for f in
                       ("loss_scale", "growth_count", "hysteresis_left")}}


def state_from_plain(d):
    """The port's ``TrainState`` (numpy leaves) from :func:`plain_state`."""
    from apex_tpu_torch.amp import ScalerState
    from apex_tpu_torch.models import training

    kind, fields = d["opt"]
    return training.TrainState(
        step=d["step"], params=d["params"],
        opt_state=training._OPT_STATES[kind](**fields),
        scaler=ScalerState(**d["scaler"]))


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size()


def _poisoned(vag, rank: int, mesh):
    """``value_and_scaled_grad`` whose gradients of the fused QKV kernel
    are inf on world rank ``rank`` at the first call of the step: an
    overflow on one rank only (the kernel is tp-sharded, so no
    collective before the vote carries it to a tp peer)."""
    calls = []

    def make(fun, cfg, **kw):
        inner = vag(fun, cfg, **kw)

        def wrapped(params, *args, scaler_state):
            value, grads, finite = inner(params, *args,
                                         scaler_state=scaler_state)
            if mesh.rank == rank and not calls:
                k = grads["layers"]["attn"]["qkv"]["kernel"]
                k.view(-1)[0] = float("inf")
                finite = finite & False
            calls.append(1)
            return value, grads, finite

        return wrapped

    return make


if __name__ == "__main__":
    _child(sys.argv[1:])
