"""GPT training on one device or over a {dp, tp} mesh of processes: the
port of ``examples/gpt_train.py`` (BASELINE config #4's script).

Megatron-GPT 2.7B (BASELINE config #5's model) on one card, through the
head-major flash kernels (its heads are 80 wide)::

    python -m apex_tpu_torch.examples.gpt_train --preset 2p7b

GPT-2 355M, or the tiny preset on the CPU (the kernels' plain versions)::

    python -m apex_tpu_torch.examples.gpt_train --preset 355m --batch 16
    python -m apex_tpu_torch.examples.gpt_train --preset tiny --steps 2 \\
        --device cpu

Train from a token file, checkpoint, and resume (the tiny preset on the
CPU; the file from :func:`apex_tpu_torch.data.write_token_file`)::

    python -m apex_tpu_torch.examples.gpt_train --preset tiny --device cpu \\
        --data tokens.bin --ckpt run.atck --metrics run.jsonl --steps 3
    python -m apex_tpu_torch.examples.gpt_train --preset tiny --device cpu \\
        --data tokens.bin --ckpt run.atck --steps 1    # resumes at step 3

As in the JAX script: full remat, bf16 compute, the chunked cross
entropy (chunks of 512) once the sequence is 1024 or longer, the
``*_attn`` remat policies pinning the flash path, ``fused_adam`` in the
chosen layout, the identity loss scaler, a loss printed per step and a
tokens/s summary over the median step from a
:class:`~apex_tpu_torch.profiler.StepTimer` (the first step, which builds
the kernels, is not timed). ``--data`` streams ``[batch, seq+1]`` records
through the prefetching :class:`~apex_tpu_torch.data.TokenLoader` (seed
0), else one synthetic batch from a seed repeats (targets rolled by
one). ``--ckpt`` resumes from the ``.atck`` file when it exists (the
loader starts its epoch anew, as the JAX script's does) and saves the
final state there; a checkpoint of the other ``--opt-layout`` stops with
the JAX script's message. ``--metrics`` appends one JSONL record a step
(:class:`~apex_tpu_torch.profiler.MetricsLogger`: the step's metrics and
``step``). ``--device`` defaults to ``cuda`` and raises when there is no
card; ``cpu`` must be asked for.

Tensor, sequence and data parallelism, one process per rank under
``torchrun``: dp is the world size over ``--tp``, and sequence
parallelism is on at tp > 1 unless ``--no-sp`` (as in the JAX script).
NCCL with a card per rank; gloo where the ranks share a card or run on
the CPU::

    torchrun --nproc-per-node 8 -m apex_tpu_torch.examples.gpt_train \
        --preset 355m --tp 8
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.gpt_train \
        --preset 355m --tp 2 --dist-backend gloo --steps 2
    torchrun --nproc-per-node 4 -m apex_tpu_torch.examples.gpt_train \
        --preset tiny --tp 2 --device cpu --dist-backend gloo --steps 2

Every rank makes the same synthetic global batch and trains its dp
block of it; only rank 0 prints. ``--n-micro`` accumulates gradients
over sequential microbatches (no pipeline), ``--clip-grad-norm`` clips
to the model-parallel global norm.

Flags that need a module the port does not have yet raise and name the
distributed slice (ROADMAP queue 1 item 4) they wait for: ``--pp``,
``--vpp`` (pipeline parallelism), ``--cp``, ``--experts``, ``--ep`` (CP
and MoE), ``--fsdp`` (ZeRO and FSDP), and ``--data`` / ``--ckpt`` at a
world of more than one process (the loaders' mesh).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Iterator, List, NamedTuple, Optional

import torch

from apex_tpu_torch import checkpoint as ckpt
from apex_tpu_torch import data as atdata
from apex_tpu_torch import mesh as mx
from apex_tpu_torch import profiler
from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.amp import ScalerConfig
from apex_tpu_torch.models import gpt, training
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel import multiproc

PRESETS = {
    "tiny": dict(vocab_size=1024, hidden_size=128, num_layers=4,
                 num_heads=4, seq_len=128),
    "355m": dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                 num_heads=16, seq_len=1024),
    "2p7b": dict(vocab_size=50304, hidden_size=2560, num_layers=32,
                 num_heads=32, seq_len=1024),
}

#: the ROADMAP queue 1 item the unported flags wait for
_DISTRIBUTED = "ROADMAP queue 1 item 4, multi-GPU parallelism"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.examples.gpt_train",
        description="GPT training on one device or a {dp, tp} mesh of "
        "processes (the port of examples/gpt_train.py)")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--cp", type=int, default=1)
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--vpp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--clip-grad-norm", type=float, default=None)
    ap.add_argument("--no-sp", action="store_true",
                    help="sequence parallelism off at tp > 1")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--data", help="binary token file "
                    "(apex_tpu_torch.data format); synthetic tokens if "
                    "omitted")
    ap.add_argument("--ckpt", help=".atck checkpoint path to save/resume")
    ap.add_argument("--metrics", help="JSONL metrics path")
    ap.add_argument("--remat-policy", default=None,
                    choices=["dots", "qkv_fc1", "fc1", "qkv_fc1_attn",
                             "fc1_attn"])
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "flash", "xla", "xla_chunked"])
    ap.add_argument("--opt-layout", default="tree", choices=["flat", "tree"])
    ap.add_argument("--ln-impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="the process group's backend over several ranks: "
                    "nccl (a card per rank) or gloo (ranks sharing a card, "
                    "or the CPU)")
    return ap.parse_args(argv)


def world_size() -> int:
    """The number of ranks: the joined process group's, else the ones
    ``torchrun`` started (1 without it)."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def _refuse_unported(args: argparse.Namespace) -> None:
    world = world_size()
    refused = [what for what, on in (
        (f"--pp {args.pp} (pipeline parallelism; {_DISTRIBUTED})",
         args.pp > 1),
        (f"--cp {args.cp} (ring attention, the CP and MoE slice; "
         f"{_DISTRIBUTED})", args.cp > 1),
        (f"--experts {args.experts} (the MoE layer, the CP and MoE slice; "
         f"{_DISTRIBUTED})", args.experts > 0),
        (f"--ep {args.ep} (the CP and MoE slice; {_DISTRIBUTED})",
         args.ep > 1),
        (f"--vpp {args.vpp} (pipeline parallelism; {_DISTRIBUTED})",
         args.vpp > 1),
        (f"--fsdp (the ZeRO and FSDP slice; {_DISTRIBUTED})", args.fsdp),
        (f"--data at a world of {world} (the loaders' mesh; "
         f"{_DISTRIBUTED})", bool(args.data) and world > 1),
        (f"--ckpt at a world of {world} (the loaders' mesh; "
         f"{_DISTRIBUTED})", bool(args.ckpt) and world > 1),
        (f"--attn-impl xla_chunked (the long-context attention, ROADMAP "
         f"queue 2)", args.attn_impl == "xla_chunked"),
    ) if on]
    if refused:
        raise SystemExit("not supported by apex_tpu_torch yet: "
                         + "; ".join(refused))


def config(args: argparse.Namespace) -> gpt.GPTConfig:
    """The JAX script's ``GPTConfig``: full remat, bf16 compute,
    ``ce_chunk`` 512 once the sequence is 1024 or longer (and a multiple
    of 512), the ``*_attn`` policies' flash path, and sequence
    parallelism at tp > 1 unless ``--no-sp``."""
    seq = PRESETS[args.preset]["seq_len"]
    ce_chunk = 512 if seq >= 1024 and seq % 512 == 0 else 0
    attn_impl = args.attn_impl
    if (args.remat_policy or "").endswith("_attn"):
        # the *_attn policies pin the flash kernel's residuals
        if attn_impl == "auto":
            attn_impl = "flash"
        elif attn_impl != "flash":
            raise SystemExit(
                f"--remat-policy {args.remat_policy} requires the flash "
                f"attention path; drop --attn-impl {args.attn_impl} or pick "
                "a non-_attn policy")
    return gpt.GPTConfig(
        sequence_parallel=args.tp > 1 and not args.no_sp,
        remat=True, compute_dtype=torch.bfloat16,
        remat_policy=args.remat_policy, ln_impl=args.ln_impl,
        attn_impl=attn_impl, ce_chunk=ce_chunk, **PRESETS[args.preset])


class Trainer(NamedTuple):
    cfg: gpt.GPTConfig
    init_fn: Callable
    step_fn: Callable
    tokens: torch.Tensor
    targets: torch.Tensor
    #: the {dp, tp} mesh of the ranks, or None on one device
    mesh: Optional[mx.Mesh] = None


def build(args: argparse.Namespace) -> Trainer:
    """The JAX script's step: ``make_train_step`` with
    ``fused_adam(lr, layout=opt_layout)`` and the identity scaler, and
    the synthetic global batch (uniform token ids from a seeded
    ``torch.Generator``, targets rolled by one). At tp > 1 or a world of
    several ranks it joins the process group (``--dist-backend``) and
    builds the mesh first; each rank's device is its card (or the CPU)."""
    _refuse_unported(args)
    mesh = None
    world = world_size()
    if args.tp > 1 or world > 1:
        if args.tp < 1 or world % args.tp:
            raise SystemExit(
                f"--tp {args.tp} needs a world of ranks that it divides, "
                f"not {world}: run under torchrun --nproc-per-node <a "
                f"multiple of {args.tp}>")
        dev = multiproc.initialize_distributed(args.dist_backend,
                                               device=args.device)
        mesh = mx.build_mesh(tp=args.tp, device=dev)
    else:
        dev = resolve_device(args.device)
    cfg = config(args)
    init_fn, step_fn = training.make_train_step(
        cfg, fused_adam(args.lr, layout=args.opt_layout),
        ScalerConfig(enabled=False), n_micro=args.n_micro,
        clip_grad_norm=args.clip_grad_norm, device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (args.batch, cfg.seq_len),
                        generator=gen, device=dev)
    return Trainer(cfg, init_fn, step_fn, tok, torch.roll(tok, -1, 1), mesh)


def train(trainer: Trainer, steps: int, state=None, *,
          log: Optional[Callable[[str], None]] = print,
          batches: Optional[Iterator] = None,
          metrics: Optional[profiler.MetricsLogger] = None) -> dict:
    """``steps`` train steps (from ``init_fn`` under seed 0 unless
    ``state`` is given) on ``batches`` (``(tokens, targets)`` pairs; the
    trainer's fixed batch when None), each logged to ``metrics`` when
    given. A :class:`~apex_tpu_torch.profiler.StepTimer` ticks on each
    step's loss (a read on the host), so the first step (the kernels'
    build included) is not timed. Returns the losses, the timed steps'
    seconds, the median step's tokens/s and the state."""
    dev = trainer.tokens.device
    if state is None:
        state = trainer.init_fn(torch.Generator(device=dev).manual_seed(0))
    timer = profiler.StepTimer(tokens_per_step=trainer.tokens.numel(),
                               window=max(steps, 1))
    losses, times = [], []
    for i in range(steps):
        tok, tgt = (next(batches) if batches is not None
                    else (trainer.tokens, trainer.targets))
        state, m = trainer.step_fn(state, tok, tgt)
        dt = timer.tick(m["loss"])
        if dt > 0.0:
            times.append(dt)
        losses.append(float(m["loss"]))
        if metrics is not None:
            metrics.log(i, m)
        if log:
            log(f"step {i} loss {losses[-1]:.4f}")
    out = dict(losses=losses, step_s=times, state=state)
    s = timer.summary()
    if s:
        out.update(median_step_s=s["median_step_s"],
                   tokens_per_sec=s["tokens_per_sec"])
        where = (dev if trainer.mesh is None else
                 f"mesh {trainer.mesh.shape} of {trainer.mesh.backend} ranks")
        if log:
            log(f"{s['tokens_per_sec']:.0f} tokens/s on {where} (median "
                f"{s['median_step_s'] * 1e3:.1f} ms/step)")
    return out


def resume(trainer: Trainer, path: str):
    """The state saved at ``path``, loaded into a template from
    ``init_fn``; a checkpoint of another optimizer layout stops with the
    JAX script's message."""
    dev = trainer.tokens.device
    like = trainer.init_fn(torch.Generator(device=dev).manual_seed(0))
    try:
        return ckpt.load_checkpoint(path, like)
    except KeyError as e:
        raise SystemExit(
            f"checkpoint {path} does not match the current "
            f"optimizer-state structure ({e}); if it was saved with a "
            "different --opt-layout, resume with that layout") from e


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the script; returns :func:`train`'s result, with the seconds
    of the checkpoint's load (``load_s``) and save (``save_s``) and the
    file written (``saved``) under ``--ckpt``."""
    args = parse_args(argv)
    owned = (args.tp > 1 or world_size() > 1) and not (
        torch.distributed.is_available()
        and torch.distributed.is_initialized())
    try:
        return _main(args)
    finally:
        if owned:
            multiproc.destroy_distributed()


def _main(args: argparse.Namespace) -> dict:
    trainer = build(args)
    lead = trainer.mesh is None or trainer.mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    dev = trainer.tokens.device
    state = None
    load_s = None
    if args.ckpt and ckpt.checkpoint_exists(args.ckpt):
        t0 = time.perf_counter()
        state = resume(trainer, args.ckpt)
        load_s = time.perf_counter() - t0
        say(f"resumed from {args.ckpt} at step {int(state.step)} "
            f"({load_s:.1f} s)")
    loader = batches = None
    if args.data:
        loader = atdata.TokenLoader(args.data, trainer.cfg.seq_len,
                                    args.batch, seed=0, device=dev)
        batches = iter(loader)
    log = profiler.MetricsLogger(jsonl_path=args.metrics if lead else None)
    try:
        out = train(trainer, args.steps, state, batches=batches,
                    metrics=log, log=say)
    finally:
        log.close()
        if loader is not None:
            loader.close()
    out["load_s"] = load_s
    if args.ckpt:
        t0 = time.perf_counter()
        out["saved"] = ckpt.save_checkpoint(args.ckpt, out["state"])
        out["save_s"] = time.perf_counter() - t0
        gb = os.path.getsize(out["saved"]) / 1e9
        say(f"saved {out['saved']} ({gb:.3f} GB in {out['save_s']:.1f} s)")
    return out


if __name__ == "__main__":
    main()
