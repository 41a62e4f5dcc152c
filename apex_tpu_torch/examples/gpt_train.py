"""GPT training on one device: the single-device path of
``examples/gpt_train.py``.

Megatron-GPT 2.7B (BASELINE config #5's model) on one card, through the
head-major flash kernels (its heads are 80 wide)::

    python -m apex_tpu_torch.examples.gpt_train --preset 2p7b

GPT-2 355M, or the tiny preset on the CPU (the kernels' plain versions)::

    python -m apex_tpu_torch.examples.gpt_train --preset 355m --batch 16
    python -m apex_tpu_torch.examples.gpt_train --preset tiny --steps 2 \\
        --device cpu

As in the JAX script: full remat, bf16 compute, the chunked cross
entropy (chunks of 512) once the sequence is 1024 or longer, the
``*_attn`` remat policies pinning the flash path, ``fused_adam`` in the
chosen layout, the identity loss scaler, synthetic tokens from a seed
(targets rolled by one), a loss printed per step and a tokens/s summary
over the median step (the first step, which builds the kernels, is not
timed). ``--device`` defaults to ``cuda`` and raises when there is no
card; ``cpu`` must be asked for.

Flags that need a module the port does not have yet raise and name the
ROADMAP queue 1 item they wait for: ``--tp/--pp/--cp > 1``, ``--n-micro
> 1`` and ``--vpp > 1`` (pipeline schedules), ``--experts``, ``--ep``
and ``--fsdp`` (item 6, multi-GPU parallelism), ``--data``, ``--ckpt``
and ``--metrics`` (item 8, the token loader, the ``.atck`` checkpoint
and the metrics logger).
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, List, NamedTuple, Optional

import torch

from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.amp import ScalerConfig
from apex_tpu_torch.models import gpt, training
from apex_tpu_torch.optimizers import fused_adam

PRESETS = {
    "tiny": dict(vocab_size=1024, hidden_size=128, num_layers=4,
                 num_heads=4, seq_len=128),
    "355m": dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                 num_heads=16, seq_len=1024),
    "2p7b": dict(vocab_size=50304, hidden_size=2560, num_layers=32,
                 num_heads=32, seq_len=1024),
}

#: ROADMAP queue 1 items the unported flags wait for
_DISTRIBUTED = "ROADMAP queue 1 item 6, multi-GPU parallelism"
_INFRA = "ROADMAP queue 1 item 8, infrastructure"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.examples.gpt_train",
        description="GPT training on one device (the port of "
        "examples/gpt_train.py's single-device path)")
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
                    help="no effect at tp=1 (sequence parallelism needs "
                    "tp > 1)")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--data")
    ap.add_argument("--ckpt")
    ap.add_argument("--metrics")
    ap.add_argument("--remat-policy", default=None,
                    choices=["dots", "qkv_fc1", "fc1", "qkv_fc1_attn",
                             "fc1_attn"])
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "flash", "xla", "xla_chunked"])
    ap.add_argument("--opt-layout", default="tree", choices=["flat", "tree"])
    ap.add_argument("--ln-impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _refuse_unported(args: argparse.Namespace) -> None:
    refused = [what for what, on in (
        (f"--tp {args.tp} ({_DISTRIBUTED})", args.tp > 1),
        (f"--pp {args.pp} ({_DISTRIBUTED})", args.pp > 1),
        (f"--cp {args.cp} (ring attention; {_DISTRIBUTED})", args.cp > 1),
        (f"--experts {args.experts} (the MoE layer; {_DISTRIBUTED})",
         args.experts > 0),
        (f"--ep {args.ep} ({_DISTRIBUTED})", args.ep > 1),
        (f"--n-micro {args.n_micro} (the pipeline schedules; "
         f"{_DISTRIBUTED})", args.n_micro > 1),
        (f"--vpp {args.vpp} (the pipeline schedules; {_DISTRIBUTED})",
         args.vpp > 1),
        (f"--fsdp ({_DISTRIBUTED})", args.fsdp),
        (f"--data (the token loader; {_INFRA})", args.data is not None),
        (f"--ckpt (the .atck checkpoint; {_INFRA})", args.ckpt is not None),
        (f"--metrics (the metrics logger; {_INFRA})",
         args.metrics is not None),
        (f"--attn-impl xla_chunked (the long-context attention, ROADMAP "
         f"queue 2)", args.attn_impl == "xla_chunked"),
    ) if on]
    if refused:
        raise SystemExit("not supported by apex_tpu_torch yet: "
                         + "; ".join(refused))


def config(args: argparse.Namespace) -> gpt.GPTConfig:
    """The JAX script's ``GPTConfig`` at tp=1: full remat, bf16 compute,
    ``ce_chunk`` 512 once the sequence is 1024 or longer (and a multiple
    of 512), and the ``*_attn`` policies' flash path."""
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
        remat=True, compute_dtype=torch.bfloat16,
        remat_policy=args.remat_policy, ln_impl=args.ln_impl,
        attn_impl=attn_impl, ce_chunk=ce_chunk, **PRESETS[args.preset])


class Trainer(NamedTuple):
    cfg: gpt.GPTConfig
    init_fn: Callable
    step_fn: Callable
    tokens: torch.Tensor
    targets: torch.Tensor


def build(args: argparse.Namespace) -> Trainer:
    """The step of the JAX script's single-device path: ``make_train_step``
    with ``fused_adam(lr, layout=opt_layout)`` and the identity scaler, and
    the synthetic batch (uniform token ids from a seeded
    ``torch.Generator``, targets rolled by one)."""
    _refuse_unported(args)
    dev = resolve_device(args.device)
    cfg = config(args)
    init_fn, step_fn = training.make_train_step(
        cfg, fused_adam(args.lr, layout=args.opt_layout),
        ScalerConfig(enabled=False), clip_grad_norm=args.clip_grad_norm,
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (args.batch, cfg.seq_len),
                        generator=gen, device=dev)
    return Trainer(cfg, init_fn, step_fn, tok, torch.roll(tok, -1, 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(trainer: Trainer, steps: int, state=None, *,
          log: Optional[Callable[[str], None]] = print) -> dict:
    """``steps`` train steps on the fixed batch (from ``init_fn`` under
    seed 0 unless ``state`` is given). Each step ends with its loss read
    on the host; a step's time runs from the previous step's end, so the
    first step (the kernels' build included) is not timed. Returns the
    losses, the timed steps' seconds, the median step's tokens/s and the
    state."""
    dev = trainer.tokens.device
    if state is None:
        state = trainer.init_fn(torch.Generator(device=dev).manual_seed(0))
    losses, times = [], []
    last = None
    for i in range(steps):
        state, m = trainer.step_fn(state, trainer.tokens, trainer.targets)
        losses.append(float(m["loss"]))
        _sync(dev)
        now = time.perf_counter()
        if last is not None:
            times.append(now - last)
        last = now
        if log:
            log(f"step {i} loss {losses[-1]:.4f}")
    out = dict(losses=losses, step_s=times, state=state)
    if times:
        med = statistics.median(times)
        out.update(median_step_s=med,
                   tokens_per_sec=trainer.tokens.numel() / med)
        if log:
            log(f"{out['tokens_per_sec']:.0f} tokens/s on {dev} (median "
                f"{med * 1e3:.1f} ms/step)")
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    return train(build(args), args.steps)


if __name__ == "__main__":
    main()
