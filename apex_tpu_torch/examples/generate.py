"""Decoding on one device: the single-device path of
``examples/generate.py``.

Greedy, sampled or beam-search continuations of random prompts from the
tiny GPT (vocab 1024, hidden 128, 4 layers of 4 heads, seq 128, fp32)
through the KV-cache path: ``gpt.generate``, or ``gpt.beam_search`` with
``--beams``, which prints each batch row's best beam and its total
log-probability. On the card, and on the CPU::

    python -m apex_tpu_torch.examples.generate --n-new 16
    python -m apex_tpu_torch.examples.generate --beams 4 --device cpu

As in the JAX script: weights from seed 0 (``gpt.init``), or with
``--ckpt`` the params of a tiny-preset checkpoint that
``apex_tpu_torch.examples.gpt_train --preset tiny --ckpt`` (or the JAX
package's ``examples/gpt_train.py``) saved (a tree-layout
``TrainState`` template filled from the file, its ``params`` taken),
``--beams``
refuses the sampling flags (beam search is deterministic), and
``--temperature`` with ``--top-k`` / ``--top-p`` samples. The prompts are
drawn with numpy from seed 1 and sampled draws use ``--seed``, so both
differ from the JAX script's ``jax.random`` streams. ``--device``
defaults to ``cuda`` and raises when there is no card; ``cpu`` must be
asked for.

A flag that needs a module the port does not have yet raises and names
the ROADMAP queue 1 item it waits for: ``--tp > 1`` (item 4).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from apex_tpu_torch._capabilities import resolve_device
from apex_tpu_torch.models import gpt

#: the JAX script's model
TINY = dict(vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
            seq_len=128, remat=False, compute_dtype=torch.float32)

#: the ROADMAP queue 1 item the unported flag waits for
_DISTRIBUTED = ("ROADMAP queue 1 item 4, multi-GPU parallelism: the "
                "distributed slice of serving and LoRA at tp > 1")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.examples.generate",
        description="GPT decoding on one device (the port of "
        "examples/generate.py's single-device path)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample only among the k best logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--seed", type=int, default=2,
                    help="the sampled draws' seed")
    ap.add_argument("--beams", type=int, default=0,
                    help="beam search width (0 = greedy/sampled "
                    "generate); prints each batch row's best beam and "
                    "its total log-prob")
    ap.add_argument("--ckpt", help=".atck from gpt_train --preset tiny; "
                    "weights from seed 0 if omitted")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[List[int]]:
    """Run the script; returns each batch row's continuation (its best
    beam under ``--beams``)."""
    args = parse_args(argv)
    if args.tp > 1:
        raise SystemExit(f"not supported by apex_tpu_torch yet: --tp "
                         f"{args.tp} ({_DISTRIBUTED})")
    if args.beams > 0 and (args.temperature > 0 or args.top_k
                           or args.top_p != 1.0):
        raise SystemExit(
            "--beams is deterministic max-probability search; "
            "--temperature/--top-k/--top-p apply to generate only")
    dev = resolve_device(args.device)
    cfg = gpt.GPTConfig(**TINY)
    if args.ckpt:
        from apex_tpu_torch.examples.serve_gpt import checkpoint_params

        params = checkpoint_params(cfg, args.ckpt, dev)
    else:
        params = gpt.init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)), device=dev)
    if args.beams > 0:
        seqs, scores = gpt.beam_search(cfg, params, prompt, args.n_new,
                                       num_beams=args.beams, device=dev)
        out = seqs[:, 0].tolist()
        for i in range(args.batch):
            print(f"prompt {prompt[i].tolist()} -> {out[i]} "
                  f"(logp {float(scores[i, 0]):.3f})")
        return out
    out = gpt.generate(
        cfg, params, prompt, args.n_new, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        seed=args.seed if args.temperature > 0 else None,
        device=dev).tolist()
    for i in range(args.batch):
        print(f"prompt {prompt[i].tolist()} -> {out[i]}")
    return out


if __name__ == "__main__":
    main()
