"""A/B of the port's end-to-end serving and training numbers between two
checkouts, on one CUDA card.

    python3 chip_serve_ab.py A_DIR B_DIR

Each turn is a process of its own, started in one checkout and importing
that checkout's ``apex_tpu_torch`` and ``chip_smoke.py`` (so each side
builds its own kernels). A turn runs ``chip_smoke.py``'s phases 1, 2 and
4 (the device, the build, the 355M serving model from seed 0 and its
reference band), then phase 5 twice: bench.py serve()'s 32-request
trace through ``Scheduler`` over ``Engine``, with its launch counts and
reference band checked as the smoke checks them; then phase 9's bench
train step in the tree layout.

The turns go A, B, B, A, so a drift of the host over the call falls on
both sides alike. Each turn's numbers are printed as they come; the last
line is one JSON object with each side's phase-5 decode tokens/s and
train step ms per run, and the ratios B / A of the means. It exits non-zero
if a turn fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_MARK = "AB_TURN "
_SERVE_RUNS = 2


def turn() -> int:
    """One side's turn, run from inside its checkout."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    cs.phase_device()
    cs.phase_build()
    from apex_tpu_torch.models import gpt

    cfg = cs.model_config()
    params = gpt.init(cfg, torch.Generator("cuda").manual_seed(0))
    band = 3 * cs.phase_model(cfg, params)
    out = {"serve": []}
    for _ in range(_SERVE_RUNS):
        # phase 5 returns (counts, metrics, engine, ...) in every version
        res = cs.phase_path(cfg, params, band)
        out["serve"].append(res[1])
        del res
    del params
    torch.cuda.empty_cache()
    tcfg = cs.train_config()
    tok, tgt = cs.train_batch(tcfg)
    tree, _, _ = cs.phase_train(tcfg, "tree", tok, tgt)
    out["train_tree"] = {k: tree[k] for k in (
        "step_ms", "train_tokens_per_sec", "peak_memory_bytes")}
    print(_MARK + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="checkout A, then checkout B")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        return turn()
    if len(a.dirs) != 2:
        ap.error("give two checkouts, A and B")
    dirs = [os.path.abspath(d) for d in a.dirs]
    me = os.path.abspath(__file__)
    got = {"A": [], "B": []}
    for i, side in enumerate("ABBA"):
        p = subprocess.run([sys.executable, me, "--turn"],
                           cwd=dirs["AB".index(side)], capture_output=True,
                           text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith(_MARK)]
        if p.returncode != 0 or not lines:
            print(f"turn {i} ({side}) failed, rc {p.returncode}:\n"
                  f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}", flush=True)
            return 1
        res = json.loads(lines[-1][len(_MARK):])
        got[side].append(res)
        print(f"turn {i} {side} {dirs['AB'.index(side)]}: "
              + json.dumps(res), flush=True)

    def series(side, f):
        return [v for r in got[side] for v in f(r)]

    dec = {s: series(s, lambda r: [m["decode_tokens_per_sec"]
                                   for m in r["serve"]]) for s in "AB"}
    tps = {s: series(s, lambda r: [m["tokens_per_sec"]
                                   for m in r["serve"]]) for s in "AB"}
    step = {s: series(s, lambda r: [r["train_tree"]["step_ms"]])
            for s in "AB"}
    ratio = lambda x: statistics.mean(x["B"]) / statistics.mean(x["A"])
    print(json.dumps({
        "decode_tokens_per_sec": dec, "decode_b_over_a": ratio(dec),
        "tokens_per_sec": tps, "tokens_b_over_a": ratio(tps),
        "train_tree_step_ms": step, "train_step_b_over_a": ratio(step),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
