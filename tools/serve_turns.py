#!/usr/bin/env python3
"""``chip_smoke.py``'s serve phase of one family on several trees, in turns,
on one card: the way to compare two commits' served numbers in one call.

    python tools/serve_turns.py --arch minicpm3-4b TREE [TREE ...] [--rounds 2]

Each TREE is a checkout of the repository (e.g. a ``git archive`` of the
parent commit unpacked under ``build/``, and ``.`` for this one). In each
round every tree runs, in order and then in the reverse order the next
round, in a subprocess of its own that imports only that tree: its
``chip_smoke.py`` builds its kernels, makes the full-width bf16 model of
``--arch`` (random weights, seed 0) and runs its ``phase_serve`` (16 requests
through a graphed ``ServeEngine``, then an eager one, the streams held to
each other). Prints each run's graphed throughput, TTFT and decode step and,
per tree, their medians, beside the card's name and power limit. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

KEYS = ("tokens_s", "ttft_p50", "ttft_p99", "step_median_ms")


def child(tree: str, arch: str) -> None:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs

    cs.phase_device()
    cs.phase_build()
    cfg = cs.get_config(arch)
    model = cs.Model(cfg.with_(dtype="bfloat16"), device=cs.DEVICE).init(
        torch.Generator(device=cs.DEVICE).manual_seed(0))
    tol = {cs.MLA_ARCH: cs.SLICE_MLA_BF16_TOL}.get(arch, cs.SLICE_BF16_TOL)
    served = cs.phase_serve(model, "serve", tol)
    print("RESULT " + json.dumps({k: float(served["direct"][k]) for k in KEYS}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--arch", default="minicpm3-4b")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.trees[0], args.arch)
        return 0
    runs = {t: [] for t in args.trees}
    for rnd in range(args.rounds):
        for tree in (args.trees if rnd % 2 == 0 else args.trees[::-1]):
            proc = subprocess.run([sys.executable, __file__, "--child", "--arch", args.arch, tree],
                                  capture_output=True, text=True, timeout=900)
            lines = proc.stdout.splitlines()
            if rnd == 0 and tree == args.trees[0]:
                print(lines[0] if lines else "", flush=True)    # the card's name and power
            result = [ln for ln in lines if ln.startswith("RESULT ")]
            if proc.returncode != 0 or not result:
                raise SystemExit(f"serve_turns: {tree} failed (exit {proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            r = json.loads(result[0][len("RESULT "):])
            runs[tree].append(r)
            print(f"[round {rnd}] {tree}: " + ", ".join(f"{k} {r[k]:.3f}" for k in KEYS),
                  flush=True)
    for tree, rs in runs.items():
        print(f"[median] {tree}: " + ", ".join(
            f"{k} {np.median([r[k] for r in rs]):.3f}" for k in KEYS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
