#!/usr/bin/env python3
"""Time fabric-served inference on the card against other builds of
``serving/fabric.py``.

    python tools/sweep_fabric.py [--baseline DIR/fabric.py ...] [--unbatched] [--json OUT]

Loads full-width bf16 qwen2-0.5b (random weights, seed 0) and serves the first
8 of ``chip_smoke.py``'s serve prompts (64–512 tokens, 64 new each) on a
graphed ``ServeEngine``: the direct streams. Then, in turns (the builds in
order, then in the reverse order), each build of the fabric ("current", the
port's own, and each ``--baseline`` file, a previous version from a ``git
archive`` of an earlier commit or a variant, named by its directory) runs
``chip_smoke.py``'s batched fabric run (two ``torch`` endpoints, a journal, 8
concurrent sessions; with ``--unbatched`` also the run with
``batching=False``), held to the direct streams under the slice's near-tie
rule, with one journal and no duplicate commitment. Prints one line per run
(tokens/s, TTFT p50 and p99, the mean decode-task wall as the client sees it,
batched steps and the largest merge), the medians of each build, and the card's
name and power limit; writes every reading to ``--json`` if given.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import fabric  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

KEYS = ("tokens_s", "ttft_p50", "ttft_p99", "task_ms", "batches", "max_merged")


def load_build(path: Path, i: int):
    """Import another fabric.py as a module of the port's serving package (its
    relative imports resolve there); it keeps its own device lock and specs."""
    name = f"repro_torch.serving._fabric_build{i}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--unbatched", action="store_true")
    ap.add_argument("--json")
    args = ap.parse_args()

    card = cs.phase_device()
    cs.phase_build()
    builds = {"current": fabric}
    for i, path in enumerate(map(Path, args.baseline)):
        builds[path.resolve().parent.name] = load_build(path, i)
    cfg = get_config(cs.ARCH).with_(dtype="bfloat16")
    model = Model(cfg, device=cs.DEVICE).init(torch.Generator(device=cs.DEVICE).manual_seed(0))
    rng = np.random.default_rng(2)                  # chip_smoke.py's serve prompts
    lens = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens][:8]
    n_new, tol = 64, cs.SLICE_BF16_TOL
    engine = ServeEngine(model, max_batch=8, max_len=1024)
    reqs = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    engine.run_until_drained(timeout=600)
    want = [r.tokens for r in reqs]
    del engine
    torch.cuda.empty_cache()

    runs = [("batched", {})] + ([("unbatched", {"batching": False})] if args.unbatched else [])
    readings = []
    for name in list(builds) + list(builds)[::-1]:
        for run, kw in runs:
            r = cs._fabric_run(model, run, prompts, n_new, 2, fabric_mod=builds[name], **kw)
            cs._report_fabric_run(model, f"sweep-fabric {name}", run, r, prompts, want, n_new,
                                  tol)
            readings.append({"build": name, "run": run, **{k: float(r[k]) for k in KEYS}})
    for name in builds:
        for run, _ in runs:
            mine = [x for x in readings if x["build"] == name and x["run"] == run]
            med = {k: float(np.median([x[k] for x in mine])) for k in KEYS}
            cs.say("sweep-fabric", f"{name} {run}, median of {len(mine)}: "
                                   f"{med['tokens_s']:.1f} tokens/s, TTFT p50 "
                                   f"{med['ttft_p50']:.1f} ms, p99 {med['ttft_p99']:.1f} ms, "
                                   f"decode task {med['task_ms']:.3f} ms, {med['batches']:g} "
                                   f"batched steps, largest merge {med['max_merged']:g}")
    if args.json:
        Path(args.json).write_text(json.dumps({"card": card, "readings": readings}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
