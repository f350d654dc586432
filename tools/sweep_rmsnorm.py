#!/usr/bin/env python3
"""Time the fused add + RMSNorm kernel on the card against other builds of
the same C interface and against the launch floor.

    python tools/sweep_rmsnorm.py [--baseline DIR/fused_add_rmsnorm.cu ...] [--json OUT]

Builds ``csrc/fused_add_rmsnorm.cu`` as the port builds it ("current") and
each ``--baseline`` source (a previous design's file from a ``git archive``
of an earlier commit, or a variant), named by its directory, one nvcc each,
at once, into ``build/repro_torch_kernels/sweep/``. Each build is held to
``ref.py`` at the four slice rows in f32 (1e-6) and bf16 (1e-2). Then, in
turns (the builds in order, then in the reverse order), each build is timed
through the port's own wrapper (``kernel.fused_add_rmsnorm`` with its library
swapped), 30 calls a reading, at the rows (1,512,2560), (8,1,2560),
(1,512,896) and (8,1,896) in bf16, with ``chip_smoke.py``'s ``cuda_ms`` after
a 256 MB write flush and after a 256 MB read flush, and, at the two decode
rows, as the marginal time of a norm in ``chip_smoke.py``'s chain of 24
(attention output product, add + norm) pairs. The launch floor (the empty
kernel of the current library) is timed in every turn the same two ways.
Prints one line per reading and the card's name and power limit, and writes
every reading to ``--json`` if given.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402


def build_all(baselines) -> dict:
    """{build name: loaded library}; the baselines compile while the current
    library builds."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in map(Path, baselines):
        name = src.resolve().parent.name
        lib = out_dir / f"libfused_add_rmsnorm-{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    info = rms_kernel.build()["fused_add_rmsnorm"]
    libs = {"current": rms_kernel._libs["fused_add_rmsnorm"]}
    logs = {"current": info["log"]}
    for name, (proc, path) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        libs[name] = rms_kernel.load(path)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    return libs


def use(lib) -> None:
    rms_kernel._libs["fused_add_rmsnorm"] = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="a fused_add_rmsnorm.cu with the same C interface, named by "
                         "its directory (repeatable)")
    ap.add_argument("--json", type=Path, help="write every reading here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_rmsnorm: needs a CUDA card")
    cs.phase_device()                                       # prints name and power limit
    libs = build_all(args.baseline)
    names = list(libs)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(5)
    inputs = {}
    for name in names:                                      # every build against ref.py
        use(libs[name])
        for shape in cs.RMS_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                _, inputs[shape] = cs._rms_case(gen, shape, dtype)
    print(f"[check] {', '.join(names)}: the four rows within 1e-6 (f32) / 1e-2 (bf16)",
          flush=True)

    readings = []
    for turn, order in enumerate((names, names[::-1])):
        use(libs["current"])
        for flush in ("write", "read"):
            ms = cs.cuda_ms(rms_kernel.empty_launch, flush=flush)
            readings.append(dict(turn=turn, build="empty kernel", shape=None, what=flush,
                                 ms=ms))
        for name in order:
            use(libs[name])
            for shape in cs.RMS_SHAPES:
                x, d, scale = inputs[shape]
                for flush in ("write", "read"):
                    ms = cs.cuda_ms(lambda: rms_kernel.fused_add_rmsnorm(x, d, scale, 1e-6),
                                    flush=flush)
                    readings.append(dict(turn=turn, build=name, shape=shape, what=flush, ms=ms))
            for D in (896, 2560):
                chain, products = cs.rms_chain_ms(D, rms_kernel.fused_add_rmsnorm)
                readings.append(dict(turn=turn, build=name, shape=(8, 1, D), what="chained",
                                     ms=(chain - products) / cs.CHAIN_PAIRS, chain_ms=chain,
                                     products_ms=products))
        for r in readings:
            if r["turn"] == turn:
                print(f"[turn {turn}] {r['build']} {r['shape']} {r['what']}: {r['ms']:.5f} ms"
                      + (f" (chain {r['chain_ms']:.4f}, products {r['products_ms']:.4f})"
                         if "chain_ms" in r else ""), flush=True)
    use(libs["current"])
    for name in ["empty kernel", *names]:
        for shape in [None, *cs.RMS_SHAPES]:
            for what in ("write", "read", "chained"):
                ms = [r["ms"] for r in readings
                      if r["build"] == name and r["shape"] == shape and r["what"] == what]
                if ms:
                    print(f"[median] {name} {shape} {what}: {np.median(ms):.5f} ms "
                          f"(turns {', '.join(f'{m:.5f}' for m in ms)})")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                         "readings": readings}, indent=1))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
