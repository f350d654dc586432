#!/usr/bin/env python3
"""Time the SSD scan's backward kernel (``csrc/ssd_backward.cu``) on the card
against other builds and designs of it.

    python tools/sweep_ssd_backward.py [--baseline DIR/ssd_backward.cu ...] \
        [--train] [--json OUT]

Builds the source as the port builds it ("current", with the headers beside
it: ``wgmma.cuh``, ``ssd_backward_plan.cuh``) and each ``--baseline`` source
(another design's file, or an edited copy of this one, with the same launch
interface and the headers it includes, named by its directory: e.g. the
first design's self-contained file, ``git archive 7623346
src/repro_torch/kernels/ssd/csrc/ssd_backward.cu | tar -x -C build/pr29
--strip-components=5``, whose scratch entry takes no dtype), one nvcc each, at
once, into ``build/repro_torch_kernels/sweep/``. Each build is held to
``ref.ssd_backward_reference`` in f32 and bf16 (``chip_smoke.SSD_BWD_TOL``,
relative L2) at a small two-group shape and, bf16, at the timed shapes. Then,
in turns (the builds in order, then in the reverse order), each build is
timed through the port's wrapper with its library swapped, bf16, with
``chip_smoke.py``'s ``cuda_ms`` (30 calls, L2 flushed) at mamba2-2.7b's and
zamba2-2.7b's training calls (``chip_smoke.SSD_BWD_TIMED``). Prints one line
per reading, the medians, each build's passes at every timed shape
(torch.profiler, 20 calls, L2 flushed), each build's registers and spills
(ptxas), the bf16 sub-group count and scratch, and the card's name and power
limit. With ``--train``, also full-width mamba2-2.7b and zamba2-2.7b bf16
train steps (``chip_smoke.py``'s: B = 8, S = 1024, remat on, random weights
from seed 0), each build's library in turns under the same model, the median
of ``chip_smoke.TRAIN_TIMED_STEPS`` steps a turn split into forward, backward
and optimizer by CUDA events. Writes every reading to ``--json`` if given.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
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
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402

NAME = "ssd_backward"


class _NoDtypeScratch:
    """A library whose scratch entry takes no dtype (the first design's): the
    wrapper's call with the dtype first, passed on without it."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, entry):
        return getattr(self._lib, entry)

    def ssd_backward_scratch(self, dtype, *shape):
        return self._lib.ssd_backward_scratch(*shape)


def load(path: Path):
    """The library at ``path`` with its entry points typed as the wrapper
    calls them."""
    lib = ctypes.CDLL(str(path))
    entries = dict(ssd_kernel._ENTRIES[NAME])
    dtype_first = hasattr(lib, "ssd_backward_subgroups")
    if not dtype_first:
        entries.pop("ssd_backward_subgroups")
        entries["ssd_backward_scratch"] = ([ctypes.c_int] * 7, ctypes.c_int64)
    for entry, (argtypes, restype) in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, restype
    return lib if dtype_first else _NoDtypeScratch(lib)


def build_all(baselines) -> dict:
    """{build name: loaded library}; the baselines compile while the current
    library builds."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = ssd_kernel.SOURCES[NAME]
    procs = {}
    for source in map(Path, baselines):
        name = source.resolve().parent.name
        lib = out_dir / f"lib{NAME}-{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    info = ssd_kernel.build()[NAME]
    libs, logs = {"current": ssd_kernel._libs[NAME]}, {"current": info["log"]}
    if info["log"] == "(cached)":  # built before this run: compile again for ptxas's report
        lib = out_dir / f"lib{NAME}-current.so"
        run = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs["current"] = run.stdout
    for name, (proc, path) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        libs[name] = load(path)
    for name, log in logs.items():
        for kernel, line in cs.ptxas_lines(log):
            print(f"[build] {name} {kernel}: {line}", flush=True)
    return libs


def use(lib) -> None:
    ssd_kernel._libs[NAME] = lib


def time_train(libs: dict, names: list, readings: list) -> None:
    """Train steps of each timed arch, each build in turns (the builds in
    order, then in the reverse order), one warm-up step after each swap."""
    from repro_torch.training.steps import build_train_step
    for arch in cs.SSD_BWD_TIMED:
        model = cs._train_model("bfloat16", arch)
        ocfg = cs.train_opt.OptimizerConfig()
        state = cs.train_opt.init_state(model.params, ocfg)
        step = build_train_step(model, ocfg).fn
        data = cs._train_batch(model.cfg)
        for turn, order in enumerate((names, names[::-1])):
            for name in order:
                use(libs[name])
                step(model.params, state, data)
                times, state = cs._timed_steps(model, state, data, ocfg)
                fwd, bwd, opt = (float(np.median(c)) for c in zip(*times))
                total = float(np.median([sum(t) for t in times]))
                readings.append(dict(turn=turn, build=name, case=f"{arch} train step", ms=total,
                                     forward=fwd, backward=bwd, optimizer=opt))
                print(f"[train turn {turn}] {name} {arch}: step {total:.3f} ms (forward "
                      f"{fwd:.3f}, backward {bwd:.3f}, optimizer {opt:.3f}; median of "
                      f"{cs.TRAIN_TIMED_STEPS})", flush=True)
        del model, state, step, data
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="an ssd_backward.cu with the same launch interface (with the headers "
                         "it includes beside it), named by its directory (repeatable)")
    ap.add_argument("--train", action="store_true",
                    help="also time full-width mamba2-2.7b and zamba2-2.7b train steps in turns")
    ap.add_argument("--json", type=Path, help="write every reading here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_ssd_backward: needs a CUDA card")
    cs.phase_device()                                       # prints name and power limit
    libs = build_all(args.baseline)
    names = list(libs)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(12)
    small = (2, 192, 6, 32, 2, 24, 64)
    for name in names:                                      # every build against ref.py
        use(libs[name])
        for dtype in (torch.float32, torch.bfloat16):
            cs._ssd_backward_case(gen, small, dtype, True, 0)
        for label in cs.SSD_BWD_TIMED:
            cs._ssd_backward_case(gen, cs.SSD_BWD_SHAPES[label][0], torch.bfloat16, False, 0)
        print(f"[check] {name}: within relative L2 {cs.SSD_BWD_TOL[torch.float32]:g} (f32) / "
              f"{cs.SSD_BWD_TOL[torch.bfloat16]:g} (bf16) of ssd_backward_reference",
              flush=True)
    use(libs["current"])
    cases = {}
    for label in cs.SSD_BWD_TIMED:
        shape = cs.SSD_BWD_SHAPES[label][0]
        B, S, H, P, G, N, chunk = shape
        _, tensors = cs._ssd_backward_case(gen, shape, torch.bfloat16, False, 0)
        cases[label] = (tensors, chunk)
        lib = libs["current"]
        s = lib.ssd_backward_subgroups(1, B, S, H, G, N, chunk)
        floats = lib.ssd_backward_scratch(1, B, S, H, P, G, N, chunk)
        print(f"[plan] {label} {shape}: {s} sub-groups of {-(-(H // G) // s)} heads, scratch "
              f"{floats * 4 / 1e6:.1f} MB (bf16)", flush=True)

    readings = []
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            use(libs[name])
            for label, (tensors, chunk) in cases.items():
                ms = cs.cuda_ms(lambda: ssd_kernel.ssd_backward(*tensors, chunk=chunk))
                readings.append(dict(turn=turn, build=name, case=label, ms=ms))
                print(f"[turn {turn}] {name} {label}: {ms:.5f} ms", flush=True)
    for name in names:                                      # each pass apart (profiler)
        use(libs[name])
        for label, (tensors, chunk) in cases.items():
            passes = cs._kernel_passes(lambda: ssd_kernel.ssd_backward(*tensors, chunk=chunk),
                                       pattern=r"\bssd_bwd_\w+")
            print(f"[passes] {name} {label}: " + (", ".join(
                f"{k} {ms:.5f} ms ({n:g} a call)" for k, (ms, n) in passes.items())
                or "not measured"), flush=True)
    del cases
    torch.cuda.empty_cache()
    if args.train:
        time_train(libs, names, readings)
    use(libs["current"])
    for name in names:
        for label in sorted({r["case"] for r in readings}):
            ms = [r["ms"] for r in readings if r["build"] == name and r["case"] == label]
            print(f"[median] {name} {label}: {np.median(ms):.5f} ms "
                  f"(turns {', '.join(f'{m:.5f}' for m in ms)})")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                         "readings": readings}, indent=1))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
