#!/usr/bin/env python3
"""Time the attention backward kernel (``csrc/flash_attention_backward.cu``)
on the card against other builds and designs of it and against SDPA's
backward.

    python tools/sweep_flash_backward.py [--define REPRO_BWD_PDL=0 ...] \
        [--baseline DIR/flash_attention_backward.cu ...] [--held] [--json OUT]

Builds the source as the port builds it ("current", with the headers beside
it: ``hopper.cuh``, ``flash_backward_plan.cuh``, ``common.cuh``), once for
each ``--define`` (a ``-D`` flag, e.g. ``REPRO_BWD_PDL=0``: the passes as
plain launches, so the profiler times each apart) and each ``--baseline``
source (another design's file with the same C interface and the headers it
includes, e.g. the earlier ``mma.sync`` design with its ``common.cuh``,
unpacked from a commit by ``git archive``, named by its directory), one nvcc
each, at once, into
``build/repro_torch_kernels/sweep/``. Each build is held to
``ref.mha_backward_reference`` in f32 and bf16 (``chip_smoke.BWD_TOL``,
relative L2) at a small causal GQA shape and, bf16, at the timed shapes.
Then, in turns (the builds in order, then in the reverse order), each build
is timed through the port's wrapper with its library swapped, bf16, with
``chip_smoke.py``'s ``cuda_ms`` (30 calls, L2 flushed) at qwen2-0.5b's and
zamba2-2.7b's training calls (``chip_smoke.BWD_TIMED_SHAPES``; with
``--held`` the other families' shapes of ``chip_smoke.BWD_HELD_SHAPES``
too), with SDPA's backward alone timed in every turn beside them (causal
shapes with every key valid only). Prints one line per reading, the
medians, each build's passes at every timed shape (torch.profiler, 10
calls), each build's registers and spills (ptxas) and the card's name and
power limit; writes every reading to ``--json`` if given. Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402

NAME = "flash_attention_backward"


def build_all(defines, baselines) -> dict:
    """{build name: loaded library}; the variants compile while the current
    library builds."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = attn_kernel.SOURCES[NAME]
    variants = [(d, src, [f"-D{d}"]) for d in defines]
    variants += [(Path(b).resolve().parent.name, Path(b), []) for b in baselines]
    procs = {}
    for name, source, flags in variants:
        lib = out_dir / f"lib{NAME}-{name.replace('=', '_')}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    info = attn_kernel.build()[NAME]
    libs, logs = {"current": attn_kernel._libs[NAME]}, {"current": info["log"]}
    for name, (proc, path) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        libs[name] = attn_kernel.load(NAME, path)
    for name, log in logs.items():
        for kernel, line in cs.ptxas_lines(log):
            print(f"[build] {name} {kernel}: {line}", flush=True)
    return libs


def use(lib) -> None:
    attn_kernel._libs[NAME] = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--define", action="append", default=[],
                    help="a -D setting of a variant build, e.g. REPRO_BWD_PDL=0 (repeatable)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="a flash_attention_backward.cu with the same C interface (with the "
                         "headers it includes beside it), named by its directory (repeatable)")
    ap.add_argument("--held", action="store_true",
                    help="also time chip_smoke.BWD_HELD_SHAPES (internvl2's hd 128 among them)")
    ap.add_argument("--json", type=Path, help="write every reading here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_flash_backward: needs a CUDA card")
    cs.phase_device()                                       # prints name and power limit
    libs = build_all(args.define, args.baseline)
    names = list(libs)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(12)
    small = (2, 200, 200, 6, 2, 64, 64, {"kv_len": [200, 77]})
    for name in names:                                      # every build against ref.py
        use(libs[name])
        for dtype in (torch.float32, torch.bfloat16):
            cs._flash_backward_case(gen, small, dtype)
        for shape in cs.BWD_TIMED_SHAPES.values():
            cs._flash_backward_case(gen, shape, torch.bfloat16)
        print(f"[check] {name}: within relative L2 {cs.BWD_TOL[torch.float32]:g} (f32) / "
              f"{cs.BWD_TOL[torch.bfloat16]:g} (bf16) of mha_backward_reference", flush=True)

    cases = {}
    timed = dict(cs.BWD_TIMED_SHAPES) | (cs.BWD_HELD_SHAPES if args.held else {})
    for arch, shape in timed.items():
        _, _, tensors, kw = cs._flash_backward_case(gen, shape, torch.bfloat16)
        q, k, v, o, do, lse = tensors
        sdpa = None
        if kw["causal"] and kw["kv_len"] is None and kw["q_offset"] is None \
                and kw["scale"] is None:
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            sdpa = (out, (qt, kt, vt), do.transpose(1, 2))
        cases[arch] = (tensors, kw, sdpa)

    readings = []
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            use(libs[name])
            for arch, (tensors, kw, _) in cases.items():
                ms = cs.cuda_ms(lambda: attn_kernel.flash_attention_backward(*tensors, **kw))
                readings.append(dict(turn=turn, build=name, case=arch, ms=ms))
        for arch, (_, _, sdpa) in cases.items():
            if sdpa is not None:
                out, xs, dout = sdpa
                ms = cs.cuda_ms(lambda: torch.autograd.grad(out, xs, dout, retain_graph=True))
                readings.append(dict(turn=turn, build="SDPA backward", case=arch, ms=ms))
        for r in readings:
            if r["turn"] == turn:
                print(f"[turn {turn}] {r['build']} {r['case']}: {r['ms']:.5f} ms", flush=True)
    for name in names:                                      # each pass apart (profiler)
        use(libs[name])
        for arch, (tensors, kw, _) in cases.items():
            passes = cs._kernel_passes(
                lambda: attn_kernel.flash_attention_backward(*tensors, **kw), calls=10,
                pattern=r"attn_bwd_\w+")
            print(f"[passes] {name} {arch}: " + (", ".join(
                f"{k} {ms:.5f} ms" for k, (ms, _) in passes.items()) or "not measured"),
                flush=True)
    use(libs["current"])
    for name in [*names, "SDPA backward"]:
        for arch in cases:
            ms = [r["ms"] for r in readings if r["build"] == name and r["case"] == arch]
            if not ms:
                continue
            print(f"[median] {name} {arch}: {np.median(ms):.5f} ms "
                  f"(turns {', '.join(f'{m:.5f}' for m in ms)})")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                         "readings": readings}, indent=1))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
