#!/usr/bin/env python3
"""Time MLA's absorbed decode kernel (``csrc/mla_decode.cu``) on the card
against builds of the same source with other compile-time settings and
against the path it replaced.

    python tools/sweep_mla_decode.py [--define REPRO_MLA_TILE=32 ...] \
        [--baseline DIR/mla_decode.cu ...] [--json OUT]

Builds ``mla_decode.cu`` as the port builds it ("current"), once for each
``--define`` (a ``-D`` flag, e.g. the keys a tile ``REPRO_MLA_TILE``) and
each ``--baseline`` source (an earlier design's file from a ``git archive``,
with its ``common.cuh``, named by its directory), one nvcc each, at once,
into ``build/repro_torch_kernels/sweep/``. Each build is
held to ``ref.mla_decode_reference`` in f32 (2e-5) and bf16 (2e-2) at
minicpm3-4b's served shape (``chip_smoke.MLA_DECODE_SHAPE``: 8 rows of a
1024-long cache, 40 heads, 256 + 32 and 256) with a row of length 0. Then, in
turns (the builds in order, then in the reverse order), each build is timed
through the port's wrapper with its library swapped, bf16, with
``chip_smoke.py``'s ``cuda_ms`` (30 calls, L2 flushed) at three sets of
lengths: the kernels phase's (a row of length 0, one of 1, one full, the
rest at random), every row full, and 4 full rows (the fabric host's 4 slots).
The path the kernel replaced (``cat`` of the caches, then
``decode_attention``) is timed in every turn beside them. Prints one line per
reading, the medians, each build's two passes at the kernels phase's lengths
(torch.profiler, 10 calls; under a programmatic dependent launch the second
pass's time includes its wait for the first: build with REPRO_MLA_PDL=0 to
time them apart) and the card's name and power limit; writes every reading
to ``--json`` if given. Needs one CUDA card.
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
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402

NAME = "mla_decode_attention"


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
        lib = out_dir / f"libmla_decode-{name.replace('=', '_')}.so"
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    return libs


def use(lib) -> None:
    attn_kernel._libs[NAME] = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--define", action="append", default=[],
                    help="a -D setting of a variant build, e.g. REPRO_MLA_TILE=32 (repeatable)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="an mla_decode.cu with the same C interface (with the common.cuh it "
                         "includes beside it), named by its directory (repeatable)")
    ap.add_argument("--json", type=Path, help="write every reading here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_mla_decode: needs a CUDA card")
    cs.phase_device()                                       # prints name and power limit
    libs = build_all(args.define, args.baseline)
    names = list(libs)
    B, S, H, _, dqk, dv = cs.MLA_DECODE_SHAPE
    kw = dict(scale=cs.MLA_SCALE)
    rng = np.random.default_rng(0)                          # the kernels phase's lengths
    slice_pos = rng.integers(64, S - 1, B).astype(np.int32)
    slice_pos[0], slice_pos[1], slice_pos[-1] = 0, -1, S - 1
    cases = {"slice lengths": (B, torch.from_numpy(slice_pos).to(cs.DEVICE)),
             "full": (B, torch.full((B,), S - 1, device=cs.DEVICE)),
             "4 full": (4, torch.full((4,), S - 1, device=cs.DEVICE))}
    gen = torch.Generator(device=cs.DEVICE).manual_seed(11)
    for name in names:                                      # every build against ref.py
        use(libs[name])
        for dtype in (torch.float32, torch.bfloat16):
            q, ckv, krope = cs._mla_caches(gen, B, S, H, dqk, dv, dtype)
            pos = cases["slice lengths"][1]
            split = libs[name].mla_decode_split(B, S)
            cs.max_err(attn_kernel.mla_decode_attention(q, ckv, krope, pos, **kw),
                       attn_ref.mla_decode_reference(q, ckv, krope, pos, **kw), cs.TOL[dtype],
                       f"{name} {dtype}")
        print(f"[check] {name} (split {split} at B {B}, S {S}): within "
              f"{cs.TOL[torch.float32]:g} (f32) / {cs.TOL[torch.bfloat16]:g} (bf16)", flush=True)

    readings = []

    def pr20(n, pos):   # the cat of the caches, then decode_attention
        k = torch.cat([ckv[:n], krope[:n]], dim=-1)[:, :, None, :]
        return attn_kernel.decode_attention(q[:n], k, ckv[:n, :, None, :], pos, **kw)

    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            use(libs[name])
            for case, (n, pos) in cases.items():
                ms = cs.cuda_ms(lambda: attn_kernel.mla_decode_attention(q[:n], ckv[:n],
                                                                         krope[:n], pos, **kw))
                readings.append(dict(turn=turn, build=name, case=case, ms=ms))
        for case, (n, pos) in cases.items():
            readings.append(dict(turn=turn, build="cat + decode_attention", case=case,
                                 ms=cs.cuda_ms(lambda: pr20(n, pos))))
        for r in readings:
            if r["turn"] == turn:
                print(f"[turn {turn}] {r['build']} {r['case']}: {r['ms']:.5f} ms", flush=True)
    for name in names:                                      # each pass apart (profiler)
        use(libs[name])
        n, pos = cases["slice lengths"]
        passes = cs._kernel_passes(
            lambda: attn_kernel.mla_decode_attention(q, ckv, krope, pos, **kw), calls=10,
            pattern=r"mla_\w+_kernel")
        print(f"[passes] {name} slice lengths: " + (", ".join(
            f"{k} {ms:.5f} ms" for k, (ms, _) in passes.items()) or "not measured"), flush=True)
    use(libs["current"])
    for name in [*names, "cat + decode_attention"]:
        for case in cases:
            ms = [r["ms"] for r in readings if r["build"] == name and r["case"] == case]
            print(f"[median] {name} {case}: {np.median(ms):.5f} ms "
                  f"(turns {', '.join(f'{m:.5f}' for m in ms)})")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                         "readings": readings}, indent=1))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
