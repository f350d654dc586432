#!/usr/bin/env python3
"""Time MLA's absorbed decode kernel (``csrc/mla_decode.cu``) on the card
against builds of the same source with other compile-time settings, against
an earlier design's file, and against the path it replaced.

    python tools/sweep_mla_decode.py [--define REPRO_MLA_PDL=0 ...] \
        [--baseline DIR/mla_decode.cu ...] [--unchecked DIR/mla_decode.cu ...] \
        [--fabric] [--json OUT]

Builds ``mla_decode.cu`` as the port builds it ("current", with the headers
beside it: ``hopper.cuh``, ``mla_decode_plan.cuh``, ``common.cuh``), once for
each ``--define`` (a ``-D`` flag: ``REPRO_MLA_PDL=0`` a plain launch) and
each ``--baseline`` source (an earlier design's file with the headers it
includes, unpacked from a commit by ``git archive``, or an edited copy of
the current files: a variant of the plan, such as another cluster size;
named by its directory), one nvcc each, at once, into
``build/repro_torch_kernels/sweep/``.
A baseline may have the two-pass C interface of the ``mma.sync`` design (a
``scratch`` argument, sized by its ``mla_decode_split``): it is then called
through an adapter that allocates the scratch as that design's wrapper did,
e.g. ``git archive 31e17ae
src/repro_torch/kernels/flash_attention/csrc/mla_decode.cu
src/repro_torch/kernels/flash_attention/csrc/common.cuh | tar -x -C
build/two_pass --strip-components=5``. An ``--unchecked`` source is timed like a
baseline but not held to the plain version: a copy with parts of the kernel
cut out, to see what a part's time is made of.

Each build is held to ``ref.mla_decode_reference`` in f32 (2e-5) and bf16
(2e-2) at minicpm3-4b's served shape (``chip_smoke.MLA_DECODE_SHAPE``: 8 rows
of a 1024-long cache, 40 heads, 256 + 32 and 256) with a row of length 0.
Then, in turns (the builds in order, then in the reverse order), each build
is timed, bf16, with ``chip_smoke.py``'s ``cuda_ms`` (30 calls, L2 flushed)
at three sets of lengths: the kernels phase's (a row of length 0, one of 1,
one full, the rest at random), every row full, and 4 full rows (the fabric
host's 4 slots). The path the kernel replaced (``cat`` of the caches, then
``decode_attention``) is timed in every turn beside them. Prints one line
per reading, the medians, each build's device kernels at the kernels phase's
lengths (torch.profiler, 10 calls), each build's registers and spills
(ptxas) and the card's name and power limit; writes every reading to
``--json`` if given. With ``--fabric``, then, in turns, each checked build
runs inside the decode graph of ``chip_smoke.py``'s fabric-mla host
(full-width bf16 minicpm3-4b, random weights, seed 0; the 4 slots of a
``cache_bytes`` budget of 4 sessions, each prefilled with one of the serve
phase's first 4 prompts, then 32 batched steps): a host is captured anew
for each build, and the median device time of one replay (``chip_smoke``'s
``_graph_step_ms``) is read, with the steps' tokens held to the current
build's. Needs one CUDA card.
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
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
from repro_torch.serving import fabric, kv_cache  # noqa: E402

NAME = "mla_decode_attention"
PORT_CALL = attn_kernel.mla_decode_attention   # the wrapper, before --fabric swaps it
_P, _I, _F, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
# the two-pass design's entry point: q, ckv, krope, o, pos, pos is int64, pos
# stride, scratch, dtype, B, S, H, dl, dr, q/ckv/krope strides, scale, stream
TWO_PASS_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I64, _P, _I, _I, _I, _I, _I, _I, _I64P, _I64P,
                     _I64P, _F, _P]


def two_pass(lib: ctypes.CDLL):
    """A call of the two-pass design's library, as its wrapper made it: o and
    the fp32 scratch of B * ceil(S / split) * H * (dl + 2) floats allocated,
    then the launch; the input checks are the current wrapper's."""
    lib.mla_decode_attention_launch.argtypes = TWO_PASS_ARGTYPES
    lib.mla_decode_attention_launch.restype = ctypes.c_int
    lib.mla_decode_split.argtypes = [_I, _I]
    lib.mla_decode_split.restype = ctypes.c_int

    def call(q, ckv, krope, pos, *, scale):
        attn_kernel._check_mla(q, ckv, krope)
        B, _, H, _ = q.shape
        S, dl, dr = ckv.shape[1], ckv.shape[-1], krope.shape[-1]
        o = torch.empty((B, 1, H, dl), dtype=q.dtype, device=q.device)
        pos = attn_kernel._positions(pos, B, q.device)
        n_split = -(-S // lib.mla_decode_split(B, S))
        scratch = torch.empty(B * n_split * H * (dl + 2), dtype=torch.float32, device=q.device)
        err = lib.mla_decode_attention_launch(
            q.data_ptr(), ckv.data_ptr(), krope.data_ptr(), o.data_ptr(), pos.data_ptr(),
            int(pos.dtype == torch.int64), pos.stride(0) if pos.ndim else 0, scratch.data_ptr(),
            attn_kernel._DTYPE_CODES[q.dtype], B, S, H, dl, dr, attn_kernel._strides(q, (0, 2)),
            attn_kernel._strides(ckv, (0, 1)), attn_kernel._strides(krope, (0, 1)),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"two-pass mla_decode launch failed: CUDA error {err}")
        return o
    return call


def build_all(defines, baselines, unchecked=()) -> dict:
    """{build name: a call like ``attn_kernel.mla_decode_attention``}; the
    variants compile while the current library builds."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = attn_kernel.SOURCES[NAME]
    variants = [(d, src, [f"-D{d}"]) for d in defines]
    variants += [(Path(b).resolve().parent.name, Path(b), []) for b in (*baselines, *unchecked)]
    procs = {}
    for name, source, flags in variants:
        lib = out_dir / f"libmla_decode-{name.replace('=', '_')}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    info = attn_kernel.build()[NAME]
    current = attn_kernel._libs[NAME]
    calls, logs = {"current": with_lib(current)}, {"current": info["log"]}
    for name, (proc, path) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        lib = ctypes.CDLL(str(path))
        calls[name] = (two_pass(lib) if hasattr(lib, "mla_decode_split")
                       else with_lib(attn_kernel.load(NAME, path)))
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "C7515" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    return calls


def with_lib(lib: ctypes.CDLL):
    """The port's wrapper with its library swapped for ``lib``."""
    def call(q, ckv, krope, pos, *, scale):
        attn_kernel._libs[NAME] = lib
        return PORT_CALL(q, ckv, krope, pos, scale=scale)
    return call


def fabric_replays(calls: dict, names: list) -> list:
    """The fabric-mla host's decode graph with each build in it, in turns:
    [{turn, build, ms, same_tokens}]. The model's MLA calls go through
    ``attn_kernel.mla_decode_attention``, swapped for the build's call
    while its host captures and runs."""
    cfg = cs.get_config(cs.MLA_ARCH)
    model = cs.Model(cfg.with_(dtype="bfloat16"), device=cs.DEVICE).init(
        torch.Generator(device=cs.DEVICE).manual_seed(0))
    rng = np.random.default_rng(2)                          # phase_serve's prompts
    lens = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens][:4]
    budget = 4 * kv_cache.cache_bytes(cfg, 1, 1024)
    out, first = [], None
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            attn_kernel.mla_decode_attention = calls[name]
            try:
                host = fabric.ModelHost(model, max_len=1024, max_sessions=8,
                                        cache_bytes_budget=budget)
                for i, p in enumerate(prompts):
                    host.prefill(f"s{i}", p)
                slots = list(range(host.n_slots))
                tokens = [host._batched_step(slots) for _ in range(32)]
                ms = cs._graph_step_ms(host)
            finally:
                attn_kernel.mla_decode_attention = PORT_CALL
            del host
            torch.cuda.empty_cache()
            if name == "current" and first is None:
                first = tokens
            out.append(dict(turn=turn, build=name, ms=ms,
                            same_tokens=None if first is None else tokens == first))
            print(f"[fabric turn {turn}] {name}: replay {ms:.4f} ms at lengths "
                  f"{[int(n) + 32 for n in lens[:4]]}, "
                  f"tokens as current's: {out[-1]['same_tokens']}", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--define", action="append", default=[],
                    help="a -D setting of a variant build, e.g. REPRO_MLA_PDL=0 (repeatable)")
    ap.add_argument("--baseline", action="append", default=[],
                    help="an mla_decode.cu (with the headers it includes beside it), named by "
                         "its directory; the current or the two-pass C interface (repeatable)")
    ap.add_argument("--unchecked", action="append", default=[],
                    help="like --baseline, timed without the checks (a copy with parts cut out)")
    ap.add_argument("--fabric", action="store_true",
                    help="also time the fabric-mla host's decode graph with each checked build")
    ap.add_argument("--json", type=Path, help="write every reading here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_mla_decode: needs a CUDA card")
    cs.phase_device()                                       # prints name and power limit
    calls = build_all(args.define, args.baseline, args.unchecked)
    current = calls["current"]
    unchecked = {Path(u).resolve().parent.name for u in args.unchecked}
    names = list(calls)
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
        if name in unchecked:
            q, ckv, krope = cs._mla_caches(gen, B, S, H, dqk, dv, torch.bfloat16)
            continue
        for dtype in (torch.float32, torch.bfloat16):
            q, ckv, krope = cs._mla_caches(gen, B, S, H, dqk, dv, dtype)
            pos = cases["slice lengths"][1]
            cs.max_err(calls[name](q, ckv, krope, pos, **kw),
                       attn_ref.mla_decode_reference(q, ckv, krope, pos, **kw), cs.TOL[dtype],
                       f"{name} {dtype}")
        print(f"[check] {name} (B {B}, S {S}): within {cs.TOL[torch.float32]:g} (f32) / "
              f"{cs.TOL[torch.bfloat16]:g} (bf16)", flush=True)

    readings = []

    def pr20(n, pos):   # the cat of the caches, then decode_attention
        k = torch.cat([ckv[:n], krope[:n]], dim=-1)[:, :, None, :]
        return attn_kernel.decode_attention(q[:n], k, ckv[:n, :, None, :], pos, **kw)

    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            for case, (n, pos) in cases.items():
                fn = calls[name]
                ms = cs.cuda_ms(lambda: fn(q[:n], ckv[:n], krope[:n], pos, **kw))
                readings.append(dict(turn=turn, build=name, case=case, ms=ms))
        for case, (n, pos) in cases.items():
            readings.append(dict(turn=turn, build="cat + decode_attention", case=case,
                                 ms=cs.cuda_ms(lambda: pr20(n, pos))))
        for r in readings:
            if r["turn"] == turn:
                print(f"[turn {turn}] {r['build']} {r['case']}: {r['ms']:.5f} ms", flush=True)
    for name in names:                                      # its device kernels (profiler)
        n, pos = cases["slice lengths"]
        fn = calls[name]
        passes = cs._kernel_passes(lambda: fn(q, ckv, krope, pos, **kw), calls=10,
                                   pattern=r"mla_\w+_kernel")
        print(f"[kernels] {name} slice lengths: " + (", ".join(
            f"{k} {ms:.5f} ms" for k, (ms, _) in passes.items()) or "not measured"), flush=True)
    current(q, ckv, krope, cases["full"][1], **kw)          # the port's library back in place
    for name in [*names, "cat + decode_attention"]:
        for case in cases:
            ms = [r["ms"] for r in readings if r["build"] == name and r["case"] == case]
            print(f"[median] {name} {case}: {np.median(ms):.5f} ms "
                  f"(turns {', '.join(f'{m:.5f}' for m in ms)})")
    replays = []
    if args.fabric:
        replays = fabric_replays(calls, [n for n in names if n not in unchecked])
        for name in dict.fromkeys(r["build"] for r in replays):
            ms = [r["ms"] for r in replays if r["build"] == name]
            print(f"[median] {name} fabric-mla replay: {np.median(ms):.4f} ms "
                  f"(turns {', '.join(f'{m:.4f}' for m in ms)})")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                         "readings": readings, "fabric": replays}, indent=1))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
