#!/usr/bin/env python3
"""Pick the decode kernel's split on the card, and see what the cold-cache timer costs it.

    python tools/sweep_decode_split.py [--splits 32,64,128,256]

Builds ``csrc/decode_attention.cu`` once per split (``-DREPRO_DECODE_SPLIT``,
one nvcc each, all at once, into ``build/repro_torch_kernels/sweep/``), holds
each build against ``ref.py`` in f32 (2e-5) and bf16 (2e-2), and times one
bf16 ``decode_attention`` call at the slices' decode shapes (8 slots of a
1024-long cache, chip_smoke.py's lengths): qwen2-0.5b (14 heads over 2 KV
heads, hd 64) and zamba2-2.7b (32 over 32, hd 80). Each call is timed with CUDA
events under three cache states: the L2 flushed by writing 256 MB (as
chip_smoke.py's ``cuda_ms`` does, which leaves the L2 full of dirty lines that
the call's reads must first write back), flushed by reading 256 MB (clean
lines), and warm (no flush). torch.profiler then times the split pass and the
combine pass apart (write flush). ``F.scaled_dot_product_attention`` is timed
beside it under the same three states. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402

DEVICE = "cuda"
SHAPES = {"qwen2-0.5b": (8, 1024, 14, 2, 64), "zamba2-2.7b": (8, 1024, 32, 32, 80)}


def build_splits(splits) -> dict:
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = attn_kernel.SOURCES["decode_attention"]
    procs = {}
    for split in splits:
        lib = out_dir / f"libdecode_attention-split{split}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DREPRO_DECODE_SPLIT={split}",
               "-o", str(lib), str(src)]
        procs[split] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True), lib)
    libs = {}
    for split, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for split {split}:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.decode_attention_launch.argtypes = attn_kernel._ARGTYPES["decode_attention"]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        if lib.decode_attention_split() != split:
            raise RuntimeError(f"the build for split {split} reports {lib.decode_attention_split()}")
        libs[split] = lib
    return libs


def use(lib, split: int) -> None:
    """Route kernel.decode_attention through one build of the sweep."""
    attn_kernel._libs["decode_attention"] = lib
    attn_kernel.DECODE_SPLIT = split


class Timer:
    def __init__(self):
        self.write = torch.empty(256 << 20, dtype=torch.int8, device=DEVICE)
        self.read = torch.ones(256 << 20, dtype=torch.int8, device=DEVICE)

    def flush(self, mode: str) -> None:
        if mode == "write":
            self.write.zero_()
        elif mode == "read":
            self.read.sum(dtype=torch.int32)

    def ms(self, fn, mode: str, reps: int = 30) -> float:
        """Median of CUDA events around fn(), the device held ~1 ms after the
        flush so the host has enqueued all of fn() before the start event."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush(mode)
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def passes_us(self, fn, reps: int = 20) -> dict:
        """Mean device time of each pass (write flush), from torch.profiler."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                self.flush("write")
                torch.cuda._sleep(2_000_000)
                fn()
            torch.cuda.synchronize()
        out = {}
        for evt in prof.key_averages():
            name = "split" if "decode_split" in evt.key else "combine" if "decode_combine" in evt.key else None
            if name:
                total = getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
                out[name] = total / evt.count
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="32,64,128,256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_decode_split: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    splits = [int(s) for s in args.splits.split(",")]
    libs = build_splits(splits)
    timer = Timer()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rng = np.random.default_rng(0)
    pos_np = rng.integers(64, 1023, 8).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, 1023                 # chip_smoke.py's decode lengths
    pos = torch.from_numpy(pos_np).to(DEVICE)
    for arch, (B, S, H, KV, hd) in SHAPES.items():
        f32 = [torch.randn(shape, generator=gen, device=DEVICE)
               for shape in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
        q, kc, vc = (x.bfloat16() for x in f32)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
        mask = (torch.arange(S, device=DEVICE)[None, :] < pos[:, None] + 1)[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        modes = ("write", "read", "warm")
        print(f"[{arch}] (B, S, H, KV, hd) = {(B, S, H, KV, hd)}, lengths {(pos_np + 1).tolist()}")
        print(f"[{arch}] sdpa ms: " + ", ".join(f"{m} {timer.ms(sdpa, m):.4f}" for m in modes))
        for split, lib in libs.items():
            use(lib, split)
            errs = []
            for (x, y, z), tol in ((f32, 2e-5), ((q, kc, vc), 2e-2)):
                got = attn_kernel.decode_attention(x, y, z, pos).float()
                want = attn_ref.decode_attention_reference(x, y, z, pos).float()
                err = (got - want).abs().max().item()
                if not torch.isfinite(got).all() or err > tol + tol * want.abs().max().item():
                    raise AssertionError(f"{arch} split {split}: max abs err {err:.3e} beyond {tol}")
                errs.append(err)

            def call():
                return attn_kernel.decode_attention(q, kc, vc, pos)

            ms = {m: timer.ms(call, m) for m in modes}
            passes = timer.passes_us(call)
            n_split = -(-S // split)
            live = int(np.sum(-(-(pos_np + 1) // split))) * KV
            print(f"[{arch}] split {split:3d}: {n_split * KV * B:5d} blocks ({live} live), "
                  f"max_abs_err {errs[0]:.2e} (f32) {errs[1]:.2e} (bf16); call ms "
                  + ", ".join(f"{m} {ms[m]:.4f}" for m in modes)
                  + f"; device us split {passes.get('split', 0):.3f}, "
                    f"combine {passes.get('combine', 0):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
