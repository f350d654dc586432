#!/usr/bin/env python3
"""Where the time of the port's serve path goes on the card (torch.profiler).

    python tools/profile_torch_serve.py [--arch mamba2-2.7b] [--eager] [--steps 20] [--trace out.json]

Builds a full-width bf16 model (``--arch``: qwen2-0.5b by default,
mamba2-2.7b or zamba2-2.7b; random weights, seed 0) and a ServeEngine
(max_batch 8, max_len 1024; its decode step a CUDA graph replay, or eager with
``--eager``), fills its 8 slots with prompts of 64..512 tokens, then profiles
two windows through the engine's own entry points: one admission (a prefill of
one 512-token prompt plus its cache insertion, eager either way) and
``--steps`` batched decode steps. For each window it prints the host wall
time, the device busy time (the device activities' own time, summed), the
device's idle share, the sum of the gaps between consecutive device activities
(the idle time inside their span), and the twelve kernels with the most device
time, each with its rank, plus every kernel of the port wherever it ranks.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402


def _gaps_us(spans) -> float:
    """The time inside the span of (start, end) device activities that none
    of them covers, in microseconds."""
    gaps, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is not None and start > reach:
            gaps += start - reach
        reach = end if reach is None else max(reach, end)
    return gaps


def _window(name: str, fn, n: int, trace: str = "") -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)
    by_kernel = defaultdict(lambda: [0, 0.0])
    spans = []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_kernel[evt.name][0] += 1
            by_kernel[evt.name][1] += evt.time_range.elapsed_us() / 1e3
            spans.append((evt.time_range.start, evt.time_range.end))
    if not by_kernel:
        raise SystemExit("the profiler recorded no device events: time with CUDA events instead")
    busy = sum(ms for _, ms in by_kernel.values())
    launches = sum(c for c, _ in by_kernel.values())
    print(f"[{name}] {n} call(s): host wall {wall_ms / n:.3f} ms each, device busy "
          f"{busy / n:.3f} ms each, idle share {1 - busy / wall_ms:.3f}, gaps between "
          f"device activities {_gaps_us(spans) / 1e3 / n:.3f} ms each, "
          f"{launches / n:.0f} device launches each")
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    for rank, (kname, (count, ms)) in enumerate(ranked):
        if rank < 12 or "repro_torch" in kname:   # the top 12, and every kernel of the port
            print(f"[{name}] {rank + 1:3d} {ms / n:9.4f} ms {count / n:6.1f}x  {kname[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=["qwen2-0.5b", "mamba2-2.7b", "zamba2-2.7b"],
                    default="qwen2-0.5b")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager decode step (ServeEngine(cuda_graph=False))")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default="", help="write the decode window's chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    cfg = get_config(args.arch)
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    engine = ServeEngine(model, max_batch=8, max_len=1024, cuda_graph=not args.eager)
    for n in rng.integers(64, 513, 8):
        engine.submit(rng.integers(0, cfg.vocab, int(n)), max_new_tokens=10_000)
    engine._admit()                       # fills the 8 slots (also warms cuBLAS)
    for _ in range(3):
        engine._step()

    def admit_one():
        engine.slot_req[0] = None         # free slot 0 for one 512-token prompt
        engine.submit(rng.integers(0, cfg.vocab, 512), max_new_tokens=10_000)
        engine._admit()

    admit_one()
    _window("prefill", admit_one, 3)
    _window("decode, eager" if args.eager else "decode, graphed", engine._step, args.steps,
            args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
