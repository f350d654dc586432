#!/usr/bin/env python3
"""Host time of the port's eager kernel launches and of an eager prefill
admission, for comparing two trees of the port on one card.

    PYTHONPATH=<tree>/src python tools/launch_host_time.py [--tag NAME]

Imports ``repro_torch`` from ``PYTHONPATH`` (the tree under test; an older
tree's ``git archive`` unpacked into a git-ignored directory, beside this
one), so the same script times both trees: run it parent, change, change,
parent in one call. Prints one JSON line:

- ``import_s``: the kernel modules' import after ``torch`` (whether it pulled
  in ``torch._dynamo`` is ``imports_dynamo``);
- ``rmsnorm_us`` / ``decode_us``: host microseconds a call of the eager
  wrappers ``fused_add_rmsnorm`` (8 rows of 896, bf16) and ``decode_attention``
  (8 rows, 14/2 heads of 64 over 1024 positions, bf16): the least over
  ROUNDS rounds of the mean of LAUNCH_CALLS calls with no synchronisation
  inside the loop (the card runs behind; the host's enqueue is what is
  timed; the least round is the one other processes on the host disturbed
  least);
- ``prefill_host_ms``: host milliseconds until ``Model.prefill`` of one
  PROMPT-token request returns (its launches enqueued), and ``admit_ms``: the
  wall of ``ServeEngine._admit`` of such a request, prefill, first token and
  cache insert (median and least of ADMISSIONS, after one warm-up each);
  full-width qwen2-0.5b in bf16, random weights from seed 0, eager engine.

``--device cpu --reduced`` runs the same calls on the CPU at the reduced
config (the wrappers then take their plain versions): a smoke run, not a
measurement. Prints the card's name and power limit on the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

LAUNCH_CALLS, ROUNDS, ADMISSIONS, PROMPT = 1000, 10, 20, 128


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tag", default="", help="a name for the tree, echoed in the line")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the reduced qwen2-0.5b config")
    ap.add_argument("--calls", type=int, default=LAUNCH_CALLS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--admissions", type=int, default=ADMISSIONS)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    t0 = time.perf_counter()
    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: F401
    import_s = time.perf_counter() - t0
    imports_dynamo = "torch._dynamo" in sys.modules

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServeEngine, prefill_batch

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        ap.exit(2, "launch_host_time: no CUDA card (use --device cpu for a smoke run)\n")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    x, d = (torch.randn((8, 896), generator=gen, device=device).to(bf16) for _ in range(2))
    scale = torch.ones(896, device=device)
    q = torch.randn((8, 1, 14, 64), generator=gen, device=device).to(bf16)
    k, v = (torch.randn((8, 1024, 2, 64), generator=gen, device=device).to(bf16)
            for _ in range(2))
    pos = torch.full((8,), 1023, dtype=torch.int64, device=device)

    def per_call_us(fn) -> float:
        for _ in range(10):
            fn()
        rounds = []
        for _ in range(args.rounds):
            sync()
            t = time.perf_counter()
            for _ in range(args.calls):
                fn()
            rounds.append(time.perf_counter() - t)
        sync()
        return min(rounds) / args.calls * 1e6

    with torch.inference_mode():
        rmsnorm_us = per_call_us(lambda: rms_kernel.fused_add_rmsnorm(x, d, scale))
        decode_us = per_call_us(lambda: attn_kernel.decode_attention(q, k, v, pos))

    cfg = (get_reduced if args.reduced else get_config)("qwen2-0.5b").with_(dtype="bfloat16")
    model = Model(cfg, device=device).init(gen)
    engine = ServeEngine(model, max_batch=8, max_len=1024, cuda_graph=False)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, PROMPT).astype(np.int32)
    host, admit = [], []
    with torch.inference_mode():
        batch = prefill_batch(model, prompt)
        for i in range(args.admissions + 1):
            sync()
            t = time.perf_counter()
            model.prefill(batch)
            dt = time.perf_counter() - t
            sync()
            engine.submit(prompt, max_new_tokens=1)
            t1 = time.perf_counter()
            engine._admit()
            sync()
            da = time.perf_counter() - t1
            if i:
                host.append(dt * 1e3)
                admit.append(da * 1e3)
            engine.slot_req = [None] * engine.max_batch
    line = {"tag": args.tag, "torch": torch.__version__, "import_s": import_s,
            "imports_dynamo": imports_dynamo, "rmsnorm_us": rmsnorm_us, "decode_us": decode_us,
            "prefill_host_ms": _median(host), "prefill_host_min_ms": min(host),
            "admit_ms": _median(admit), "admit_min_ms": min(admit),
            "launch_calls": args.calls, "rounds": args.rounds, "admissions": args.admissions,
            "prompt": PROMPT}
    if on_card:
        line["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
