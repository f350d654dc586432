"""Serving entry point: continuous-batching LM inference on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --full \\
        --requests 16 --max-new-tokens 12
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu

The flags of ``repro.launch.serve`` plus ``--device`` (default ``cuda``).
Requests go to ``ServeEngine.submit`` directly while the engine runs in a
serving thread; the run reports TTFT and aggregate token throughput. Weights
are random, drawn from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServeEngine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = (get_reduced(args.arch) if args.reduced else get_config(args.arch)).with_(
        dtype="float32" if args.reduced else "bfloat16"
    )
    gen = torch.Generator(device=device).manual_seed(0)
    model = Model(cfg, device=device).init(gen)
    engine = ServeEngine(model, max_batch=args.max_batch, max_len=args.max_len)

    stop = threading.Event()
    loop = threading.Thread(target=engine.serve_forever, args=(stop,), daemon=True)
    loop.start()

    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    reqs = [
        engine.submit(rng.integers(0, cfg.vocab, int(rng.integers(4, 12))),
                      max_new_tokens=args.max_new_tokens)
        for _ in range(args.requests)
    ]
    for r in reqs:
        if not r.done.wait(timeout=600):
            raise TimeoutError(r.request_id)
    stop.set()
    loop.join(timeout=5)
    wall = time.monotonic() - t0
    total = sum(len(r.tokens) for r in reqs)
    ttfts = [(r.first_token_at - r.submitted) * 1e3 for r in reqs]
    print(f"{cfg.name} on {device}: {len(reqs)} requests / {total} tokens in {wall:.2f}s "
          f"({total/wall:.1f} tok/s); TTFT mean {np.mean(ttfts):.1f}ms "
          f"p95 {np.percentile(ttfts, 95):.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
