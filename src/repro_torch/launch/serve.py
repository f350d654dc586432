"""Serving driver: continuous-batching LM inference behind the FaaS service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --full \\
        --requests 16 --max-new-tokens 12
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu

The flags of ``repro.launch.serve`` plus ``--device`` (default ``cuda``).
Requests enter as registered-function invocations (``generate``) through
``FunctionService`` -> Forwarder -> Endpoint -> worker, as in the reference;
the function submits to a ``ServeEngine`` running in a serving thread (its
decode step one CUDA graph replay on the card) and waits. The run reports
TTFT and aggregate token throughput. Weights are random, drawn from a seeded
``torch.Generator``. An encoder-decoder arch (``whisper-small``) is served on
zero frames, as the reference's driver serves it, and a VLM
(``internvl2-26b``) on zero patches: its ``--max-len`` (default 96 after the
patches) counts the patches too.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import FunctionService
from repro_torch.models.model import Model
from repro_torch.serving.engine import ServeEngine, prefix_len


def serve_through_front_door(engine: ServeEngine, prompts: Sequence, max_new_tokens: int,
                             timeout: float = 600.0) -> Tuple[List[dict], float]:
    """Serve `prompts` as fabric tasks: a service with one endpoint
    ("serve-frontdoor", one executor of two workers) runs a pass-through
    ``generate`` function that submits each prompt to `engine` and waits.
    Returns one dict per request (``tokens``; ``ttft_ms``, the engine's, as the
    reference reports it; ``client_ttft_ms``, from ``service.run`` to the first
    token) and the wall time of the whole run in seconds."""
    service = FunctionService()
    service.make_endpoint("serve-frontdoor", n_executors=1, workers_per_executor=2)

    def generate(doc):
        req = engine.submit(doc["prompt"], max_new_tokens=doc.get("max_new_tokens", 8))
        if not req.done.wait(timeout=timeout):
            raise TimeoutError(req.request_id)
        return {"tokens": np.asarray(req.tokens, np.int32),
                "ttft_ms": (req.first_token_at - req.submitted) * 1e3,
                "first_token_at": req.first_token_at}

    fid = service.register_function(generate, name=f"generate/{engine.cfg.name}",
                                    pass_through=True, serialize_result=False,
                                    deterministic=False)
    stop = threading.Event()
    loop = threading.Thread(target=engine.serve_forever, args=(stop,), daemon=True)
    loop.start()
    try:
        t0 = time.monotonic()
        submitted, futs = [], []
        for p in prompts:
            submitted.append(time.monotonic())
            futs.append(service.run(fid, {"prompt": p, "max_new_tokens": max_new_tokens}))
        outs = [f.result(timeout) for f in futs]
        wall = time.monotonic() - t0
    finally:
        stop.set()
        loop.join(timeout=5)
        service.shutdown()
    for o, t in zip(outs, submitted):
        o["client_ttft_ms"] = (o.pop("first_token_at") - t) * 1e3
    return outs, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache positions a slot holds (default: 96 after a VLM's patches)")
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
    max_len = args.max_len if args.max_len is not None else prefix_len(cfg) + 96
    engine = ServeEngine(model, max_batch=args.max_batch, max_len=max_len)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 12))) for _ in range(args.requests)]
    outs, wall = serve_through_front_door(engine, prompts, args.max_new_tokens)
    total = sum(len(o["tokens"]) for o in outs)
    ttfts = [o["ttft_ms"] for o in outs]
    print(f"{cfg.name} on {device}: {len(outs)} requests / {total} tokens in {wall:.2f}s "
          f"({total/wall:.1f} tok/s) through FunctionService; TTFT mean "
          f"{np.mean(ttfts):.1f}ms p95 {np.percentile(ttfts, 95):.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
