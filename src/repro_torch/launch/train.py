"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 50 --batch 8 --seq 1024 --ckpt ckpt/qwen2
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

The flags of ``repro.launch.train`` plus ``--device`` (default ``cuda``).
``--reduced`` takes the smoke config of the same family. Steps run as
registered FaaS functions on a local endpoint (routing, warming, retry,
telemetry) unless ``--no-faas``; the checkpointer bounds restart loss, and
the data pipeline prefetches. Exits 0 when the last loss is below the first,
else 2.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import FunctionService
from repro_torch.models.model import Model
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import TrainConfig, Trainer


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--no-faas", action="store_true", help="run steps inline")
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg, device=device)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt)

    service = None
    if not args.no_faas:
        service = FunctionService()
        service.make_endpoint("train-endpoint", n_executors=1, workers_per_executor=1)

    trainer = Trainer(model, ocfg, tcfg, service=service)
    print(f"training {cfg.name} on {device}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens", flush=True)
    history = trainer.run()
    if service is not None:
        service.shutdown()
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {len(history)} steps")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return 0 if last < first else 2


if __name__ == "__main__":
    raise SystemExit(main())
