"""What the benchmark takes from the program: its configuration type, built
from a configuration file's ``model`` block, and the freeing of what a run
of it held."""
from __future__ import annotations

import gc
import sys
import threading
import time

_T0 = time.monotonic()

# the program's process-wide clock thread, which lives as long as the process
KEEP_THREADS = ("heartbeat-stall-clock",)


def model_config(m: dict):
    """The program's ``ModelConfig`` of a configuration file's ``model`` block."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig

    kw = dict(m)
    nested = {"moe": MoEConfig, "ssm": SSMConfig, "mla": MLAConfig}
    for key, cls in nested.items():
        if kw.get(key) is not None:
            kw[key] = cls(**kw[key])
    return ModelConfig(**kw)


def release(timeout: float = 30.0) -> None:
    """After a service's shutdown: wait for every thread it started to end
    (a worker's last task holds its payload until its thread ends), then free
    what they held."""
    end = time.monotonic() + timeout
    for t in threading.enumerate():
        if t is not threading.main_thread() and t.name not in KEEP_THREADS:
            t.join(max(0.0, end - time.monotonic()))
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def allocated_gib() -> float:
    import torch

    return torch.cuda.memory_allocated() / 2**30 if torch.cuda.is_available() else 0.0


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since import."""
    print(f"[perfbench {time.monotonic() - _T0:8.2f}s] {msg}", file=sys.stderr, flush=True)
