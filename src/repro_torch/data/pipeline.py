"""Data pipeline with prefetch (the paper's §5.5 prefetching applied to the
input path): a background thread keeps `depth` ready-to-consume batches in a
queue, overlapping host-side batch construction / device transfer with step
compute. Synthetic deterministic token streams back the examples, tests and
benchmarks (no external datasets are needed).

A copy of ``repro.data.pipeline`` (numpy only): the same seeds give the same
batches in both packages, so the port trains on the reference's stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, step: int) -> Dict[str, Any]:
    """Deterministic batch for `step` (restart-reproducible)."""
    rng = np.random.default_rng(1234 + step)
    if cfg.family == "vlm":
        return {
            "tokens": rng.integers(0, cfg.vocab, (batch, seq - cfg.n_patches), dtype=np.int32),
            "patches": rng.standard_normal((batch, cfg.n_patches, cfg.d_model)).astype(np.float32),
        }
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def token_stream(cfg: ModelConfig, batch: int, seq: int, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, batch, seq, step)
        step += 1


class Prefetcher:
    """Wraps an iterator; a worker thread keeps up to `depth` items ready.
    `transform` (e.g. a copy of the batch to the card) runs on the worker
    thread so transfer overlaps compute."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable[[Any], Any]] = None):
        self.depth = depth
        self._it = it
        self._transform = transform
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001
            self._exc = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class _Sentinel:
    pass


_SENTINEL = _Sentinel()
