"""Continuous-batching serve engine.

Port of ``repro.serving.engine``: the same slots, admission, greedy sampling
and metric names. Each admitted request is prefilled alone (B=1) and its
cache inserted into a free slot of one stacked cache; then one batched decode
step runs over all slots, each reading and writing its own position. The
decode step updates the cache in place where the JAX engine donates it.
"""
from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.metrics import MetricsRegistry
from ..models.model import Model
from . import kv_cache


@dataclass
class Request:
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never stops early
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    # outputs
    tokens: List[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    submitted: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class ServeEngine:
    """Slot-based continuous batching: `max_batch` concurrent sequences share
    one stacked cache on the model's device; new requests prefill into free
    slots while existing ones keep decoding."""

    def __init__(self, model: Model, max_batch: int = 4, max_len: int = 256,
                 metrics: Optional[MetricsRegistry] = None):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.metrics = metrics if metrics is not None else MetricsRegistry()

        self.cache = model.init_cache(max_batch, max_len)
        self.batch_axes = model.cache_batch_axes()
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)
        self.pending: List[Request] = []
        self._lock = threading.Lock()
        self._alive = False
        self.steps = 0

    # -- client API -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16, eos_id: int = -1) -> Request:
        req = Request(np.asarray(prompt, np.int32), max_new_tokens, eos_id)
        with self._lock:
            self.pending.append(req)
        return req

    def generate(self, prompt, max_new_tokens: int = 16, timeout: float = 120.0) -> List[int]:
        req = self.submit(prompt, max_new_tokens)
        if not self._alive:
            self.run_until_drained()
        if not req.done.wait(timeout):
            raise TimeoutError(req.request_id)
        return req.tokens

    # -- engine loop -----------------------------------------------------------
    @torch.inference_mode()
    def _admit(self) -> None:
        with self._lock:
            for slot in range(self.max_batch):
                if self.slot_req[slot] is not None or not self.pending:
                    continue
                req = self.pending.pop(0)
                tokens = torch.from_numpy(req.prompt[None, :]).to(self.device)
                logits, seq_cache = self.model.prefill({"tokens": tokens})
                first = int(torch.argmax(logits[0]))
                kv_cache.insert_sequence(self.cache, seq_cache, slot, self.batch_axes)
                req.tokens.append(first)
                req.first_token_at = time.monotonic()
                self.metrics.histogram("serving.ttft_s").observe(
                    req.first_token_at - req.submitted
                )
                self.metrics.counter("serving.tokens_generated").inc()
                self.slot_req[slot] = req
                self.slot_pos[slot] = len(req.prompt)
                self._finish_if_done(slot)

    def _finish_if_done(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        hit_eos = req.tokens and req.tokens[-1] == req.eos_id
        full = self.slot_pos[slot] >= self.max_len - 1
        if len(req.tokens) >= req.max_new_tokens or hit_eos or full:
            req.finished_at = time.monotonic()
            req.done.set()
            self.slot_req[slot] = None

    @torch.inference_mode()
    def _step(self) -> bool:
        """One decode step over all active slots (vector positions: each slot
        reads/writes its own cache position). Returns True if any active."""
        active = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
        if not active:
            return False
        tok = np.zeros((self.max_batch, 1), np.int32)
        for s in active:
            tok[s, 0] = self.slot_req[s].tokens[-1]
        pos_vec = torch.from_numpy(self.slot_pos.copy()).to(self.device)
        logits, self.cache = self.model.decode_step(
            torch.from_numpy(tok).to(self.device), self.cache, pos_vec
        )
        nt = torch.argmax(logits, dim=-1).cpu().numpy()  # greedy sampling
        for s in active:
            self.slot_req[s].tokens.append(int(nt[s]))
            self.slot_pos[s] += 1
            self._finish_if_done(s)
        self.steps += 1
        self.metrics.counter("serving.tokens_generated").inc(len(active))
        self.metrics.counter("serving.decode_batches").inc()
        self.metrics.gauge("serving.batch_occupancy").set(len(active))
        return True

    def serve_forever(self, stop_event: threading.Event, idle_sleep_s: float = 0.002) -> None:
        """Drive admit/decode until `stop_event` is set (for request streams
        that trickle in — run_until_drained exits between waves)."""
        self._alive = True
        try:
            while not stop_event.is_set():
                self._admit()
                if not self._step():
                    time.sleep(idle_sleep_s)
        finally:
            self._alive = False

    def run_until_drained(self, timeout: float = 300.0) -> None:
        t0 = time.monotonic()
        self._alive = True
        try:
            while time.monotonic() - t0 < timeout:
                self._admit()
                if not self._step():
                    with self._lock:
                        if not self.pending:
                            return
        finally:
            self._alive = False

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "active": sum(r is not None for r in self.slot_req),
            "pending": len(self.pending),
            "cache": kv_cache.summarize(self.cfg, self.max_batch, self.max_len),
        }
