"""Continuous-batching serve engine.

Port of ``repro.serving.engine``: the same slots, admission, greedy sampling
and metric names. Each admitted request is prefilled alone (B=1) and its
cache inserted into a free slot of one stacked cache; then one batched decode
step runs over all slots, each reading and writing its own position. The
decode step updates the cache in place where the JAX engine donates it.

The reference compiles its step once (``jax.jit(model.decode_step,
donate_argnums=(2,))``). Its counterpart here is a CUDA graph: on the card the
engine captures ``Model.decode_step`` and the greedy ``argmax`` once, at
construction, over static token, position and sampled-token buffers and its
own cache, and each step replays it. Prefill stays eager (its length varies).
On the CPU the same step runs eagerly.
"""
from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.metrics import MetricsRegistry
from ..kernels.flash_attention import kernel as attn_kernel
from ..kernels.rmsnorm import kernel as rms_kernel
from ..kernels.ssd import kernel as ssd_kernel
from ..models.model import Model
from . import kv_cache

# every kernel wrapper's module: each keeps a LAUNCHES count of its host calls
_KERNEL_MODULES = (attn_kernel, rms_kernel, ssd_kernel)
# eager steps before capture: they run each kernel's one-time set-up (the
# shared-memory grant, cuBLAS handles and workspaces) outside the capture
WARMUP_STEPS = 2


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's ``LAUNCHES``, by kernel name."""
    return {name: n for mod in _KERNEL_MODULES for name, n in mod.LAUNCHES.items()}


class DecodeGraph:
    """One captured decode step, with the kernel calls its capture made.

    A wrapper's ``LAUNCHES`` counts host calls and a replay makes none, so
    ``replay`` adds the calls counted during capture (``launches``) to the
    wrappers' counts. The capture also fixes the model's ``kernel_impl``: a
    replay under another one raises rather than run the captured path."""

    def __init__(self, graph, launches: Dict[str, int], kernel_impl: str):
        self.graph = graph
        self.launches = launches
        self.kernel_impl = kernel_impl

    @classmethod
    def capture(cls, step: Callable[[], None], kernel_impl: str, device) -> "DecodeGraph":
        """Run ``step`` WARMUP_STEPS times eagerly on a side stream, under
        ``set_sync_debug_mode("error")`` so that a host sync in it raises, then
        capture it once on that stream. A failure raises: nothing falls back."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    step()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        graph = torch.cuda.CUDAGraph(keep_graph=True)   # keeps the graph's nodes readable
        before = launch_counts()
        with torch.cuda.graph(graph, stream=side):
            step()
        after = launch_counts()
        graph.instantiate()
        return cls(graph, {name: after[name] - before[name] for name in after}, kernel_impl)

    def replay(self, kernel_impl: str) -> None:
        if kernel_impl != self.kernel_impl:
            raise RuntimeError(f"the decode graph was captured with kernel_impl="
                               f"{self.kernel_impl!r}; the model now has {kernel_impl!r}")
        self.graph.replay()
        for mod in _KERNEL_MODULES:
            for name in mod.LAUNCHES:
                mod.LAUNCHES[name] += self.launches.get(name, 0)


def _zero(tree: dict) -> None:
    for leaf in tree.values():
        if isinstance(leaf, dict):
            _zero(leaf)
        else:
            leaf.zero_()


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
    slots while existing ones keep decoding.

    ``cuda_graph``: None replays a captured decode step on a CUDA model and
    steps eagerly on a CPU one; False steps eagerly on the card too (the
    yardstick a graphed engine is compared with); True on a CPU model raises."""

    def __init__(self, model: Model, max_batch: int = 4, max_len: int = 256,
                 metrics: Optional[MetricsRegistry] = None,
                 cuda_graph: Optional[bool] = None):
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

        # the decode step's static buffers: tokens and int32 positions (one
        # host-to-device copy a step), and the greedy tokens it samples
        self._inputs = torch.zeros((2, max_batch), dtype=torch.int32, device=self.device)
        self._tokens = self._inputs[0].unsqueeze(1)              # (B, 1)
        self._positions = self._inputs[1]                        # (B,)
        self._sampled = torch.zeros(max_batch, dtype=torch.int64, device=self.device)
        on_card = self.device.type == "cuda"
        use_graph = on_card if cuda_graph is None else cuda_graph
        if use_graph and not on_card:
            raise ValueError(f"cuda_graph=True needs a CUDA model; this one is on {self.device}")
        self._graph: Optional[DecodeGraph] = None
        if use_graph:
            # before any admission: the warm-up steps write k/v and advance
            # every SSM state, so the cache is zeroed after them
            with torch.inference_mode():
                self._graph = DecodeGraph.capture(self._decode, model.kernel_impl, self.device)
                _zero(self.cache)

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

    def _decode(self) -> None:
        """The step the graph captures: decode the static tokens at the static
        positions (the cache in place) and sample greedily into ``_sampled``."""
        logits, _ = self.model.decode_step(self._tokens, self.cache, self._positions)
        torch.argmax(logits, dim=-1, out=self._sampled)

    @torch.inference_mode()
    def _step(self) -> bool:
        """One decode step over all slots (vector positions: each slot
        reads/writes its own cache position; an idle slot decodes token 0 at
        its last position). Returns True if any slot is active."""
        active = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
        if not active:
            return False
        inputs = np.zeros((2, self.max_batch), np.int32)
        for s in active:
            inputs[0, s] = self.slot_req[s].tokens[-1]
        inputs[1] = self.slot_pos
        self._inputs.copy_(torch.from_numpy(inputs))
        if self._graph is None:
            self._decode()
        else:
            self._graph.replay(self.model.kernel_impl)
        nt = self._sampled.cpu().numpy()  # greedy sampling: one copy to the host
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
