"""Interchange framing: batched task flow between tiers (paper §5.3, §5.5).

The paper's headline scale (millions of tasks over 65k+ concurrent workers)
comes from moving tasks in *batches* at every hop: the interchange batches
tasks to managers, managers hand executors batches sized by advertised
capacity, and results return in batches (Fig. 8). This module provides the
shared framing for that pipeline:

- :class:`TaskBatch` — a frame of task envelopes (plus their futures at the
  fabric tier) that travels service -> forwarder -> endpoint as one unit.
- :class:`ResultBatch` — a frame of results draining executor -> endpoint.
- :class:`BatchCoalescer` — flush-on-size / flush-on-deadline accumulator
  (the ``max_batch`` / ``max_delay_s`` knobs), guaranteed to deliver every
  added item exactly once.

All four tiers ride these frames; a single-task ``run()`` is simply a batch
of one, so per-task semantics (memoization, retries, speculation, failover)
are unchanged.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Sequence, Tuple

from .futures import TaskEnvelope, TaskFuture

_batch_counter = itertools.count()


def new_batch_id() -> str:
    return f"batch-{next(_batch_counter)}"


@dataclass
class TaskBatch:
    """A frame of tasks moving downstream as one unit.

    At the fabric tier (forwarder -> endpoint) ``futures`` runs parallel to
    ``envelopes``; at the endpoint -> executor hop only envelopes travel (the
    endpoint keeps the futures).
    """

    envelopes: List[TaskEnvelope]
    futures: List[TaskFuture] = field(default_factory=list)
    batch_id: str = field(default_factory=new_batch_id)
    created_at: float = field(default_factory=time.monotonic)

    def __post_init__(self) -> None:
        for env in self.envelopes:
            env.batch_id = self.batch_id

    def __len__(self) -> int:
        return len(self.envelopes)

    def __iter__(self) -> Iterator[TaskEnvelope]:
        return iter(self.envelopes)

    def pairs(self) -> List[Tuple[TaskEnvelope, TaskFuture]]:
        return list(zip(self.envelopes, self.futures))


@dataclass
class ResultBatch:
    """A frame of :class:`repro.core.worker.TaskResult`s moving upstream."""

    results: List[Any]
    batch_id: str = field(default_factory=new_batch_id)

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.results)


def iter_frames(
    pairs: Sequence[Tuple[TaskEnvelope, TaskFuture]], max_batch: int
) -> Iterator[TaskBatch]:
    """Slice routed (envelope, future) pairs into TaskBatch frames of at most
    ``max_batch`` tasks each."""
    step = max(1, int(max_batch))
    for i in range(0, len(pairs), step):
        chunk = pairs[i : i + step]
        yield TaskBatch(
            envelopes=[env for env, _ in chunk],
            futures=[fut for _, fut in chunk],
        )


class BatchCoalescer:
    """Accumulate items; flush when ``max_batch`` is reached or the oldest
    item has waited ``max_delay_s``.

    Thread-safe. Invariant (property-tested): every item passed to
    :meth:`add` appears in exactly one list returned by :meth:`add`,
    :meth:`poll`, or :meth:`flush`, in insertion order — nothing is dropped,
    nothing is duplicated.

    ``max_delay_s == 0`` means "no coalescing window": :meth:`poll` flushes
    whatever is pending immediately.
    """

    def __init__(self, max_batch: int = 64, max_delay_s: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self._lock = threading.Lock()
        self._pending: List[Any] = []
        self._oldest_at: Optional[float] = None
        self.flushed_batches = 0
        self.flushed_items = 0

    def _drain_locked(self) -> List[Any]:
        out, self._pending = self._pending, []
        self._oldest_at = None
        self.flushed_batches += 1
        self.flushed_items += len(out)
        return out

    def add(self, item: Any, now: Optional[float] = None) -> Optional[List[Any]]:
        """Append ``item``; returns a flushed batch when the add fills the
        frame (flush-on-size), else None."""
        with self._lock:
            if not self._pending:
                self._oldest_at = time.monotonic() if now is None else now
            self._pending.append(item)
            if len(self._pending) >= self.max_batch:
                return self._drain_locked()
            return None

    def poll(self, now: Optional[float] = None) -> Optional[List[Any]]:
        """Flush-on-deadline: returns the pending batch when the oldest item
        has aged past ``max_delay_s`` (or instantly when the window is 0)."""
        with self._lock:
            if not self._pending:
                return None
            if now is None:
                now = time.monotonic()
            if self.max_delay_s > 0 and (now - self._oldest_at) < self.max_delay_s:
                return None
            return self._drain_locked()

    def flush(self) -> List[Any]:
        """Unconditionally drain everything pending (shutdown / failover)."""
        with self._lock:
            if not self._pending:
                return []
            return self._drain_locked()

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_age_s(self, now: Optional[float] = None) -> float:
        with self._lock:
            if self._oldest_at is None:
                return 0.0
            return ((time.monotonic() if now is None else now) - self._oldest_at)
