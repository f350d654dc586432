"""Heartbeats + watchdog (paper §5.3, §6.3).

Executors emit heartbeats; the endpoint manager's watchdog marks an executor
dead after `threshold` missed intervals, requeues its in-flight tasks, and
asks the provider for a replacement. The fault-tolerance benchmark (Fig. 7)
drives exactly this machinery.

Executors here are threads of one process, so a thread that holds the GIL
(``torch.compile``'s code generation in a worker, where the reference's XLA
compile releases it; a CUDA graph capture) stops every heartbeat thread at
once, a stall no executor caused. ``dead`` counts only the time the process
ran: ``_StallClock`` measures its stalls.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass

from typing import Deque, Dict, List, Optional, Tuple


class _StallClock:
    """The process's stalls: a thread that sleeps PERIOD_S at a time keeps
    each gap longer than STALL_S between two of its wake-ups, the time some
    thread held the GIL (or the host ran none of the process's threads), as
    a (start, end) span for KEEP_S. One for the process, started on first
    use, and again in a forked child."""

    PERIOD_S = 0.02
    STALL_S = 0.1
    KEEP_S = 600.0

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Deque[Tuple[float, float]] = deque()
        self._last = time.monotonic()
        self._pid: Optional[int] = None

    def start(self) -> None:
        with self._lock:
            if self._pid == os.getpid():
                return
            self._pid = os.getpid()
            self._spans.clear()
            self._last = time.monotonic()
        threading.Thread(target=self._run, name="heartbeat-stall-clock", daemon=True).start()

    def _run(self) -> None:
        while True:
            time.sleep(self.PERIOD_S)
            now = time.monotonic()
            with self._lock:
                if now - self._last > self.STALL_S:
                    self._spans.append((self._last, now))
                while self._spans and now - self._spans[0][1] > self.KEEP_S:
                    self._spans.popleft()
                self._last = now

    def stalled(self, since: float, now: float) -> float:
        """Seconds of (since, now] the process spent stalled, the stall still
        running at ``now`` included."""
        with self._lock:
            spans = list(self._spans)
            if now - self._last > self.STALL_S:
                spans.append((self._last, now))
        return sum(max(0.0, min(end, now) - max(start, since)) for start, end in spans)


_STALLS = _StallClock()


@dataclass
class HeartbeatRecord:
    last_seen: float
    count: int = 0
    suspended: bool = False


class HeartbeatMonitor:
    def __init__(self, interval_s: float = 2.0, threshold: float = 2.0):
        """`threshold` is in heartbeat intervals (paper uses 2s heartbeats)."""
        self.interval_s = interval_s
        self.threshold = threshold
        self._lock = threading.Lock()
        self._records: Dict[str, HeartbeatRecord] = {}
        _STALLS.start()

    def register(self, executor_id: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._records[executor_id] = HeartbeatRecord(last_seen=now)

    def beat(self, executor_id: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            rec = self._records.get(executor_id)
            if rec is None:
                self._records[executor_id] = HeartbeatRecord(last_seen=now, count=1)
            else:
                rec.last_seen = now
                rec.count += 1

    def deregister(self, executor_id: str) -> None:
        with self._lock:
            self._records.pop(executor_id, None)

    def suspend(self, executor_id: str) -> None:
        """Paper: manager suspends executors to prevent further scheduling."""
        with self._lock:
            rec = self._records.get(executor_id)
            if rec is not None:
                rec.suspended = True

    def is_suspended(self, executor_id: str) -> bool:
        with self._lock:
            rec = self._records.get(executor_id)
            return bool(rec and rec.suspended)

    def dead(self, now: Optional[float] = None) -> List[str]:
        """Executor ids whose heartbeat is older than threshold intervals of
        the time the process ran (its stalls excepted: no thread could beat)."""
        now = time.monotonic() if now is None else now
        limit = self.interval_s * self.threshold
        with self._lock:
            late = [
                (eid, rec.last_seen)
                for eid, rec in self._records.items()
                if (now - rec.last_seen) > limit and not rec.suspended
            ]
        return [eid for eid, seen in late
                if (now - seen) - _STALLS.stalled(seen, now) > limit]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                eid: {"age": time.monotonic() - r.last_seen, "count": r.count, "suspended": r.suspended}
                for eid, r in self._records.items()
            }


class LatencyTracker:
    """Rolling latency stats used for straggler detection (speculative
    re-execution triggers at p95 * multiplier)."""

    def __init__(self, window: int = 256):
        self.window = window
        self._lock = threading.Lock()
        self._samples: List[float] = []

    def record(self, latency_s: float) -> None:
        with self._lock:
            self._samples.append(latency_s)
            if len(self._samples) > self.window:
                self._samples = self._samples[-self.window :]

    def p95(self) -> Optional[float]:
        with self._lock:
            if len(self._samples) < 8:
                return None
            s = sorted(self._samples)
            return s[int(0.95 * (len(s) - 1))]

    def count(self) -> int:
        with self._lock:
            return len(self._samples)
