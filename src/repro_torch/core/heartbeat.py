"""Heartbeats + watchdog (paper §5.3, §6.3).

Executors emit heartbeats; the endpoint manager's watchdog marks an executor
dead after `threshold` missed intervals, requeues its in-flight tasks, and
asks the provider for a replacement. The fault-tolerance benchmark (Fig. 7)
drives exactly this machinery.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from typing import Dict, List, Optional


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
        """Executor ids whose heartbeat is older than threshold intervals."""
        now = time.monotonic() if now is None else now
        limit = self.interval_s * self.threshold
        with self._lock:
            return [
                eid
                for eid, rec in self._records.items()
                if (now - rec.last_seen) > limit and not rec.suspended
            ]

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
