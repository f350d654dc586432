"""Executable warming (the paper's "container warming", §5.5, Table 4).

On a TPU pod the cold-start cost that container warming amortizes is not
process boot but **trace + lower + XLA compile + weight residency**. The warm
pool caches compiled executables keyed by (function_id, container variant,
abstract input signature); a hit is a "warm container", a miss pays the
compile ("cold container instantiation", Table 4). Entries expire after a TTL
exactly like funcX's 5–10 minute container keep-alive, and an LRU bound caps
device/host memory spent on retained executables.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

from typing import Any, Callable, Optional, Tuple

from .metrics import MetricsRegistry


@dataclass
class WarmEntry:
    executable: Any
    compile_time_s: float
    created: float
    last_used: float
    uses: int = 0


class WarmPool:
    """TTL + LRU cache of compiled executables."""

    def __init__(
        self,
        ttl_s: float = 300.0,
        max_entries: int = 256,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._entries: OrderedDict[Tuple, WarmEntry] = OrderedDict()
        self.cold_starts = 0
        self.warm_hits = 0
        self.evictions = 0

    def get_or_compile(
        self,
        key: Tuple,
        compile_fn: Callable[[], Any],
        now: Optional[float] = None,
    ) -> Tuple[Any, bool, float]:
        """Returns (executable, was_cold, compile_time_s).

        The compile runs outside the lock: concurrent cold-starts of the same
        key may duplicate work (funcX likewise boots one container per
        concurrent cold request) but the winner-stays write is idempotent.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and (now - entry.last_used) <= self.ttl_s:
                entry.last_used = now
                entry.uses += 1
                self._entries.move_to_end(key)
                self.warm_hits += 1
                self.metrics.counter("warming.warm_hits").inc()
                return entry.executable, False, 0.0
            if entry is not None:  # expired
                del self._entries[key]
                self.evictions += 1
                self.metrics.counter("warming.evictions").inc()

        t0 = time.monotonic()
        executable = compile_fn()
        dt = time.monotonic() - t0

        with self._lock:
            self.cold_starts += 1
            self._entries[key] = WarmEntry(
                executable=executable, compile_time_s=dt, created=now, last_used=now, uses=1
            )
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
                self.metrics.counter("warming.evictions").inc()
        self.metrics.counter("warming.cold_starts").inc()
        self.metrics.histogram("warming.compile_time_s").observe(dt)
        return executable, True, dt

    def warm(self, key: Tuple, compile_fn: Callable[[], Any]) -> float:
        """Pre-warm (paper: functions may be warmed ahead of invocation)."""
        _, was_cold, dt = self.get_or_compile(key, compile_fn)
        return dt if was_cold else 0.0

    def sweep(self, now: Optional[float] = None) -> int:
        """Evict expired entries. Called opportunistically by executor loops."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expired = [k for k, e in self._entries.items() if (now - e.last_used) > self.ttl_s]
            for k in expired:
                del self._entries[k]
            self.evictions += len(expired)
        if expired:
            self.metrics.counter("warming.evictions").inc(len(expired))
        return len(expired)

    def contains(self, key: Tuple) -> bool:
        with self._lock:
            e = self._entries.get(key)
            return e is not None and (time.monotonic() - e.last_used) <= self.ttl_s

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "cold_starts": self.cold_starts,
                "warm_hits": self.warm_hits,
                "evictions": self.evictions,
                "total_compile_s": sum(e.compile_time_s for e in self._entries.values()),
            }
