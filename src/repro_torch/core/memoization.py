"""Result memoization (paper §5.5, Table 3).

funcX memoizes by "hashing the function body and input document and storing a
mapping from hash to computed results". The cache is service-side, LRU-bounded
and thread-safe; it is consulted only when the caller opted in AND the
function is registered deterministic.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple


class MemoCache:
    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._cache: OrderedDict[Tuple[str, str], Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(function_id: str, payload_digest: str) -> Tuple[str, str]:
        return (function_id, payload_digest)

    def get(self, function_id: str, payload_digest: str) -> Tuple[bool, Optional[Any]]:
        k = self.key(function_id, payload_digest)
        with self._lock:
            if k in self._cache:
                self._cache.move_to_end(k)
                self.hits += 1
                return True, self._cache[k]
            self.misses += 1
            return False, None

    def put(self, function_id: str, payload_digest: str, value: Any) -> None:
        k = self.key(function_id, payload_digest)
        with self._lock:
            self._cache[k] = value
            self._cache.move_to_end(k)
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)

    def invalidate(self, function_id: Optional[str] = None) -> int:
        """Drop entries (all, or those of one function). Returns count dropped."""
        with self._lock:
            if function_id is None:
                n = len(self._cache)
                self._cache.clear()
                return n
            keys = [k for k in self._cache if k[0] == function_id]
            for k in keys:
                del self._cache[k]
            return len(keys)

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._cache),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }
