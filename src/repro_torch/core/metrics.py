"""Fabric-wide telemetry (the follow-up funcX papers' monitoring subsystem).

A copy of ``repro.core.metrics``: the port keeps its own copy of every module
it needs and imports nothing of ``repro``.

The paper's headline results (§6) are throughput/latency breakdowns at up to
65k workers and managed elasticity; both need a metrics substrate. This module
provides the three Prometheus-shaped instrument kinds the fabric records:

- :class:`Counter` — monotonically increasing event counts (tasks submitted,
  failovers, warm hits).
- :class:`Gauge` — last-written point-in-time values (queue depth, outstanding
  tasks, desired blocks). A gauge starts *unset* (``value is None``) so
  consumers can distinguish "never measured" from "measured zero" — the
  Forwarder's ``latency_aware`` routing explores unmeasured endpoints first.
- :class:`Histogram` — fixed-bucket distributions (latencies, batch sizes)
  with percentile estimation by linear interpolation inside the bucket.

All instruments live in a :class:`MetricsRegistry`: get-or-create by
``(name, labels)``, with a ``snapshot()`` dict export and a Prometheus-style
``export_text()``. One registry is shared per fabric — ``FunctionService``
creates it, the Forwarder and every registered endpoint/executor/warm-pool
bind to it — so service-tier counters, endpoint-tier gauges, and autoscaler
decisions are one coherent, queryable surface (see docs/scaling.md for the
full catalog of names).

Instruments are cheap: recording is a lock-free attribute bump guarded by a
per-instrument lock only where read-modify-write requires it; registry lookup
is a dict get. The hot path (one histogram observation per task) costs well
under a microsecond.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default buckets for latency-flavoured histograms (seconds): 1ms → 60s,
# roughly geometric, matching the dynamic range of Fig. 4/5.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Default buckets for size-flavoured histograms (batch sizes, counts).
SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

# Default buckets for byte-size histograms (journal record frames, payload
# sizes): 64 B → 1 MiB, geometric.
BYTES_BUCKETS: Tuple[float, ...] = (
    64, 256, 1024, 4096, 16384, 65536, 262144, 1048576,
)


def _labels_key(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return "{" + inner + "}"


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value. Starts unset (``value is None``)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, v: Optional[float]) -> None:
        with self._lock:
            self._value = v if v is None else float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value = (self._value or 0.0) + n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> Optional[float]:
        return self._value


class Histogram:
    """Fixed-bucket histogram: cumulative bucket counts + sum + count.

    ``buckets`` are upper bounds; an implicit +inf bucket catches overflow.
    ``percentile(p)`` estimates by linear interpolation between the bucket's
    lower and upper bound (the +inf bucket reports its lower bound).
    """

    __slots__ = ("name", "buckets", "_lock", "_counts", "_sum", "_count", "_max")

    def __init__(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +inf
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, v: float) -> None:
        idx = len(self.buckets)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def percentile(self, p: float) -> Optional[float]:
        """Estimated p-th percentile (p in [0, 100])."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if not total:
            return None
        target = (p / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            lo = self.buckets[i - 1] if i > 0 else 0.0
            if i < len(self.buckets):
                hi = self.buckets[i]
            else:  # +inf bucket: best effort, clamp to observed max
                hi = max(self._max, lo)
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.buckets[-1]

    def to_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        d = {
            "count": total,
            "sum": round(s, 6),
            "mean": round(s / total, 6) if total else None,
            "buckets": {
                ("+inf" if i == len(self.buckets) else repr(self.buckets[i])): c
                for i, c in enumerate(counts)
                if c
            },
        }
        for p in (50, 95, 99):
            q = self.percentile(p)
            d[f"p{p}"] = round(q, 6) if q is not None else None
        return d


class MetricsRegistry:
    """Get-or-create instrument registry with snapshot/export.

    Instruments are keyed by ``name`` plus an optional ``labels`` dict (e.g.
    per-endpoint gauges). Lookup is designed to be called on the hot path —
    components do ``metrics.counter("x").inc()`` per event rather than caching
    instrument handles, so a registry can be rebound wholesale
    (``Endpoint.bind_metrics``) when an endpoint joins a service's fabric.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- instrument access -------------------------------------------------
    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        key = name + _labels_key(labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(key))
        return c

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        key = name + _labels_key(labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(key))
        return g

    def histogram(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ) -> Histogram:
        key = name + _labels_key(labels)
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(key, Histogram(key, buckets))
        return h

    # -- aggregation over labeled families ---------------------------------
    def family(self, name: str) -> Dict[str, float]:
        """All gauge values whose name matches `name` (any labels), keyed by
        full labeled name. Lets consumers (autoscaler, routing) read every
        per-endpoint series of one metric."""
        prefix = name + "{"
        with self._lock:  # concurrent registration mutates the dict
            gauges = list(self._gauges.items())
        return {
            k: g.value
            for k, g in gauges
            if (k == name or k.startswith(prefix)) and g.value is not None
        }

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time export of every instrument, JSON-serializable."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.to_dict() for k, h in sorted(histograms.items())},
        }

    def export_text(self) -> str:
        """Prometheus-flavoured text exposition (one line per sample)."""
        snap = self.snapshot()
        lines: List[str] = []
        for k, v in snap["counters"].items():
            lines.append(f"{_promname(k, '_total')} {v}")
        for k, v in snap["gauges"].items():
            if v is not None:
                lines.append(f"{_promname(k)} {v}")
        for k, h in snap["histograms"].items():
            lines.append(f"{_promname(k, '_count')} {h['count']}")
            lines.append(f"{_promname(k, '_sum')} {h['sum']}")
        return "\n".join(lines) + "\n"


def _promname(key: str, suffix: str = "") -> str:
    """`endpoint.queue_depth{endpoint=ep}` -> `endpoint_queue_depth{endpoint="ep"}`.
    The `_total`/`_count`/`_sum` suffix goes on the name, before the labels."""
    name, brace, labels = key.partition("{")
    name = name.replace(".", "_") + suffix
    if not brace:
        return name
    parts = []
    for pair in labels.rstrip("}").split(","):
        k, _, v = pair.partition("=")
        v = v.replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return name + "{" + ",".join(parts) + "}"


def merged_snapshot(registries: Iterable[MetricsRegistry]) -> dict:
    """Union of several registries' snapshots (later registries win on key
    collisions) — used when standalone endpoints keep private registries."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for reg in registries:
        snap = reg.snapshot()
        for section in out:
            out[section].update(snap[section])
    return out
