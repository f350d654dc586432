"""Runtime/transfer prediction for data-aware placement (funcX follow-up
work; SNIPPETS.md central-scheduler exemplars).

Three estimators feed the Forwarder's ``eta_aware`` policy:

- :class:`RuntimePredictor` — per-(function, endpoint) rolling average over
  the last N observed runtimes, with a cold-start fallback chain: unseen
  (function, endpoint) pairs borrow the function's cross-endpoint mean, a
  never-seen function predicts ``None`` (the policy then degrades to
  normalized least-outstanding rather than guessing).
- :class:`TransferPredictor` — byte-cost model ``latency + bytes/bandwidth``
  for moving payload bytes (and any DataRef blobs not already resident in an
  endpoint's locality cache) to a candidate endpoint. Observed transfers
  EWMA-update the bandwidth estimate.
- per-endpoint *queue error* — an EWMA of how much actual completion time
  overran the predicted ETA, folded back into both future ETAs and the
  speculation bound so a consistently mis-modeled endpoint is neither
  dog-piled nor spuriously speculated against.

:class:`TaskPredictor` bundles the three behind the surface the Forwarder
consumes: ``eta()`` at routing time, ``record()``/``observe_eta()`` at result
time, and ``overrun_bound()`` for backup-task speculation.
"""
from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Deque, Dict, Optional, Tuple

from .metrics import MetricsRegistry

DEFAULT_LAST_N = 10


class RuntimePredictor:
    """Rolling-average runtime model keyed by (function_id, endpoint_id)."""

    def __init__(self, last_n: int = DEFAULT_LAST_N,
                 metrics: Optional[MetricsRegistry] = None):
        if last_n < 1:
            raise ValueError("last_n must be >= 1")
        self.last_n = last_n
        self.metrics = metrics
        self._lock = threading.Lock()
        self._window: Dict[Tuple[str, str], Deque[float]] = {}
        self._total = 0.0
        self._count = 0

    def record(self, function_id: str, endpoint_id: str, runtime_s: float) -> None:
        if runtime_s < 0:
            return
        with self._lock:
            key = (function_id, endpoint_id)
            win = self._window.get(key)
            if win is None:
                win = self._window[key] = deque(maxlen=self.last_n)
            win.append(float(runtime_s))
            self._total += runtime_s
            self._count += 1
        if self.metrics is not None:
            self.metrics.counter("predictor.observations").inc()

    def predict(self, function_id: str, endpoint_id: str) -> Optional[float]:
        """Mean of the last N runtimes for the pair; cold pairs fall back to
        the function's mean across every endpoint; unknown functions return
        None (the caller chooses a cold-start behavior)."""
        with self._lock:
            win = self._window.get((function_id, endpoint_id))
            if win:
                return sum(win) / len(win)
            pooled = [
                v
                for (fid, _eid), w in self._window.items()
                if fid == function_id
                for v in w
            ]
        if self.metrics is not None:
            self.metrics.counter("predictor.cold_starts").inc()
        if pooled:
            return sum(pooled) / len(pooled)
        return None

    def has_history(self, function_id: str, endpoint_id: str) -> bool:
        with self._lock:
            return bool(self._window.get((function_id, endpoint_id)))

    def global_mean(self) -> Optional[float]:
        with self._lock:
            return self._total / self._count if self._count else None


class TransferPredictor:
    """Seconds to move n bytes: ``latency_s + n / bandwidth_bps``. Defaults
    model an in-process fabric (10 GiB/s, 0.1 ms); observed transfers refine
    the bandwidth estimate by EWMA."""

    def __init__(self, bandwidth_bps: float = 10 * 2**30,
                 latency_s: float = 1e-4, alpha: float = 0.25):
        self.bandwidth_bps = float(bandwidth_bps)
        self.latency_s = float(latency_s)
        self.alpha = alpha
        self._lock = threading.Lock()

    def estimate(self, n_bytes: int) -> float:
        if n_bytes <= 0:
            return 0.0
        with self._lock:
            return self.latency_s + n_bytes / self.bandwidth_bps

    def record(self, n_bytes: int, seconds: float) -> None:
        if n_bytes <= 0 or seconds <= 0:
            return
        observed = n_bytes / seconds
        with self._lock:
            self.bandwidth_bps = (
                self.alpha * observed + (1 - self.alpha) * self.bandwidth_bps
            )


class TaskPredictor:
    """The Forwarder-facing bundle: runtime + transfer models plus the
    per-endpoint queue-error EWMA."""

    def __init__(
        self,
        last_n: int = DEFAULT_LAST_N,
        metrics: Optional[MetricsRegistry] = None,
        transfer: Optional[TransferPredictor] = None,
        queue_error_alpha: float = 0.3,
    ):
        self.metrics = metrics
        self.runtime = RuntimePredictor(last_n=last_n, metrics=metrics)
        self.transfer = transfer if transfer is not None else TransferPredictor()
        self.queue_error_alpha = queue_error_alpha
        self._qlock = threading.Lock()
        self._queue_error: Dict[str, float] = defaultdict(float)

    def bind_metrics(self, metrics: MetricsRegistry) -> None:
        self.metrics = metrics
        self.runtime.metrics = metrics

    def queue_error(self, endpoint_id: str) -> float:
        with self._qlock:
            return self._queue_error[endpoint_id]

    def eta(
        self,
        function_id: str,
        endpoint_id: str,
        transfer_bytes: int,
        outstanding: int,
        capacity: int,
    ) -> float:
        """Predicted completion time from now if routed to `endpoint_id`:
        runtime + transfer cost + queue delay + the endpoint's ETA error.
        A cold function contributes zero runtime/queue terms, so cold-start
        scoring reduces to transfer + error — ties broken by the caller."""
        rt = self.runtime.predict(function_id, endpoint_id)
        rt_q = rt if rt is not None else self.runtime.global_mean()
        queue_delay = (
            outstanding * rt_q / max(1, capacity) if rt_q is not None else 0.0
        )
        return (
            (rt or 0.0)
            + self.transfer.estimate(transfer_bytes)
            + queue_delay
            + self.queue_error(endpoint_id)
        )

    def record(self, function_id: str, endpoint_id: str, runtime_s: float) -> None:
        self.runtime.record(function_id, endpoint_id, runtime_s)

    def observe_eta(
        self, endpoint_id: str, predicted_s: float, actual_s: float
    ) -> None:
        """Fold one completed task's (predicted, actual) pair into the
        endpoint's queue-error EWMA. Only overruns accumulate — the error
        term is a pessimism correction, not a bonus for finishing early."""
        err = max(0.0, actual_s - predicted_s)
        with self._qlock:
            prev = self._queue_error[endpoint_id]
            self._queue_error[endpoint_id] = (
                self.queue_error_alpha * err
                + (1 - self.queue_error_alpha) * prev
            )
        if self.metrics is not None:
            self.metrics.histogram("predictor.eta_error_s").observe(err)

    def overrun_bound(
        self, endpoint_id: str, predicted_s: float,
        factor: float, min_age_s: float,
    ) -> float:
        """Age after which an in-flight task counts as overrunning its ETA
        error bound (the Forwarder then launches a backup copy)."""
        return max(min_age_s, predicted_s * factor + self.queue_error(endpoint_id))

    def stats(self) -> dict:
        with self._qlock:
            qerr = dict(self._queue_error)
        return {
            "observations": self.runtime._count,
            "global_mean_runtime_s": self.runtime.global_mean(),
            "bandwidth_bps": self.transfer.bandwidth_bps,
            "queue_error_s": qerr,
        }
