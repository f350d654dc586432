"""Task envelopes and futures.

funcX invocations are asynchronous: ``run()`` returns a :class:`TaskFuture`
whose result is delivered by the endpoint's manager loop. Every task carries a
timestamp trail so the paper's latency decomposition (Fig. 5: t_c / t_w / t_m /
t_e) can be reconstructed per invocation.
"""
from __future__ import annotations

import enum
import itertools
import threading
import time
import uuid
from concurrent.futures import CancelledError
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple


class TaskState(enum.Enum):
    PENDING = "pending"
    QUEUED = "queued"          # accepted by service, waiting in endpoint queue
    DISPATCHED = "dispatched"  # assigned to an executor
    RUNNING = "running"        # picked up by a worker
    SUCCESS = "success"
    FAILED = "failed"
    LOST = "lost"              # executor died while task in flight
    MEMOIZED = "memoized"      # served from the memo cache
    CANCELLED = "cancelled"    # client cancelled before a result arrived


_task_counter = itertools.count()


def new_task_id() -> str:
    return f"task-{next(_task_counter)}-{uuid.uuid4().hex[:8]}"


@dataclass
class Timestamps:
    """Wall-clock trail. All fields are ``time.monotonic()`` values."""

    client_submit: float = 0.0     # client called run()
    service_in: float = 0.0        # service accepted the request
    endpoint_in: float = 0.0       # endpoint queue insertion
    dispatched: float = 0.0        # manager assigned to an executor
    exec_start: float = 0.0        # worker began executing
    exec_end: float = 0.0          # worker finished executing
    result_ready: float = 0.0      # future completed

    def breakdown(self) -> dict:
        """Paper Fig. 5 decomposition (seconds).

        t_c: client <-> service round-trip overhead
        t_w: service routing (accept -> endpoint queue)
        t_m: endpoint/manager latency (queue + dispatch + worker pickup)
        t_e: function execution time
        """
        t_e = max(0.0, self.exec_end - self.exec_start)
        t_m = max(0.0, self.exec_start - self.endpoint_in)
        t_w = max(0.0, self.endpoint_in - self.service_in)
        total = max(0.0, self.result_ready - self.client_submit)
        t_c = max(0.0, total - t_w - t_m - t_e)
        return {"t_c": t_c, "t_w": t_w, "t_m": t_m, "t_e": t_e, "total": total}


@dataclass
class TaskEnvelope:
    """The unit that travels service -> endpoint -> executor -> worker."""

    task_id: str
    function_id: str
    payload: bytes                      # serialized input document
    container: str = "default"          # container type / warm-cache variant key
    # Capabilities the executing container pool must provide (resolved from
    # the RegisteredFunction's ResourceSpec at submission). The Forwarder and
    # Scheduler route only where these are satisfied; a task no live endpoint
    # can satisfy fails fast with a CapabilityError.
    requirements: Tuple[str, ...] = ()
    memoize: bool = False
    max_retries: int = 2
    retries: int = 0
    speculative_of: Optional[str] = None  # task_id this is a straggler-duplicate of
    timestamps: Timestamps = field(default_factory=Timestamps)
    # Filled in by the endpoint:
    executor_id: Optional[str] = None
    # Frame identity: set when this task travels inside a TaskBatch. A retry
    # is a fresh single-task attempt, so clone_for_retry() drops it.
    batch_id: Optional[str] = None
    # Soft routing preference (workflow warm-affinity: a node's children
    # prefer the endpoint holding the parent's warm function). The Forwarder
    # honors it only while the hinted endpoint is live and has spare capacity.
    affinity_hint: Optional[str] = None
    # Session-sticky routing (serving tier): tasks sharing a session_id pin
    # to one endpoint for as long as it stays live — a decode step must land
    # where the session's KV-cache slot lives, so stickiness survives
    # saturation (unlike affinity_hint) and rebinds only on endpoint death,
    # at which point the serving layer re-prefills (cache migration).
    session_id: Optional[str] = None
    # Data fabric (see core/datastore.py): (key, size) of every DataRef the
    # payload carries — the Forwarder's transfer estimator reads sizes without
    # unpacking, and endpoints resolve refs at dispatch when this is
    # non-empty. `spill_store`/`spill_threshold` tell the worker where to
    # spill an oversized *result* so it returns as a ref, not inline bytes.
    data_refs: Tuple[Tuple[str, int], ...] = ()
    spill_store: Optional[str] = None
    spill_threshold: Optional[int] = None
    # Runtime-only handles to the dispatching endpoint's locality caches
    # (raw blobs + decoded values); attached at dispatch and deliberately
    # NOT cloned for retries (a retry may land on a different endpoint,
    # whose own dispatch re-warms them).
    data_cache: Any = None
    data_decoded: Any = None
    # Runtime-only handle to the dispatching endpoint's SiteRuntime (worker
    # SiteRuntime): endpoint-scoped state for site-aware functions (serving
    # hosts live there). Attached at dispatch, never cloned.
    site: Any = None
    # Identity that submitted this task (from TokenAuthority.verify); drives
    # per-tenant quotas and fair-share dequeue in the Forwarder. None when no
    # auth is configured (treated as the shared "anonymous" tenant).
    tenant: Optional[str] = None

    def _clone(self, **overrides) -> "TaskEnvelope":
        """Base for retry/speculation clones. The packed payload is immutable
        wire bytes, so clones alias it (`clone.payload is self.payload`) —
        duplicating a task must never duplicate its payload. Timestamps are
        shared too: the trail describes the one logical task. Runtime-only
        handles (`data_cache`/`data_decoded`/`site`, `executor_id`,
        `batch_id`) are dropped: the clone travels the fabric as a fresh
        attempt.
        """
        fields = dict(
            task_id=self.task_id,
            function_id=self.function_id,
            payload=self.payload,
            container=self.container,
            requirements=self.requirements,
            memoize=self.memoize,
            max_retries=self.max_retries,
            retries=self.retries,
            timestamps=self.timestamps,
            affinity_hint=self.affinity_hint,
            session_id=self.session_id,
            data_refs=self.data_refs,
            spill_store=self.spill_store,
            spill_threshold=self.spill_threshold,
            tenant=self.tenant,
        )
        fields.update(overrides)
        return TaskEnvelope(**fields)

    def clone_for_retry(self) -> "TaskEnvelope":
        return self._clone(retries=self.retries + 1)

    def clone_speculative(self, suffix: str) -> "TaskEnvelope":
        """Straggler-duplicate of this task: same shared payload bytes and
        timestamp trail, id-suffixed so result dedup maps it back to the
        canonical task (`speculative_of`). Never retried on its own — the
        canonical attempt owns the retry budget."""
        return self._clone(
            task_id=f"{self.task_id}{suffix}",
            speculative_of=self.task_id,
            max_retries=0,
        )


class TaskFuture:
    """Thread-safe future for an asynchronous function invocation."""

    def __init__(self, task_id: str):
        self.task_id = task_id
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._state = TaskState.PENDING
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self.timestamps = Timestamps()
        self._callbacks: list[Callable[["TaskFuture"], None]] = []
        # Stamped by the Forwarder at routing time (and re-stamped on
        # failover): where this task currently lives. Consumers (the workflow
        # engine's warm-affinity hints) treat it as best-effort.
        self.endpoint_id: Optional[str] = None

    # -- producer side -------------------------------------------------
    def set_state(self, state: TaskState) -> None:
        with self._lock:
            if not self._event.is_set():
                self._state = state

    def set_result(self, value: Any, state: TaskState = TaskState.SUCCESS) -> bool:
        """Complete the future. Returns False if already complete (idempotent:
        speculative duplicates race and only the first wins)."""
        with self._lock:
            if self._event.is_set():
                return False
            self._result = value
            self._state = state
            self.timestamps.result_ready = time.monotonic()
            self._event.set()
            callbacks = list(self._callbacks)
        for cb in callbacks:
            cb(self)
        return True

    def set_exception(
        self, exc: BaseException, state: TaskState = TaskState.FAILED
    ) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._exception = exc
            self._state = state
            self.timestamps.result_ready = time.monotonic()
            self._event.set()
            callbacks = list(self._callbacks)
        for cb in callbacks:
            cb(self)
        return True

    # -- consumer side -------------------------------------------------
    @property
    def state(self) -> TaskState:
        with self._lock:
            return self._state

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> bool:
        """Best-effort cancellation (``concurrent.futures`` shape): resolves
        this future with :class:`CancelledError` unless it already completed.
        The fabric cannot interrupt a remotely-executing function — a late
        result for a cancelled task dedupes against the already-resolved
        future (and counts in ``journal.duplicate_results``)."""
        return self.set_exception(
            CancelledError(self.task_id), state=TaskState.CANCELLED
        )

    def cancelled(self) -> bool:
        with self._lock:
            return self._state is TaskState.CANCELLED

    def running(self) -> bool:
        """stdlib alignment: dispatched to (or executing on) a worker and not
        yet complete."""
        with self._lock:
            return not self._event.is_set() and self._state in (
                TaskState.DISPATCHED, TaskState.RUNNING
            )

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.task_id} not complete after {timeout}s")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.task_id} not complete after {timeout}s")
        return self._exception

    def add_done_callback(self, cb: Callable[["TaskFuture"], None]) -> None:
        run_now = False
        with self._lock:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(cb)
        if run_now:
            cb(self)

    def remove_done_callback(self, cb: Callable[["TaskFuture"], None]) -> bool:
        """Detach a pending done-callback (workflow cancel: the in-flight task
        keeps running but its completion no longer drives the run). Returns
        True if the callback was found and removed."""
        with self._lock:
            try:
                self._callbacks.remove(cb)
                return True
            except ValueError:
                return False

    def latency_breakdown(self) -> dict:
        return self.timestamps.breakdown()
