"""Worker: executes one function at a time (paper §5.3).

Port of ``repro.core.worker`` without its JAX executable: a function
registered with ``jax_jit=True`` raises at ``build_executable``.

funcX workers "persist within containers and each executes one function at a
time ... once a function is received it is deserialized and executed, and the
serialized results are returned via the executor." Here a worker is a thread
(on TPU: pinned to a device slice); it persists within one
:class:`~repro.core.containers.ContainerPool` and the container is the warm
executable it runs inside (see `warming.py`).

Idle workers block on the pool inbox — no timeout-poll — so hundreds of idle
workers across container pools burn no CPU. Retirement is a stop-sentinel
(:data:`Worker.STOP`) delivered through the same inbox: tasks queued ahead of
the sentinel still execute, then the worker exits.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Optional

from . import serializer

if TYPE_CHECKING:  # imported lazily to avoid a registry<->containers cycle
    from .registry import RegisteredFunction
    from .warming import WarmPool


@dataclass
class TaskResult:
    envelope: Any                     # TaskEnvelope
    value: Any = None                 # deserialized result (or bytes if wire=True)
    error: Optional[str] = None
    exception: Optional[BaseException] = None
    worker_id: str = ""
    cold_start: bool = False
    compile_time_s: float = 0.0
    batch_id: Optional[str] = None    # TaskBatch frame this task arrived in


class SiteRuntime:
    """Endpoint-scoped runtime state handed to *site-aware* functions.

    A function registered with ``site_aware=True`` metadata receives
    ``(payload, site)`` instead of ``(payload,)``: the dispatching endpoint
    attaches its SiteRuntime to every envelope, so the function can reach
    state that must live *where the task runs* — the serving tier's per-
    endpoint model hosts (KV-cache slots) are the canonical tenant. State is
    a keyed get-or-create map so concurrent workers build each service once.
    """

    def __init__(self, endpoint_id: str, name: str,
                 metrics_fn: Optional[Callable[[], Any]] = None):
        self.endpoint_id = endpoint_id
        self.name = name
        self._metrics_fn = metrics_fn
        self._state: dict = {}
        self._lock = threading.Lock()

    @property
    def metrics(self):
        """The owning endpoint's *current* MetricsRegistry (endpoints rebind
        to the service registry at registration, so this is read late)."""
        return self._metrics_fn() if self._metrics_fn is not None else None

    def get_or_create(self, key: Any, factory: Callable[[], Any]) -> Any:
        with self._lock:
            if key not in self._state:
                self._state[key] = factory()
            return self._state[key]

    def pop(self, key: Any) -> Any:
        with self._lock:
            return self._state.pop(key, None)


_default_site: Optional[SiteRuntime] = None
_default_site_lock = threading.Lock()


def default_site() -> SiteRuntime:
    """Fallback SiteRuntime for tasks that bypassed endpoint dispatch
    (direct executor submission in tests, in-process engine use)."""
    global _default_site
    with _default_site_lock:
        if _default_site is None:
            from .metrics import MetricsRegistry

            registry = MetricsRegistry()
            _default_site = SiteRuntime(
                "local", "local", metrics_fn=lambda: registry
            )
        return _default_site


def strip_traceback(exc: BaseException) -> BaseException:
    """Drop the traceback (frames + their locals) from `exc` and its
    cause/context chain. A TaskResult's exception outlives the task for as
    long as the caller holds the future; carrying live frames across the
    executor boundary would pin every local of the failed call for that
    lifetime. The formatted traceback string in TaskResult.error survives.
    """
    seen = set()
    stack = [exc]
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        e.__traceback__ = None
        stack.extend((e.__cause__, e.__context__))
    return exc


def build_executable(rf: "RegisteredFunction", sample_payload: Any = None) -> Callable:
    # Simulated container instantiation cost (paper Table 4: funcX containers
    # take seconds to boot). Benchmarks use this to make cold starts
    # deterministic — XLA's in-process executable cache makes *re*-compiles of
    # identical HLO nearly free, which would otherwise hide the cost a second
    # endpoint pays to warm up.
    boot_s = rf.metadata.get("container_boot_s", 0.0)
    if boot_s:
        time.sleep(boot_s)
    if rf.metadata.get("jax_jit", False):
        # the reference compiles such a function with jax.jit; the port has no
        # JAX and never runs it uncompiled in its place
        raise ValueError(
            f"function {rf.name!r} is registered with jax_jit=True: the PyTorch "
            "port cannot build a JAX executable"
        )
    return rf.fn


class Worker(threading.Thread):
    #: stop sentinel: delivered through the inbox so a blocked worker wakes
    #: exactly once to retire (one sentinel stops one worker)
    STOP = object()

    def __init__(
        self,
        worker_id: str,
        inbox: "queue.Queue",
        outbox: "queue.Queue[TaskResult]",
        registry,
        warm_pool: "WarmPool",
        on_stop: Optional[Callable[[], None]] = None,
    ):
        super().__init__(name=worker_id, daemon=True)
        self.worker_id = worker_id
        self.inbox = inbox
        self.outbox = outbox
        self.registry = registry
        self.warm_pool = warm_pool
        # invoked when a STOP sentinel is consumed (pool bookkeeping: the
        # sentinel is no longer pending in the shared inbox)
        self._on_stop = on_stop
        self._drop_inflight = threading.Event()  # simulated node failure
        self.busy = False
        self.executed = 0

    # -- failure injection (tests / Fig. 7 benchmark) --------------------
    def simulate_failure(self) -> None:
        """Drop whatever is executing, produce no results, stop the loop."""
        self._drop_inflight.set()

    def stop(self) -> None:
        """Graceful retirement: tasks already queued ahead of the sentinel
        still execute; the worker consuming the sentinel exits."""
        self.inbox.put(Worker.STOP)

    # -- main loop --------------------------------------------------------
    def run(self) -> None:
        while True:
            item = self.inbox.get()  # blocking: idle workers burn no CPU
            if item is Worker.STOP:
                if self._on_stop is not None:
                    self._on_stop()
                return
            if self._drop_inflight.is_set():
                return  # vanish without reporting — watchdog must recover
            self.busy = True
            try:
                result = self._execute(item)
            finally:
                self.busy = False
            if self._drop_inflight.is_set():
                return  # killed mid-task: the result vanishes with the node
            self.outbox.put(result)
            self.executed += 1

    def _execute(self, env) -> TaskResult:
        env.timestamps.exec_start = time.monotonic()
        try:
            rf = self.registry.get(env.function_id)
            payload = serializer.unpackb(env.payload) if isinstance(env.payload, bytes) else env.payload
            if getattr(env, "data_refs", ()):
                # materialize DataRef leaves in parallel across workers; the
                # dispatching endpoint warmed its locality cache and attached
                # it as env.data_cache. A path that bypassed dispatch (direct
                # executor submission, speculation backups holding unpacked
                # payloads) resolves straight from the refs' store locations.
                from .datastore import resolve_payload

                payload = resolve_payload(
                    payload,
                    cache=getattr(env, "data_cache", None),
                    decoded=getattr(env, "data_decoded", None),
                )
            key = (env.function_id, env.container)
            executable, cold, dt = self.warm_pool.get_or_compile(
                key, lambda: build_executable(rf, payload)
            )
            if rf.metadata.get("site_aware", False):
                # endpoint-scoped functions see where they run: the serving
                # tier resolves its per-endpoint model host through this
                site = getattr(env, "site", None)
                value = executable(payload, site or default_site())
            else:
                value = executable(payload)
            if getattr(env, "spill_store", None) and env.spill_threshold:
                # result spill: oversized result leaves stay in the object
                # store near where they were computed; only refs travel the
                # result path back through the fabric
                from .datastore import get_store, spill_payload

                store = get_store(env.spill_store)
                value, _ = spill_payload(value, store, env.spill_threshold)
            if rf.metadata.get("serialize_result", True):
                # wire-faithful: results cross the executor/manager boundary as
                # bytes; deserialized once at the service edge.
                value = serializer.unpackb(serializer.packb(value))
            env.timestamps.exec_end = time.monotonic()
            return TaskResult(
                envelope=env, value=value, worker_id=self.worker_id,
                cold_start=cold, compile_time_s=dt, batch_id=env.batch_id,
            )
        except BaseException as exc:  # noqa: BLE001 — report, don't die
            env.timestamps.exec_end = time.monotonic()
            error = f"{type(exc).__name__}: {exc}\n{traceback.format_exc(limit=5)}"
            return TaskResult(
                envelope=env,
                error=error,
                # the exception crosses the executor boundary without its
                # traceback: live frames (and their locals) must not stay
                # pinned for the lifetime of the result/memo cache
                exception=strip_traceback(exc),
                worker_id=self.worker_id,
                batch_id=env.batch_id,
            )
