"""Typed container pools: the heterogeneous execution tier (paper §5.3–5.4, §8).

The paper promises that functions are "offloaded to specialized accelerators"
and run inside managed containers whose workers "persist within containers";
resource-aware scheduling is its named future work (§8). The journal funcX
follow-up makes container management first-class: an endpoint hosts several
*container types*, each with its own warm worker pool, and tasks carry the
capabilities they require so the fabric can route them only where they can
run.

This module defines that tier:

- :class:`ContainerSpec` — one container type an executor can host: a name
  (the warm-cache variant key), the capability set it provides (``{"cpu"}``,
  ``{"cpu", "jit"}``, ...), pool bounds, and a memory hint.
- :class:`ResourceSpec` — what a registered function *requires*: capabilities
  that must all be present, plus a preferred container name tasks default
  into when the invocation doesn't name one.
- :class:`ContainerPool` — a typed worker pool with its own inbox whose
  workers persist within that container (paper §5.3). Pools resize on
  demand: workers spin up when matching tasks arrive (bounded by
  ``max_workers``) and shrink back to ``min_workers`` after a keep-alive
  idle period, unified with the :class:`~repro.core.warming.WarmPool`
  TTL semantics.
- :class:`CapabilityError` — raised (or delivered through the task future)
  when no live endpoint/pool satisfies a task's requirements. Incapable
  dispatch fails fast instead of timing out in a watchdog.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional

from .futures import TaskEnvelope
from .worker import Worker


class CapabilityError(RuntimeError):
    """No live endpoint / container pool satisfies a task's ResourceSpec."""


def _as_capability_set(caps: Optional[Iterable[str]]) -> frozenset:
    if caps is None:
        return frozenset()
    if isinstance(caps, str):  # a lone "tpu" is a 1-capability set, not chars
        return frozenset({caps})
    return frozenset(caps)


@dataclass(frozen=True)
class ContainerSpec:
    """One container type an executor can host.

    ``name`` doubles as the warm-cache variant key — tasks executed in this
    container warm ``(function_id, name)`` entries. ``capabilities`` is what
    the pool *provides*; a task can run here iff its required capabilities
    are a subset. ``min_workers`` workers persist for the life of the
    executor; demand grows the pool up to ``max_workers`` and the keep-alive
    shrinks it back. ``memory_hint_mb`` is advisory (surfaces in stats and
    provider submit scripts; nothing in-process enforces it).
    """

    name: str
    capabilities: frozenset = frozenset({"cpu"})
    min_workers: int = 0
    max_workers: int = 4
    memory_hint_mb: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "capabilities", _as_capability_set(self.capabilities))
        if self.max_workers < 1:
            raise ValueError(f"container {self.name!r}: max_workers must be >= 1")
        if not 0 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"container {self.name!r}: need 0 <= min_workers <= max_workers, "
                f"got {self.min_workers}/{self.max_workers}"
            )

    def provides(self, required: Iterable[str]) -> bool:
        return _as_capability_set(required) <= self.capabilities


def default_container_spec(workers: int, name: str = "default") -> ContainerSpec:
    """The homogeneous-endpoint spec: a fixed-size cpu pool (seed parity)."""
    return ContainerSpec(
        name=name,
        capabilities=frozenset({"cpu"}),
        min_workers=workers,
        max_workers=workers,
    )


@dataclass(frozen=True)
class ResourceSpec:
    """What a registered function requires from the fabric.

    ``capabilities`` must all be provided by the chosen container pool;
    ``preferred_container`` names the container variant tasks default into
    when the invocation leaves ``container="default"``.
    """

    capabilities: frozenset = frozenset()
    preferred_container: Optional[str] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "capabilities", _as_capability_set(self.capabilities))

    def satisfied_by(self, provided: Iterable[str]) -> bool:
        return self.capabilities <= _as_capability_set(provided)


class ContainerPool:
    """A typed worker pool: one inbox, workers that persist within the
    container (paper §5.3), demand-driven sizing.

    Workers block on the inbox (no timeout-poll), so idle pools burn no CPU;
    retirement delivers one stop-sentinel per surplus worker through the same
    inbox. Sizing is demand-driven: ``submit()`` spins up as many workers as
    the backlog needs (up to ``spec.max_workers``) and ``shrink_idle()``
    retires the surplus back to ``spec.min_workers`` once the pool has been
    continuously idle for the keep-alive period — the container analogue of
    the WarmPool's TTL on compiled executables.
    """

    def __init__(
        self,
        spec: ContainerSpec,
        executor_id: str,
        outbox: "queue.Queue",
        registry,
        warm_pool,
    ):
        self.spec = spec
        self.executor_id = executor_id
        self.outbox = outbox
        self.registry = registry
        self.warm_pool = warm_pool
        self.inbox: "queue.Queue[TaskEnvelope]" = queue.Queue()
        self._lock = threading.Lock()
        self._workers: List[Worker] = []
        self._counter = 0
        self._alive = True
        # STOP sentinels enqueued but not yet consumed. Every capacity and
        # backlog computation subtracts these: a sentinel in the inbox is not
        # work, and an alive worker that will consume one is not capacity.
        # (Without this, a submit racing a shrink sees doomed workers as
        # live, declines to spin up, and strands its task in a pool whose
        # workers all retire.)
        self._pending_stops = 0
        self.spinups = 0
        self.shrinks = 0
        # becomes "idle since": refreshed while the pool has work, so the
        # keep-alive clock starts when the last task drains, not when the
        # first arrived
        self._idle_since = time.monotonic()
        if spec.min_workers:
            with self._lock:
                self._spin_up(spec.min_workers)

    # -- sizing -----------------------------------------------------------
    def _note_stop_consumed(self) -> None:
        """Worker callback: a STOP sentinel left the inbox."""
        with self._lock:
            self._pending_stops = max(0, self._pending_stops - 1)

    def _alive_count(self) -> int:
        return sum(1 for w in self._workers if w.is_alive())

    def _effective_live(self) -> int:
        """Workers that will still be here once pending sentinels land."""
        return max(0, self._alive_count() - self._pending_stops)

    def _spin_up(self, n: int) -> int:
        """Start up to n workers (bounded by spec.max_workers net of workers
        already doomed by pending sentinels). Lock held by caller."""
        started = 0
        for _ in range(n):
            self._workers = [w for w in self._workers if w.is_alive()]
            if self._effective_live() >= self.spec.max_workers:
                break
            w = Worker(
                worker_id=f"{self.executor_id}/{self.spec.name}/w{self._counter}",
                inbox=self.inbox,
                outbox=self.outbox,
                registry=self.registry,
                warm_pool=self.warm_pool,
                on_stop=self._note_stop_consumed,
            )
            self._counter += 1
            self._workers.append(w)
            w.start()
            started += 1
        self.spinups += started
        return started

    def live_workers(self) -> int:
        return sum(1 for w in self._workers if w.is_alive())

    def idle_workers(self) -> int:
        with self._lock:
            idle = sum(1 for w in self._workers if w.is_alive() and not w.busy)
            return max(0, idle - self._pending_stops)

    def busy_workers(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if w.is_alive() and w.busy)

    def queued(self) -> int:
        """Task backlog: inbox size net of pending stop sentinels."""
        with self._lock:
            return max(0, self.inbox.qsize() - self._pending_stops)

    def free_capacity(self, prefetch: int = 0) -> int:
        """Tasks this pool will absorb right now: idle workers, plus workers
        it can still spin up on demand, plus the prefetch allowance, minus
        the local backlog — all net of workers doomed by pending sentinels."""
        if not self._alive:
            return 0
        with self._lock:
            alive = self._alive_count()
            idle = sum(1 for w in self._workers if w.is_alive() and not w.busy)
            effective_idle = max(0, idle - self._pending_stops)
            effective_live = max(0, alive - self._pending_stops)
            headroom = self.spec.max_workers - effective_live
            backlog = max(0, self.inbox.qsize() - self._pending_stops)
        return max(0, effective_idle + headroom + prefetch - backlog)

    def submit(self, envs: List[TaskEnvelope]) -> None:
        """Queue tasks and grow the pool to meet the backlog (demand-driven
        spin-up, paper §5.4 'managed elasticity' at container granularity)."""
        for env in envs:
            self.inbox.put(env)
        with self._lock:
            self._idle_since = time.monotonic()
            busy = sum(1 for w in self._workers if w.is_alive() and w.busy)
            backlog = max(0, self.inbox.qsize() - self._pending_stops)
            want = min(self.spec.max_workers,
                       max(self.spec.min_workers, busy + backlog))
            if want > self._effective_live():
                self._spin_up(want - self._effective_live())

    def shrink_idle(self, keep_alive_s: float, now: Optional[float] = None) -> int:
        """Retire surplus workers after a continuous idle keep-alive period.
        Returns the number of workers retired."""
        now = time.monotonic() if now is None else now
        with self._lock:
            busy = sum(1 for w in self._workers if w.is_alive() and w.busy)
            if busy or self.inbox.qsize() > self._pending_stops:
                self._idle_since = now  # still working: keep-alive re-arms
                return 0
            live = self._effective_live()
            if live <= self.spec.min_workers:
                return 0
            if now - self._idle_since < keep_alive_s:
                return 0
            surplus = live - self.spec.min_workers
            # one sentinel per surplus worker: whichever workers consume them
            # exit; the next submit's spin-up re-grows if load returns
            for _ in range(surplus):
                self.inbox.put(Worker.STOP)
            self._pending_stops += surplus
            self.shrinks += surplus
            return surplus

    # -- lifecycle --------------------------------------------------------
    def drain_queued(self) -> List[TaskEnvelope]:
        """Pull every queued task back out (watchdog recovery path)."""
        drained: List[TaskEnvelope] = []
        while True:
            try:
                item = self.inbox.get_nowait()
            except queue.Empty:
                return drained
            if item is Worker.STOP:
                self._note_stop_consumed()
            else:
                drained.append(item)

    def kill(self) -> None:
        """Simulated node failure: workers vanish without reporting. Idle
        workers block on the inbox, so each alive worker also gets a wake-up
        sentinel — without it a killed pool would strand its idle workers as
        permanently-blocked threads pinning the pool and registry. A worker
        that wakes on a real task drops it unexecuted (``_drop_inflight``);
        the watchdog recovers it from the in-flight bookkeeping."""
        self._alive = False
        with self._lock:
            alive = [w for w in self._workers if w.is_alive()]
            for w in alive:
                w.simulate_failure()
            self._pending_stops += len(alive)
            for _ in alive:
                self.inbox.put(Worker.STOP)

    def stop(self, join: bool = True) -> None:
        """Graceful retirement: one sentinel per worker, then join the idle
        ones (a worker mid-task finishes and exits on its own)."""
        self._alive = False
        with self._lock:
            workers = [w for w in self._workers if w.is_alive()]
            self._pending_stops += len(workers)
        for w in workers:
            w.stop()
        if join:
            for w in workers:
                if not w.busy:
                    w.join(timeout=1.0)

    def stats(self) -> dict:
        return {
            "container": self.spec.name,
            "capabilities": sorted(self.spec.capabilities),
            "workers": self.live_workers(),
            "idle": self.idle_workers(),
            "queued": self.queued(),
            "spinups": self.spinups,
            "shrinks": self.shrinks,
            "memory_hint_mb": self.spec.memory_hint_mb,
        }
