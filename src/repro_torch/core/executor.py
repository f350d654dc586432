"""Executor: per-node container pools (paper §5.3–5.4).

"Executors represent, and communicate on behalf of, the collective capacity
of the workers on a single node" — they partition the node among *typed
container pools* (one per :class:`~repro.core.containers.ContainerSpec` the
node hosts), advertise available capacity per container type to the manager,
emit heartbeats, and forward results. Prefetch (§5.5) is the capacity each
pool advertises beyond currently-idle workers.

Heterogeneity: every pool carries a capability set; the scheduler only hands
an executor tasks some pool can run (``can_run``), and capacity is advertised
per container (``free_capacity(container)``) instead of one scalar. Pools
resize on demand — workers spin up when matching tasks arrive and shrink back
to ``min_workers`` after a keep-alive idle period, unified with the WarmPool
TTL that retires the compiled executables those workers would have reused.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .containers import (
    CapabilityError,
    ContainerPool,
    ContainerSpec,
    default_container_spec,
)
from .futures import TaskEnvelope
from .heartbeat import HeartbeatMonitor
from .interchange import ResultBatch
from .metrics import MetricsRegistry
from .registry import FunctionRegistry
from .warming import WarmPool
from .worker import TaskResult


class Executor:
    def __init__(
        self,
        executor_id: str,
        registry: FunctionRegistry,
        result_queue: "queue.Queue[ResultBatch]",
        containers: Optional[Sequence[ContainerSpec]] = None,
        prefetch: int = 0,
        warm_ttl_s: float = 300.0,
        container_keep_alive_s: Optional[float] = None,
        monitor: Optional[HeartbeatMonitor] = None,
        heartbeat_interval_s: float = 2.0,
        result_max_batch: int = 64,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.executor_id = executor_id
        self.registry = registry
        self.result_queue = result_queue
        self.prefetch = prefetch
        self.result_max_batch = result_max_batch
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.warm_pool = WarmPool(ttl_s=warm_ttl_s, metrics=self.metrics)
        # container keep-alive defaults to the warm TTL: workers and the
        # compiled executables they reuse retire on the same clock
        self.container_keep_alive_s = (
            warm_ttl_s if container_keep_alive_s is None else container_keep_alive_s
        )
        self.monitor = monitor
        self.heartbeat_interval_s = heartbeat_interval_s

        self._alive = True
        self._suspended = False
        self._lock = threading.Lock()
        self.in_flight: Dict[str, TaskEnvelope] = {}
        self.completed = 0

        specs = list(containers) if containers else [default_container_spec(4)]
        if len({s.name for s in specs}) != len(specs):
            raise ValueError(f"duplicate container names in {[s.name for s in specs]}")
        self.specs: Dict[str, ContainerSpec] = {s.name: s for s in specs}
        outbox: "queue.Queue[TaskResult]" = queue.Queue()
        self._outbox = outbox
        self.pools: Dict[str, ContainerPool] = {
            s.name: ContainerPool(
                spec=s,
                executor_id=executor_id,
                outbox=outbox,
                registry=registry,
                warm_pool=self.warm_pool,
            )
            for s in specs
        }

        self._forwarder = threading.Thread(
            target=self._forward_results, name=f"{executor_id}/fwd", daemon=True
        )
        self._forwarder.start()

        if monitor is not None:
            monitor.register(executor_id)
            self._beater = threading.Thread(
                target=self._beat_loop, name=f"{executor_id}/hb", daemon=True
            )
            self._beater.start()

    # -- capability surface (consumed by the resource-aware scheduler) ----
    def capabilities(self) -> frozenset:
        """Union of every hosted container's capability set."""
        return frozenset().union(*(s.capabilities for s in self.specs.values()))

    def pool_for(self, env: TaskEnvelope) -> Optional[ContainerPool]:
        """The pool `env` runs in: the container it names when that pool
        satisfies its requirements, else the first pool that does. The seed's
        container-as-cache-key usage (arbitrary names, no requirements) keeps
        working: an unknown name with empty requirements lands in the first
        (default) pool, warm-keyed by the requested name."""
        required = env.requirements
        pool = self.pools.get(env.container)
        if pool is not None and pool.spec.provides(required):
            return pool
        for pool in self.pools.values():
            if pool.spec.provides(required):
                return pool
        return None

    def can_run(self, env: TaskEnvelope) -> bool:
        return self.pool_for(env) is not None

    # -- capacity advertising (enables executor-side batching) -----------
    def idle_workers(self) -> int:
        return sum(p.idle_workers() for p in self.pools.values())

    def worker_count(self) -> int:
        return sum(p.live_workers() for p in self.pools.values())

    @property
    def max_workers(self) -> int:
        """Advertised ceiling: what this node can grow to across pools."""
        return sum(s.max_workers for s in self.specs.values())

    def free_capacity(self, container: str) -> int:
        """Per-container-type capacity advertisement (idle + demand headroom
        + prefetch − backlog) for the named pool."""
        if not self.accepting():
            return 0
        pool = self.pools.get(container)
        return pool.free_capacity(self.prefetch) if pool is not None else 0

    def free_capacity_for(self, env: TaskEnvelope) -> int:
        """Capacity advertisement for the pool `env` would run in."""
        if not self.accepting():
            return 0
        pool = self.pool_for(env)
        return pool.free_capacity(self.prefetch) if pool is not None else 0

    def queued_tasks(self) -> int:
        """Backlog across every pool inbox (autoscaler drain check)."""
        return sum(p.queued() for p in self.pools.values())

    def accepting(self) -> bool:
        return self._alive and not self._suspended

    def has_warm(self, key: Tuple) -> bool:
        return self.warm_pool.contains(key)

    # -- task intake ------------------------------------------------------
    def submit(self, env: TaskEnvelope) -> None:
        self.submit_batch([env])

    def submit_batch(self, envs: List[TaskEnvelope]) -> None:
        """Accept a manager-pulled batch: one in-flight bookkeeping pass for
        the whole batch, then one pool submission per container type (the
        pool grows itself to meet the backlog)."""
        with self._lock:
            for env in envs:
                env.executor_id = self.executor_id
                self.in_flight[env.task_id] = env
        by_pool: Dict[str, List[TaskEnvelope]] = {}
        unroutable: List[TaskEnvelope] = []
        for env in envs:
            pool = self.pool_for(env)
            if pool is None:
                unroutable.append(env)
            else:
                by_pool.setdefault(pool.spec.name, []).append(env)
        for name, batch in by_pool.items():
            self.pools[name].submit(batch)
        for env in unroutable:
            # defensive: the scheduler filters on can_run(), so this only
            # fires when specs changed between choice and delivery — report
            # a capability error instead of stranding the task
            self.metrics.counter("container.capability_misses").inc()
            exc = CapabilityError(
                f"executor {self.executor_id} has no container providing "
                f"{sorted(env.requirements)} (hosts {sorted(self.specs)})"
            )
            self._outbox.put(TaskResult(envelope=env, error=str(exc), exception=exc))

    def take_in_flight(self) -> List[TaskEnvelope]:
        """Called by the watchdog after this executor is declared dead."""
        with self._lock:
            tasks = list(self.in_flight.values())
            self.in_flight.clear()
            return tasks

    def drain_queued(self) -> List[TaskEnvelope]:
        """Recover tasks still sitting in pool inboxes (watchdog path)."""
        drained: List[TaskEnvelope] = []
        for pool in self.pools.values():
            drained.extend(pool.drain_queued())
        return drained

    def running_longer_than(self, seconds: float) -> List[TaskEnvelope]:
        """Straggler candidates: dispatched here and executing for > seconds."""
        now = time.monotonic()
        with self._lock:
            return [
                e
                for e in self.in_flight.values()
                if e.timestamps.exec_start and (now - e.timestamps.exec_start) > seconds
            ]

    # -- internals ----------------------------------------------------------
    def _forward_results(self) -> None:
        """Drain the workers' outbox into ResultBatch frames: block for the
        first result (latency), then sweep whatever else is ready (throughput)
        so the manager pays one queue round-trip per frame, not per result."""
        while self._alive:
            try:
                res = self._outbox.get(timeout=0.02)
            except queue.Empty:
                continue
            results = [res]
            while len(results) < self.result_max_batch:
                try:
                    results.append(self._outbox.get_nowait())
                except queue.Empty:
                    break
            with self._lock:
                for r in results:
                    self.in_flight.pop(r.envelope.task_id, None)
                self.completed += len(results)
            self.metrics.counter("executor.tasks_executed").inc(len(results))
            service_time = self.metrics.histogram("executor.service_time_s")
            for r in results:
                ts = r.envelope.timestamps
                if ts.exec_end and ts.exec_start:
                    service_time.observe(ts.exec_end - ts.exec_start)
            self.result_queue.put(ResultBatch(results=results))

    def _beat_loop(self) -> None:
        while self._alive:
            self.monitor.beat(self.executor_id)
            self.warm_pool.sweep()
            self.maintain()
            time.sleep(self.heartbeat_interval_s)

    def maintain(self, now: Optional[float] = None) -> None:
        """Heartbeat-cadence pool upkeep: shrink idle pools back to their
        floors and publish per-container telemetry."""
        for name, pool in self.pools.items():
            retired = pool.shrink_idle(self.container_keep_alive_s, now=now)
            labels = {"container": name, "executor": self.executor_id}
            if retired:
                self.metrics.counter("container.pool_shrinks").inc(retired)
            self.metrics.gauge("container.pool_size", labels).set(pool.live_workers())
            self.metrics.gauge("container.queue_depth", labels).set(pool.queued())

    # -- lifecycle ------------------------------------------------------------
    def kill(self) -> None:
        """Simulated node failure: heartbeats stop, in-flight results vanish."""
        self._alive = False
        for pool in self.pools.values():
            pool.kill()

    def suspend(self) -> None:
        """Paper: 'suspend executors to prevent further tasks being scheduled
        to failed executors'. Also the first step of an autoscaler drain."""
        self._suspended = True

    def resume(self) -> None:
        """Undo a suspend — the autoscaler resumes an executor when work
        raced its drain attempt (a suspended-but-live executor is healthy)."""
        self._suspended = False

    def shutdown(self) -> None:
        self._alive = False
        for pool in self.pools.values():
            # A worker mid-execution is left to finish and exit on its own
            # (daemon thread): joining it would stall the caller — e.g. the
            # endpoint manager loop releasing a dead block — long enough for
            # the fabric watchdog to declare the whole endpoint dead.
            pool.stop(join=True)
        if self.monitor is not None:
            self.monitor.deregister(self.executor_id)

    def stats(self) -> dict:
        return {
            "executor_id": self.executor_id,
            "workers": self.worker_count(),
            "max_workers": self.max_workers,
            "capabilities": sorted(self.capabilities()),
            "idle": self.idle_workers(),
            "queued": self.queued_tasks(),
            "in_flight": len(self.in_flight),
            "completed": self.completed,
            "warm": self.warm_pool.stats(),
            "containers": {name: p.stats() for name, p in self.pools.items()},
            "accepting": self.accepting(),
        }
