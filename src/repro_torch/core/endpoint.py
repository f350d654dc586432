"""Endpoint: manager + executor pool (paper §5.3–5.4).

The Manager "queues and forwards function execution requests and results,
interacts with resource schedulers, and batches and load balances requests";
it detects failures via heartbeats + a watchdog, re-executes lost tasks,
suspends failed executors, and scales resources through the provider.

Beyond-paper: speculative re-execution of stragglers (p95 × multiplier,
first-result-wins) and warm-affinity scheduling.
"""
from __future__ import annotations

import queue
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .autoscaler import Autoscaler, ScalingObservation, ScalingPolicy
from .containers import CapabilityError, ContainerSpec, default_container_spec
from . import serializer
from .datastore import InMemoryStore, ObjectStore, prefetch_refs, scan_refs
from .executor import Executor
from .futures import TaskEnvelope, TaskFuture, TaskState
from .heartbeat import HeartbeatMonitor, LatencyTracker
from .interchange import ResultBatch, TaskBatch
from .metrics import MetricsRegistry
from .provider import LocalThreadProvider, Provider, ProviderSpec
from .registry import FunctionRegistry
from .scheduler import Scheduler
from .worker import SiteRuntime, TaskResult


class Endpoint:
    def __init__(
        self,
        name: str,
        registry: FunctionRegistry,
        n_executors: int = 1,
        workers_per_executor: int = 4,
        prefetch: int = 0,
        policy: str = "random",
        provider: Optional[Provider] = None,
        heartbeat_interval_s: float = 0.25,
        heartbeat_threshold: float = 2.0,
        elastic: bool = False,
        max_executors: int = 8,
        speculation: bool = False,
        speculation_multiplier: float = 3.0,
        warm_ttl_s: float = 300.0,
        containers: Optional[List[ContainerSpec]] = None,
        container_keep_alive_s: Optional[float] = None,
        tick_s: float = 0.001,
        dispatch_interval_s: float = 0.0,
        result_hook: Optional[Callable[[TaskEnvelope, TaskResult], None]] = None,
        memo_probe: Optional[Callable[[TaskEnvelope], tuple]] = None,
        metrics: Optional[MetricsRegistry] = None,
        scaling_policy: "str | ScalingPolicy" = "queue_depth",
        scale_cooldown_s: float = 30.0,
        scale_step_fraction: float = 0.5,
        target_tasks_per_worker: float = 2.0,
        latency_slo_s: float = 1.0,
        data_cache: Optional[ObjectStore] = None,
    ):
        self.endpoint_id = f"ep-{uuid.uuid4().hex[:8]}"
        self.name = name
        self.registry = registry
        self.workers_per_executor = workers_per_executor
        self.prefetch = prefetch
        self.scheduler = Scheduler(policy)
        self.monitor = HeartbeatMonitor(heartbeat_interval_s, heartbeat_threshold)
        self.heartbeat_interval_s = heartbeat_interval_s
        self.elastic = elastic
        self.speculation = speculation
        self.speculation_multiplier = speculation_multiplier
        self.warm_ttl_s = warm_ttl_s
        # container types every executor on this endpoint hosts; default is
        # the homogeneous seed shape — one fixed-size cpu pool per executor
        self.container_specs: List[ContainerSpec] = (
            list(containers)
            if containers
            else [default_container_spec(workers_per_executor)]
        )
        self.container_keep_alive_s = container_keep_alive_s
        # per-block worker ceiling across hosted pools: what one executor
        # grows to on demand (== workers_per_executor for the default spec)
        self._block_workers = sum(s.max_workers for s in self.container_specs)
        self.tick_s = tick_s
        # simulated manager<->executor RTT: dispatch rounds happen at most
        # this often (0 = in-process, dispatch on every loop iteration)
        self.dispatch_interval_s = dispatch_interval_s
        self.result_hook = result_hook
        self.memo_probe = memo_probe
        self.tracker = LatencyTracker()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # Data fabric locality cache: DataRef payload leaves materialize here
        # at dispatch time, so a dataset shared by N tasks crosses the
        # store->endpoint boundary once. Unregistered (refs never point AT a
        # cache) and endpoint-private.
        self.data_cache: ObjectStore = (
            data_cache
            if data_cache is not None
            else InMemoryStore(
                store_id=f"cache://{self.endpoint_id}", register=False
            )
        )
        # Decoded-value companion to the blob cache: the msgpack decode of a
        # shared blob runs once per endpoint, workers hand out fresh copies
        # (see resolve_payload(decoded=...)). Plain dict — worker threads may
        # race to populate a key, which is harmless.
        self.data_decoded: Dict[str, Any] = {}
        # Endpoint-scoped runtime state for site-aware functions (the serving
        # tier's per-endpoint model hosts). The metrics thunk reads late so
        # hosts see the service registry the endpoint rebinds to.
        self.site = SiteRuntime(
            self.endpoint_id, name, metrics_fn=lambda: self.metrics
        )

        self.result_queue: "queue.Queue[TaskResult]" = queue.Queue()
        self._queue: deque[TaskEnvelope] = deque()
        self._qlock = threading.Lock()
        self.futures: Dict[str, TaskFuture] = {}
        self._flock = threading.Lock()
        self.executors: Dict[str, Executor] = {}
        self._block_of: Dict[str, str] = {}  # executor_id -> provider block_id
        self._exlock = threading.Lock()  # guards executors against fabric-thread readers
        self._speculated: set[str] = set()
        self.completed = 0
        self.requeued = 0
        self.lost_executors = 0

        if provider is None:
            provider = LocalThreadProvider(
                ProviderSpec(
                    min_blocks=min(1, n_executors),
                    init_blocks=n_executors,
                    max_blocks=max(max_executors, n_executors),
                    workers_per_block=self._block_workers,
                )
            )
        self.provider = provider
        if isinstance(provider, LocalThreadProvider):
            provider.bind_factory(self._make_executor)
        provider.scale_out(n_executors)
        # All block-count changes flow through the autoscaler: policy ticks at
        # heartbeat cadence when `elastic`, and the watchdog's replacement
        # path (which releases the dead block before requesting a new one, so
        # repeated failures can never exceed ProviderSpec.max_blocks).
        self.autoscaler = Autoscaler(
            provider=self.provider,
            host=self,
            policy=scaling_policy,
            cooldown_s=scale_cooldown_s,
            step_fraction=scale_step_fraction,
            metrics=self.metrics,
            name=self.endpoint_id,  # unique gauge label, matching forwarder tier
            target_tasks_per_worker=target_tasks_per_worker,
            latency_slo_s=latency_slo_s,
        )

        self._alive = True
        self.last_heartbeat = time.monotonic()
        self._manager = threading.Thread(target=self._manager_loop, name=f"{name}/mgr", daemon=True)
        self._manager.start()

    # -- executor factory (provider blocks -> Executors) -----------------
    def _make_executor(self, block_id: str) -> Executor:
        ex = Executor(
            executor_id=f"{self.name}/{block_id}",
            registry=self.registry,
            result_queue=self.result_queue,
            containers=self.container_specs,
            prefetch=self.prefetch,
            warm_ttl_s=self.warm_ttl_s,
            container_keep_alive_s=self.container_keep_alive_s,
            monitor=self.monitor,
            heartbeat_interval_s=self.heartbeat_interval_s,
            metrics=self.metrics,
        )
        with self._exlock:
            self.executors[ex.executor_id] = ex
            self._block_of[ex.executor_id] = block_id
        return ex

    def bind_metrics(self, metrics: MetricsRegistry) -> None:
        """Adopt a fabric-wide registry (called when this endpoint registers
        with a FunctionService) so service-, endpoint-, and executor-tier
        telemetry share one snapshot surface."""
        self.metrics = metrics
        self.autoscaler.metrics = metrics
        for ex in self._executor_list():
            ex.metrics = metrics
            ex.warm_pool.metrics = metrics

    def _executor_list(self) -> List[Executor]:
        with self._exlock:
            return list(self.executors.values())

    # -- submission --------------------------------------------------------
    def submit(self, env: TaskEnvelope, future: TaskFuture) -> None:
        self.submit_batch(TaskBatch(envelopes=[env], futures=[future]))

    def submit_batch(self, batch: TaskBatch) -> None:
        """Accept a TaskBatch frame: one timestamp read, one futures-map
        update, and one queue extension for the whole frame (vs. one of each
        per task on the unbatched path)."""
        now = time.monotonic()
        for env, future in zip(batch.envelopes, batch.futures):
            env.timestamps.endpoint_in = now
            future.timestamps = env.timestamps
        with self._flock:
            for env, future in zip(batch.envelopes, batch.futures):
                self.futures[env.task_id] = future
        for future in batch.futures:
            future.set_state(TaskState.QUEUED)
        with self._qlock:
            self._queue.extend(batch.envelopes)

    def queue_depth(self) -> int:
        with self._qlock:
            return len(self._queue)

    # -- fabric-facing surface (consumed by the Forwarder) -------------------
    def capacity(self) -> int:
        """Advertised worker capacity: what the endpoint tells the fabric it
        can absorb (sum of per-container worker ceilings across accepting
        executors — pools grow to these on demand)."""
        return sum(ex.max_workers for ex in self._executor_list() if ex.accepting())

    def capabilities(self) -> frozenset:
        """Capability set this endpoint advertises to the fabric: the union
        over its hosted container specs. Spec-derived (static), not
        derived from currently-accepting executors: a transient executor
        outage must let requirement-bearing tasks queue through the
        replacement window exactly like requirement-free ones, not fail
        them with a capability error. The Forwarder routes a task here only
        when its requirements are a subset."""
        caps: frozenset = frozenset()
        for spec in self.container_specs:
            caps |= spec.capabilities
        return caps

    def has_warm(self, key) -> bool:
        """Endpoint-tier warm probe: any accepting executor holds a warm
        executable for (function_id, container)."""
        return any(ex.has_warm(key) for ex in self._executor_list() if ex.accepting())

    def has_data(self, key: str) -> bool:
        """Data-locality probe: is this blob already resident in the
        endpoint's cache? The Forwarder's ``eta_aware`` policy charges a
        transfer cost only for ref bytes that are NOT local."""
        return key in self.data_cache

    def is_alive(self, max_heartbeat_age_s: Optional[float] = None) -> bool:
        if not self._alive:
            return False
        if max_heartbeat_age_s is None:
            return True
        return (time.monotonic() - self.last_heartbeat) <= max_heartbeat_age_s

    # -- manager loop -------------------------------------------------------
    def _manager_loop(self) -> None:
        last_watchdog = 0.0
        last_dispatch = 0.0
        while self._alive:
            self.last_heartbeat = time.monotonic()
            # 1) results (block briefly here — it is the latency-critical path)
            try:
                res = self.result_queue.get(timeout=self.tick_s)
                self._handle_frame(res)
                # opportunistically drain the rest
                while True:
                    try:
                        self._handle_frame(self.result_queue.get_nowait())
                    except queue.Empty:
                        break
            except queue.Empty:
                pass
            # 2) watchdog + elasticity + speculation at heartbeat cadence
            now = time.monotonic()
            if now - last_watchdog >= self.heartbeat_interval_s:
                last_watchdog = now
                self._watchdog()
                if self.elastic:
                    self.autoscaler.tick()
                if self.speculation:
                    self._speculate()
                # labeled by endpoint_id, not name: names are user-chosen and
                # same-named endpoints must not merge into one gauge series
                labels = {"endpoint": self.endpoint_id}
                self.metrics.gauge("endpoint.queue_depth", labels).set(
                    self.queue_depth()
                )
                self.metrics.gauge("endpoint.executors_live", labels).set(
                    sum(1 for e in self._executor_list() if e.accepting())
                )
            # 3) dispatch (rate-limited when simulating a WAN RTT)
            now = time.monotonic()
            if now - last_dispatch >= self.dispatch_interval_s:
                last_dispatch = now
                self._dispatch()

    def _handle_frame(self, frame) -> None:
        """Result intake: executors drain their outboxes into ResultBatch
        frames (futures resolved in one lock acquisition per frame); a bare
        TaskResult (legacy producers) is a frame of one."""
        if isinstance(frame, ResultBatch):
            with self._flock:
                futs = [self.futures.get(r.envelope.task_id) for r in frame]
            for res, fut in zip(frame, futs):
                self._handle_result(res, fut)
        else:
            self._handle_result(frame)

    def _handle_result(self, res: TaskResult, fut: Optional[TaskFuture] = None) -> None:
        env = res.envelope
        if fut is None:
            with self._flock:
                fut = self.futures.get(env.task_id)
        if fut is None:
            return
        if res.error is not None:
            if env.retries < env.max_retries:
                self.requeued += 1
                self.metrics.counter("endpoint.tasks_requeued").inc()
                retry = env.clone_for_retry()
                with self._flock:
                    self.futures[retry.task_id] = fut
                with self._qlock:
                    self._queue.appendleft(retry)
            else:
                self._speculated.discard(env.speculative_of or env.task_id)
                if not fut.set_exception(res.exception or RuntimeError(res.error)):
                    # the future already resolved (speculative copy, replayed
                    # frame, cancelled client): exactly-once held, count it
                    self.metrics.counter("journal.duplicate_results").inc()
            return
        # prune straggler bookkeeping once either copy delivers (the set
        # otherwise grows without bound under long-running speculation)
        self._speculated.discard(env.speculative_of or env.task_id)
        won = fut.set_result(res.value)
        if not won:
            # a second completion for an already-resolved future (speculation
            # loser, duplicated/replayed ResultBatch delivery): dedupe to
            # exactly-once resolution and count the duplicate
            self.metrics.counter("journal.duplicate_results").inc()
        if won:
            self.completed += 1
            self.metrics.counter("endpoint.tasks_completed").inc()
            ts = env.timestamps
            if ts.exec_end and ts.endpoint_in:
                self.tracker.record(ts.exec_end - ts.endpoint_in)
            if self.result_hook is not None:
                try:
                    self.result_hook(env, res)
                except Exception:
                    pass

    def _dispatch(self) -> None:
        """Capacity-pulled batch dispatch (paper §5.3/§5.5): each round picks
        an executor for the queue head, then hands it a batch sized to its
        ``free_capacity()`` advertisement (idle workers + prefetch) in one
        pull — instead of re-running the scheduler and re-taking every lock
        once per task."""
        while True:
            with self._qlock:
                if not self._queue:
                    return
                head = self._queue[0]
            executors = self._executor_list()
            ex = self.scheduler.choose(executors, head)
            if ex is None:
                accepting = any(e.accepting() for e in executors)
                if accepting and not self.scheduler.capable(executors, head):
                    # Live pools exist but none can ever run this task: fail
                    # it fast with a capability error instead of letting it
                    # pin the queue head until a watchdog timeout. (The
                    # Forwarder filters on advertised capabilities, so this
                    # is the defense-in-depth for specs changing between
                    # routing and dispatch.) With no accepting executor at
                    # all the task stays queued — executor replacement or
                    # fabric-level failover owns that case.
                    self._fail_incapable(head)
                    continue
                return  # capable executors exist but none has capacity now
            want = max(1, ex.free_capacity_for(head))
            with self._qlock:
                if not self._queue or self._queue[0] is not head:
                    continue
                chunk = [self._queue.popleft()]
                # extend the batch only with tasks this executor can run;
                # the first incompatible task ends the chunk and leads the
                # next dispatch round (which picks its own executor)
                while (
                    len(chunk) < want
                    and self._queue
                    and ex.can_run(self._queue[0])
                ):
                    chunk.append(self._queue.popleft())
            now = time.monotonic()
            dispatch_latency = self.metrics.histogram("endpoint.dispatch_latency_s")
            ready: List[TaskEnvelope] = []
            for env in chunk:
                # queue-time memoization: a result computed while this task
                # waited serves it without dispatch (paper Table 3)
                if env.memoize and self.memo_probe is not None:
                    hit, value = self.memo_probe(env)
                    if hit:
                        with self._flock:
                            fut = self.futures.get(env.task_id)
                        if fut is not None and fut.set_result(value, TaskState.MEMOIZED):
                            self.completed += 1
                        continue
                # data fabric: pull every blob the payload references into
                # the site-local cache (one store read per NEW key — raw
                # bytes only, nothing is unpacked or repacked on this serial
                # loop). Workers then materialize values in parallel from
                # the warmed cache via the env.data_cache handle.
                if env.data_refs and isinstance(env.payload, (bytes, bytearray)):
                    try:
                        payload = serializer.unpackb(env.payload)
                        prefetch_refs(
                            scan_refs(payload), self.data_cache,
                            metrics=self.metrics,
                        )
                        env.payload = payload
                        env.data_cache = self.data_cache
                        env.data_decoded = self.data_decoded
                    except Exception as exc:
                        with self._flock:
                            fut = self.futures.get(env.task_id)
                        if fut is not None:
                            fut.set_exception(
                                KeyError(
                                    f"task {env.task_id}: payload data "
                                    f"unresolvable at {self.name!r}: {exc}"
                                )
                            )
                        continue
                env.timestamps.dispatched = now
                if env.timestamps.endpoint_in:
                    dispatch_latency.observe(now - env.timestamps.endpoint_in)
                env.site = self.site  # where this attempt runs (site-aware fns)
                ready.append(env)
            if not ready:
                continue
            with self._flock:
                futs = [self.futures.get(env.task_id) for env in ready]
            for fut in futs:
                if fut is not None:
                    fut.set_state(TaskState.DISPATCHED)
            ex.submit_batch(ready)

    def _fail_incapable(self, head: TaskEnvelope) -> None:
        """Pop `head` and fail its future with a capability error: no hosted
        container pool provides its required capabilities."""
        with self._qlock:
            if not self._queue or self._queue[0] is not head:
                return
            self._queue.popleft()
        self.metrics.counter("container.capability_misses").inc()
        with self._flock:
            fut = self.futures.pop(head.task_id, None)
        if fut is not None:
            fut.set_exception(
                CapabilityError(
                    f"endpoint {self.name!r} has no container pool providing "
                    f"{sorted(head.requirements)} for task {head.task_id} "
                    f"(advertising {sorted(self.capabilities())})"
                )
            )

    def _watchdog(self) -> None:
        for eid in self.monitor.dead():
            with self._exlock:
                ex = self.executors.get(eid)
            self.monitor.suspend(eid)
            self.lost_executors += 1
            self.metrics.counter("endpoint.executors_lost").inc()
            if ex is None:
                continue
            ex.suspend()
            lost = ex.take_in_flight()
            # also recover tasks sitting in the dead executor's pool queues
            lost.extend(ex.drain_queued())
            for env in lost:
                with self._flock:
                    fut = self.futures.get(env.task_id)
                if fut is None or fut.done():
                    continue
                if env.retries < env.max_retries:
                    fut.set_state(TaskState.LOST)
                    retry = env.clone_for_retry()
                    with self._flock:
                        self.futures[retry.task_id] = fut
                    with self._qlock:
                        self._queue.appendleft(retry)
                    self.requeued += 1
                else:
                    fut.set_exception(RuntimeError(f"task lost with executor {eid}"))
            with self._exlock:
                del self.executors[eid]
                dead_block = self._block_of.pop(eid, None)
            if self.elastic:
                # Replacement flows through the autoscaler: the dead block is
                # released from the provider before a new one is requested, so
                # repeated failures cannot leak blocks past max_blocks.
                self.autoscaler.replace_block(dead_block)
            elif dead_block is not None:
                # Non-elastic: no replacement, but forget the corpse so the
                # provider's block count stays honest. release(), not
                # scale_in(): a false-positive death must leave the executor
                # running so its late result can still resolve the future.
                self.provider.release([dead_block])

    # -- autoscaler host protocol (see core/autoscaler.py) -------------------
    def observe(self) -> ScalingObservation:
        """One heartbeat's load observation for the scaling policy."""
        executors = self._executor_list()
        accepting = [e for e in executors if e.accepting()]
        return ScalingObservation(
            queue_depth=self.queue_depth(),
            # in_flight covers inbox-queued tasks too (submit_batch books a
            # task before the worker pulls it), so count it alone
            outstanding=sum(len(e.in_flight) for e in accepting),
            blocks=len(accepting),
            # ceiling across hosted container specs, not the default-spec
            # knob: with custom containers a block grows past
            # workers_per_executor and the policy must size against that
            workers_per_block=self._block_workers,
            p95_latency_s=self.tracker.p95(),
        )

    def select_idle_block(self) -> Optional[tuple]:
        """A (block_id, executor) scale-in candidate with no queued or
        in-flight work, or None. The autoscaler suspends it, re-verifies
        emptiness, and either releases the block or resumes the executor."""
        with self._exlock:
            items = list(self.executors.items())
            block_of = dict(self._block_of)
        for eid, ex in items:
            if not ex.accepting():
                continue
            if len(ex.in_flight) or ex.queued_tasks():
                continue
            block_id = block_of.get(eid)
            if block_id is not None:
                return block_id, ex
        return None

    def release_block(self, block_id: str) -> None:
        """Drop the executor backing `block_id` from the dispatch tables and
        release the block at the provider (which shuts the executor down)."""
        with self._exlock:
            eid = next(
                (e for e, b in self._block_of.items() if b == block_id), None
            )
            if eid is not None:
                self.executors.pop(eid, None)
                self._block_of.pop(eid, None)
        self.provider.scale_in([block_id])

    def _speculate(self) -> None:
        p95 = self.tracker.p95()
        if p95 is None:
            return
        limit = p95 * self.speculation_multiplier
        for ex in self._executor_list():
            for env in ex.running_longer_than(limit):
                if env.task_id in self._speculated or env.speculative_of:
                    continue
                self._speculated.add(env.task_id)
                # shares the primary's payload object outright — duplicating
                # a straggler must not duplicate its (possibly large) payload
                dup = env.clone_speculative("#spec")
                with self._flock:
                    fut = self.futures.get(env.task_id)
                    if fut is None or fut.done():
                        continue
                    self.futures[dup.task_id] = fut
                with self._qlock:
                    self._queue.appendleft(dup)

    # -- fault injection ----------------------------------------------------
    def kill_executor(self, index: int = 0) -> str:
        """Hard-kill the index-th executor (Fig. 7 fault experiment)."""
        with self._exlock:
            eid = sorted(self.executors)[index]
            ex = self.executors[eid]
        ex.kill()
        return eid

    def kill(self) -> None:
        """Simulated whole-endpoint death (site outage): the manager loop
        halts, heartbeats stop, and every executor dies with its in-flight
        work. The Forwarder's watchdog re-routes stranded tasks."""
        self._alive = False
        for ex in self._executor_list():
            ex.kill()

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        self._alive = False
        self._manager.join(timeout=2.0)
        for ex in self._executor_list():
            ex.shutdown()
        with self._exlock:
            self.executors.clear()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Wait until queue and all executors are drained."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            busy = self.queue_depth() or any(
                len(e.in_flight) or e.queued_tasks() for e in self._executor_list()
            )
            if not busy:
                return True
            time.sleep(0.005)
        return False

    def stats(self) -> dict:
        return {
            "endpoint_id": self.endpoint_id,
            "name": self.name,
            "queue_depth": self.queue_depth(),
            "completed": self.completed,
            "requeued": self.requeued,
            "lost_executors": self.lost_executors,
            "executors": {ex.executor_id: ex.stats() for ex in self._executor_list()},
            "p95_latency_s": self.tracker.p95(),
            "autoscaler": self.autoscaler.stats(),
        }
