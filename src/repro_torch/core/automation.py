"""Workflow automation: DAG engine + event triggers (paper §5.6, §7).

funcX exposes start/cancel/status endpoints so automation platforms (Globus
Automate) can run functions as flow steps, and the paper's five §7 science
scenarios are all multi-step pipelines "triggered by events (e.g., arrival of
new data)". This module provides that layer on top of the fabric:

- :class:`Workflow` — a DAG of :class:`WorkflowNode`\\ s. Nodes declare
  upstream dependencies and receive the merged upstream results; every node
  that becomes ready in the same scheduling round is submitted through
  :meth:`FunctionService.run_many` as ONE batch, so sibling branches ride a
  single TaskBatch frame through the Forwarder. Scheduling is iterative
  (a drain-loop driver, never recursion through done-callbacks), supports
  per-node retry (`max_attempts`) and on-error policies (`fail` / `skip`),
  and passes warm-affinity hints so a node's children prefer the endpoint
  holding the parent's warm function.
- :class:`EventBus` / :class:`Trigger` — publish/subscribe event routing with
  :class:`DataArrivalEvent` and :class:`TimerEvent` sources; a Trigger rule
  starts one workflow run per matching event (the "arrival of new data"
  pattern).
- :class:`Flow` — the original linear ActionProvider surface, kept as a thin
  shim over :class:`Workflow` so existing callers keep working.

Metrics (recorded in the service's fabric registry): ``workflow.runs``
(counter, labeled ``state=started|succeeded|failed|cancelled``),
``workflow.nodes_completed``, ``workflow.node_retries``,
``workflow.node_latency_s`` (histogram), ``trigger.fired`` (counter, labeled
by trigger name). See docs/workflows.md.
"""
from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import serializer
from .auth import Token
from .futures import TaskFuture
from .journal import RunJournalEntry
from .metrics import MetricsRegistry
from .service import FunctionService, Invocation

# Run / node terminal states are plain strings (REST-shaped, like the paper's
# ActionProvider status document).
ACTIVE, SUCCEEDED, FAILED, CANCELLED = "ACTIVE", "SUCCEEDED", "FAILED", "CANCELLED"
PENDING, RUNNING, SKIPPED = "PENDING", "RUNNING", "SKIPPED"

ON_ERROR_POLICIES = ("fail", "skip")


@dataclass
class WorkflowNode:
    """One DAG node: run `function_id` once every upstream dep has finished.

    ``prepare(document, upstream)`` maps the run's initial document plus the
    dict of upstream results (``{dep_name: result}``) to this node's payload.
    Default when omitted: no deps → the document; one dep → that dep's
    result; several deps → the upstream dict itself (fan-in merge).

    ``max_attempts`` is workflow-level retry (re-submission through the
    service); ``max_retries`` is the transport-level retry the endpoint
    applies before the failure ever reaches the workflow. ``on_error="skip"``
    records ``fallback`` as the node's result and lets downstream nodes
    proceed; ``"fail"`` (default) fails the whole run.
    """

    name: str
    function_id: str
    deps: Sequence[str] = ()
    prepare: Optional[Callable[[Any, Dict[str, Any]], Any]] = None
    endpoint_id: Optional[str] = None
    container: str = "default"
    requirements: Optional[Sequence[str]] = None  # capability override (None = function's)
    memoize: bool = False
    max_attempts: int = 1
    max_retries: int = 2
    on_error: str = "fail"
    fallback: Any = None

    def __post_init__(self) -> None:
        if self.on_error not in ON_ERROR_POLICIES:
            raise ValueError(
                f"node {self.name!r}: on_error {self.on_error!r} not in {ON_ERROR_POLICIES}"
            )
        if self.max_attempts < 1:
            raise ValueError(f"node {self.name!r}: max_attempts must be >= 1")

    def payload_for(self, document: Any, upstream: Dict[str, Any]) -> Any:
        if self.prepare is not None:
            return self.prepare(document, upstream)
        if not self.deps:
            return document
        if len(self.deps) == 1:
            return upstream[self.deps[0]]
        return dict(upstream)


class WorkflowRun:
    """State of one workflow execution. All mutation happens under ``_lock``;
    progression is driven by the owning :class:`Workflow`'s drain loop."""

    def __init__(self, workflow: "Workflow", document: Any,
                 metrics: Optional[MetricsRegistry] = None):
        self.run_id = f"wfrun-{uuid.uuid4().hex[:8]}"
        self.workflow = workflow
        self.document = document
        self.state = ACTIVE
        self.node_states: Dict[str, str] = {n: PENDING for n in workflow.nodes}
        self.results: Dict[str, Any] = {}
        self.node_endpoint: Dict[str, Optional[str]] = {}
        self.attempts: Dict[str, int] = {n: 0 for n in workflow.nodes}
        self.error: Optional[str] = None
        self.history: List[dict] = []
        self.inflight: Dict[str, Tuple[TaskFuture, Callable]] = {}
        self._indegree: Dict[str, int] = {
            n: len(node.deps) for n, node in workflow.nodes.items()
        }
        self._remaining = len(workflow.nodes)
        self._events: deque = deque()
        self._lock = threading.RLock()
        self._draining = False
        self._done = threading.Event()
        self._metrics = metrics
        self._journal = None  # bound by Workflow.start/resume when durable

    # -- consumer surface --------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def output(self) -> Any:
        """Merged result of the DAG's sink nodes (single sink → its bare
        result; several sinks → ``{name: result}``)."""
        sinks = self.workflow.sinks
        with self._lock:
            if len(sinks) == 1:
                return self.results.get(sinks[0])
            return {name: self.results.get(name) for name in sinks}

    def wait(self, timeout: float = 60.0) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(f"workflow run {self.run_id} still active")
        if self.state == FAILED:
            raise RuntimeError(f"workflow run {self.run_id} failed: {self.error}")
        if self.state == CANCELLED:
            raise RuntimeError(f"workflow run {self.run_id} was cancelled")
        return self.output()

    def status(self) -> dict:
        with self._lock:
            return {
                "run_id": self.run_id,
                "workflow": self.workflow.name,
                "state": self.state,
                "nodes": dict(self.node_states),
                "error": self.error,
                "history": list(self.history),
            }

    def cancel(self) -> None:
        """Cancel the run: nothing further launches, and every in-flight
        future is detached — its task may still finish on the endpoint, but
        its completion no longer drives this run."""
        with self._lock:
            if self.state != ACTIVE:
                return
            self.state = CANCELLED
            inflight = list(self.inflight.items())
            self.inflight.clear()
            for name, st in self.node_states.items():
                if st in (PENDING, RUNNING):
                    self.node_states[name] = CANCELLED
            self._events.clear()
        for _, (fut, cb) in inflight:
            fut.remove_done_callback(cb)
        if self._journal is not None:  # a cancelled run must not resume
            self._journal.append(
                "run", "finished", run_id=self.run_id, state=CANCELLED
            )
        if self._metrics is not None:
            self._metrics.counter("workflow.runs", {"state": "cancelled"}).inc()
        self._done.set()


class Workflow:
    """A DAG of :class:`WorkflowNode`\\ s, validated at construction
    (unique names, known deps, acyclic). A Workflow is stateless across
    runs — the same instance can drive many concurrent :class:`WorkflowRun`\\ s.
    """

    def __init__(self, nodes: Sequence[WorkflowNode], name: str = "workflow"):
        self.name = name
        self.nodes: Dict[str, WorkflowNode] = {}
        for node in nodes:
            if node.name in self.nodes:
                raise ValueError(f"duplicate node name {node.name!r}")
            self.nodes[node.name] = node
        self.children: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for node in nodes:
            for dep in node.deps:
                if dep not in self.nodes:
                    raise ValueError(
                        f"node {node.name!r} depends on unknown node {dep!r}"
                    )
                self.children[dep].append(node.name)
        self._order = self._toposort()
        self.sinks: List[str] = [n for n in self._order if not self.children[n]]

    def _toposort(self) -> List[str]:
        indeg = {n: len(node.deps) for n, node in self.nodes.items()}
        frontier = deque(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while frontier:
            n = frontier.popleft()
            order.append(n)
            for child in self.children[n]:
                indeg[child] -= 1
                if indeg[child] == 0:
                    frontier.append(child)
        if len(order) != len(self.nodes):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(f"workflow has a dependency cycle through {cyclic}")
        return order

    def topological_order(self) -> List[str]:
        return list(self._order)

    # -- ActionProvider interface: start / status / cancel -----------------
    def start(
        self,
        service: FunctionService,
        document: Any = None,
        token: Optional[Token] = None,
    ) -> WorkflowRun:
        run = WorkflowRun(self, document, metrics=service.metrics)
        run._journal = service.journal
        service.metrics.counter("workflow.runs", {"state": "started"}).inc()
        if service.journal is not None:
            try:
                packed_doc = serializer.packb(document)
            except Exception:
                packed_doc = None  # unserializable document: run not resumable
            service.journal.append(
                "run", "started", run_id=run.run_id, workflow=self.name,
                document=packed_doc, nodes=list(self._order),
            )
        if not self.nodes:
            run.state = SUCCEEDED
            run._done.set()
            service.metrics.counter("workflow.runs", {"state": "succeeded"}).inc()
            if service.journal is not None:
                service.journal.append(
                    "run", "finished", run_id=run.run_id, state=SUCCEEDED
                )
            return run
        ready = [n for n in self._order if not self.nodes[n].deps]
        # reraise: a submission error in the caller's own start() frame
        # (unknown function, bad token) surfaces synchronously, exactly as
        # the seed Flow did — only callback-thread resubmissions may not throw
        self._submit(service, run, ready, token, reraise=True)
        return run

    @staticmethod
    def status(run: WorkflowRun) -> dict:
        return run.status()

    @staticmethod
    def cancel(run: WorkflowRun) -> None:
        run.cancel()

    @staticmethod
    def wait(run: WorkflowRun, timeout: float = 60.0) -> Any:
        return run.wait(timeout)

    # -- durability --------------------------------------------------------
    def resume(
        self,
        service: FunctionService,
        entry: RunJournalEntry,
        token: Optional[Token] = None,
    ) -> WorkflowRun:
        """Rehydrate a journaled run and re-execute ONLY its unfinished
        nodes. Committed node results (and skips) are replayed into the run
        verbatim; everything whose dependencies are thereby satisfied is
        re-submitted. Usually reached through
        :meth:`FunctionService.resume`, which matches journal entries to
        workflow definitions by name."""
        document = (
            serializer.unpackb(entry.document)
            if entry.document is not None else None
        )
        run = WorkflowRun(self, document, metrics=service.metrics)
        run.run_id = entry.run_id  # identity survives the restart
        run._journal = service.journal
        service.metrics.counter("workflow.runs", {"state": "resumed"}).inc()
        with run._lock:
            for name, packed in entry.node_results.items():
                if name not in self.nodes:
                    continue  # journal from an older definition of this DAG
                if entry.node_skipped.get(name):
                    run.results[name] = self.nodes[name].fallback
                    run.node_states[name] = SKIPPED
                elif packed is not None:
                    run.results[name] = serializer.unpackb(packed)
                    run.node_states[name] = SUCCEEDED
                else:
                    continue  # completed but result not journaled: re-run
                run.history.append({
                    "node": name, "state": run.node_states[name],
                    "attempt": 0, "replayed": True,
                })
                self._advance_children(run, name)
            ready = [
                n for n in self._order
                if run.node_states[n] == PENDING and run._indegree[n] == 0
            ]
            finished = run._remaining == 0
        if service.journal is not None:
            service.journal.append("run", "resumed", run_id=run.run_id)
        if finished:
            self._finish(service, run, SUCCEEDED)
        else:
            self._submit(service, run, ready, token)
        return run

    # -- scheduler ---------------------------------------------------------
    def _submit(
        self,
        service: FunctionService,
        run: WorkflowRun,
        names: Sequence[str],
        token: Optional[Token],
        reraise: bool = False,
    ) -> None:
        """Submit every node in `names` as ONE heterogeneous batch (sibling
        branches ride a single TaskBatch frame through the Forwarder)."""
        invocations: List[Invocation] = []
        submit_names: List[str] = []
        for name in names:
            node = self.nodes[name]
            with run._lock:
                if run.state != ACTIVE:
                    return
                upstream = {dep: run.results.get(dep) for dep in node.deps}
                document = run.document
                run.attempts[name] += 1
                run.node_states[name] = RUNNING
                # warm-affinity hint: prefer the endpoint that just ran a
                # parent (it holds the warm executable for the lineage)
                hint = None
                for dep in node.deps:
                    hint = run.node_endpoint.get(dep) or hint
            try:
                payload = node.payload_for(document, upstream)
            except Exception as exc:  # prepare() itself failed
                run._events.append(("failed", name, exc))
                continue
            invocations.append(
                Invocation(
                    function_id=node.function_id,
                    payload=payload,
                    endpoint_id=node.endpoint_id,
                    container=node.container,
                    requirements=node.requirements,
                    memoize=node.memoize,
                    max_retries=node.max_retries,
                    affinity_hint=None if node.endpoint_id else hint,
                    owner=run.run_id,  # durability: this run re-drives the node
                )
            )
            submit_names.append(name)
        if invocations:
            try:
                futures = service.run_many(invocations, token=token)
            except Exception as exc:
                # a submission error (unknown function, auth failure) must
                # fail the run, not escape through the completion-callback
                # chain into whatever thread drove the parent's result
                with run._lock:
                    if run.state != ACTIVE:
                        return
                    for name in submit_names:
                        run.node_states[name] = FAILED
                        run.history.append({
                            "node": name,
                            "state": FAILED,
                            "attempt": run.attempts[name],
                            "error": repr(exc),
                        })
                    run.error = f"submission of {submit_names} failed: {exc!r}"
                self._finish(service, run, FAILED)
                if reraise:
                    raise
                return
            for name, fut in zip(submit_names, futures):
                def _cb(f: TaskFuture, name: str = name) -> None:
                    run._events.append(("done", name, f))
                    self._drain(service, run, token)

                with run._lock:
                    run.inflight[name] = (fut, _cb)
                fut.add_done_callback(_cb)
        self._drain(service, run, token)

    def _drain(
        self,
        service: FunctionService,
        run: WorkflowRun,
        token: Optional[Token],
    ) -> None:
        """Iterative event processor: the first caller becomes the driver and
        consumes the event queue to exhaustion; concurrent completions merely
        enqueue. Deep chains therefore advance in a flat loop — completion
        callbacks never recurse into submission into completion (the seed
        ``Flow._advance`` stack-overflowed on memoized 1000-step chains)."""
        with run._lock:
            if run._draining:
                return
            run._draining = True
        try:
            while True:
                with run._lock:
                    if not run._events:
                        run._draining = False
                        return
                    kind, name, obj = run._events.popleft()
                if kind == "done":
                    exc = obj.exception(0)
                    if exc is None:
                        self._node_succeeded(service, run, name, obj, token)
                    else:
                        self._node_failed(service, run, name, exc, token, obj)
                else:  # "failed": prepare() raised, no future exists
                    self._node_failed(service, run, name, obj, token, None)
        except BaseException:
            with run._lock:
                run._draining = False
            raise

    def _node_succeeded(
        self,
        service: FunctionService,
        run: WorkflowRun,
        name: str,
        future: TaskFuture,
        token: Optional[Token],
    ) -> None:
        ts = future.timestamps
        with run._lock:
            if run.state != ACTIVE:
                return
            run.inflight.pop(name, None)
            run.results[name] = future.result(0)
            run.node_states[name] = SUCCEEDED
            run.node_endpoint[name] = future.endpoint_id
            run.history.append({
                "node": name,
                "state": SUCCEEDED,
                "task_id": future.task_id,
                "attempt": run.attempts[name],
                "endpoint": future.endpoint_id,
                "latency": future.latency_breakdown(),
            })
            ready = self._advance_children(run, name)
            finished = run._remaining == 0
        if service.journal is not None:
            try:
                packed = serializer.packb(future.result(0))
            except Exception:
                packed = None  # unserializable: the node re-runs on resume
            if packed is not None:
                service.journal.append(
                    "run", "node_completed", run_id=run.run_id,
                    node=name, result=packed,
                )
        service.metrics.counter("workflow.nodes_completed").inc()
        if ts.result_ready and ts.client_submit:
            service.metrics.histogram("workflow.node_latency_s").observe(
                ts.result_ready - ts.client_submit
            )
        if finished:
            self._finish(service, run, SUCCEEDED)
        elif ready:
            self._submit(service, run, ready, token)

    def _node_failed(
        self,
        service: FunctionService,
        run: WorkflowRun,
        name: str,
        exc: BaseException,
        token: Optional[Token],
        future: Optional[TaskFuture],
    ) -> None:
        node = self.nodes[name]
        with run._lock:
            if run.state != ACTIVE:
                return
            run.inflight.pop(name, None)
            attempts = run.attempts[name]
            retry = future is not None and attempts < node.max_attempts
            run.history.append({
                "node": name,
                "state": "RETRYING" if retry else (
                    SKIPPED if node.on_error == "skip" else FAILED
                ),
                "attempt": attempts,
                "error": repr(exc),
            })
            if retry:
                run.node_states[name] = PENDING
            elif node.on_error == "skip":
                run.results[name] = node.fallback
                run.node_states[name] = SKIPPED
                ready = self._advance_children(run, name)
                finished = run._remaining == 0
            else:
                run.node_states[name] = FAILED
                run.error = f"node {name!r}: {exc!r}"
        if retry:
            service.metrics.counter("workflow.node_retries").inc()
            self._submit(service, run, [name], token)
        elif node.on_error == "skip":
            if service.journal is not None:
                service.journal.append(
                    "run", "node_skipped", run_id=run.run_id, node=name
                )
            if finished:
                self._finish(service, run, SUCCEEDED)
            elif ready:
                self._submit(service, run, ready, token)
        else:
            self._finish(service, run, FAILED)

    def _advance_children(self, run: WorkflowRun, name: str) -> List[str]:
        """Bookkeeping after a node reaches a downstream-visible terminal
        state. Must be called with ``run._lock`` held. Returns newly-ready
        children in topological order."""
        run._remaining -= 1
        ready = []
        for child in self.children[name]:
            run._indegree[child] -= 1
            if run._indegree[child] == 0:
                ready.append(child)
        return ready

    def _finish(self, service: FunctionService, run: WorkflowRun, state: str) -> None:
        with run._lock:
            if run.state != ACTIVE:
                return
            run.state = state
            inflight = list(run.inflight.items())
            run.inflight.clear()
            run._events.clear()
        for _, (fut, cb) in inflight:  # a failed run detaches its survivors
            fut.remove_done_callback(cb)
        if service.journal is not None:
            service.journal.append(
                "run", "finished", run_id=run.run_id, state=state
            )
        service.metrics.counter(
            "workflow.runs", {"state": state.lower()}
        ).inc()
        run._done.set()


# --------------------------------------------------------------------------
# Event subsystem: bus, sources, triggers
# --------------------------------------------------------------------------
class Event:
    """Base event: a topic plus an arbitrary data payload."""

    topic = "event"

    def __init__(self, data: Any = None):
        self.data = data
        self.created = time.monotonic()

    def document(self) -> Any:
        """What a triggered workflow run receives as its initial document."""
        return self.data

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(topic={self.topic!r})"


class DataArrivalEvent(Event):
    """New data landed somewhere (the paper's 'arrival of new data' pattern:
    a detector wrote a frame, a transfer completed, a file appeared)."""

    topic = "data.arrival"

    def __init__(self, source: str, item: Any = None, metadata: Optional[dict] = None):
        super().__init__(data=item)
        self.source = source
        self.item = item
        self.metadata = metadata or {}

    def document(self) -> Any:
        return {"source": self.source, "item": self.item, "metadata": self.metadata}


class TimerEvent(Event):
    """Periodic tick from a :class:`TimerSource` (cron-style triggering)."""

    topic = "timer"

    def __init__(self, tick: int, period_s: float):
        super().__init__(data={"tick": tick, "period_s": period_s})
        self.tick = tick
        self.period_s = period_s


class EventBus:
    """Topic-keyed publish/subscribe. Dispatch is synchronous in the
    publisher's thread (sources that need isolation publish from their own
    thread, e.g. :class:`TimerSource`); a handler exception never prevents
    delivery to the remaining subscribers, but is never silent either —
    ``errors``/``last_error`` record it (plus an ``eventbus.handler_errors``
    counter when a metrics registry is attached)."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self._subs: Dict[str, List[Callable[[Event], Any]]] = {}
        self._lock = threading.Lock()
        self.metrics = metrics
        self.published = 0
        self.errors = 0
        self.last_error: Optional[BaseException] = None

    def subscribe(self, topic: str, handler: Callable[[Event], Any]) -> Callable:
        with self._lock:
            self._subs.setdefault(topic, []).append(handler)
        return handler

    def unsubscribe(self, topic: str, handler: Callable[[Event], Any]) -> None:
        with self._lock:
            handlers = self._subs.get(topic, [])
            if handler in handlers:
                handlers.remove(handler)

    def attach(self, trigger: "Trigger") -> "Trigger":
        """Bind a trigger rule to its topic."""
        self.subscribe(trigger.topic, trigger.handle)
        return trigger

    def detach(self, trigger: "Trigger") -> None:
        self.unsubscribe(trigger.topic, trigger.handle)

    def publish(self, event: Event) -> int:
        """Deliver `event` to every subscriber of its topic; returns the
        number of handlers invoked."""
        with self._lock:
            handlers = list(self._subs.get(event.topic, ()))
            self.published += 1
        for handler in handlers:
            try:
                handler(event)
            except Exception as exc:  # noqa: BLE001 - one bad rule must not mute the rest
                with self._lock:
                    self.errors += 1
                    self.last_error = exc
                if self.metrics is not None:
                    self.metrics.counter("eventbus.handler_errors").inc()
        return len(handlers)


class TimerSource:
    """Publishes a :class:`TimerEvent` on `bus` every `period_s` seconds
    until stopped."""

    def __init__(self, bus: EventBus, period_s: float, max_ticks: Optional[int] = None):
        self.bus = bus
        self.period_s = period_s
        self.max_ticks = max_ticks
        self.ticks = 0
        self._halt = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="automation/timer", daemon=True
        )

    def start(self) -> "TimerSource":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._halt.wait(self.period_s):
            self.ticks += 1
            self.bus.publish(TimerEvent(self.ticks, self.period_s))
            if self.max_ticks is not None and self.ticks >= self.max_ticks:
                return

    def stop(self) -> None:
        self._halt.set()
        self._thread.join(timeout=2.0)


class Trigger:
    """An event→workflow rule: when a matching event arrives, start one
    workflow run with a document built from the event.

    `build_document` maps the event to the run's initial document (default:
    ``event.document()``); `predicate` optionally filters events; `once=True`
    disarms the trigger after its first firing. `fired` counts firings;
    `runs` retains recent runs, pruning *completed* ones beyond `keep_runs`
    oldest-first so a long-lived trigger (a 1 Hz timer left running for days)
    cannot grow memory without bound — in-flight runs are never dropped.
    """

    def __init__(
        self,
        workflow: Workflow,
        service: FunctionService,
        topic: str = DataArrivalEvent.topic,
        name: str = "trigger",
        build_document: Optional[Callable[[Event], Any]] = None,
        predicate: Optional[Callable[[Event], bool]] = None,
        token: Optional[Token] = None,
        once: bool = False,
        keep_runs: int = 256,
    ):
        self.workflow = workflow
        self.service = service
        self.topic = topic
        self.name = name
        self.build_document = build_document
        self.predicate = predicate
        self.token = token
        self.once = once
        self.keep_runs = keep_runs
        self.fired = 0
        self.runs: List[WorkflowRun] = []
        self._lock = threading.Lock()

    def handle(self, event: Event) -> Optional[WorkflowRun]:
        if self.predicate is not None and not self.predicate(event):
            return None
        # the lock guards only the once/fired decision: starting the workflow
        # may drive an entire memoized DAG synchronously, and a node that
        # publishes back onto the bus must not deadlock on re-entry
        with self._lock:
            if self.once and self.fired:
                return None
            self.fired += 1
        document = (
            self.build_document(event)
            if self.build_document is not None
            else event.document()
        )
        run = self.workflow.start(self.service, document, token=self.token)
        with self._lock:
            self.runs.append(run)
            if len(self.runs) > self.keep_runs:
                self.runs = (
                    [r for r in self.runs[:-self.keep_runs] if not r.done()]
                    + self.runs[-self.keep_runs:]
                )
        self.service.metrics.counter("trigger.fired", {"trigger": self.name}).inc()
        return run


# --------------------------------------------------------------------------
# Linear Flow shim (the original §5.6 ActionProvider surface)
# --------------------------------------------------------------------------
@dataclass
class ActionStep:
    function_id: str
    endpoint_id: Optional[str] = None
    # maps the flow document -> this step's payload (default: identity)
    prepare: Callable[[Any], Any] = lambda doc: doc
    # merges the step result back into the flow document (default: replace)
    merge: Callable[[Any, Any], Any] = lambda doc, result: result
    memoize: bool = False
    name: str = ""


@dataclass
class FlowRun:
    """Linear-flow view over a :class:`WorkflowRun` (kept API-compatible with
    the original dataclass: state / step_index / document / history /
    current)."""

    flow_id: str
    flow: "Flow"
    inner: WorkflowRun
    _doc: Dict[str, Any] = field(default_factory=dict)
    _final_merged: bool = False

    @property
    def state(self) -> str:
        return self.inner.state

    @property
    def step_index(self) -> int:
        with self.inner._lock:
            return sum(
                1 for s in self.inner.node_states.values() if s == SUCCEEDED
            )

    @property
    def document(self) -> Any:
        # the last step's merge has no downstream prepare() to apply it, so
        # it lands lazily once the run has succeeded (under the run lock:
        # concurrent readers must not apply a non-idempotent merge twice)
        with self.inner._lock:
            if self.inner.state == SUCCEEDED and not self._final_merged:
                last = self.flow.steps[-1]
                self._doc["doc"] = last.merge(
                    self._doc["doc"], self.inner.results[self.flow._node_names[-1]]
                )
                self._final_merged = True
            return self._doc["doc"]

    @property
    def history(self) -> List[dict]:
        out = []
        for entry in self.inner.history:
            step_name = self.flow._step_name(entry["node"])
            if entry["state"] == SUCCEEDED:
                out.append({
                    "step": step_name,
                    "task_id": entry["task_id"],
                    "latency": entry["latency"],
                })
            else:
                out.append({"step": step_name, "error": entry.get("error")})
        return out

    @property
    def current(self) -> Optional[TaskFuture]:
        with self.inner._lock:
            for fut, _ in self.inner.inflight.values():
                return fut
            return None


class Flow:
    """A linear automation flow: a chain-shaped :class:`Workflow` whose steps
    thread a single document through ``prepare``/``merge``."""

    def __init__(self, steps: List[ActionStep], name: str = "flow"):
        if not steps:
            raise ValueError("a Flow needs at least one step")
        self.steps = steps
        self.name = name
        self._node_names = [
            f"s{i}:{step.name or 'step'}" for i, step in enumerate(steps)
        ]

    def _step_name(self, node_name: str) -> str:
        idx = int(node_name.split(":", 1)[0][1:])
        return self.steps[idx].name

    # ActionProvider interface: start / status / cancel / release ----------
    def start(self, service: FunctionService, document: Any,
              token: Optional[Token] = None) -> FlowRun:
        holder = {"doc": document}
        nodes: List[WorkflowNode] = []
        for i, step in enumerate(self.steps):
            prev_step = self.steps[i - 1] if i else None
            prev_name = self._node_names[i - 1] if i else None

            def prepare(doc: Any, upstream: Dict[str, Any],
                        step: ActionStep = step,
                        prev_step: Optional[ActionStep] = prev_step,
                        prev_name: Optional[str] = prev_name) -> Any:
                if prev_step is not None:
                    holder["doc"] = prev_step.merge(holder["doc"], upstream[prev_name])
                return step.prepare(holder["doc"])

            nodes.append(WorkflowNode(
                name=self._node_names[i],
                function_id=step.function_id,
                deps=[prev_name] if prev_name is not None else (),
                prepare=prepare,
                endpoint_id=step.endpoint_id,
                memoize=step.memoize,
            ))
        # built per-start because prepare closes over this run's document
        # holder — a Flow, like a Workflow, stays reusable across runs
        inner = Workflow(nodes, name=self.name).start(service, document, token=token)
        return FlowRun(
            flow_id=f"flow-{uuid.uuid4().hex[:8]}", flow=self, inner=inner,
            _doc=holder,
        )

    @staticmethod
    def status(run: FlowRun) -> dict:
        return {"flow_id": run.flow_id, "state": run.state,
                "step": run.step_index, "history": list(run.history)}

    @staticmethod
    def cancel(run: FlowRun) -> None:
        """Cancel the flow: the in-flight future (if any) is detached so its
        completion cannot launch further steps."""
        run.inner.cancel()

    @staticmethod
    def wait(run: FlowRun, timeout: float = 60.0) -> Any:
        if not run.inner._done.wait(timeout):
            raise TimeoutError(f"flow {run.flow_id} still active")
        if run.state == FAILED:
            raise RuntimeError(f"flow failed: {run.history[-1]}")
        return run.document
