"""The funcX service (paper §5.1): registry + routing + memoization + auth.

REST-shaped API surface:
    register_function(fn, ...)          -> function_id
    register_endpoint(endpoint, ...)    -> endpoint_id
    run(function_id, payload, ...)      -> TaskFuture (async) or result (sync)
    batch_run(function_id, payloads)    -> [TaskFuture]  (user-driven batching)
    status(task) / result(task)

Invocation is federated: tasks flow service -> Forwarder -> endpoint, so a
request executes "without regard for the physical resource location". Passing
an explicit ``endpoint_id`` pins a task but still travels through the
Forwarder so liveness tracking and failover apply. ``map()`` fan-outs are
sharded across endpoints proportional to advertised capacity.

All invocation paths stamp the Fig.-5 timestamp trail. Memoization (§5.5) is
service-side: hits complete the future immediately without touching an
endpoint.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import auth as auth_mod
from . import serializer
from .auth import Token, TokenAuthority
from .batching import stack_payloads, unstack_results
from .containers import ResourceSpec
from .datastore import (
    DEFAULT_SPILL_THRESHOLD,
    DataRef,
    ObjectStore,
    resolve_payload,
    scan_refs,
    spill_payload,
)
from .endpoint import Endpoint
from .fairness import FairnessPolicy
from .forwarder import Forwarder, ShardedForwarder
from .futures import TaskEnvelope, TaskFuture, TaskState, new_task_id
from .journal import Journal, ResumeReport
from .memoization import MemoCache
from .metrics import MetricsRegistry
from .registry import FunctionRegistry
from .worker import TaskResult


@dataclass
class Invocation:
    """One invocation spec for :meth:`FunctionService.run_many`.

    Unlike ``batch_run`` (one function, many payloads), a sequence of
    Invocations may name different functions and still travel the fabric as
    one batch — the submission shape of a workflow's ready set, where sibling
    DAG nodes run different functions but should ride one TaskBatch frame.
    """

    function_id: str
    payload: Any
    endpoint_id: Optional[str] = None
    container: str = "default"
    # Per-invocation capability override; None inherits the registered
    # function's ResourceSpec capabilities. A task travels the fabric only
    # through endpoints/pools providing every listed capability.
    requirements: Optional[Sequence[str]] = None
    memoize: bool = False
    max_retries: int = 2
    affinity_hint: Optional[str] = None
    # Serving-session stickiness: tasks sharing a session_id route to one
    # endpoint while it lives (the Forwarder's SessionRouter owns the
    # binding); see docs/serving.md.
    session_id: Optional[str] = None
    # Durability ownership: who re-drives this task after a fabric restart.
    # None = a standalone client task (``FunctionService.resume`` re-submits
    # it from the journal); a workflow run_id = the workflow engine owns it
    # (``Workflow.resume`` re-executes the node, so service-level resume must
    # not double-submit the same work).
    owner: Optional[str] = None


def _scan_futures(payload: Any, found: Optional[List[TaskFuture]] = None) -> List[TaskFuture]:
    """Collect TaskFuture leaves nested anywhere in a payload pytree."""
    if found is None:
        found = []
    if isinstance(payload, TaskFuture):
        found.append(payload)
    elif isinstance(payload, dict):
        for v in payload.values():
            _scan_futures(v, found)
    elif isinstance(payload, (list, tuple)):
        for v in payload:
            _scan_futures(v, found)
    return found


def _resolve_futures(payload: Any) -> Any:
    """Substitute each (completed) TaskFuture leaf with its result."""
    if isinstance(payload, TaskFuture):
        return payload.result(0)
    if isinstance(payload, dict):
        return {k: _resolve_futures(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        out = [_resolve_futures(v) for v in payload]
        return tuple(out) if isinstance(payload, tuple) else out
    return payload


class FunctionService:
    def __init__(
        self,
        authority: Optional[TokenAuthority] = None,
        memo_entries: int = 4096,
        policy: str = "least_outstanding",
        forwarder: Optional[Forwarder] = None,
        metrics: Optional[MetricsRegistry] = None,
        journal: Optional[Journal] = None,
        journal_dir: Optional[str] = None,
        datastore: Optional[ObjectStore] = None,
        spill_threshold: int = DEFAULT_SPILL_THRESHOLD,
        n_shards: int = 1,
        fairness: Optional[FairnessPolicy] = None,
    ):
        self.registry = FunctionRegistry()
        self.memo = MemoCache(max_entries=memo_entries)
        self.authority = authority
        # Fairness quotas/weights declared on the authority's tenant profiles
        # apply fabric-wide (explicit policy entries still win).
        if fairness is not None and authority is not None:
            fairness.bind_profiles(authority)
        # One MetricsRegistry per fabric: the forwarder and every registered
        # endpoint (and its executors/warm pools) bind to it, so
        # ``self.metrics.snapshot()`` is the whole-fabric telemetry surface.
        if forwarder is not None:
            self.forwarder = forwarder
            self.metrics = metrics if metrics is not None else forwarder.metrics
            # unify unconditionally: record gauges keep their values, and any
            # endpoint registered before adoption binds to the fabric
            # registry — telemetry must never split across registries
            forwarder.rebind_metrics(self.metrics)
            # a pre-built fair forwarder still learns the authority's profiles
            if authority is not None and getattr(forwarder, "fairness", None) is not None:
                forwarder.fairness.bind_profiles(authority)
        else:
            self.metrics = metrics if metrics is not None else MetricsRegistry()
            if n_shards > 1:
                # million-task scale: hash-partitioned forwarder shards, each
                # with its own lock/pump/watchdog (see ShardedForwarder)
                self.forwarder = ShardedForwarder(
                    n_shards=n_shards, policy=policy, metrics=self.metrics,
                    fairness=fairness,
                )
            else:
                self.forwarder = Forwarder(
                    policy=policy, metrics=self.metrics, fairness=fairness
                )
        # Durability: with a journal attached, every task and workflow-run
        # lifecycle transition is written ahead, and resume() rehydrates
        # incomplete work after a restart (see docs/durability.md).
        if journal is None and journal_dir is not None:
            journal = Journal(journal_dir, metrics=self.metrics)
        self.journal = journal
        if journal is not None and self.forwarder.journal is None:
            self.forwarder.journal = journal
        # Data fabric: with a store attached, payload leaves of at least
        # `spill_threshold` packed bytes travel as DataRefs (resolved at the
        # endpoint, near the workers), and workers spill oversized results
        # back into the same store. Without a store refs in user payloads
        # still route and resolve; nothing auto-spills.
        self.datastore = datastore
        self.spill_threshold = spill_threshold
        if datastore is not None:
            datastore.bind_metrics(self.metrics)

    @property
    def endpoints(self) -> Dict[str, Endpoint]:
        """Registered endpoints, derived from the forwarder's registry (the
        single source of truth, so fabric-level deregistration cannot desync)."""
        return self.forwarder.endpoints()

    # -- auth ------------------------------------------------------------
    def _identity(self, token: Optional[Token], scope: str) -> str:
        if self.authority is None:
            return "anonymous"
        return self.authority.verify(token, scope)

    # -- registration ------------------------------------------------------
    def register_function(
        self,
        fn: Callable,
        name: Optional[str] = None,
        description: str = "",
        public: bool = False,
        requirements: "ResourceSpec | Sequence[str] | None" = None,
        token: Optional[Token] = None,
        **metadata: Any,
    ) -> str:
        owner = self._identity(token, auth_mod.SCOPE_REGISTER_FUNCTION)
        return self.registry.register(
            fn, name=name, description=description, owner=owner, public=public,
            requirements=requirements, **metadata
        )

    def register_endpoint(
        self,
        endpoint: Endpoint,
        token: Optional[Token] = None,
    ) -> str:
        self._identity(token, auth_mod.SCOPE_REGISTER_ENDPOINT)
        endpoint.result_hook = self._on_result
        endpoint.memo_probe = self._memo_probe
        if hasattr(endpoint, "bind_metrics"):
            endpoint.bind_metrics(self.metrics)
        return self.forwarder.register(endpoint)

    def make_endpoint(self, name: str, token: Optional[Token] = None,
                      **kwargs: Any) -> Endpoint:
        """Convenience: construct an Endpoint bound to this service's registry."""
        kwargs.setdefault("metrics", self.metrics)
        ep = Endpoint(name=name, registry=self.registry, result_hook=self._on_result, **kwargs)
        self.register_endpoint(ep, token=token)
        return ep

    # -- invocation ---------------------------------------------------------
    # ``_submit`` is THE submission path: run(), batch_run(), run_many(),
    # map(), and the workflow engine all collapse onto it. The public names
    # are thin keyword-compatible shims.
    def _submit(
        self,
        invocations: Sequence[Invocation],
        token: Optional[Token] = None,
    ) -> List[TaskFuture]:
        """Submit a heterogeneous batch: each :class:`Invocation` may name a
        different function, yet everything routable now travels the Forwarder
        as ONE batch per endpoint pin. Auth and registry lookups are paid once
        per distinct function, not once per task.

        Dependency-aware submission ("futures as inputs"): a payload may embed
        :class:`TaskFuture` leaves anywhere in its pytree. Such tasks are held
        back until every input future resolves, then submitted with the input
        results substituted in place — an upstream failure fails the dependent
        task without it ever reaching an endpoint.
        """
        t_submit = time.monotonic()
        identity = self._identity(token, auth_mod.SCOPE_INVOKE)
        fns = {}
        for inv in invocations:  # auth/registry paid once per distinct function
            if inv.function_id not in fns:
                rf = self.registry.get(inv.function_id)
                if not self.registry.authorized(inv.function_id, identity):
                    raise auth_mod.AuthError(f"{identity} may not invoke {rf.name}")
                fns[inv.function_id] = rf
        t_service_in = time.monotonic()
        self.metrics.counter("service.tasks_submitted").inc(len(invocations))

        futures: List[TaskFuture] = []
        groups: Dict[Optional[str], List[Tuple[TaskEnvelope, TaskFuture]]] = {}
        for inv in invocations:
            rf = fns[inv.function_id]
            wire = rf.metadata.get("pass_through", False)
            memoizable = inv.memoize and rf.deterministic and not wire
            future = TaskFuture(new_task_id())
            future.timestamps.client_submit = t_submit
            future.timestamps.service_in = t_service_in
            future.add_done_callback(self._observe_completion)
            futures.append(future)

            inputs = [] if wire else _scan_futures(inv.payload)
            if inputs:
                self._submit_deferred(
                    inv, rf, future, inputs, memoizable, wire, identity
                )
                continue
            env = self._build_envelope(
                inv, rf, future, inv.payload, memoizable, wire, identity
            )
            if env is not None:  # None = served from the memo cache
                groups.setdefault(inv.endpoint_id, []).append((env, future))
        for endpoint_id, pairs in groups.items():
            self.forwarder.submit_many(pairs, endpoint_id=endpoint_id)
        return futures

    def run_many(
        self,
        invocations: Sequence[Invocation],
        token: Optional[Token] = None,
    ) -> List[TaskFuture]:
        """Heterogeneous batch submission (back-compat name for the unified
        :meth:`_submit` path)."""
        return self._submit(invocations, token=token)

    def _build_envelope(
        self,
        inv: Invocation,
        rf,
        future: TaskFuture,
        payload: Any,
        memoizable: bool,
        wire: bool,
        identity: Optional[str] = None,
    ) -> Optional[TaskEnvelope]:
        """Memo-check `payload` and wrap it for the wire. Returns None when the
        memo cache completed the future without needing an endpoint."""
        digest = None
        if memoizable:
            digest = serializer.payload_hash(payload)
            hit, value = self.memo.get(inv.function_id, digest)
            if hit:
                self.metrics.counter("service.memo_hits").inc()
                future.set_result(value, state=TaskState.MEMOIZED)
                return None
        # capability resolution: per-invocation override, else the function's
        # registered ResourceSpec; the default container name defers to the
        # function's preferred container variant
        if inv.requirements is not None:
            requirements = tuple(sorted(inv.requirements))
        else:
            requirements = tuple(sorted(rf.requirements.capabilities))
        container = inv.container
        if container == "default" and rf.requirements.preferred_container:
            container = rf.requirements.preferred_container
        # Data fabric: spill (or just scan for) DataRef leaves AFTER the memo
        # digest — the key is computed over the original payload, and the
        # location-free hash view keeps it identical either way.
        refs: list = []
        if not wire:
            if self.datastore is not None:
                payload, refs = spill_payload(
                    payload, self.datastore, self.spill_threshold,
                    metrics=self.metrics,
                )
            else:
                refs = scan_refs(payload)
        env = TaskEnvelope(
            task_id=future.task_id,
            function_id=inv.function_id,
            payload=payload if wire else serializer.packb(payload),
            container=container,
            requirements=requirements,
            memoize=digest is not None,
            max_retries=inv.max_retries,
            affinity_hint=inv.affinity_hint,
            session_id=inv.session_id,
            data_refs=tuple((r.key, r.size) for r in refs),
            spill_store=(
                self.datastore.store_id if self.datastore is not None else None
            ),
            spill_threshold=(
                self.spill_threshold if self.datastore is not None else None
            ),
            tenant=identity,
        )
        env.timestamps.client_submit = future.timestamps.client_submit
        env.timestamps.service_in = future.timestamps.service_in
        if digest is not None:
            env.__dict__["_memo_digest"] = digest
        if self.journal is not None:
            # write-ahead: the submitted record lands before the task can
            # reach any endpoint, so a crash after this point is resumable
            self.journal.append(
                "task", "submitted",
                task_id=env.task_id,
                function_id=env.function_id,
                payload=env.payload if isinstance(env.payload, bytes) else None,
                container=env.container,
                requirements=list(env.requirements),
                max_retries=env.max_retries,
                owner=inv.owner,
            )
        return env

    def _submit_deferred(
        self,
        inv: Invocation,
        rf,
        future: TaskFuture,
        inputs: List[TaskFuture],
        memoizable: bool,
        wire: bool,
        identity: Optional[str] = None,
    ) -> None:
        """Hold `inv` until every input future resolves, then substitute the
        results into the payload and submit. First input failure wins and
        fails the dependent future immediately."""
        state = {"remaining": len(inputs)}
        lock = threading.Lock()

        def _on_input(done: TaskFuture) -> None:
            exc = done.exception(0)
            if exc is not None:
                future.set_exception(exc)
                return
            with lock:
                state["remaining"] -= 1
                if state["remaining"]:
                    return
            if future.done():  # a sibling input already failed us
                return
            try:
                payload = _resolve_futures(inv.payload)
                env = self._build_envelope(
                    inv, rf, future, payload, memoizable, wire, identity
                )
                if env is not None:
                    self.forwarder.submit(env, future, endpoint_id=inv.endpoint_id)
            except BaseException as exc:  # noqa: BLE001 - must reach the future
                future.set_exception(exc)

        for f in inputs:
            f.add_done_callback(_on_input)

    def _submit_tasks(
        self,
        function_id: str,
        payloads: Sequence[Any],
        endpoint_id: Optional[str] = None,
        container: str = "default",
        requirements: Optional[Sequence[str]] = None,
        memoize: bool = False,
        max_retries: int = 2,
        token: Optional[Token] = None,
        session_id: Optional[str] = None,
    ) -> List[TaskFuture]:
        """Homogeneous batch: one function, many payloads, submitted to the
        Forwarder as ONE batch (a single ``run()`` is simply a batch of one)."""
        return self._submit(
            [
                Invocation(
                    function_id=function_id,
                    payload=payload,
                    endpoint_id=endpoint_id,
                    container=container,
                    requirements=requirements,
                    memoize=memoize,
                    max_retries=max_retries,
                    session_id=session_id,
                )
                for payload in payloads
            ],
            token=token,
        )

    def run(
        self,
        function_id: str,
        payload: Any,
        endpoint_id: Optional[str] = None,
        container: str = "default",
        requirements: Optional[Sequence[str]] = None,
        memoize: bool = False,
        sync: bool = False,
        max_retries: int = 2,
        token: Optional[Token] = None,
        timeout: Optional[float] = None,
        session_id: Optional[str] = None,
    ) -> Any:
        future = self._submit_tasks(
            function_id,
            [payload],
            endpoint_id,
            container=container,
            requirements=requirements,
            memoize=memoize,
            max_retries=max_retries,
            token=token,
            session_id=session_id,
        )[0]
        return future.result(timeout) if sync else future

    def batch_run(
        self,
        function_id: str,
        payloads: Sequence[Any],
        endpoint_id: Optional[str] = None,
        user_batched: bool = False,
        **kwargs: Any,
    ) -> List[TaskFuture]:
        """N invocations. With user_batched=True the payloads are stacked into
        ONE invocation (paper §5.5 'user-driven batching', Fig. 8) and the
        stacked result is split back into N per-request futures. Otherwise the
        N tasks travel as one TaskBatch through the Forwarder, amortizing
        auth, registry lookups, and routing locks across the batch."""
        if not user_batched:
            sync = kwargs.pop("sync", False)
            timeout = kwargs.pop("timeout", None)
            futures = self._submit_tasks(function_id, list(payloads), endpoint_id, **kwargs)
            if sync:
                return [f.result(timeout) for f in futures]
            return futures
        stacked = stack_payloads(list(payloads))
        inner = self.run(function_id, stacked, endpoint_id, **kwargs)
        outs = [TaskFuture(f"{inner.task_id}/{i}") for i in range(len(payloads))]

        def _split(done: TaskFuture) -> None:
            try:
                results = unstack_results(done.result(), len(outs))
                for f, r in zip(outs, results):
                    f.timestamps = done.timestamps
                    f.set_result(r)
            except BaseException as exc:  # noqa: BLE001
                for f in outs:
                    f.set_exception(exc)

        inner.add_done_callback(_split)
        return outs

    def map(self, function_id: str, payloads: Sequence[Any], endpoint_id: Optional[str] = None,
            timeout: Optional[float] = 120.0, **kwargs: Any) -> List[Any]:
        """Fan out N invocations and gather results in order. With several live
        endpoints and no pin, the fan-out is sharded across endpoints
        proportional to their advertised capacity."""
        payloads = list(payloads)
        if (
            endpoint_id is None
            and not kwargs.get("user_batched")
            and self.forwarder.live_count() > 1
        ):
            kwargs.pop("user_batched", None)  # falsy here; _submit_tasks doesn't take it
            req = kwargs.get("requirements")
            if req is None:
                req = tuple(sorted(self.registry.get(function_id).requirements.capabilities))
            futs: List[TaskFuture] = []
            start = 0
            for eid, count in self.forwarder.shard(len(payloads), requirements=req):
                if count:  # each shard travels as one pinned batch
                    futs.extend(
                        self._submit_tasks(
                            function_id, payloads[start : start + count],
                            endpoint_id=eid, **kwargs,
                        )
                    )
                start += count
            if start < len(payloads):  # defensive: shard() should cover all
                futs.extend(self._submit_tasks(function_id, payloads[start:], **kwargs))
            return [f.result(timeout) for f in futs]
        futs = self.batch_run(function_id, payloads, endpoint_id, **kwargs)
        return [f.result(timeout) for f in futs]

    # -- durability ------------------------------------------------------------
    def resume(
        self,
        journal_dir: Optional[str] = None,
        workflows: Sequence[Any] = (),
        token: Optional[Token] = None,
    ) -> ResumeReport:
        """Rehydrate incomplete work from a journal after a fabric restart.

        Re-executes ONLY work without a committed terminal record: standalone
        tasks are re-submitted through the Forwarder under their original
        task ids (so the eventual terminal record matches the journal entry),
        and incomplete workflow runs are handed to their matching definition
        in `workflows` (``Workflow.resume`` re-runs only unfinished nodes).
        Every already-terminal task id is primed into the Forwarder's
        :class:`~repro.core.journal.ResultStore` first, so a replayed late
        delivery for committed work dedupes instead of resolving twice.
        """
        if journal_dir is not None:
            journal = Journal(journal_dir, metrics=self.metrics)
            self.journal = journal
            self.forwarder.journal = journal
        if self.journal is None:
            raise ValueError(
                "resume() needs a journal: pass journal_dir or construct "
                "the service with one"
            )
        self._identity(token, auth_mod.SCOPE_INVOKE)
        st = self.journal.state()
        report = ResumeReport(state=st)
        for entry in st.tasks.values():
            if entry.terminal:  # exactly-once: committed results never re-resolve
                self.forwarder.results.prime(entry.task_id)
        by_name: Dict[str, Any] = {}
        for wf in workflows:
            by_name.setdefault(wf.name, wf)
        for run_entry in st.incomplete_runs():
            wf = by_name.get(run_entry.workflow)
            if wf is None:
                report.skipped.append(
                    (run_entry.run_id,
                     f"no definition for workflow {run_entry.workflow!r}")
                )
                continue
            report.runs[run_entry.run_id] = wf.resume(
                self, run_entry, token=token
            )
            self.metrics.counter("journal.resumed_runs").inc()
        pairs: List[Tuple[TaskEnvelope, TaskFuture]] = []
        for entry in st.incomplete_tasks():
            if entry.owner is not None:
                continue  # the owning workflow run re-executes this node
            if not entry.resumable:
                report.skipped.append((entry.task_id, "payload not journaled"))
                continue
            try:
                self.registry.get(entry.function_id)
            except KeyError:
                report.skipped.append(
                    (entry.task_id,
                     f"function {entry.function_id!r} not registered")
                )
                continue
            now = time.monotonic()
            future = TaskFuture(entry.task_id)  # original id: stable identity
            future.timestamps.client_submit = now
            future.timestamps.service_in = now
            future.add_done_callback(self._observe_completion)
            env = TaskEnvelope(
                task_id=entry.task_id,
                function_id=entry.function_id,
                payload=entry.payload,
                container=entry.container,
                requirements=entry.requirements,
                max_retries=entry.max_retries,
                spill_store=(
                    self.datastore.store_id
                    if self.datastore is not None else None
                ),
                spill_threshold=(
                    self.spill_threshold
                    if self.datastore is not None else None
                ),
            )
            env.timestamps.client_submit = now
            env.timestamps.service_in = now
            # re-discover DataRef leaves: the journal holds the small
            # ref-bearing bytes, and endpoints resolve from a ref's own
            # locations (fs:// stores re-attach by path after a restart)
            try:
                # scan-only decode: never handed to user code → zero-copy
                refs = scan_refs(serializer.unpackb(entry.payload, writable=False))
            except Exception:
                refs = []
            env.data_refs = tuple((r.key, r.size) for r in refs)
            self.journal.append(  # idempotent under the fold
                "task", "submitted",
                task_id=entry.task_id, function_id=entry.function_id,
                payload=entry.payload, container=entry.container,
                requirements=list(entry.requirements),
                max_retries=entry.max_retries, owner=None,
            )
            pairs.append((env, future))
            report.futures[entry.task_id] = future
            self.metrics.counter("journal.resumed_tasks").inc()
        if pairs:
            self.forwarder.submit_many(pairs)
        return report

    # -- status/result (REST-shaped) ------------------------------------------
    @staticmethod
    def status(future: TaskFuture) -> str:
        return future.state.value

    @staticmethod
    def result(future: TaskFuture, timeout: Optional[float] = None) -> Any:
        return future.result(timeout)

    # -- data fabric client surface --------------------------------------------
    def put_data(self, value: Any) -> DataRef:
        """Store `value` once and get a :class:`DataRef` usable as a payload
        leaf in any number of invocations — the N-tasks-share-one-dataset
        pattern (each endpoint fetches the blob once into its locality
        cache; the Forwarder never carries it inline)."""
        if self.datastore is None:
            raise ValueError("put_data() needs a datastore attached to the service")
        blob = serializer.packb(value)
        key = self.datastore.put(blob)
        return DataRef(key=key, size=len(blob),
                       locations=(self.datastore.store_id,))

    def fetch(self, value: Any, timeout: Optional[float] = None) -> Any:
        """Materialize any DataRef leaves in `value` (a result, a payload, or
        a TaskFuture whose result may carry spilled leaves)."""
        if isinstance(value, TaskFuture):
            value = value.result(timeout)
        return resolve_payload(value, metrics=self.metrics)

    # -- hooks -----------------------------------------------------------------
    def _observe_completion(self, future: TaskFuture) -> None:
        """Done-callback on every future built by this service: end-to-end
        success/failure counts and the client-observed latency histogram.
        With a journal attached this is also the commitment point — the
        terminal record lands exactly once per task (the future resolves at
        most once, so this callback fires at most once)."""
        if self.journal is not None:
            exc = future.exception(0)
            if exc is None:
                try:
                    value = serializer.packb(future.result(0))
                except Exception:
                    value = None  # unserializable result: committed in-memory only
                self.journal.append(
                    "task", "completed", task_id=future.task_id, value=value
                )
            else:
                self.journal.append(
                    "task", "failed", task_id=future.task_id, error=repr(exc)
                )
        if future.exception(0) is None:
            self.metrics.counter("service.tasks_completed").inc()
            ts = future.timestamps
            if ts.result_ready and ts.client_submit:
                self.metrics.histogram("service.e2e_latency_s").observe(
                    ts.result_ready - ts.client_submit
                )
        else:
            self.metrics.counter("service.tasks_failed").inc()

    def _on_result(self, env: TaskEnvelope, res: TaskResult) -> None:
        digest = env.__dict__.get("_memo_digest")
        if env.memoize and digest is not None and res.error is None:
            self.memo.put(env.function_id, digest, res.value)

    def _memo_probe(self, env: TaskEnvelope):
        """Queue-time memo lookup for the endpoint's dispatch loop."""
        digest = env.__dict__.get("_memo_digest")
        if digest is None:
            return False, None
        return self.memo.get(env.function_id, digest)

    # -- lifecycle ---------------------------------------------------------------
    def shutdown(self) -> None:
        self.forwarder.shutdown()
        for eid, ep in self.endpoints.items():
            ep.shutdown()
            self.forwarder.deregister(eid)

    def stats(self) -> dict:
        return {
            "functions": len(self.registry.list()),
            "endpoints": {eid: ep.stats() for eid, ep in self.endpoints.items()},
            "forwarder": self.forwarder.stats(),
            "memo": self.memo.stats(),
            "metrics": self.metrics.snapshot(),
        }
