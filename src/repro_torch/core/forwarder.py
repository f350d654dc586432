"""Forwarder: the federated multi-endpoint fabric tier.

The follow-up funcX papers (arXiv:2005.04215, arXiv:2209.11631) make the
Forwarder the central abstraction: a service-side component that owns the
registry of *endpoints* (not executors), tracks their health and observed
performance, and routes every task to some endpoint "without regard for the
physical resource location". This module generalizes the per-executor
policies in :mod:`repro.core.scheduler` one tier up:

- ``random``: uniform choice among live endpoints (paper-faithful baseline).
- ``least_outstanding``: fewest tasks currently routed-but-unfinished.
- ``latency_aware``: lowest EWMA of observed endpoint latency; unmeasured
  endpoints are explored first.
- ``warm_affinity``: prefer endpoints holding a warm executable for the
  task's (function, container), tie-broken by least outstanding.
- ``eta_aware``: lowest predicted completion time — per-(function, endpoint)
  rolling-average runtime + transfer cost for payload/DataRef bytes not
  already resident at the endpoint + queue delay + the endpoint's observed
  ETA-error correction (see :mod:`repro.core.predictor`). Unmeasured
  (function, endpoint) pairs are explored first.

With ``speculation=True`` the watchdog also launches one backup copy of any
task that overruns its ETA error bound (``predicted_eta × factor +
queue_error``) onto a different endpoint. First result wins the shared
future; the loser dedupes in the exactly-once ResultStore
(``journal.duplicate_results``) and the journal's commitment point still
fires once (``journal.duplicate_completions == 0``).

The Forwarder also runs a liveness watchdog over endpoint heartbeats: when an
endpoint dies mid-task (``Endpoint.kill()`` or a hung manager loop), every
outstanding task routed there is failed over to a surviving endpoint.
``TaskFuture.set_result`` is idempotent, so a false-positive death detection
degrades into a speculative duplicate — first result wins — and a
false-positive endpoint is resurrected once its heartbeat resumes.

Two scale tiers sit on top (the federated follow-ups' million-task shape):

- :class:`ShardedForwarder` hash-partitions ``task_id → shard`` over N
  independent ``Forwarder`` instances, each with its own endpoint-record
  view, submit queues, pump, watchdog, and lock — completions on shard A
  never contend with routing on shard B. The single ``Forwarder`` is the
  degenerate one-shard case, so :class:`~repro.core.service.FunctionService`,
  resume/journal, and speculation work unchanged against either.
- Multi-tenant fairness (see :mod:`repro.core.fairness`): with a
  :class:`~repro.core.fairness.FairnessPolicy` attached, submissions pass
  per-tenant quota admission (reject with ``retry_after`` instead of
  unbounded queueing), land in per-tenant queues, and the pump drains them
  deficit-round-robin weighted by tenant — a greedy tenant's backlog cannot
  starve a light tenant's p99.
"""
from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .containers import CapabilityError
from .fairness import ANONYMOUS, AdmissionError, DeficitRoundRobin, FairnessPolicy, TenantLedger
from .futures import TaskEnvelope, TaskFuture
from .interchange import BatchCoalescer, iter_frames
from .journal import Journal, ResultStore
from .metrics import SIZE_BUCKETS, MetricsRegistry
from .predictor import TaskPredictor

ENDPOINT_POLICIES = (
    "random", "least_outstanding", "latency_aware", "warm_affinity", "eta_aware",
)

_Pair = Tuple[TaskEnvelope, TaskFuture]


def _caps_of(endpoint) -> Optional[frozenset]:
    """An endpoint's advertised capability set, or None when it has no
    ``capabilities()`` surface (test fakes, legacy shims)."""
    caps_fn = getattr(endpoint, "capabilities", None)
    if caps_fn is None:
        return None
    return frozenset(caps_fn())


def _endpoint_satisfies(endpoint, requirements, caps=...) -> bool:
    """Capability check against an endpoint's advertised set. Requirement-free
    tasks run anywhere; an endpoint without a capability surface can't claim
    to satisfy any requirement. Callers routing a batch pass a pre-computed
    `caps` snapshot so the endpoint lock is paid once, not once per task."""
    if not requirements:
        return True
    if caps is ...:
        caps = _caps_of(endpoint)
    return caps is not None and set(requirements) <= caps


class EndpointRecord:
    """Forwarder-side bookkeeping for one registered endpoint.

    The two routing signals — observed latency EWMA and outstanding task
    count — are backed by the shared metrics registry (gauges
    ``forwarder.endpoint_latency_ewma_s`` / ``forwarder.endpoint_outstanding``
    labeled by endpoint), not private fields: ``latency_aware`` routing, the
    autoscaler, and external telemetry all consume the same numbers."""

    def __init__(
        self,
        endpoint,                         # Endpoint-shaped: see FakeEndpoint in tests
        pending: Optional[BatchCoalescer] = None,
        metrics: Optional[MetricsRegistry] = None,
        shard: Optional[str] = None,
    ):
        self.endpoint = endpoint
        self.outstanding: Dict[str, TaskEnvelope] = {}
        self.routed = 0
        self.completed = 0
        self.dead = False
        # Per-endpoint submit queue: routed-but-undelivered (envelope, future)
        # pairs waiting for the pump to coalesce them into a TaskBatch.
        self.pending = pending
        # Gauge label disambiguator: every shard of a ShardedForwarder keeps
        # its own record (and measurement view) of each endpoint in one shared
        # registry; without the label the shards would stomp each other's
        # series.
        self.shard = shard
        # EWMA folds happen outside the forwarder's global lock (completions
        # must not serialize against routing); this tiny per-record lock makes
        # the read-modify-write safe against concurrent completer threads.
        self._stat_lock = threading.Lock()
        metrics = metrics if metrics is not None else MetricsRegistry()
        self._bind_gauges(metrics, reset=True)

    def _bind_gauges(self, metrics: MetricsRegistry, reset: bool) -> None:
        labels = {"endpoint": self.endpoint.endpoint_id}
        if self.shard is not None:
            labels["shard"] = self.shard
        self._ewma_gauge = metrics.gauge(
            "forwarder.endpoint_latency_ewma_s", labels
        )
        self._outstanding_gauge = metrics.gauge(
            "forwarder.endpoint_outstanding", labels
        )
        if reset:
            # a fresh record means fresh measurement state: a deregistered
            # endpoint re-joining must be explored again by latency_aware
            # routing, not shunned on an arbitrarily stale EWMA
            self._ewma_gauge.set(None)
            self._outstanding_gauge.set(0)

    def rebind_metrics(self, metrics: MetricsRegistry) -> None:
        """Move this record's gauges to another registry, carrying the
        current values over."""
        ewma, outstanding = self._ewma_gauge.value, self._outstanding_gauge.value
        self._bind_gauges(metrics, reset=False)
        self._ewma_gauge.set(ewma)
        self._outstanding_gauge.set(outstanding if outstanding is not None else 0)

    @property
    def latency_ewma(self) -> Optional[float]:
        """Observed endpoint-tier latency EWMA (s); None until measured."""
        return self._ewma_gauge.value

    @latency_ewma.setter
    def latency_ewma(self, v: Optional[float]) -> None:
        self._ewma_gauge.set(v)

    def sync_outstanding(self) -> None:
        self._outstanding_gauge.set(len(self.outstanding))

    def observe_latency(self, lat: float, alpha: float) -> None:
        """Fold one observed completion latency into the EWMA. Safe to call
        without the forwarder lock (see `_stat_lock`)."""
        with self._stat_lock:
            cur = self._ewma_gauge.value
            self._ewma_gauge.set(lat if cur is None else alpha * lat + (1 - alpha) * cur)


class SessionRouter:
    """Sticky ``session_id → endpoint_id`` map for serving sessions.

    Session affinity is *harder* than ``affinity_hint``: a bound session
    follows its endpoint even when saturated (migrating would force a
    KV-cache re-prefill, queueing is cheaper) and rebinds only when the
    endpoint dies or deregisters — the serving tier then re-prefills on the
    new endpoint (cache migration). One router is shared across every shard
    of a :class:`ShardedForwarder` so a session's tasks agree on their home
    regardless of which shard their task_ids hash to.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._map: Dict[str, str] = {}

    def lookup(self, session_id: str) -> Optional[str]:
        with self._lock:
            return self._map.get(session_id)

    def bind(self, session_id: str, endpoint_id: str) -> Optional[str]:
        """Bind (or rebind) a session; returns the previous binding."""
        with self._lock:
            prev = self._map.get(session_id)
            self._map[session_id] = endpoint_id
            return prev

    def forget(self, session_id: str) -> None:
        with self._lock:
            self._map.pop(session_id, None)

    def evict_endpoint(self, endpoint_id: str) -> int:
        """Drop every session bound to a dead/deregistered endpoint; their
        next task rebinds under the routing policy."""
        with self._lock:
            stale = [s for s, e in self._map.items() if e == endpoint_id]
            for s in stale:
                del self._map[s]
            return len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


class Forwarder:
    def __init__(
        self,
        policy: str = "least_outstanding",
        seed: Optional[int] = None,
        ewma_alpha: float = 0.25,
        liveness_threshold_s: float = 2.0,
        watchdog_interval_s: float = 0.05,
        failover: bool = True,
        max_batch: int = 64,
        max_delay_s: float = 0.0,
        metrics: Optional[MetricsRegistry] = None,
        journal: Optional[Journal] = None,
        predictor: Optional[TaskPredictor] = None,
        speculation: bool = False,
        speculation_eta_factor: float = 3.0,
        speculation_min_age_s: float = 0.05,
        fairness: Optional[FairnessPolicy] = None,
        tenant_ledger: Optional[TenantLedger] = None,
        shard: Optional[str] = None,
        session_router: Optional[SessionRouter] = None,
    ):
        if policy not in ENDPOINT_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; choose from {ENDPOINT_POLICIES}"
            )
        self.policy = policy
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # Predictive tier (core/predictor.py): runtime/transfer/queue-error
        # models behind eta_aware routing and ETA-overrun backup speculation.
        # Auto-created when either consumer is enabled.
        if predictor is None and (policy == "eta_aware" or speculation):
            predictor = TaskPredictor(metrics=self.metrics)
        self.predictor = predictor
        if predictor is not None:
            predictor.bind_metrics(self.metrics)
        self.speculation = speculation
        self.speculation_eta_factor = speculation_eta_factor
        self.speculation_min_age_s = speculation_min_age_s
        self.backups_launched = 0
        # Durability tier: an optional write-ahead journal records routing
        # transitions, and the task-id-keyed ResultStore is the exactly-once
        # authority — a task's first terminal outcome is recorded here;
        # replayed/speculated duplicates dedupe (journal.duplicate_results).
        self.journal = journal
        self.results = ResultStore(metrics=self.metrics)
        self.ewma_alpha = ewma_alpha
        self.liveness_threshold_s = liveness_threshold_s
        self.watchdog_interval_s = watchdog_interval_s
        self.failover = failover
        self.failovers = 0
        self.orphaned = 0  # tasks that died with no surviving endpoint
        # Batching knobs: delivered frames hold at most `max_batch` tasks; with
        # `max_delay_s > 0` routed tasks sit in per-endpoint submit queues and
        # a pump thread coalesces them, otherwise delivery is synchronous
        # (a lone submit() is simply a batch of one).
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.batches_delivered = 0
        self.tasks_delivered = 0
        # Multi-tenant fairness: quota admission at submit, per-tenant queues
        # drained deficit-round-robin by the pump. The ledger may be shared
        # (one ledger across every ShardedForwarder shard → quotas cap a
        # tenant's fabric-wide footprint).
        self.fairness = fairness
        self.shard_label = shard
        if fairness is not None:
            self.ledger = tenant_ledger if tenant_ledger is not None else TenantLedger()
            self.ledger.bind_metrics(self.metrics)
            self._fair: Optional[DeficitRoundRobin] = DeficitRoundRobin(
                fairness, metrics=self.metrics
            )
        else:
            self.ledger = None
            self._fair = None

        # Serving tier: session-sticky routing (may be shared across shards).
        self.sessions = (
            session_router if session_router is not None else SessionRouter()
        )

        self._rng = random.Random(seed)
        self._records: Dict[str, EndpointRecord] = {}
        self._futures: Dict[str, TaskFuture] = {}
        self._task_endpoint: Dict[str, str] = {}  # task_id -> endpoint_id (O(1) _on_done)
        # speculation bookkeeping: task_id -> (routed_at, predicted_eta_s),
        # and the set of task ids that already have a backup copy in flight
        self._eta: Dict[str, Tuple[float, float]] = {}
        self._backed: set = set()
        self._lock = threading.RLock()
        self._alive = True
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="forwarder/watchdog", daemon=True
        )
        self._watchdog.start()
        self._pump_event = threading.Event()
        self._pump: Optional[threading.Thread] = None
        # The pump also owns the fair drain, so fairness needs it even with
        # synchronous (max_delay_s == 0) delivery.
        if self.max_delay_s > 0 or self._fair is not None:
            self._pump = threading.Thread(
                target=self._pump_loop, name="forwarder/pump", daemon=True
            )
            self._pump.start()

    # -- endpoint registry ---------------------------------------------------
    def register(self, endpoint) -> str:
        with self._lock:
            self._records[endpoint.endpoint_id] = EndpointRecord(
                endpoint=endpoint,
                pending=BatchCoalescer(self.max_batch, self.max_delay_s),
                metrics=self.metrics,
                shard=self.shard_label,
            )
        if self._fair is not None:
            self._pump_event.set()  # queued tenants may now have capacity
        return endpoint.endpoint_id

    def deregister(self, endpoint_id: str) -> None:
        with self._lock:
            self._records.pop(endpoint_id, None)
        self.sessions.evict_endpoint(endpoint_id)

    def rebind_metrics(self, metrics: MetricsRegistry) -> None:
        """Adopt another registry: future forwarder-tier recordings land in
        `metrics`, every registered record's gauges move over with their
        current values, and already-registered endpoints are re-bound too.
        Counters/histograms accumulated before adoption stay in the old
        registry (adoption normally happens at FunctionService construction,
        before any traffic). Keeps fabric telemetry from splitting across
        registries when a pre-built forwarder is handed to a service."""
        with self._lock:
            self.metrics = metrics
            self.results.metrics = metrics
            if self.predictor is not None:
                self.predictor.bind_metrics(metrics)
            records = list(self._records.values())
        for rec in records:
            rec.rebind_metrics(metrics)
            if hasattr(rec.endpoint, "bind_metrics"):
                rec.endpoint.bind_metrics(metrics)

    def endpoint_ids(self) -> List[str]:
        with self._lock:
            return list(self._records)

    def endpoints(self) -> Dict[str, object]:
        """Registered endpoints by id (the single source of truth)."""
        with self._lock:
            return {eid: rec.endpoint for eid, rec in self._records.items()}

    def _is_live(self, rec: EndpointRecord) -> bool:
        if rec.dead:
            return False
        is_alive = getattr(rec.endpoint, "is_alive", None)
        return is_alive(self.liveness_threshold_s) if is_alive else True

    def _live_records(self) -> List[EndpointRecord]:
        return [r for r in self._records.values() if self._is_live(r)]

    def live_count(self) -> int:
        with self._lock:
            return len(self._live_records())

    # -- routing -------------------------------------------------------------
    def choose(self, env: TaskEnvelope):
        """Pick a live endpoint for `env` under the configured policy.
        Returns None when no endpoint is live."""
        with self._lock:
            live = self._live_records()
            if not live:
                return None
            return self._choose_record(live, env).endpoint

    def _choose_record(
        self,
        live: List[EndpointRecord],
        env: TaskEnvelope,
        caps_cache: Optional[Dict[str, Optional[frozenset]]] = None,
    ) -> EndpointRecord:
        """Policy selection over a pre-computed live list (callers batching
        many tasks pay the liveness scan once, not once per task). Must be
        called with the lock held.

        The capability filter runs before any policy: only endpoints whose
        advertised capability set satisfies the task's requirements are
        candidates, so incapable dispatch is impossible. `caps_cache` (by
        endpoint id) amortizes the endpoint-lock walk across a batch. A task
        no live endpoint satisfies raises :class:`CapabilityError` — the
        caller fails the future fast instead of letting a watchdog time it
        out."""
        if not env.requirements:
            capable = live  # requirement-free: no filter walk on the hot path
        else:
            if caps_cache is None:
                caps_cache = {
                    r.endpoint.endpoint_id: _caps_of(r.endpoint) for r in live
                }
            capable = [
                r for r in live
                if _endpoint_satisfies(
                    r.endpoint, env.requirements,
                    caps_cache.get(r.endpoint.endpoint_id),
                )
            ]
        if not capable:
            self.metrics.counter("container.capability_misses").inc()
            advertised = {
                r.endpoint.endpoint_id: sorted(caps_cache.get(r.endpoint.endpoint_id) or ())
                for r in live
            }
            raise CapabilityError(
                f"no live endpoint satisfies requirements "
                f"{sorted(env.requirements)} for task {env.task_id} "
                f"(function {env.function_id[:12]}…); live endpoints advertise "
                f"{advertised}"
            )
        live = capable
        if env.session_id is not None:
            # Session stickiness (serving tier): a bound session follows its
            # endpoint even at capacity — its KV-cache slot lives there and a
            # move means a re-prefill. Only death/deregistration (the binding
            # was evicted, so lookup misses) falls through to the policy.
            bound = self.sessions.lookup(env.session_id)
            if bound is not None:
                for r in live:
                    if r.endpoint.endpoint_id == bound:
                        self.metrics.counter("forwarder.session_hits").inc()
                        return r
        if env.affinity_hint is not None:
            # Soft warm-affinity (workflow parent→child): prefer the hinted
            # endpoint while it is live with spare capacity; saturation or
            # death falls through to the configured policy.
            for r in live:
                if (
                    r.endpoint.endpoint_id == env.affinity_hint
                    and len(r.outstanding) < max(1, r.endpoint.capacity())
                ):
                    self.metrics.counter("forwarder.affinity_hits").inc()
                    return r
        rec = self._policy_pick(live, env)
        if env.session_id is not None:
            # first task of a session (or its first after failover): bind it
            # here so every subsequent decode step lands on this endpoint
            prev = self.sessions.bind(env.session_id, rec.endpoint.endpoint_id)
            if prev is not None and prev != rec.endpoint.endpoint_id:
                self.metrics.counter("forwarder.session_moves").inc()
        return rec

    def _policy_pick(
        self, live: List[EndpointRecord], env: TaskEnvelope
    ) -> EndpointRecord:
        """The configured policy's choice over capability-filtered live
        records (no session/affinity shortcuts — callers handled those)."""
        if self.policy == "random":
            return self._rng.choice(live)
        if self.policy == "least_outstanding":
            return min(live, key=lambda r: (len(r.outstanding), r.routed))
        if self.policy == "latency_aware":
            unmeasured = [r for r in live if r.latency_ewma is None]
            if unmeasured:  # explore before exploiting
                return min(unmeasured, key=lambda r: (len(r.outstanding), r.routed))
            # backlog-weighted EWMA: raw EWMA lags behind a burst, so
            # scale by outstanding/capacity to avoid dogpiling the
            # endpoint that last looked fastest
            def score(r):
                backlog = len(r.outstanding) / max(1, r.endpoint.capacity())
                return (r.latency_ewma * (1.0 + backlog), len(r.outstanding))

            return min(live, key=score)
        if self.policy == "warm_affinity":
            key = (env.function_id, env.container)
            warm = [
                r for r in live
                if r.endpoint.has_warm(key)
                and len(r.outstanding) < max(1, r.endpoint.capacity())
            ]
            # saturated-warm spills to cold endpoints (which then warm up)
            pool = warm or live
            return min(pool, key=lambda r: (len(r.outstanding), r.routed))
        if self.policy == "eta_aware":
            return self._choose_eta(live, env)
        raise AssertionError(self.policy)  # pragma: no cover

    def _transfer_bytes(self, rec: EndpointRecord, env: TaskEnvelope) -> int:
        """Bytes that must move to run `env` at this endpoint: the inline
        payload plus every DataRef blob not already in its locality cache."""
        inline = len(env.payload) if isinstance(env.payload, (bytes, bytearray)) else 0
        if not env.data_refs:
            return inline
        has_data = getattr(rec.endpoint, "has_data", None)
        miss = sum(
            size for key, size in env.data_refs
            if has_data is None or not has_data(key)
        )
        return inline + miss

    def _choose_eta(
        self, live: List[EndpointRecord], env: TaskEnvelope
    ) -> EndpointRecord:
        """Lowest predicted completion time (runtime + transfer + queue delay
        + ETA-error correction). Unmeasured (function, endpoint) pairs are
        explored first — normalized least-outstanding among them — so the
        runtime model covers every endpoint before exploitation begins. The
        chosen ETA is remembered for speculation's overrun check."""
        pred = self.predictor
        now = time.monotonic()

        def load(r: EndpointRecord) -> float:
            return len(r.outstanding) / max(1, r.endpoint.capacity())

        unmeasured = [
            r for r in live
            if not pred.runtime.has_history(env.function_id, r.endpoint.endpoint_id)
        ]
        if unmeasured:
            rec = min(unmeasured, key=lambda r: (load(r), r.routed))
            eta = pred.eta(
                env.function_id, rec.endpoint.endpoint_id,
                self._transfer_bytes(rec, env),
                len(rec.outstanding), max(1, rec.endpoint.capacity()),
            )
            self._eta[env.task_id] = (now, eta)
            return rec
        best = best_eta = best_key = None
        for r in live:
            eta = pred.eta(
                env.function_id, r.endpoint.endpoint_id,
                self._transfer_bytes(r, env),
                len(r.outstanding), max(1, r.endpoint.capacity()),
            )
            key = (eta, load(r), r.routed)
            if best_key is None or key < best_key:
                best, best_eta, best_key = r, eta, key
        self._eta[env.task_id] = (now, best_eta)
        return best

    def submit(
        self,
        env: TaskEnvelope,
        future: TaskFuture,
        endpoint_id: Optional[str] = None,
    ) -> Optional[str]:
        """Route `env` to an endpoint (pinned when `endpoint_id` is given) and
        track it until its future completes. Returns the chosen endpoint id
        (None when the future was capability-failed instead of routed).
        A single submit travels the batched pipe as a batch of one."""
        return self.submit_many([(env, future)], endpoint_id=endpoint_id)[0]

    def submit_many(
        self,
        pairs: Sequence[_Pair],
        endpoint_id: Optional[str] = None,
    ) -> List[Optional[str]]:
        """Route a batch of (envelope, future) pairs, amortizing registry locks
        and delivering one TaskBatch frame per chosen endpoint. Returns the
        chosen endpoint id for each pair, in order — None for a pair whose
        future was failed fast with a :class:`CapabilityError` (no live
        endpoint, pinned or otherwise, satisfies its requirements).

        With ``max_delay_s > 0`` the routed pairs land in per-endpoint submit
        queues and the pump delivers them (flush-on-size happens inline);
        otherwise delivery is synchronous.

        With a fairness policy attached, each pair first passes quota
        admission (futures beyond the tenant's quota fail fast with
        :class:`~repro.core.fairness.AdmissionError` carrying ``retry_after``)
        and admitted pairs land in per-tenant queues for the pump's
        deficit-round-robin drain — routing is deferred, so every admitted
        pair's chosen id reports as None."""
        pairs = list(pairs)
        if not pairs:
            return []
        if self._fair is None:
            return self._route_many(pairs, endpoint_id)
        admitted = 0
        for env, future in pairs:
            tenant = getattr(env, "tenant", None) or ANONYMOUS
            quota = self.fairness.quota_of(tenant)
            if not self.ledger.try_admit(tenant, quota):
                self.metrics.counter("fair.rejected", {"tenant": tenant}).inc()
                future.set_exception(AdmissionError(
                    tenant=tenant, quota=quota,
                    outstanding=self.ledger.outstanding(tenant),
                    retry_after=self._retry_after(tenant, quota),
                ))
                continue
            # the quota slot frees when the task reaches ANY terminal state —
            # completion, failover loss, cancellation — so the ledger can
            # never leak a slot
            future.add_done_callback(lambda f, t=tenant: self.ledger.release(t))
            self._fair.enqueue(tenant, (env, future, endpoint_id))
            admitted += 1
        if admitted:
            self.metrics.counter("fair.admitted").inc(admitted)
            self._pump_event.set()
        return [None] * len(pairs)

    def _retry_after(self, tenant: str, quota: Optional[int]) -> float:
        """Backpressure hint: observed mean endpoint service latency scaled by
        how deep the tenant's own backlog already is relative to its quota."""
        with self._lock:
            ewmas = [
                r.latency_ewma for r in self._records.values()
                if r.latency_ewma is not None
            ]
        lat = sum(ewmas) / len(ewmas) if ewmas else self.fairness.base_retry_after_s
        backlog = self._fair.pending(tenant)
        return max(
            self.fairness.base_retry_after_s,
            lat * (1.0 + backlog / max(1, quota or 1)),
        )

    def _route_many(
        self,
        pairs: Sequence[_Pair],
        endpoint_id: Optional[str] = None,
    ) -> List[Optional[str]]:
        """The routing core (admission-free): policy choice, bookkeeping,
        journaling, delivery. Fairness-mode pumps call this after the DRR
        drain; without fairness `submit_many` is a straight pass-through."""
        pairs = list(pairs)
        if not pairs:
            return []
        chosen: List[Optional[str]] = []
        routed_pairs: List[_Pair] = []
        rejected: List[Tuple[TaskFuture, CapabilityError]] = []
        deliveries: Dict[str, Tuple[EndpointRecord, List[_Pair]]] = {}
        with self._lock:
            pinned: Optional[EndpointRecord] = None
            pinned_caps: Optional[frozenset] = None
            if endpoint_id is not None:
                pinned = self._records.get(endpoint_id)
                if pinned is None:
                    raise KeyError(f"unknown endpoint {endpoint_id!r}; register one first")
                if not self._is_live(pinned):
                    pinned = None  # pinned endpoint died: fall back to policy routing
                else:
                    pinned_caps = _caps_of(pinned.endpoint)
            live: Optional[List[EndpointRecord]] = None
            caps_cache: Optional[Dict[str, Optional[frozenset]]] = None
            decisions = 0
            for env, future in pairs:
                rec = pinned
                if rec is not None and not _endpoint_satisfies(
                    rec.endpoint, env.requirements, pinned_caps
                ):
                    self.metrics.counter("container.capability_misses").inc()
                    rejected.append((future, CapabilityError(
                        f"pinned endpoint {endpoint_id!r} does not provide "
                        f"{sorted(env.requirements)} required by task {env.task_id}"
                    )))
                    chosen.append(None)
                    continue
                if rec is None:
                    if live is None:  # liveness scan paid once per batch
                        live = self._live_records()
                    if not live:
                        raise RuntimeError(
                            "no live endpoints registered with the forwarder"
                        )
                    if caps_cache is None and env.requirements:
                        # capability snapshot paid once per batch, like the
                        # liveness scan — not once per task under the lock
                        caps_cache = {
                            r.endpoint.endpoint_id: _caps_of(r.endpoint)
                            for r in live
                        }
                    try:
                        rec = self._choose_record(live, env, caps_cache)
                    except CapabilityError as exc:
                        # fail fast through the future: the rest of the batch
                        # still routes (capability misses are per-task)
                        rejected.append((future, exc))
                        chosen.append(None)
                        continue
                    decisions += 1
                elif env.session_id is not None:
                    # a pinned task establishes session residency exactly like
                    # a policy-routed one: the session's next unpinned step
                    # must follow its KV cache to this endpoint
                    self.sessions.bind(env.session_id, rec.endpoint.endpoint_id)
                eid = rec.endpoint.endpoint_id
                rec.outstanding[env.task_id] = env
                rec.routed += 1
                self._futures[env.task_id] = future
                self._task_endpoint[env.task_id] = eid
                future.endpoint_id = eid
                chosen.append(eid)
                routed_pairs.append((env, future))
                deliveries.setdefault(eid, (rec, []))[1].append((env, future))
            self.metrics.counter("forwarder.tasks_routed").inc(len(routed_pairs))
            if decisions:  # one bulk inc, not one per task inside the lock
                self.metrics.counter(
                    "forwarder.routing_decisions", {"policy": self.policy}
                ).inc(decisions)
            for rec, _ in deliveries.values():
                rec.sync_outstanding()
        for future, exc in rejected:
            future.set_exception(exc)
        for env, future in routed_pairs:
            future.add_done_callback(lambda f, tid=env.task_id: self._on_done(tid, f))
        if self.journal is not None:
            # WAL ordering: the routing transition is journaled before the
            # task can reach an endpoint, so a terminal record never precedes
            # its routed record
            for env, future in routed_pairs:
                self.journal.append(
                    "task", "routed",
                    task_id=env.task_id, endpoint_id=future.endpoint_id,
                )
        # deliver via the record captured at routing time: a concurrent
        # deregister() must not strand already-routed tasks undelivered
        for rec, routed in deliveries.values():
            if self.max_delay_s > 0:
                for pair in routed:
                    full = rec.pending.add(pair)
                    if full:  # flush-on-size fires inline
                        self._deliver(rec.endpoint, full)
                self._pump_event.set()
            else:
                self._deliver(rec.endpoint, routed)
        return chosen

    def _deliver(self, endpoint, pairs: List[_Pair]) -> None:
        """Hand routed pairs to `endpoint` as TaskBatch frames of at most
        `max_batch` tasks (per-task submit for endpoints without a batch
        surface, e.g. test fakes)."""
        submit_batch = getattr(endpoint, "submit_batch", None)
        for frame in iter_frames(pairs, self.max_batch):
            with self._lock:
                self.batches_delivered += 1
                self.tasks_delivered += len(frame)
            self.metrics.counter("forwarder.batches_delivered").inc()
            self.metrics.histogram(
                "forwarder.batch_size", buckets=SIZE_BUCKETS
            ).observe(len(frame))
            if submit_batch is not None:
                submit_batch(frame)
            else:
                for env, future in frame.pairs():
                    endpoint.submit(env, future)

    # -- submit-queue pump ----------------------------------------------------
    def _pump_loop(self) -> None:
        interval = min(0.01, max(0.001, self.max_delay_s / 4))
        while self._alive:
            self._pump_event.wait(timeout=interval)
            self._pump_event.clear()
            try:
                self.pump_once()
            except Exception:  # pragma: no cover - pump must never die
                pass

    def pump_once(self, force: bool = False) -> int:
        """Flush per-endpoint submit queues whose deadline has expired (all of
        them when `force`), after draining the fair-share tenant queues when
        fairness is on. Returns the number of tasks delivered."""
        delivered = self._pump_fair(force) if self._fair is not None else 0
        return delivered + self._pump_queues(force)

    def _pump_fair(self, force: bool = False) -> int:
        """Drain the per-tenant queues deficit-round-robin into the router.

        The drain budget is the fabric's spare capacity (Σ max(0, capacity −
        outstanding) over live endpoints): tasks beyond it stay queued by
        tenant, which is the fairness mechanism itself — a light tenant's
        next task is drained ahead of a greedy tenant's backlog instead of
        joining the back of a FIFO. With no live endpoints the budget is 0
        and tenants simply wait. `force` (shutdown) ignores the budget."""
        drained = 0
        while True:
            with self._lock:
                budget = sum(
                    max(0, r.endpoint.capacity() - len(r.outstanding))
                    for r in self._live_records()
                )
            if force:
                budget = max(budget, self._fair.pending())
            if budget <= 0 or not self._fair.pending():
                return drained
            items = self._fair.drain(budget)
            if not items:
                return drained
            by_pin: Dict[Optional[str], List[_Pair]] = {}
            for env, future, pin in items:
                by_pin.setdefault(pin, []).append((env, future))
            for pin, routed in by_pin.items():
                try:
                    self._route_many(routed, endpoint_id=pin)
                except (KeyError, RuntimeError) as exc:
                    # unknown pin / every endpoint died since the budget
                    # check: fail these futures (releasing their quota slots)
                    # rather than dropping them silently
                    for _, future in routed:
                        future.set_exception(exc)
            drained += len(items)
            if not force:
                return drained

    def _pump_queues(self, force: bool = False) -> int:
        now = time.monotonic()
        flushes: List[Tuple[object, List[_Pair]]] = []
        with self._lock:
            for rec in self._records.values():
                if rec.pending is None or not len(rec.pending):
                    continue
                if rec.dead:
                    # late adds racing endpoint death: the watchdog already
                    # failed these tasks over, so drop the stale pairs rather
                    # than delivering to a corpse.
                    rec.pending.flush()
                    continue
                batch = rec.pending.flush() if force else rec.pending.poll(now)
                if batch:
                    flushes.append((rec.endpoint, batch))
        delivered = 0
        for endpoint, batch in flushes:
            self._deliver(endpoint, batch)
            delivered += len(batch)
        return delivered

    def resolve(
        self,
        task_id: str,
        value: Any = None,
        error: Optional[BaseException] = None,
    ) -> bool:
        """Idempotent fabric-level result delivery: complete the future for
        `task_id` unless a terminal outcome is already recorded. Replayed
        completions (journal replay, duplicated ResultBatch frames, restarts)
        dedupe here — counted in ``journal.duplicate_results`` — so a future
        resolves exactly once no matter how many times its result arrives.
        Returns True when this call won the resolution."""
        with self._lock:
            future = self._futures.get(task_id)
        if task_id in self.results or (future is not None and future.done()):
            self.metrics.counter("journal.duplicate_results").inc()
            return False
        if future is None:
            return False  # never routed here (or store already evicted it)
        if error is not None:
            return future.set_exception(error)
        return future.set_result(value)

    def _on_done(
        self, task_id: str, future: TaskFuture, canonical: Optional[str] = None
    ) -> None:
        # the exactly-once authority: the first terminal outcome for this
        # task id is recorded; any later delivery dedupes against the store.
        # A backup copy records under its primary's id (`canonical`), so the
        # speculation loser counts as a duplicate instead of a second task.
        exc = future.exception(0)
        self.results.record(
            canonical or task_id,
            value=None if exc is not None else future.result(0),
            error=exc,
        )
        # Completion hot path: the global lock guards ONLY the map mutations
        # (futures/eta/task→endpoint pops, outstanding decrement). Gauge sync,
        # the EWMA fold, and predictor training run outside it — at scale
        # completer threads must not serialize against routing holding this
        # lock on the other side of the fabric.
        env: Optional[TaskEnvelope] = None
        with self._lock:
            self._futures.pop(task_id, None)
            was_backed = (canonical or task_id) in self._backed
            self._backed.discard(canonical or task_id)
            eta_info = self._eta.pop(task_id, None)
            eid = self._task_endpoint.pop(task_id, None)
            rec = self._records.get(eid) if eid is not None else None
            if rec is not None and task_id in rec.outstanding:
                env = rec.outstanding.pop(task_id)
                if exc is None:
                    rec.completed += 1
        if rec is not None and env is not None:
            rec.sync_outstanding()
            if exc is None:
                ts = future.timestamps
                if ts.result_ready and ts.endpoint_in:
                    rec.observe_latency(
                        max(0.0, ts.result_ready - ts.endpoint_in), self.ewma_alpha
                    )
        if self.predictor is None or eid is None or env is None:
            return
        ts = future.timestamps
        # train the runtime model only on clean, unspeculated primaries: a
        # backed task's shared timestamp trail mixes two copies' clocks
        if (
            canonical is None and not was_backed and exc is None
            and ts.exec_end and ts.exec_start
        ):
            self.predictor.record(
                env.function_id, eid, max(0.0, ts.exec_end - ts.exec_start)
            )
        if canonical is None and eta_info is not None and ts.result_ready:
            routed_at, predicted = eta_info
            self.predictor.observe_eta(
                eid, predicted, max(0.0, ts.result_ready - routed_at)
            )

    # -- ETA-overrun backup speculation ---------------------------------------
    def check_speculation(self) -> int:
        """Launch one backup copy for every unbacked in-flight task older than
        its ETA error bound (``predicted × factor + endpoint queue error``).
        Runs at watchdog cadence when ``speculation=True``; returns how many
        backups launched this call."""
        if self.predictor is None:
            return 0
        now = time.monotonic()
        overdue: List[Tuple[TaskEnvelope, EndpointRecord]] = []
        with self._lock:
            for rec in self._records.values():
                if rec.dead:
                    continue
                for tid, env in rec.outstanding.items():
                    if env.speculative_of or tid in self._backed:
                        continue
                    info = self._eta.get(tid)
                    if info is None:
                        continue  # pinned past the policy: no prediction made
                    routed_at, predicted = info
                    bound = self.predictor.overrun_bound(
                        rec.endpoint.endpoint_id, predicted,
                        self.speculation_eta_factor, self.speculation_min_age_s,
                    )
                    if now - routed_at > bound:
                        overdue.append((env, rec))
        launched = 0
        for env, rec in overdue:
            if self._launch_backup(env, rec):
                launched += 1
        return launched

    def _launch_backup(self, env: TaskEnvelope, source: EndpointRecord) -> bool:
        """Route a speculative duplicate of `env` to a live endpoint other
        than `source`, mapped onto the SAME future. First result wins; the
        loser dedupes (``journal.duplicate_results``). Backups are never
        journaled — the primary's records own the durable identity, so the
        commitment point cannot double-fire."""
        with self._lock:
            future = self._futures.get(env.task_id)
            if future is None or future.done() or env.task_id in self._backed:
                return False
            live = [
                r for r in self._live_records()
                if r is not source
                and _endpoint_satisfies(r.endpoint, env.requirements)
            ]
            if not live:
                return False
            self._backed.add(env.task_id)
            # aliases the primary's packed payload bytes — a backup copy
            # must never duplicate the payload it re-sends
            dup = env.clone_speculative("#eta")
            rec = min(
                live,
                key=lambda r: (
                    len(r.outstanding) / max(1, r.endpoint.capacity()), r.routed
                ),
            )
            rec.outstanding[dup.task_id] = dup
            rec.routed += 1
            rec.sync_outstanding()
            self._futures[dup.task_id] = future
            self._task_endpoint[dup.task_id] = rec.endpoint.endpoint_id
            self.backups_launched += 1
        self.metrics.counter("predictor.backups_launched").inc()
        future.add_done_callback(
            lambda f, tid=dup.task_id, canon=env.task_id: self._on_done(
                tid, f, canonical=canon
            )
        )
        self._deliver(rec.endpoint, [(dup, future)])
        return True

    # -- capacity-proportional sharding ---------------------------------------
    def shard(self, n: int, requirements=()) -> List[Tuple[str, int]]:
        """Split an n-task fan-out across live endpoints proportional to their
        advertised capacity (largest-remainder allocation). With
        `requirements`, only capability-satisfying endpoints receive shards."""
        with self._lock:
            live = self._live_records()
            if not live:
                raise RuntimeError("no live endpoints registered with the forwarder")
            capable = [
                rec for rec in live
                if _endpoint_satisfies(rec.endpoint, requirements)
            ]
            if not capable:
                self.metrics.counter("container.capability_misses").inc()
                raise CapabilityError(
                    f"no live endpoint satisfies requirements "
                    f"{sorted(requirements)} for a {n}-task fan-out"
                )
            caps = [max(1, rec.endpoint.capacity()) for rec in capable]
            ids = [rec.endpoint.endpoint_id for rec in capable]
        total = sum(caps)
        quotas = [n * c / total for c in caps]
        counts = [int(q) for q in quotas]
        remainder = n - sum(counts)
        by_fraction = sorted(
            range(len(ids)), key=lambda i: quotas[i] - counts[i], reverse=True
        )
        for i in by_fraction[:remainder]:
            counts[i] += 1
        return list(zip(ids, counts))

    # -- liveness watchdog + failover -----------------------------------------
    def _watchdog_loop(self) -> None:
        while self._alive:
            time.sleep(self.watchdog_interval_s)
            try:
                self.check_endpoints()
                if self.speculation:
                    self.check_speculation()
            except Exception:  # pragma: no cover - watchdog must never die
                pass

    def check_endpoints(self) -> List[str]:
        """Detect newly-dead endpoints and fail their outstanding tasks over to
        survivors. Returns the ids of endpoints declared dead this call."""
        newly_dead: List[Tuple[EndpointRecord, List[TaskEnvelope]]] = []
        with self._lock:
            for rec in self._records.values():
                if rec.dead:
                    # resurrection: a heartbeat-stall false positive (GIL/CPU
                    # pressure) recovers once the endpoint beats again; a
                    # killed endpoint never does (_alive stays False)
                    is_alive = getattr(rec.endpoint, "is_alive", None)
                    if is_alive is None or is_alive(self.liveness_threshold_s):
                        rec.dead = False
                    continue
                if self._is_live(rec):
                    continue
                rec.dead = True
                evicted = self.sessions.evict_endpoint(rec.endpoint.endpoint_id)
                if evicted:
                    # sticky sessions lose their home with the endpoint; their
                    # next decode step rebinds (and the serving tier
                    # re-prefills the KV cache on the new endpoint)
                    self.metrics.counter("forwarder.session_evictions").inc(evicted)
                stranded = list(rec.outstanding.values())
                rec.outstanding.clear()
                rec.sync_outstanding()
                if rec.pending is not None:
                    # routed-but-undelivered pairs are already in `stranded`
                    # (bookkeeping happens at routing time); just make sure
                    # the pump never delivers them to the corpse.
                    rec.pending.flush()
                newly_dead.append((rec, stranded))
            self.metrics.gauge("forwarder.endpoints_live").set(
                len(self._live_records())
            )
        dead_ids = []
        for rec, stranded in newly_dead:
            dead_ids.append(rec.endpoint.endpoint_id)
            if not self.failover:
                continue
            self._failover_batch(stranded, rec)
        return dead_ids

    def _failover_batch(
        self, stranded: List[TaskEnvelope], source: EndpointRecord
    ) -> None:
        """Re-route every stranded task of a dead endpoint, then re-deliver
        them as whole TaskBatch frames grouped by surviving endpoint (the
        in-flight batch fails over intact rather than task-by-task)."""
        deliveries: Dict[str, List[_Pair]] = {}
        for env in stranded:
            with self._lock:
                future = self._futures.get(env.task_id)
            if future is None or future.done():
                continue
            env.executor_id = None
            try:
                with self._lock:
                    live = self._live_records()
                    if not live:
                        raise RuntimeError("no surviving endpoint for failover")
                    ep = self.choose(env)
                    rec = self._records[ep.endpoint_id]
                    rec.outstanding[env.task_id] = env
                    rec.routed += 1
                    rec.sync_outstanding()
                    self._task_endpoint[env.task_id] = ep.endpoint_id
                    future.endpoint_id = ep.endpoint_id
                self.failovers += 1
                self.metrics.counter("forwarder.failovers").inc()
                if self.journal is not None:
                    self.journal.append(
                        "task", "routed",
                        task_id=env.task_id, endpoint_id=ep.endpoint_id,
                    )
                deliveries.setdefault(ep.endpoint_id, []).append((env, future))
            except RuntimeError as exc:
                is_alive = getattr(source.endpoint, "is_alive", None)
                if is_alive is not None and is_alive(None):
                    # merely stalled, not halted: leave the task with its
                    # endpoint — it still owns the future and can complete it.
                    # Re-check done under the lock: if it completed since the
                    # outstanding map was cleared, _on_done already ran and a
                    # re-add would leak a phantom entry forever.
                    with self._lock:
                        if not future.done():
                            source.outstanding[env.task_id] = env
                            source.sync_outstanding()
                    continue
                self.orphaned += 1
                self.metrics.counter("forwarder.orphaned").inc()
                # a capability miss keeps its type so callers can tell
                # "no capable survivor" from generic endpoint loss
                wrapped: RuntimeError = (
                    CapabilityError(f"task {env.task_id} lost: {exc}")
                    if isinstance(exc, CapabilityError)
                    else RuntimeError(f"task {env.task_id} lost: {exc}")
                )
                future.set_exception(wrapped)
        for eid, routed in deliveries.items():
            with self._lock:
                rec = self._records.get(eid)
            if rec is not None:
                self._deliver(rec.endpoint, routed)

    # -- lifecycle / stats ----------------------------------------------------
    def shutdown(self) -> None:
        if self._pump is not None:
            self.pump_once(force=True)  # don't strand queued tasks
        self._alive = False
        self._pump_event.set()
        self._watchdog.join(timeout=2.0)
        if self._pump is not None:
            self._pump.join(timeout=2.0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy,
                "shard": self.shard_label,
                "fairness": self._fair is not None,
                "fair_pending": self._fair.pending() if self._fair is not None else 0,
                "failovers": self.failovers,
                "orphaned": self.orphaned,
                "sessions": len(self.sessions),
                "speculation": self.speculation,
                "backups_launched": self.backups_launched,
                "predictor": (
                    self.predictor.stats() if self.predictor is not None else None
                ),
                "max_batch": self.max_batch,
                "max_delay_s": self.max_delay_s,
                "batches_delivered": self.batches_delivered,
                "tasks_delivered": self.tasks_delivered,
                "mean_batch_size": (
                    self.tasks_delivered / self.batches_delivered
                    if self.batches_delivered
                    else 0.0
                ),
                "endpoints": {
                    eid: {
                        "routed": rec.routed,
                        "completed": rec.completed,
                        "outstanding": len(rec.outstanding),
                        "pending": len(rec.pending) if rec.pending is not None else 0,
                        "latency_ewma_s": rec.latency_ewma,
                        "dead": rec.dead,
                        "capacity": rec.endpoint.capacity() if not rec.dead else 0,
                    }
                    for eid, rec in self._records.items()
                },
            }


# -- sharded front ------------------------------------------------------------
def shard_of(task_id: str, n_shards: int) -> int:
    """Stable task→shard partition (crc32: deterministic across processes, so
    a resumed fabric reassigns every journaled task to the same shard)."""
    return zlib.crc32(task_id.encode()) % n_shards


class _ShardedResults:
    """ResultStore facade over a ShardedForwarder: each task's exactly-once
    record lives in its owning shard's store; `prime`/`__contains__` route by
    the same hash the submit path uses, so journal resume primes every
    shard's ResultStore with exactly its own tasks."""

    def __init__(self, owner: "ShardedForwarder"):
        self._owner = owner

    def _store(self, task_id: str) -> ResultStore:
        return self._owner.shard_for(task_id).results

    def prime(self, task_id: str) -> bool:
        return self._store(task_id).prime(task_id)

    def record(self, task_id: str, value: Any = None, error: Any = None) -> bool:
        return self._store(task_id).record(task_id, value=value, error=error)

    def get(self, task_id: str):
        return self._store(task_id).get(task_id)

    def __contains__(self, task_id: str) -> bool:
        return task_id in self._store(task_id)

    def __len__(self) -> int:
        return sum(len(f.results) for f in self._owner.shards)


class ShardedForwarder:
    """N independent :class:`Forwarder` shards behind one Forwarder-shaped
    front (the federated follow-ups' multi-forwarder deployment).

    ``task_id → shard`` is a stable hash partition: every per-task structure
    (future map, outstanding entry, ETA record, result slot) lives in exactly
    one shard, so shards share no per-task state and each keeps its own lock,
    submit queues, pump thread, and watchdog — completions on shard A never
    contend with routing on shard B, which is what lifts the single global
    RLock's throughput ceiling. Endpoints register with every shard; each
    shard learns its own latency/outstanding view of them (gauge series are
    disambiguated with a ``shard`` label).

    The single :class:`Forwarder` is the degenerate one-shard case: the
    surface consumed by :class:`~repro.core.service.FunctionService`
    (register/submit_many/results/journal/resume/shard/stats/shutdown) is
    mirrored here, so services, journal resume, and speculation work
    unchanged against either. With a fairness policy, all shards share one
    :class:`~repro.core.fairness.TenantLedger` so quotas cap a tenant's
    fabric-wide outstanding count, not per-shard.
    """

    def __init__(
        self,
        n_shards: int = 4,
        policy: str = "least_outstanding",
        metrics: Optional[MetricsRegistry] = None,
        journal: Optional[Journal] = None,
        fairness: Optional[FairnessPolicy] = None,
        **forwarder_kwargs,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.fairness = fairness
        ledger = TenantLedger(metrics=self.metrics) if fairness is not None else None
        self.ledger = ledger
        # One session router across every shard: a session's decode steps
        # hash to different shards by task_id, but must agree on their home.
        self.sessions = SessionRouter()
        self.shards: List[Forwarder] = [
            Forwarder(
                policy=policy,
                metrics=self.metrics,
                journal=journal,
                fairness=fairness,
                tenant_ledger=ledger,
                shard=str(i),
                session_router=self.sessions,
                **forwarder_kwargs,
            )
            for i in range(n_shards)
        ]
        self.results = _ShardedResults(self)

    # -- partition -----------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_index(self, task_id: str) -> int:
        return shard_of(task_id, len(self.shards))

    def shard_for(self, task_id: str) -> Forwarder:
        return self.shards[self.shard_index(task_id)]

    # -- Forwarder-shaped surface ---------------------------------------------
    @property
    def policy(self) -> str:
        return self.shards[0].policy

    @property
    def speculation(self) -> bool:
        return self.shards[0].speculation

    @property
    def journal(self) -> Optional[Journal]:
        return self.shards[0].journal

    @journal.setter
    def journal(self, journal: Optional[Journal]) -> None:
        for fwd in self.shards:
            fwd.journal = journal

    @property
    def liveness_threshold_s(self) -> float:
        return self.shards[0].liveness_threshold_s

    @liveness_threshold_s.setter
    def liveness_threshold_s(self, v: float) -> None:
        for fwd in self.shards:
            fwd.liveness_threshold_s = v

    @property
    def watchdog_interval_s(self) -> float:
        return self.shards[0].watchdog_interval_s

    @watchdog_interval_s.setter
    def watchdog_interval_s(self, v: float) -> None:
        for fwd in self.shards:
            fwd.watchdog_interval_s = v

    @property
    def failovers(self) -> int:
        return sum(f.failovers for f in self.shards)

    @property
    def orphaned(self) -> int:
        return sum(f.orphaned for f in self.shards)

    @property
    def backups_launched(self) -> int:
        return sum(f.backups_launched for f in self.shards)

    def register(self, endpoint) -> str:
        for fwd in self.shards:
            fwd.register(endpoint)
        return endpoint.endpoint_id

    def deregister(self, endpoint_id: str) -> None:
        for fwd in self.shards:
            fwd.deregister(endpoint_id)

    def rebind_metrics(self, metrics: MetricsRegistry) -> None:
        self.metrics = metrics
        if self.ledger is not None:
            self.ledger.bind_metrics(metrics)
        for fwd in self.shards:
            fwd.rebind_metrics(metrics)

    def endpoint_ids(self) -> List[str]:
        return self.shards[0].endpoint_ids()

    def endpoints(self) -> Dict[str, object]:
        return self.shards[0].endpoints()

    def live_count(self) -> int:
        return self.shards[0].live_count()

    def choose(self, env: TaskEnvelope):
        return self.shard_for(env.task_id).choose(env)

    def submit(
        self,
        env: TaskEnvelope,
        future: TaskFuture,
        endpoint_id: Optional[str] = None,
    ) -> Optional[str]:
        return self.shard_for(env.task_id).submit(env, future, endpoint_id=endpoint_id)

    def submit_many(
        self,
        pairs: Sequence[_Pair],
        endpoint_id: Optional[str] = None,
    ) -> List[Optional[str]]:
        """Partition the batch by task-id hash and submit each sub-batch to
        its owning shard, stitching per-pair results back into input order."""
        pairs = list(pairs)
        if not pairs:
            return []
        n = len(self.shards)
        by_shard: Dict[int, List[int]] = {}
        for i, (env, _) in enumerate(pairs):
            by_shard.setdefault(shard_of(env.task_id, n), []).append(i)
        chosen: List[Optional[str]] = [None] * len(pairs)
        for idx, indices in by_shard.items():
            self.metrics.counter(
                "forwarder.shard_tasks", {"shard": str(idx)}
            ).inc(len(indices))
            sub = self.shards[idx].submit_many(
                [pairs[i] for i in indices], endpoint_id=endpoint_id
            )
            for i, eid in zip(indices, sub):
                chosen[i] = eid
        return chosen

    def shard(self, n: int, requirements=()) -> List[Tuple[str, int]]:
        """Capacity-proportional fan-out split (endpoint view is identical
        across shards, so shard 0 answers for all)."""
        return self.shards[0].shard(n, requirements=requirements)

    def pump_once(self, force: bool = False) -> int:
        return sum(fwd.pump_once(force=force) for fwd in self.shards)

    def check_endpoints(self) -> List[str]:
        dead: List[str] = []
        for fwd in self.shards:
            for eid in fwd.check_endpoints():
                if eid not in dead:
                    dead.append(eid)
        return dead

    def check_speculation(self) -> int:
        return sum(fwd.check_speculation() for fwd in self.shards)

    def shutdown(self) -> None:
        for fwd in self.shards:
            fwd.shutdown()

    def stats(self) -> dict:
        per_shard = [fwd.stats() for fwd in self.shards]
        endpoints: Dict[str, dict] = {}
        for s in per_shard:
            for eid, ep in s["endpoints"].items():
                agg = endpoints.setdefault(eid, {
                    "routed": 0, "completed": 0, "outstanding": 0,
                    "pending": 0, "dead": ep["dead"], "capacity": ep["capacity"],
                })
                for k in ("routed", "completed", "outstanding", "pending"):
                    agg[k] += ep[k]
                agg["dead"] = agg["dead"] and ep["dead"]
        return {
            "policy": self.policy,
            "n_shards": len(self.shards),
            "fairness": self.fairness is not None,
            "failovers": self.failovers,
            "orphaned": self.orphaned,
            "sessions": len(self.sessions),
            "speculation": self.speculation,
            "backups_launched": self.backups_launched,
            "batches_delivered": sum(s["batches_delivered"] for s in per_shard),
            "tasks_delivered": sum(s["tasks_delivered"] for s in per_shard),
            "endpoints": endpoints,
            "shards": per_shard,
        }
