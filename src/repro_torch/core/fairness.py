"""Multi-tenant fairness and admission control (funcX federation follow-ups).

The funcX federated-fabric papers describe the hosted service arbitrating many
users over shared endpoint fleets: per-user quotas bound how much of the fabric
any one identity can hold in flight, and the forwarder tier drains competing
users' queues fairly instead of FIFO (a greedy tenant's 10^6-task backlog must
not add its full drain time to a light tenant's p99).

Three pieces, all consumed by :class:`~repro.core.forwarder.Forwarder`:

- :class:`FairnessPolicy` — the knobs: per-tenant quota (max outstanding tasks
  before admission rejects with ``retry_after``) and weight (fair-share ratio),
  with defaults for unknown tenants. Binds to a
  :class:`~repro.core.auth.TokenAuthority` so quotas/weights declared on
  tenant profiles (``set_tenant_profile``) apply fabric-wide.
- :class:`TenantLedger` — global outstanding-task accounting. One ledger is
  shared by every shard of a :class:`~repro.core.forwarder.ShardedForwarder`
  so a tenant's quota caps its *fabric-wide* footprint, not per-shard.
- :class:`DeficitRoundRobin` — weighted fair queueing across per-tenant
  submit queues. The forwarder's pump drains it with a budget equal to the
  fabric's spare capacity; tasks beyond that stay in their tenant's queue, so
  a light tenant's task is interleaved ahead of a greedy tenant's backlog.

Rejections surface as :class:`AdmissionError` on the task future, carrying
``retry_after`` (seconds) — the client-visible backpressure signal the paper's
hosted service returns instead of queueing unboundedly.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

#: identity used when a task carries no tenant stamp (no auth configured)
ANONYMOUS = "anonymous"


class AdmissionError(RuntimeError):
    """A tenant's outstanding count exceeds its quota; retry later.

    ``retry_after`` estimates (seconds) when quota headroom should free up,
    derived from observed endpoint service latency and the tenant's backlog.
    """

    def __init__(self, tenant: str, quota: int, outstanding: int, retry_after: float):
        super().__init__(
            f"tenant {tenant!r} at quota ({outstanding}/{quota} outstanding); "
            f"retry after {retry_after:.3f}s"
        )
        self.tenant = tenant
        self.quota = quota
        self.outstanding = outstanding
        self.retry_after = retry_after


@dataclass
class FairnessPolicy:
    """Quota/weight knobs for multi-tenant scheduling.

    Precedence for a tenant's quota (weight works the same):
    explicit ``quotas[tenant]`` → the authority's tenant profile →
    ``default_quota``. ``None`` quota means unlimited.
    """

    default_quota: Optional[int] = None   # None = unlimited outstanding
    default_weight: float = 1.0
    quantum: int = 16                     # DRR credits added per round, scaled by weight
    base_retry_after_s: float = 0.05      # retry_after floor when no latency observed
    quotas: Dict[str, int] = field(default_factory=dict)
    weights: Dict[str, float] = field(default_factory=dict)
    _authority: Any = field(default=None, repr=False, compare=False)

    def bind_profiles(self, authority: Any) -> "FairnessPolicy":
        """Consult `authority.tenant_profile(identity)` for per-tenant knobs
        not set explicitly on this policy."""
        self._authority = authority
        return self

    def _profile(self, tenant: str):
        if self._authority is None:
            return None
        getter = getattr(self._authority, "tenant_profile", None)
        return getter(tenant) if getter is not None else None

    def quota_of(self, tenant: str) -> Optional[int]:
        if tenant in self.quotas:
            return self.quotas[tenant]
        prof = self._profile(tenant)
        if prof is not None and prof.quota is not None:
            return prof.quota
        return self.default_quota

    def weight_of(self, tenant: str) -> float:
        if tenant in self.weights:
            return self.weights[tenant]
        prof = self._profile(tenant)
        if prof is not None and prof.weight is not None:
            return prof.weight
        return self.default_weight


class TenantLedger:
    """Fabric-global outstanding-task counts, one entry per tenant.

    Shared by every forwarder shard: admission (`try_admit`) and completion
    (`release`) are single small-lock counter bumps, so the ledger never
    becomes the contention point the sharding removed.
    """

    def __init__(self, metrics=None):
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {}
        self.metrics = metrics

    def bind_metrics(self, metrics) -> None:
        self.metrics = metrics

    def try_admit(self, tenant: str, quota: Optional[int]) -> bool:
        """Reserve one outstanding slot for `tenant`; False when at quota."""
        with self._lock:
            cur = self._outstanding.get(tenant, 0)
            if quota is not None and cur >= quota:
                return False
            self._outstanding[tenant] = cur + 1
        if self.metrics is not None:
            self.metrics.gauge("fair.tenant_outstanding", {"tenant": tenant}).set(cur + 1)
        return True

    def release(self, tenant: str) -> None:
        with self._lock:
            cur = self._outstanding.get(tenant, 0)
            nxt = max(0, cur - 1)
            if nxt:
                self._outstanding[tenant] = nxt
            else:
                self._outstanding.pop(tenant, None)
        if self.metrics is not None:
            self.metrics.gauge("fair.tenant_outstanding", {"tenant": tenant}).set(nxt)

    def outstanding(self, tenant: str) -> int:
        with self._lock:
            return self._outstanding.get(tenant, 0)


class DeficitRoundRobin:
    """Weighted fair dequeue across per-tenant queues (classic DRR).

    Each drain round grants every backlogged tenant ``weight * quantum``
    credits; a tenant dequeues one task per credit. Rounds repeat until the
    caller's budget is spent or all queues are dry, and the tenant rotation
    persists across drains (served tenants move to the back), so over time
    each backlogged tenant's share of dequeues converges to its weight share.
    """

    def __init__(self, policy: FairnessPolicy, metrics=None):
        self.policy = policy
        self.metrics = metrics
        self._lock = threading.Lock()
        self._queues: "OrderedDict[str, Deque[Any]]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._pending = 0

    def __len__(self) -> int:
        return self._pending

    def pending(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is None:
                return self._pending
            q = self._queues.get(tenant)
            return len(q) if q is not None else 0

    def enqueue(self, tenant: str, item: Any) -> None:
        with self._lock:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
            q.append(item)
            self._pending += 1
            depth = len(q)
        if self.metrics is not None:
            self.metrics.gauge("fair.queue_depth", {"tenant": tenant}).set(depth)

    def drain(self, budget: int) -> List[Any]:
        """Dequeue up to `budget` items, weighted-fairly across tenants."""
        out: List[Any] = []
        rounds = 0
        touched: Dict[str, int] = {}
        with self._lock:
            while self._pending and len(out) < budget:
                rounds += 1
                progressed = False
                for tenant in list(self._queues):
                    q = self._queues[tenant]
                    if not q:
                        continue
                    credit = self._deficit.get(tenant, 0.0)
                    credit += self.policy.weight_of(tenant) * self.policy.quantum
                    while q and credit >= 1.0 and len(out) < budget:
                        out.append(q.popleft())
                        self._pending -= 1
                        credit -= 1.0
                        progressed = True
                    if q:
                        self._deficit[tenant] = credit
                        # move served tenants back so the next drain starts
                        # with whoever waited longest
                        self._queues.move_to_end(tenant)
                    else:
                        # empty queue forfeits its credit (classic DRR: no
                        # banking credits while idle)
                        self._deficit.pop(tenant, None)
                        del self._queues[tenant]
                    touched[tenant] = len(q)
                    if len(out) >= budget:
                        break
                if not progressed:
                    break
        if self.metrics is not None and out:
            self.metrics.counter("fair.drr_rounds").inc(rounds)
            for tenant, depth in touched.items():
                self.metrics.gauge("fair.queue_depth", {"tenant": tenant}).set(depth)
        return out
