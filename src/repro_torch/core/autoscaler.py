"""Policy-driven elastic autoscaling (paper §5.4 "managed elasticity").

funcX endpoints grow and shrink pilot-job blocks to track demand. The seed's
heuristic ("scale out by 1 when the queue is deep") had no scale-in and no
policy surface; this module makes provisioning a first-class subsystem, the
way the follow-up funcX papers (arXiv:2005.04215, arXiv:2209.11631) treat it:

- A :class:`ScalingPolicy` computes *desired blocks* from a
  :class:`ScalingObservation` (queue depth, in-flight tasks, live blocks,
  observed latency). Two built-ins:

  * :class:`TargetQueueDepthPolicy` — size the pool so each worker carries at
    most ``target_tasks_per_worker`` queued+running tasks.
  * :class:`LatencySLOPolicy` — scale out while observed p95 latency exceeds
    the SLO; scale in only when comfortably under it *and* idle.

- The :class:`Autoscaler` clamps desired blocks to the provider's
  ``ProviderSpec.min_blocks``/``max_blocks``, scales **out** in proportional
  steps (``step_fraction`` of the gap per tick, so a big burst converges in a
  few heartbeats without overshooting), and scales **in** at most one block
  per tick after a ``cooldown_s`` quiet period — draining the chosen executor
  (suspend, verify no in-flight work, release) so no task is ever lost to a
  scale-in. The cool-down timer resets on every scale-out, which prevents
  flapping under oscillating load.

- Every decision is published through the shared :class:`MetricsRegistry`
  (``autoscaler.*`` gauges/counters, catalog in docs/scaling.md), the same
  registry the Forwarder's ``latency_aware`` routing reads — telemetry and
  control consume one set of numbers.

The watchdog's replacement path also routes through :meth:`replace_block`:
the dead block is *released* from the provider before a replacement is
requested, so repeated failures can no longer leak dead blocks into the
provider's bookkeeping or exceed the ``max_blocks`` ceiling.
"""
from __future__ import annotations

import abc
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Optional

from .metrics import MetricsRegistry
from .provider import Provider


@dataclass
class ScalingObservation:
    """One heartbeat's view of endpoint load, fed to the policy."""

    queue_depth: int = 0
    outstanding: int = 0          # dispatched-but-unfinished across executors
    blocks: int = 0               # live (accepting) blocks
    workers_per_block: int = 1
    p95_latency_s: Optional[float] = None

    @property
    def demand(self) -> int:
        return self.queue_depth + self.outstanding


@dataclass
class ScalingDecision:
    """What the autoscaler decided on one tick (kept in a bounded history
    and mirrored into the metrics registry)."""

    at: float
    action: str                   # "scale_out" | "scale_in" | "hold"
    current: int
    desired: int
    delta: int = 0
    reason: str = ""
    observation: ScalingObservation = field(default_factory=ScalingObservation)


class ScalingPolicy(abc.ABC):
    """Maps an observation to a raw desired block count (pre-clamp)."""

    name = "abstract"

    @abc.abstractmethod
    def desired_blocks(self, obs: ScalingObservation) -> int:
        ...


class TargetQueueDepthPolicy(ScalingPolicy):
    """Provision so each worker carries at most `target_tasks_per_worker`
    queued+running tasks. Zero demand ⇒ zero blocks (the autoscaler clamps
    to ``min_blocks``)."""

    name = "queue_depth"

    def __init__(self, target_tasks_per_worker: float = 2.0):
        if target_tasks_per_worker <= 0:
            raise ValueError("target_tasks_per_worker must be positive")
        self.target_tasks_per_worker = target_tasks_per_worker

    def desired_blocks(self, obs: ScalingObservation) -> int:
        if obs.demand <= 0:
            return 0
        workers_needed = obs.demand / self.target_tasks_per_worker
        return max(1, math.ceil(workers_needed / max(1, obs.workers_per_block)))


class LatencySLOPolicy(ScalingPolicy):
    """Hold p95 task latency under an SLO: scale out (half again the current
    pool) while p95 breaches `slo_s` under demand; drain one block per tick
    while idle. Idleness dominates the latency signal — the p95 window
    freezes when traffic stops, so a stale breach sample must never pin an
    idle endpoint at max_blocks."""

    name = "latency_slo"

    def __init__(self, slo_s: float):
        if slo_s <= 0:
            raise ValueError("slo_s must be positive")
        self.slo_s = slo_s

    def desired_blocks(self, obs: ScalingObservation) -> int:
        if obs.blocks == 0:
            # bootstrap: no block will ever produce a latency signal, so
            # demand alone must bring the pool back from zero
            return 1 if obs.demand else 0
        if obs.demand == 0:
            return obs.blocks - 1  # idle: drain toward min_blocks
        if obs.p95_latency_s is not None and obs.p95_latency_s > self.slo_s:
            return obs.blocks + max(1, math.ceil(obs.blocks * 0.5))
        return obs.blocks


def make_policy(policy, **kwargs) -> ScalingPolicy:
    """Resolve a policy spec: a ScalingPolicy instance passes through; the
    strings "queue_depth" / "latency_slo" build the matching built-in."""
    if isinstance(policy, ScalingPolicy):
        return policy
    if policy == "queue_depth":
        return TargetQueueDepthPolicy(kwargs.get("target_tasks_per_worker", 2.0))
    if policy == "latency_slo":
        return LatencySLOPolicy(kwargs.get("latency_slo_s", 1.0))
    raise ValueError(f"unknown scaling policy {policy!r}")


class Autoscaler:
    """Drives a Provider's block count from policy decisions.

    `host` is the endpoint-shaped owner of the blocks; the autoscaler needs
    three things from it (duck-typed so tests can fake it):

    - ``observe() -> ScalingObservation``
    - ``select_idle_block() -> Optional[(block_id, executor)]`` — a candidate
      whose executor has no queued or in-flight work; the executor must
      support ``suspend()``/``resume()`` and expose ``in_flight`` +
      ``queued_tasks()`` (backlog across its container pools).
    - ``release_block(block_id) -> None`` — drop the executor from the
      host's tables and ``scale_in`` the block at the provider.
    """

    def __init__(
        self,
        provider: Provider,
        host,
        policy="queue_depth",
        cooldown_s: float = 30.0,
        step_fraction: float = 0.5,
        metrics: Optional[MetricsRegistry] = None,
        name: str = "",
        clock: Callable[[], float] = time.monotonic,
        history: int = 256,
        **policy_kwargs,
    ):
        self.provider = provider
        self.host = host
        self.policy = make_policy(policy, **policy_kwargs)
        self.cooldown_s = cooldown_s
        self.step_fraction = step_fraction
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.name = name
        self.clock = clock
        self._lock = threading.Lock()
        # arm the cooldown at birth: the operator's init_blocks survive at
        # least one quiet period before the first scale-in can touch them
        self._last_scale_out = self.clock()
        self._last_scale_in = -math.inf
        self.history: Deque[ScalingDecision] = deque(maxlen=history)
        self.scale_out_events = 0
        self.scale_in_events = 0
        self.replacements = 0
        self.ceiling_denials = 0

    # -- bounds ------------------------------------------------------------
    @property
    def min_blocks(self) -> int:
        return self.provider.spec.min_blocks

    @property
    def max_blocks(self) -> int:
        return self.provider.spec.max_blocks

    def current_blocks(self) -> int:
        return self.provider.status()["blocks"]

    def clamp(self, desired: int) -> int:
        return max(self.min_blocks, min(self.max_blocks, desired))

    # -- the control loop entry point --------------------------------------
    def tick(self, obs: Optional[ScalingObservation] = None) -> ScalingDecision:
        """One heartbeat of the control loop: observe → decide → act.
        Serialized by a lock so a slow provider call can't interleave with
        the next heartbeat's decision."""
        with self._lock:
            if obs is None:
                obs = self.host.observe()
            now = self.clock()
            desired = self.clamp(self.policy.desired_blocks(obs))
            current = self.current_blocks()
            decision = ScalingDecision(
                at=now, action="hold", current=current, desired=desired,
                observation=obs,
            )
            if desired > current:
                gap = desired - current
                step = max(1, math.ceil(gap * self.step_fraction))
                step = min(step, self.max_blocks - current)
                created = self.provider.scale_out(step)
                decision.action = "scale_out"
                decision.delta = len(created)
                decision.reason = (
                    f"demand={obs.demand} desired={desired} step={step}"
                )
                if created:
                    self._last_scale_out = now
                    self.scale_out_events += 1
                    self.metrics.counter("autoscaler.scale_out_events").inc()
            elif desired < current and current > self.min_blocks:
                quiet_since = max(self._last_scale_out, self._last_scale_in)
                if now - quiet_since < self.cooldown_s:
                    decision.reason = "cooldown"
                else:
                    released = self._drain_one_idle_block()
                    if released:
                        decision.action = "scale_in"
                        decision.delta = -1
                        decision.reason = f"idle, desired={desired}"
                        self._last_scale_in = now
                        self.scale_in_events += 1
                        self.metrics.counter("autoscaler.scale_in_events").inc()
                    else:
                        decision.reason = "no idle block to drain"
            self.history.append(decision)
            self._publish(decision)
            return decision

    def _drain_one_idle_block(self) -> bool:
        """Drain-then-release: suspend the candidate executor so the
        scheduler stops feeding it, re-verify it is still empty (a dispatch
        may have raced the selection), and only then release the block. An
        executor with any outstanding work is resumed, never killed."""
        cand = self.host.select_idle_block()
        if cand is None:
            return False
        block_id, ex = cand
        ex.suspend()
        if len(ex.in_flight) or ex.queued_tasks():
            ex.resume()
            return False
        self.host.release_block(block_id)
        return True

    # -- watchdog replacement path ------------------------------------------
    def replace_block(self, dead_block_id: Optional[str]) -> bool:
        """Replace a failed block: release the corpse first (so dead blocks
        never accumulate in the provider's bookkeeping), then request one
        replacement if — and only if — the ceiling allows it. Returns True
        when a replacement block was provisioned.

        The corpse is released, not scaled in: a false-positive death (a
        heartbeat stall, which the Forwarder's resurrection path explicitly
        anticipates) must leave the executor running so its late results
        still resolve futures — only genuine scale-in tears blocks down."""
        with self._lock:
            if dead_block_id is not None:
                self.provider.release([dead_block_id])
            if self.current_blocks() >= self.max_blocks:
                self.ceiling_denials += 1
                self.metrics.counter("autoscaler.ceiling_denials").inc()
                return False
            created = self.provider.scale_out(1)
            if created:
                self.replacements += 1
                self.metrics.counter("autoscaler.replacements").inc()
                self._last_scale_out = self.clock()
            return bool(created)

    # -- telemetry ----------------------------------------------------------
    def _publish(self, decision: ScalingDecision) -> None:
        labels = {"endpoint": self.name} if self.name else None
        m = self.metrics
        m.gauge("autoscaler.desired_blocks", labels).set(decision.desired)
        m.gauge("autoscaler.blocks", labels).set(self.current_blocks())
        m.gauge("autoscaler.queue_depth", labels).set(
            decision.observation.queue_depth
        )

    def stats(self) -> dict:
        with self._lock:
            last = self.history[-1] if self.history else None
            return {
                "policy": self.policy.name,
                "min_blocks": self.min_blocks,
                "max_blocks": self.max_blocks,
                "blocks": self.current_blocks(),
                "cooldown_s": self.cooldown_s,
                "scale_out_events": self.scale_out_events,
                "scale_in_events": self.scale_in_events,
                "replacements": self.replacements,
                "ceiling_denials": self.ceiling_denials,
                "last_decision": (
                    {
                        "action": last.action,
                        "desired": last.desired,
                        "current": last.current,
                        "reason": last.reason,
                    }
                    if last
                    else None
                ),
            }
