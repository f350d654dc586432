"""Task -> executor scheduling.

The paper's manager "uses a randomized scheduling algorithm to allocate
functions to executors" (§5.3) and names resource-aware scheduling as future
work (§8). We implement randomized scheduling as the paper-faithful baseline
plus three beyond-paper policies measured in the benchmarks — and the §8
future work itself: every policy now runs *after* a capability filter, so a
task only ever reaches an executor hosting a container pool that provides
its required capabilities.

- random: uniform choice among capable executors with capacity.
- round_robin: classic fair rotation.
- least_loaded: pick the executor advertising the most free capacity for
  this task's container type.
- warm_affinity: prefer executors that already hold a warm executable for the
  task's (function, container) — compile-cache locality.
"""
from __future__ import annotations

import random
import threading
from typing import Optional, Sequence

from .futures import TaskEnvelope

POLICIES = ("random", "round_robin", "least_loaded", "warm_affinity")


class Scheduler:
    def __init__(self, policy: str = "random", seed: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; choose from {POLICIES}")
        self.policy = policy
        self._rng = random.Random(seed)
        self._rr = 0
        self._lock = threading.Lock()

    @staticmethod
    def capable(executors: Sequence, task: TaskEnvelope) -> list:
        """Executors hosting a container pool that can run `task` (the §8
        resource-aware filter — applied before any policy)."""
        return [ex for ex in executors if ex.accepting() and ex.can_run(task)]

    def choose(self, executors: Sequence, task: TaskEnvelope):
        """Pick an executor for `task` (each candidate exposes .accepting(),
        .can_run(env), .free_capacity_for(env), .has_warm(key),
        .executor_id). Returns None if no capable executor has capacity."""
        live = [
            ex for ex in self.capable(executors, task)
            if ex.free_capacity_for(task) > 0
        ]
        if not live:
            return None
        if self.policy == "random":
            return self._rng.choice(live)
        if self.policy == "round_robin":
            with self._lock:
                ex = live[self._rr % len(live)]
                self._rr += 1
            return ex
        if self.policy == "least_loaded":
            return max(live, key=lambda ex: ex.free_capacity_for(task))
        if self.policy == "warm_affinity":
            key = (task.function_id, task.container)
            warm = [ex for ex in live if ex.has_warm(key)]
            pool = warm or live
            return max(pool, key=lambda ex: ex.free_capacity_for(task))
        raise AssertionError(self.policy)
