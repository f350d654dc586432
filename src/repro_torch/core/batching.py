"""Batching (paper §5.5, Figs. 8).

Two models, exactly as in the paper:

1. *Executor-side batching*: executors request many tasks per round on behalf
   of their idle workers (implemented in `endpoint.py`'s dispatch loop via
   capacity advertising; this module provides the grouping helper).
2. *User-driven batching*: the caller stacks many input documents into one
   invocation, trading per-request latency for throughput. Helpers here stack
   and unstack array pytrees along a new leading axis.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, List, Sequence

import numpy as np

from .futures import TaskEnvelope


def group_by_function(tasks: Sequence[TaskEnvelope]) -> dict:
    """Executor-side grouping: tasks of the same (function, container) can be
    delivered to one executor in a single round."""
    groups: dict = defaultdict(list)
    for t in tasks:
        groups[(t.function_id, t.container)].append(t)
    return dict(groups)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        typ = type(tree)
        return typ(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    out: list = []
    if isinstance(tree, dict):
        for k in sorted(tree, key=repr):
            out.extend(_tree_leaves(tree[k]))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out.extend(_tree_leaves(v))
    else:
        out.append(tree)
    return out


def stack_payloads(payloads: Sequence[Any]) -> Any:
    """Stack N structurally-identical payload pytrees along a new axis 0.

    Non-array leaves must be equal across payloads (they become the shared
    value); array leaves are stacked. Raises ValueError on mismatch.
    """
    if not payloads:
        raise ValueError("empty batch")

    def stack_leaf(*leaves):
        if isinstance(leaves[0], np.ndarray) or hasattr(leaves[0], "__array__"):
            return np.stack([np.asarray(x) for x in leaves], axis=0)
        if any(x != leaves[0] for x in leaves[1:]):
            raise ValueError(f"non-array leaves differ across batch: {leaves!r}")
        return leaves[0]

    def rec(*nodes):
        n0 = nodes[0]
        if isinstance(n0, dict):
            keys = set(n0)
            for n in nodes[1:]:
                if set(n) != keys:
                    raise ValueError("payload structures differ (dict keys)")
            return {k: rec(*[n[k] for n in nodes]) for k in n0}
        if isinstance(n0, (list, tuple)):
            ln = len(n0)
            for n in nodes[1:]:
                if len(n) != ln or type(n) is not type(n0):
                    raise ValueError("payload structures differ (sequence)")
            typ = type(n0)
            out = [rec(*[n[i] for n in nodes]) for i in range(ln)]
            return typ(out) if typ is tuple else out
        return stack_leaf(*nodes)

    return rec(*payloads)


def unstack_results(result: Any, n: int) -> List[Any]:
    """Split a stacked result back into per-request results."""

    def get(i):
        def leaf(x):
            if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
                arr = np.asarray(x)
                if arr.ndim >= 1 and arr.shape[0] == n:
                    return arr[i]
            return x

        return _tree_map(leaf, result)

    return [get(i) for i in range(n)]


class MicroBatcher:
    """Accumulates requests until `max_batch` or `max_wait_s`, then flushes.

    Used by the serving engine for continuous batching of decode requests —
    the same flush-on-size / flush-on-deadline policy that the task-flow
    pipeline's :class:`repro.core.interchange.BatchCoalescer` applies between
    tiers, but caller-clocked: the engine loop supplies the oldest-item age
    and drains explicitly, so no internal timestamps are kept.
    """

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.002):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._pending: list = []

    def add(self, item) -> None:
        self._pending.append(item)

    def ready(self, oldest_age_s: float) -> bool:
        if not self._pending:
            return False
        return len(self._pending) >= self.max_batch or oldest_age_s >= self.max_wait_s

    def drain(self) -> list:
        out, self._pending = self._pending, []
        return out

    def __len__(self) -> int:
        return len(self._pending)
