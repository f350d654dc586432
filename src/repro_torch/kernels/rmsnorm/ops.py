"""Dispatching wrapper: the Hopper fused add + RMSNorm kernel on CUDA tensors,
the plain version on CPU ones.

``impl``: "auto" (the kernel for a CUDA tensor, the reference for a CPU
tensor), "kernel" (the kernel; a CPU tensor is an error), "ref" (the plain
PyTorch version on any device, which ``chip_smoke.py`` uses as the yardstick
of correctness). A CUDA tensor under "auto" never falls back to the reference.
Given DTensors (a model on a mesh) it runs on every rank's rows through
``sharding.local.local_call``; a sharded last axis is gathered first.
"""
from __future__ import annotations

import functools

from .. import use_ref
from ...sharding.local import local_call
from ...sharding.partition import is_dtensor
from . import kernel, ref


def fused_add_rmsnorm(x, delta, scale, eps: float = 1e-5, impl: str = "auto"):
    """(x + delta, rmsnorm(x + delta) * scale), both in x's dtype."""
    fn = ref.fused_add_rmsnorm_reference if use_ref(x, impl) else kernel.fused_add_rmsnorm
    if is_dtensor(x) or is_dtensor(delta):
        rows = "abcdefgh"[: x.ndim - 1] + "."
        return local_call(functools.partial(fn, eps=eps), [x, delta, scale],
                          [rows, rows, "."], (rows, rows))
    return fn(x, delta, scale, eps)
