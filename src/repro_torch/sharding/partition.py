"""Logical-axis partitioning (DP/FSDP x TP/EP/SP) with divisibility fallback.

Port of ``repro.sharding.partition`` over a torch ``DeviceMesh``. Models
annotate parameters and activations with *logical* axis names; this module
resolves them against the active mesh:

    "batch"   -> ("pod", "data")      (data parallel; pod axis folds in)
    "embed"   -> "data"               (FSDP: parameters 2D-sharded)
    "heads" / "kv_heads" / "mlp" / "vocab" / "experts" / "ssm_heads" -> "model"
    "seq"     -> "model" (sequence parallelism / seq-sharded KV) when requested

Resolution is greedy left to right per tensor: a mesh axis is used at most
once per spec, and a dim only shards if the mesh axis size divides it,
otherwise the dim replicates (14 heads on a 16-way model axis, 60 experts).
It is a pure function of the mesh's axis sizes: ``resolve_spec`` takes any
mesh whose ``shape`` is a dict of axis sizes (the reference's ``Mesh``, or a
stand-in in the tests) as well as a ``DeviceMesh`` (whose ``shape`` is a
tuple beside ``mesh_dim_names``).

The reference's ``PartitionSpec`` becomes the port's own ``PartitionSpec``, a
tuple of axis names, axis tuples or None; ``placements`` turns one into a
DTensor placement per mesh dimension, ``Shard(d)`` or ``Replicate()``. A
joint ``("pod", "data")`` on dim d gives ``Shard(d)`` on both mesh dims, in
mesh order: DTensor then splits d by pod first and by data within, JAX's
row-major joint sharding. ``shard_act`` is ``DTensor.redistribute`` where
the reference has ``with_sharding_constraint``. ``use_mesh`` also enters
DTensor's implicit replication, so a plain tensor that the model makes (a
position table, a zero pad) meets a DTensor as a replicated one, as a
traced constant does in JAX.
"""
from __future__ import annotations

import contextlib
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

# logical name -> candidate mesh axes, in preference order. Each candidate is
# an axis name or tuple of axis names (joint sharding).
DEFAULT_RULES: dict = {
    "batch": (("pod", "data"), "data"),
    # params FSDP-shard over the pod axis too (multi-pod ZeRO: optimizer
    # state halves at 512 chips; without this the pod axis only replicates)
    "embed": (("pod", "data"), "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "ssm_heads": ("model",),
    "state": (),
    "seq_shard": ("model",),   # sequence parallelism / seq-sharded KV cache
    "seq": (),                 # unsharded sequence
    "layers": (),
    "capacity": (("pod", "data"), "data"),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (joint
    sharding) or None (replicated); trailing dims absent are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh whose ``shape`` is
    already that dict."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclass
class MeshContext:
    mesh: Any
    rules: dict

    @property
    def shape(self) -> dict:
        return mesh_axes(self.mesh)

    def axis_size(self, axis) -> int:
        if self.mesh is None:
            return 1
        shape = self.shape
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= shape.get(a, 0) or 0
                if a not in shape:
                    return 0
            return n
        return shape.get(axis, 0)


_ctx = threading.local()


def current() -> Optional[MeshContext]:
    return getattr(_ctx, "ctx", None)


def rules_for(cfg=None) -> dict:
    """Rule set for a model config. pure_dp widens the batch rule to consume
    both mesh axes (ZeRO-3: no tensor parallelism, per-layer param gathers)."""
    rules = dict(DEFAULT_RULES)
    if cfg is not None and getattr(cfg, "pure_dp", False):
        wide = (("pod", "data", "model"), ("data", "model"), ("pod", "data"), "data")
        rules["batch"] = wide
        rules["capacity"] = wide
    return rules


def _implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


@contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh for logical-axis resolution (per thread) and, for a
    ``DeviceMesh``, DTensor's implicit replication of plain tensors."""
    prev = getattr(_ctx, "ctx", None)
    _ctx.ctx = MeshContext(mesh=mesh, rules=dict(rules or DEFAULT_RULES))
    try:
        is_device_mesh = mesh is not None and hasattr(mesh, "mesh_dim_names")
        with _implicit_replication() if is_device_mesh else contextlib.nullcontext():
            yield _ctx.ctx
    finally:
        _ctx.ctx = prev


def resolve_spec(logical: Sequence, shape: Optional[Sequence[int]] = None,
                 ctx: Optional[MeshContext] = None) -> PartitionSpec:
    """Logical names -> PartitionSpec with greedy axis assignment +
    divisibility fallback. `shape` enables the divisibility check; without it
    the first present candidate axis is used unconditionally."""
    ctx = ctx or current()
    if ctx is None or ctx.mesh is None:
        return P()
    axes_of = ctx.shape
    used: set = set()
    out = []
    for d, name in enumerate(logical):
        assigned = None
        for cand in ctx.rules.get(name, ()):  # preference order
            axes = cand if isinstance(cand, tuple) else (cand,)
            if any(a not in axes_of for a in axes):
                continue
            if any(a in used for a in axes):
                continue
            size = ctx.axis_size(cand)
            if size <= 1:
                continue
            if shape is not None and shape[d] % size != 0:
                continue
            assigned = cand
            used.update(axes)
            break
        out.append(assigned)
    # trim trailing Nones for tidiness
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim d's
    entry names that mesh axis (alone or in a joint tuple), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_axes(mesh):
        dim = None
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if name in axes:
                dim = d
                break
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x: Any, *logical, ctx: Optional[MeshContext] = None) -> Any:
    """Redistribute an activation to the placements its logical names resolve
    to. A no-op with no mesh active (one device) or on a plain tensor."""
    ctx = ctx or current()
    if ctx is None or ctx.mesh is None or not is_dtensor(x):
        return x
    spec = resolve_spec(logical, shape=tuple(x.shape), ctx=ctx)
    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


BATCH_AXES = ("pod", "data")


def gather_fsdp(w):
    """Weight ``w`` with its shards over the batch axes (FSDP) gathered,
    its other placements kept; a plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if name in BATCH_AXES else p
               for name, p in zip(w.device_mesh.mesh_dim_names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def resolve_tree_specs(logical_tree: Any, aval_tree: Any,
                       ctx: Optional[MeshContext] = None) -> Any:
    """A tree (nested dicts) of logical-axis tuples + the matching tree of
    tensors (or anything with ``shape``) -> the tree of PartitionSpecs."""
    ctx = ctx or current()
    return _tree_map(lambda logical, aval: resolve_spec(tuple(logical), tuple(aval.shape), ctx),
                     logical_tree, aval_tree)


def named_shardings(logical_tree: Any, aval_tree: Any, mesh,
                    rules: Optional[dict] = None) -> Any:
    ctx = MeshContext(mesh=mesh, rules=dict(rules or DEFAULT_RULES))
    specs = resolve_tree_specs(logical_tree, aval_tree, ctx=ctx)
    return _tree_map(lambda s: NamedSharding(mesh, s), specs)
