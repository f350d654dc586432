"""Running code that DTensor cannot partition on each rank's local shard.

The main helpers, each the counterpart of what XLA does for a call it cannot
partition or what ``shard_map`` does in the reference:

- ``local_call``: a kernel over the dims its function is independent of
  (batch and heads for attention and the SSD scan, rows for the add + norm),
  through ``torch.distributed.tensor.experimental.local_map``. Each argument
  names its dims with keys; a mesh dim keeps its sharding only where the
  leading argument is sharded over a keyed dim and every argument holding that
  key divides evenly. Every other sharding (a sharded D or sequence, a
  ``Partial`` sum, a GQA head split that would pair the wrong KV heads) is
  first redistributed to ``Replicate``, as XLA gathers the operand of a
  custom call it cannot partition.
- ``shard_map``: the reference's ``shard_map`` over PartitionSpecs (the
  MoE's expert-parallel body).
- ``replicated_call``: a function with no sharding rule in DTensor (a
  ``searchsorted``, a scatter) on replicated inputs, its outputs replicated.
- ``all_reduce``: a differentiable all-reduce over one mesh dim's group, the
  reference's ``psum`` / ``pmean`` inside ``shard_map`` (``scale_grad`` for a
  value every rank of a group computes alike).
- ``reduce_grad``: the identity, whose gradient's partial sums are reduced to
  the tensor's own placements, where XLA would reduce them (DTensor keeps a
  gradient partial as long as every op is linear in it, the whole backward).

Beside them: ``as_replicated`` (a plain tensor, the same on every rank, as a
replicated DTensor), ``local_shard`` (this rank's slice of such a tensor),
``grad_placements`` (the inputs' gradient placements of a local call), and
``unflatten`` / ``flatten2`` (reshapes DTensor cannot split unevenly).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .partition import PartitionSpec, is_dtensor, placements


def _dt():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def _mesh_of(args):
    for a in args:
        if is_dtensor(a):
            return a.device_mesh
    raise ValueError("local_call needs at least one DTensor argument")


def as_replicated(a, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (it holds the same
    value on every rank); a DTensor or a non-tensor as it is."""
    DTensor, Replicate, _ = _dt()
    if a is None or is_dtensor(a) or not isinstance(a, torch.Tensor):
        return a
    return DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_call(fn: Callable, args: Sequence, keys: Sequence, out_keys: Sequence):
    """``fn(*local args)`` on each rank's shards. ``keys[i]`` names the dims of
    ``args[i]`` (a string, one character per dim, "." for a dim the kernel
    reduces over or mixes; None for a non-tensor argument); ``out_keys``
    names each output's dims alike (``fn`` returns a tensor or a tuple).
    The first argument leads: only its keyed shardings are kept. Returns
    DTensors placed as the outputs' keys resolve."""
    DTensor, Replicate, Shard = _dt()
    from torch.distributed.tensor.experimental import local_map

    mesh = _mesh_of(args)
    args = [as_replicated(a, mesh) for a in args]
    lead_arg, lead_keys = args[0], keys[0]
    # key -> the mesh dims it keeps, in mesh order
    chosen: dict = {}
    mesh_key = []
    for i, p in enumerate(lead_arg.placements):
        key = None
        if isinstance(p, Shard) and lead_keys[p.dim] != ".":
            key = lead_keys[p.dim]
            parts = mesh.size(i)
            for j in chosen.get(key, ()):
                parts *= mesh.size(j)
            for a, k in zip(args, keys):
                if a is None or k is None:
                    continue
                for d, c in enumerate(k):
                    if c == key and a.shape[d] % parts:
                        key = None
                        break
                if key is None:
                    break
        mesh_key.append(key)
        if key is not None:
            chosen.setdefault(key, []).append(i)

    def place(k: Optional[str]):
        if k is None:
            return None
        return tuple(Shard(k.index(key)) if key is not None and key in k else Replicate()
                     for key in mesh_key)

    in_pl = tuple(place(k) if is_dtensor(a) else None for a, k in zip(args, keys))
    args = [a.redistribute(mesh, pl) if pl is not None and tuple(a.placements) != pl else a
            for a, pl in zip(args, in_pl)]
    # local_map reads a tuple as one entry per output, a list as one output's
    out_pl = list(place(out_keys)) if isinstance(out_keys, str) else tuple(
        place(k) for k in out_keys)
    return local_map(_contiguous_grads(fn), out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_placements(in_pl),
                     device_mesh=mesh)(*args)


def grad_placements(in_pl: Sequence) -> tuple:
    """The placements of the inputs' gradients in a local call: an input
    replicated over a mesh dim along which the call splits its work (some
    input is sharded there) gets a partial gradient from each rank's share,
    a ``Partial`` sum; every other placement is its input's."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    split = {i for pl in in_pl if pl is not None
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    return tuple(None if pl is None else
                 tuple(Partial() if isinstance(p, Replicate) and i in split else p
                       for i, p in enumerate(pl))
                 for pl in in_pl)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    gradient with a transposed layout breaks DTensor's ``view`` in the
    backward of the reshapes around the call."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(fn: Callable) -> Callable:
    def call(*args):
        return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))
    return call


def shard_map(fn: Callable, mesh, in_specs: Sequence, out_specs):
    """The reference's ``shard_map``: ``fn`` on each rank's local blocks of
    arguments placed by ``in_specs`` (PartitionSpecs; None for a non-tensor),
    its outputs assembled by ``out_specs``. A plain tensor argument is taken
    as replicated; an argument placed otherwise is redistributed first."""
    from torch.distributed.tensor.experimental import local_map

    in_pl = tuple(None if s is None else placements(s, mesh) for s in in_specs)
    single = isinstance(out_specs, PartitionSpec)
    out_pl = (list(placements(out_specs, mesh)) if single
              else tuple(placements(s, mesh) for s in out_specs))

    def call(*args):
        args = [as_replicated(a, mesh) for a in args]
        args = [a.redistribute(mesh, pl) if pl is not None and tuple(a.placements) != pl else a
                for a, pl in zip(args, in_pl)]
        return local_map(_contiguous_grads(fn), out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=grad_placements(in_pl),
                         device_mesh=mesh)(*args)

    return call


def replicated_call(fn: Callable, *args):
    """``fn`` on the full value of every DTensor argument (redistributed to
    ``Replicate``), its tensor outputs wrapped as replicated DTensors; with no
    DTensor argument, ``fn(*args)``."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    DTensor, Replicate, _ = _dt()
    mesh = _mesh_of(args)
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a for a in args]
    out = fn(*local)

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, rep, run_check=False)
        return o

    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)


def _even(t, dim: int, outer: int):
    """DTensor ``t`` with every mesh dim that shards ``dim`` unevenly for an
    outer size ``outer`` replicated (a plain tensor as it is)."""
    if not is_dtensor(t):
        return t
    _, Replicate, Shard = _dt()
    d = dim % t.ndim
    parts, pl = 1, list(t.placements)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == d:
            parts *= t.device_mesh.size(i)
            if outer % parts:
                pl[i] = Replicate()
    return t if tuple(pl) == tuple(t.placements) else t.redistribute(t.device_mesh, pl)


class _EvenGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, outer):
        ctx.dim, ctx.outer = dim, outer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _even(g, ctx.dim, ctx.outer), None, None


def unflatten(t: torch.Tensor, dim: int, sizes: Sequence[int]) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``; on a DTensor whose ``dim`` is sharded over
    mesh dims that do not split the outer size ``sizes[0]`` evenly (a matrix
    product may shard its output columns by any split), those mesh dims are
    first replicated, as DTensor cannot split the result."""
    return _even(t, dim, sizes[0]).unflatten(dim, sizes)


def flatten2(t: torch.Tensor, start: int) -> torch.Tensor:
    """``t.flatten(start, start + 1)``, whose gradient (a view back) on a
    DTensor gets the same guard as ``unflatten``."""
    start %= t.ndim
    flat = t.flatten(start, start + 1)
    if is_dtensor(t) and t.requires_grad:
        return _EvenGrad.apply(flat, start, t.shape[start])
    return flat


def local_shard(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of ``full`` (the same value on every rank) under the
    placements of DTensor ``like``: a slice, no communication."""
    DTensor, Replicate, _ = _dt()
    mesh = like.device_mesh
    rep = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return rep.redistribute(mesh, like.placements).to_local()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group):
        import torch.distributed._functional_collectives as funcol
        ctx.scale = 1.0 if op == "sum" else 1.0 / torch.distributed.get_world_size(group)
        return funcol.wait_tensor(funcol.all_reduce(x, op, group))

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale if ctx.scale != 1.0 else g, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """An all-reduce (``op`` "sum" or "avg") of a plain tensor over a
    process group (``mesh.get_group(dim)``) whose output is replicated over
    the group, as ``psum`` / ``pmean`` in the reference's ``shard_map``: its
    gradient, the same on every rank, passes to each rank's input as it is
    (sum) or over the group's size (avg)."""
    return _AllReduce.apply(x, op, group)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The identity, with the gradient scaled: a value that every rank of a
    group computes alike gets 1/size of its gradient on each, so that the
    ranks' ``Partial`` gradients of its inputs sum to one."""
    return _ScaleGrad.apply(x, scale)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g) or not any(p.is_partial() for p in g.placements):
            return g
        target = tuple(want if p.is_partial() else p
                       for p, want in zip(g.placements, ctx.placements))
        return g.redistribute(g.device_mesh, target)


def reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """The identity on DTensor ``x`` (a plain tensor as it is), whose gradient,
    where it arrives as a partial sum over a mesh dim, is reduced to ``x``'s
    own placement there (an all-reduce, or a reduce-scatter onto a shard).
    Without it a partial gradient travels through every op that is linear in
    it, and a matrix product that meets it gathers its weight and computes
    the whole product on every rank rather than reducing the gradient."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _ReduceGrad.apply(x)
