"""Dispatching wrapper: the Hopper kernels on CUDA tensors, the plain version on CPU ones.

``impl``: "auto" (the kernel for a CUDA tensor, the reference for a CPU
tensor), "kernel" (the kernel; a CPU tensor is an error), "ref" (the plain
PyTorch version on any device, which ``chip_smoke.py`` uses as the yardstick
of correctness). A CUDA tensor under "auto" never falls back to the reference.

Given DTensors (a model on a mesh), each runs on every rank's shard through
``sharding.local.local_call`` (``local_map``), independent over batch and
heads. KV heads shard with the query heads where they divide alike (so each
query head meets its own KV group); where only the query heads divide and
each rank's heads fall in one KV group (``_kv_group_of_rank``), the KV heads
stay whole on every rank and each rank takes its group's head. Anything else
the kernel reduces over or mixes is first gathered, with one exception: a
decode cache sharded over its sequence (``seq_shard``: KV heads that do not
divide the `model` axis, and MLA's latent cache) is never gathered. Each
rank runs ``decode_attention_partials`` over its own positions, and two
all-reduces over the sequence's mesh dims (the max, then the rescaled sums
and accumulators) merge the partials by log-sum-exp, as XLA partitions the
reference's plain attention over the sequence. MLA's absorbed decode
(``mla_decode_attention``) reads its two latent caches, ``Shard(1)`` both,
the same way through ``mla_decode_attention_partials``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import use_ref
from ...sharding.local import local_call
from ...sharding.partition import is_dtensor
from . import kernel, ref


def flash_attention(q, k, v, *, causal: bool = True, q_offset=None, kv_len=None,
                    scale: Optional[float] = None, impl: str = "auto"):
    """GQA attention. q (B,Sq,H,dqk); k (B,Skv,KV,dqk), v (B,Skv,KV,dv) -> (B,Sq,H,dv)."""
    fn = ref.mha_reference if use_ref(q, impl) else kernel.flash_attention
    if is_dtensor(q) or is_dtensor(k):
        per_row = torch.is_tensor(kv_len) and kv_len.ndim == 1
        group = _kv_group_of_rank(q, k)
        kv_keys = "b..." if group is not None else "b.h."

        def call(q, k, v, lens=None):
            if group is not None:  # this rank's query heads read one KV head
                k, v = k[:, :, group:group + 1], v[:, :, group:group + 1]
            return fn(q, k, v, causal=causal, q_offset=q_offset,
                      kv_len=lens if per_row else kv_len, scale=scale)

        args, keys = [q, k, v], ["b.h.", kv_keys, kv_keys]
        if per_row:
            args, keys = args + [kv_len], keys + ["b"]
        return local_call(call, args, keys, "b.h.")
    return fn(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale)


def decode_attention(q, k_cache, v_cache, pos, *, scale: Optional[float] = None,
                     impl: str = "auto"):
    """Single-token attention against a cache; entries <= pos are valid."""
    plain = use_ref(q, impl)
    fn = ref.decode_attention_reference if plain else kernel.decode_attention
    pos_key = ("b" if pos.ndim == 1 else "") if torch.is_tensor(pos) else None
    if is_dtensor(k_cache) and _sequence_dims(k_cache):
        partials = (ref.decode_attention_partials_reference if plain
                    else kernel.decode_attention_partials)
        return _decode_over_sequence_shards(partials, q, k_cache, v_cache, pos, pos_key, scale)
    if is_dtensor(q) or is_dtensor(k_cache):
        return local_call(functools.partial(fn, scale=scale), [q, k_cache, v_cache, pos],
                          ["b.h.", "b.h.", "b.h.", pos_key], "b.h.")
    return fn(q, k_cache, v_cache, pos, scale=scale)


def mla_decode_attention(q, ckv, krope, pos, *, scale: float, impl: str = "auto"):
    """MLA's absorbed decode: q (B,1,H,dl+dr) against the latent caches ckv
    (B,S,dl) and krope (B,S,dr), K = [ckv | krope], V = ckv, entries <= pos
    valid -> (B,1,H,dl)."""
    plain = use_ref(q, impl)
    fn = ref.mla_decode_reference if plain else kernel.mla_decode_attention
    pos_key = ("b" if pos.ndim == 1 else "") if torch.is_tensor(pos) else None
    if is_dtensor(ckv) and _sequence_dims(ckv):
        partials = (ref.mla_decode_partials_reference if plain
                    else kernel.mla_decode_attention_partials)
        return _decode_over_sequence_shards(partials, q, ckv, krope, pos, pos_key, scale)
    if is_dtensor(q) or is_dtensor(ckv):
        return local_call(functools.partial(fn, scale=scale), [q, ckv, krope, pos],
                          ["b.h.", "b..", "b..", pos_key], "b.h.")
    return fn(q, ckv, krope, pos, scale=scale)


def _split(t, dim: int) -> tuple:
    """The mesh dims that shard DTensor ``t``'s dim ``dim``, and the number of
    parts they cut it into."""
    from torch.distributed.tensor import Shard

    dims = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim]
    parts = 1
    for i in dims:
        parts *= t.device_mesh.size(i)
    return dims, parts


def _rank_index(t, dims) -> int:
    """This rank's index among the shards that mesh dims ``dims`` of DTensor
    ``t`` cut one tensor dim into (mesh order, as DTensor splits it)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    index = 0
    for i in dims:
        index = index * mesh.size(i) + coord[i]
    return index


def _kv_group_of_rank(q, k) -> Optional[int]:
    """The one KV head this rank's query heads read, where q's heads are
    sharded and k's cannot follow (KV heads do not divide the split, GQA
    heads do) and each rank's heads fall in one KV group; else None. XLA
    splits the reference's attention so (each device its query heads against
    the KV head they share); gathering q instead would give every rank every
    head's work."""
    if not is_dtensor(q):
        return None
    dims, parts = _split(q, 2)
    H, KV = q.shape[2], k.shape[2]
    if not dims or KV % parts == 0 or H % parts or (H // KV) % (H // parts):
        return None
    return _rank_index(q, dims) * (H // parts) // (H // KV)


def _sequence_dims(cache) -> list:
    """The mesh dims that shard a DTensor cache's sequence (dim 1) evenly."""
    dims, parts = _split(cache, 1)
    return dims if dims and cache.shape[1] % parts == 0 else []


def _decode_over_sequence_shards(partials, q, k_cache, v_cache, pos, pos_key, scale):
    """Decode against a cache sharded over its sequence, with no gather:
    each rank's partials over its own positions (its shard starts at global
    position index * local S, the index counted over the sequence's mesh dims
    in mesh order, as DTensor splits them), merged across those dims by an
    all-reduce of the max and one of [acc, l] rescaled to it. Batch and head
    shards pass through ``local_call``; q, replicated over the sequence's
    mesh dims, meets every shard. ``partials`` takes (q, k, v, pos) or
    MLA's (q, ckv, krope, pos)."""
    import torch.distributed._functional_collectives as funcol

    dims = _sequence_dims(k_cache)
    index = _rank_index(k_cache, dims)
    groups = [k_cache.device_mesh.get_group(i) for i in dims]

    def reduce(x, op):
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, g))
        return x

    def call(k, v, q, pos):
        m, l, acc = partials(q, k, v, pos, pos_offset=index * k.shape[1], scale=scale)
        w = ref.rescale(m, reduce(m, "max"))
        both = reduce(torch.cat([acc * w[..., None], (l * w)[..., None]], dim=-1), "sum")
        return ref.normalise(both[..., :-1], both[..., -1], q.dtype)

    cache = "bsh." if k_cache.ndim == 4 else "bs."    # MLA's latent caches have no heads
    return local_call(call, [k_cache, v_cache, q, pos], [cache, cache, "b.h.", pos_key], "b.h.")
