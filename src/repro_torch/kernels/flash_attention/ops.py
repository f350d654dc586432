"""Dispatching wrapper: the Hopper kernels on CUDA tensors, the plain version on CPU ones.

``impl``: "auto" (the kernel for a CUDA tensor, the reference for a CPU
tensor), "kernel" (the kernel; a CPU tensor is an error), "ref" (the plain
PyTorch version on any device, which ``chip_smoke.py`` uses as the yardstick
of correctness). A CUDA tensor under "auto" never falls back to the reference.

Given DTensors (a model on a mesh), each runs on every rank's shard through
``sharding.local.local_call`` (``local_map``), independent over batch and
heads: KV heads shard with the query heads only where they divide alike (so
each query head meets its own KV group), and anything else the kernel
reduces over or mixes, a sequence-sharded decode cache among them, is first
gathered. A cross-rank combine of split-KV partials is ROADMAP B12.
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

        def call(q, k, v, lens=None):
            return fn(q, k, v, causal=causal, q_offset=q_offset,
                      kv_len=lens if per_row else kv_len, scale=scale)

        args, keys = [q, k, v], ["b.h.", "b.h.", "b.h."]
        if per_row:
            args, keys = args + [kv_len], keys + ["b"]
        return local_call(call, args, keys, "b.h.")
    return fn(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale)


def decode_attention(q, k_cache, v_cache, pos, *, scale: Optional[float] = None,
                     impl: str = "auto"):
    """Single-token attention against a cache; entries <= pos are valid."""
    fn = ref.decode_attention_reference if use_ref(q, impl) else kernel.decode_attention
    if is_dtensor(q) or is_dtensor(k_cache):
        pos_key = "b" if torch.is_tensor(pos) and pos.ndim == 1 else ""
        return local_call(functools.partial(fn, scale=scale), [q, k_cache, v_cache, pos],
                          ["b.h.", "b.h.", "b.h.", pos_key if torch.is_tensor(pos) else None],
                          "b.h.")
    return fn(q, k_cache, v_cache, pos, scale=scale)
