"""Dispatching wrapper: the Hopper kernels on CUDA tensors, the plain version on CPU ones.

``impl``: "auto" (the kernel for a CUDA tensor, the reference for a CPU
tensor), "kernel" (the kernel; a CPU tensor is an error), "ref" (the plain
PyTorch version on any device, which ``chip_smoke.py`` uses as the yardstick
of correctness). A CUDA tensor under "auto" never falls back to the reference.
"""
from __future__ import annotations

from typing import Optional

from .. import use_ref
from . import kernel, ref


def flash_attention(q, k, v, *, causal: bool = True, q_offset=None, kv_len=None,
                    scale: Optional[float] = None, impl: str = "auto"):
    """GQA attention. q (B,Sq,H,dqk); k (B,Skv,KV,dqk), v (B,Skv,KV,dv) -> (B,Sq,H,dv)."""
    fn = ref.mha_reference if use_ref(q, impl) else kernel.flash_attention
    return fn(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale)


def decode_attention(q, k_cache, v_cache, pos, *, scale: Optional[float] = None,
                     impl: str = "auto"):
    """Single-token attention against a cache; entries <= pos are valid."""
    fn = ref.decode_attention_reference if use_ref(q, impl) else kernel.decode_attention
    return fn(q, k_cache, v_cache, pos, scale=scale)
