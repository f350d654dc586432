"""KV-cache utilities: sizing, slot insertion for continuous batching.

Port of ``repro.serving.kv_cache`` for every family: dense (GQA or MLA),
MoE, SSM, hybrid, encoder-decoder and VLM.
"""
from __future__ import annotations

from typing import Union

import torch

from ..configs.base import ModelConfig


def cache_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> int:
    """Analytical decode-state footprint (bytes): the serving-capacity
    planner for admission control and the roofline memory term."""
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    if cfg.family in ("dense", "moe", "vlm"):
        # a VLM's seq_len counts its patches, as its cache does
        if cfg.mla is not None:
            per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
        else:
            per_tok = 2 * cfg.n_kv_heads * cfg.hd
        return cfg.n_layers * batch * seq_len * per_tok * itemsize
    if cfg.family == "encdec":
        # self-attention k/v over seq_len positions and the cross k/v over the
        # encoder's enc_seq frames (the reference's live branch, kv_cache.py:26-28)
        per_tok = 2 * cfg.n_kv_heads * cfg.hd
        return cfg.n_layers * batch * (seq_len + cfg.enc_seq) * per_tok * itemsize
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"cache_bytes: unknown family {cfg.family!r}")
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    conv = (s.conv_kernel - 1) * (d_in + 2 * s.n_groups * s.d_state) * itemsize
    ssm = H * s.head_dim * s.d_state * 4  # fp32 state
    per_layer = (conv + ssm) * batch
    if cfg.family == "ssm":
        return cfg.n_layers * per_layer
    # hybrid: mamba states + shared-attn KV per group
    G = cfg.n_layers // cfg.shared_attn_every
    attn = G * batch * seq_len * 2 * cfg.n_kv_heads * cfg.hd * itemsize
    return cfg.n_layers * per_layer + attn


def insert_sequence(batched_cache: dict, seq_cache: dict, slot: int,
                    batch_axis: Union[int, dict] = 1) -> dict:
    """Place a single-sequence cache (batch dim 1) into slot `slot` of a
    batched cache, IN PLACE. ``batch_axis`` is one axis for every leaf or a
    tree of axes shaped like the cache (``Model.cache_batch_axes()``): caches
    are stacked over layers, so the batch axis follows the layer axes. It is 1
    for the dense and ssm leaves; the hybrid nests its caches, and its
    ``(G, PG, B, ...)`` mamba leaves take 2 where its ``(G, B, S, ...)``
    attention leaves take 1. (The reference takes one axis for every leaf and
    so cannot serve the hybrid.) The sequence is zero-padded up to the
    batched cache's length, as the JAX version pads it; the SSM leaves
    ({"conv", "ssm"}) have no sequence axis, and the encoder-decoder's cross
    leaves are as long as the destination's (enc_seq): both are copied whole."""
    for name, dst in batched_cache.items():
        src = seq_cache[name]
        axis = batch_axis[name] if isinstance(batch_axis, dict) else batch_axis
        if isinstance(dst, dict):
            insert_sequence(dst, src, slot, axis)
            continue
        row = dst.narrow(axis, slot, 1)
        region = row
        for d in range(src.ndim):
            if d != axis and src.shape[d] != dst.shape[d]:
                region = region.narrow(d, 0, src.shape[d])
        row.zero_()
        region.copy_(src)
    return batched_cache


def summarize(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    b = cache_bytes(cfg, batch, seq_len)
    return {
        "bytes": int(b),
        "gib": round(b / 2**30, 3),
        "bytes_per_seq": int(b / max(batch, 1)),
    }
