"""GQA attention blocks: init + train/prefill/decode application.

Port of ``repro.models.attention``. Both flavours funnel into
``kernels.flash_attention.ops`` (the Hopper kernels on CUDA tensors, the plain
version on CPU ones; ``impl`` forces either). Decode writes k/v into a
caller-owned cache at position ``pos`` and attends over entries <= pos.
``cross_attention`` comes with the encoder-decoder family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import ops as attn_ops
from . import layers


def init_attention(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = layers.dtype_of(cfg)
    p = {
        "wq": layers.dense_init(gen, (*lead, D, H, hd), D, dt, device),
        "wk": layers.dense_init(gen, (*lead, D, KV, hd), D, dt, device),
        "wv": layers.dense_init(gen, (*lead, D, KV, hd), D, dt, device),
        "wo": layers.dense_init(gen, (*lead, H, hd, D), H * hd, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((*lead, KV, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((*lead, KV, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((*lead, hd), dtype=torch.float32, device=device)
    return p


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' as one matrix product."""
    D, Hn, hd = w.shape
    return (x @ w.reshape(D, Hn * hd)).unflatten(-1, (Hn, hd))


def _qkv(p, x, cfg: ModelConfig, positions: Optional[torch.Tensor], rope: bool):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = _headwise_rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = _headwise_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope and positions is not None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """'bshk,hkd->bsd' as one matrix product."""
    H, hd, D = wo.shape
    return o.flatten(-2) @ wo.reshape(H * hd, D)


def self_attention(
    p,
    x: torch.Tensor,                       # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    return_kv: bool = False,
    impl: str = "auto",
):
    rope = cfg.rope_theta > 0
    q, k, v = _qkv(p, x, cfg, positions, rope)
    o = attn_ops.flash_attention(q, k, v, causal=causal, impl=impl)
    out = _out(o, p["wo"])
    return (out, (k, v)) if return_kv else (out, None)


def self_attention_decode(
    p,
    x: torch.Tensor,                       # (B, 1, D)
    k_cache: torch.Tensor,                 # (B, S, KV, hd)
    v_cache: torch.Tensor,
    pos: torch.Tensor,                     # scalar or (B,) int: write position
    cfg: ModelConfig,
    impl: str = "auto",
):
    """The cache is updated IN PLACE (index_copy_/index_put_) and returned;
    the JAX reference returns a new cache instead, and its engine donates
    the old one to XLA (repro/serving/engine.py:61) to the same effect."""
    rope = cfg.rope_theta > 0
    vec = pos.ndim == 1
    positions = (pos[:, None] if vec else pos[None]) if rope else None
    q, k, v = _qkv(p, x, cfg, positions, rope)
    if vec:  # per-sequence positions (continuous batching)
        rows = torch.arange(k_cache.shape[0], device=k_cache.device)
        idx = (rows, pos.long())
        k_cache.index_put_(idx, k[:, 0].to(k_cache.dtype))
        v_cache.index_put_(idx, v[:, 0].to(v_cache.dtype))
    else:
        at = pos.long().reshape(1)
        k_cache.index_copy_(1, at, k.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    o = attn_ops.decode_attention(q, k_cache, v_cache, pos, impl=impl)
    out = _out(o, p["wo"])
    return out, (k_cache, v_cache)
