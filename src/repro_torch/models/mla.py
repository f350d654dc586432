"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3).

Port of ``repro.models.mla``. Prefill expands the compressed latent into
per-head k/v and runs ``ops.flash_attention`` with dqk = nope + rope and
dv = v_head; decode runs the *absorbed* form: queries are projected into
latent space and attention runs as MQA over one (kv_lora + rope)-wide KV head
(``ops.decode_attention`` with dqk = kv_lora + rope, dv = kv_lora). The
cache stores only (c_kv, k_rope) per token, the technique's memory advantage.

Decode writes the new token's latent into the caller's cache IN PLACE at
``pos`` (a device tensor: no host sync, so the step captures as one CUDA
graph), as ``attention.self_attention_decode`` does. The per-step
concatenation of the two cache leaves into ``k_full`` is the reference's
(src/repro/models/mla.py:131): a copy of the whole cache a layer a step.
The reference's ``_norm`` (an RMSNorm over the last axis in fp32) is
``attention._headwise_rmsnorm`` here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import ops as attn_ops
from . import attention, layers


def init_mla(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    dt = layers.dtype_of(cfg)
    return {
        "wdq": layers.dense_init(gen, (*lead, D, m.q_lora_rank), D, dt, device),
        "q_norm": torch.ones((*lead, m.q_lora_rank), dtype=torch.float32, device=device),
        "wuq": layers.dense_init(gen, (*lead, m.q_lora_rank, H, qk), m.q_lora_rank, dt, device),
        "wdkv": layers.dense_init(gen, (*lead, D, m.kv_lora_rank), D, dt, device),
        "wkr": layers.dense_init(gen, (*lead, D, m.qk_rope_dim), D, dt, device),
        "kv_norm": torch.ones((*lead, m.kv_lora_rank), dtype=torch.float32, device=device),
        "wuk": layers.dense_init(gen, (*lead, m.kv_lora_rank, H, m.qk_nope_dim),
                                 m.kv_lora_rank, dt, device),
        "wuv": layers.dense_init(gen, (*lead, m.kv_lora_rank, H, m.v_head_dim),
                                 m.kv_lora_rank, dt, device),
        "wo": layers.dense_init(gen, (*lead, H, m.v_head_dim, D), H * m.v_head_dim, dt, device),
    }


def _queries(p, x: torch.Tensor, cfg: ModelConfig, positions: Optional[torch.Tensor]):
    m = cfg.mla
    ql = attention._headwise_rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = attention._proj(ql, p["wuq"])                              # (B, S, H, nope + rope)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    if positions is not None:
        q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent_kv(p, x: torch.Tensor, cfg: ModelConfig, positions: Optional[torch.Tensor]):
    c_kv = attention._headwise_rmsnorm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = x @ p["wkr"]                                          # (B, S, rope)
    if positions is not None:
        k_rope = layers.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Prefill/train path: expand the latent to per-head k/v, causal
    attention. Returns (out (B, S, D), (c_kv, k_rope) for the cache)."""
    m = cfg.mla
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latent_kv(p, x, cfg, positions)
    k_nope = attention._proj(c_kv, p["wuk"])                       # (B, S, H, nope)
    v = attention._proj(c_kv, p["wuv"])                            # (B, S, H, v_head)
    B, S, H = k_nope.shape[:3]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attn_ops.flash_attention(q, k, v, causal=True,
                                 scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5, impl=impl)
    return attention._out(o, p["wo"]), (c_kv, k_rope)


def mla_attention_decode(p, x: torch.Tensor, ckv_cache: torch.Tensor,
                         krope_cache: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                         impl: str = "auto"):
    """Absorbed decode: MQA over the compressed cache. x (B, 1, D); caches
    (B, S, kv_lora) and (B, S, rope), updated IN PLACE at ``pos`` (a scalar or
    (B,) int tensor) and returned."""
    m = cfg.mla
    vec = pos.ndim == 1
    positions = pos[:, None] if vec else pos[None]
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latent_kv(p, x, cfg, positions)
    if vec:  # per-sequence positions (continuous batching)
        idx = (torch.arange(ckv_cache.shape[0], device=ckv_cache.device), pos.long())
        ckv_cache.index_put_(idx, c_kv[:, 0].to(ckv_cache.dtype))
        krope_cache.index_put_(idx, k_rope[:, 0].to(krope_cache.dtype))
    else:
        at = pos.long().reshape(1)
        ckv_cache.index_copy_(1, at, c_kv.to(ckv_cache.dtype))
        krope_cache.index_copy_(1, at, k_rope.to(krope_cache.dtype))
    # absorb W_uk into the query: q_lat (B, 1, H, kv_lora)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
    q_full = torch.cat([q_lat, q_rope], dim=-1)                    # (B, 1, H, lora + rope)
    k_full = torch.cat([ckv_cache, krope_cache], dim=-1)[:, :, None, :]  # (B, S, 1, ·)
    v_lat = ckv_cache[:, :, None, :]                               # (B, S, 1, lora)
    o_lat = attn_ops.decode_attention(q_full, k_full, v_lat, pos,
                                      scale=(m.qk_nope_dim + m.qk_rope_dim) ** -0.5,
                                      impl=impl)                   # (B, 1, H, lora)
    o = torch.einsum("bshr,rhk->bshk", o_lat, p["wuv"])           # absorb W_uv
    return attention._out(o, p["wo"]), (ckv_cache, krope_cache)
