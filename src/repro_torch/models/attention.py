"""GQA attention blocks: init + train/prefill/decode/cross application.

Port of ``repro.models.attention``. Every flavour funnels into
``kernels.flash_attention.ops`` (the Hopper kernels on CUDA tensors, the plain
version on CPU ones; ``impl`` forces either). Decode writes k/v into a
caller-owned cache at position ``pos`` and attends over entries <= pos.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash_attention import ops as attn_ops
from ..sharding import partition
from ..sharding.local import as_replicated, flatten2, unflatten
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


def attention_specs(cfg: ModelConfig) -> dict:
    """Logical axes of ``init_attention``'s tree (self or cross)."""
    s = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    if cfg.qkv_bias:
        s.update(bq=("heads", None), bk=("kv_heads", None), bv=("kv_heads", None))
    if cfg.qk_norm:
        s.update(q_norm=(None,), k_norm=(None,))
    return s


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """'bsd,dhk->bshk' as one matrix product."""
    D, Hn, hd = w.shape
    return unflatten(x @ flatten2(w, 1), -1, (Hn, hd))


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
    return flatten2(o, -2) @ flatten2(wo, 0)


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
    # context-parallel fallback: when heads don't divide the model axis, the
    # reference shards q's sequence over `model` instead (attn_seq_shard)
    q_seq = "seq_shard" if cfg.attn_seq_shard else "seq"
    q = partition.shard_act(q, "batch", q_seq, "heads", None)
    k = partition.shard_act(k, "batch", "seq", "kv_heads", None)
    v = partition.shard_act(v, "batch", "seq", "kv_heads", None)
    o = attn_ops.flash_attention(q, k, v, causal=causal, impl=impl)
    if cfg.attn_seq_shard:
        o = partition.shard_act(o, "batch", "seq_shard", "heads", None)
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
    if partition.is_dtensor(k_cache):
        write_position(k_cache, k, pos)
        write_position(v_cache, v, pos)
    elif vec:  # per-sequence positions (continuous batching)
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


def _write_shard(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 offset: int) -> None:
    """cache[b, pos - offset] = new[b, 0] in place (a scalar ``pos``: every
    row at one position; (B,): each row at its own), on a shard that holds
    positions [offset, offset + S): a row whose position lies outside keeps
    its entry."""
    S = cache.shape[1]
    at = pos.long() - offset
    inside = (at >= 0) & (at < S)
    at = at.clamp(0, S - 1)
    if pos.ndim == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        old = cache[rows, at]
        mask = inside.reshape(-1, *([1] * (old.ndim - 1)))
        cache.index_put_((rows, at), torch.where(mask, new[:, 0].to(cache.dtype), old))
    else:
        at = at.reshape(1)
        old = cache.index_select(1, at)
        cache.index_copy_(1, at, torch.where(inside, new.to(cache.dtype), old))


def write_position(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one token's ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at
    ``pos`` (a scalar or (B,) int tensor), in place. On a mesh each rank writes
    its shard: its rows and, for a sequence-sharded cache, only the positions
    its slice of S holds."""
    if not partition.is_dtensor(cache):
        _write_shard(cache, new, pos, 0)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    coord = mesh.get_coordinate()
    rank_in_seq = 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            rank_in_seq = rank_in_seq * mesh.size(i) + coord[i]
    # the token follows the cache's row and head split, replicated over S;
    # per-row positions follow its row split
    new_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl)
    pos_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 and pos.ndim == 1 else Replicate()
                   for p in pl)
    new = as_replicated(new, mesh).redistribute(mesh, new_pl).to_local()
    pos = as_replicated(pos, mesh).redistribute(mesh, pos_pl).to_local()
    local = cache.to_local()
    _write_shard(local, new, pos, rank_in_seq * local.shape[1])


def cross_attention(
    p,
    x: torch.Tensor,                       # (B, Sq, D) decoder states
    kv_source: Optional[torch.Tensor] = None,   # (B, Skv, D) encoder output
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cfg: Optional[ModelConfig] = None,
    impl: str = "auto",
):
    """Whisper-style cross attention. Pass kv_source at prefill/train (k and v
    computed and returned for caching); pass kv_cache, (B, Skv, KV, hd) each,
    at decode. Both go through non-causal flash attention, as the reference
    does: at decode that is Sq = 1 against every encoder key."""
    q = _proj(x, p["wq"])
    if cfg is not None and cfg.qkv_bias:
        q = q + p["bq"]
    if kv_cache is not None:
        k, v = kv_cache
    else:
        k, v = _proj(kv_source, p["wk"]), _proj(kv_source, p["wv"])
        if cfg is not None and cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
    o = attn_ops.flash_attention(q, k, v, causal=False, impl=impl)
    return _out(o, p["wo"]), (k, v)
