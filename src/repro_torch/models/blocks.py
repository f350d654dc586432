"""Blocks of the dense and SSM families: init / train-apply / decode-apply / cache.

Port of the dense and SSM parts of ``repro.models.blocks``: GQA attention +
SwiGLU MLP, and RMSNorm + Mamba2 mixer. A "layer" is the unit the model stack
loops over (the hybrid family runs both). The JAX ``partition.shard_act``
calls are dropped: the port runs on one device.

The dense layer's residual add and second RMSNorm are one call,
``kernels.rmsnorm.ops.fused_add_rmsnorm`` (the Hopper kernel on CUDA tensors).
It differs from JAX in one place: in bf16, JAX rounds ``h + a`` to bf16 and
normalises the rounded sum, where the fused version normalises the unrounded
fp32 sum (the residual it returns is rounded as JAX's is). In f32 the two are
equal.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.rmsnorm import ops as rmsnorm_ops
from . import attention, layers, mamba2


def init_decoder_layer(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    return {
        "attn": attention.init_attention(gen, cfg, device, lead),
        "ffn": layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, layers.dtype_of(cfg), device, lead),
        "ln1": layers.init_rmsnorm(cfg.d_model, device, lead),
        "ln2": layers.init_rmsnorm(cfg.d_model, device, lead),
    }


def decoder_layer(p, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  impl: str = "auto"):
    """Train/prefill. Returns (h, aux_loss, kv_for_cache)."""
    hn = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
    a, kv = attention.self_attention(
        p["attn"], hn, cfg, positions=positions, causal=True, return_kv=True, impl=impl
    )
    h, hn = rmsnorm_ops.fused_add_rmsnorm(h, a, p["ln2"]["scale"], cfg.norm_eps, impl)
    f = layers.swiglu(hn, p["ffn"])
    return h + f, 0.0, kv


def decoder_layer_decode(p, h: torch.Tensor, cache: dict, pos: torch.Tensor,
                         cfg: ModelConfig, impl: str = "auto"):
    """One token. ``cache`` ({"k", "v"}, (B, S, KV, hd) each) is updated in place."""
    hn = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
    a, (k, v) = attention.self_attention_decode(
        p["attn"], hn, cache["k"], cache["v"], pos, cfg, impl=impl
    )
    h, hn = rmsnorm_ops.fused_add_rmsnorm(h, a, p["ln2"]["scale"], cfg.norm_eps, impl)
    return h + layers.swiglu(hn, p["ffn"]), {"k": k, "v": v}


def init_decoder_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                       lead: Tuple[int, ...] = ()):
    """Zero cache; ``lead`` stacks it (the model passes ``(n_layers,)``)."""
    shape = (*lead, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    dt = layers.dtype_of(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


# ------------------------------------------------------------------------ ssm
def init_ssm_layer(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    return {
        "mamba": mamba2.init_mamba2(gen, cfg, device, lead),
        "ln": layers.init_rmsnorm(cfg.d_model, device, lead),
    }


def ssm_layer(p, h: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
              impl: str = "auto"):
    """Train/prefill. Returns (h, state or None)."""
    hn = layers.rmsnorm(h, p["ln"], cfg.norm_eps)
    y, state = mamba2.mamba2_block(p["mamba"], hn, cfg, return_state=return_state, impl=impl)
    return h + y, state


def ssm_layer_decode(p, h: torch.Tensor, state: dict, cfg: ModelConfig):
    """One token. ``state`` ({"conv", "ssm"}) is updated in place."""
    hn = layers.rmsnorm(h, p["ln"], cfg.norm_eps)
    y, state = mamba2.mamba2_decode(p["mamba"], hn, state, cfg)
    return h + y, state
