"""Per-family blocks: init / train-apply / decode-apply / cache.

Port of ``repro.models.blocks``: GQA attention (or, where the config has
``mla``, Multi-head Latent Attention, ``mla.py``) + SwiGLU MLP (the moe
family: + the routed-expert FFN, ``moe.moe_ffn``); RMSNorm + Mamba2 mixer;
and the encoder-decoder family's encoder layer (non-causal self-attention +
GELU MLP) and decoder layer (causal self-attention + cross-attention + GELU
MLP), each norm a LayerNorm. A "layer" is the unit the model stack loops
over (the hybrid family runs both of the first two). Each layer's input
takes the reference's ``partition.shard_act`` (``_residual_enter``), a no-op
with no mesh active; the ``*_specs`` functions give each ``init_*`` tree's
logical axes, and ``decoder_cache_specs`` the cache's.

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
from ..sharding import partition
from ..sharding.local import reduce_grad
from . import attention, layers, mamba2, mla, moe


def _residual_enter(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.sequence_parallel:
        return partition.shard_act(h, "batch", "seq_shard", None)
    return partition.shard_act(h, "batch", "seq", None)


def _add_residual(h: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h + x, with a sublayer's output x (on a mesh a product's partial sum
    over `model`) first placed as the residual stream, and the sum's gradient
    reduced to that placement (``reduce_grad``). The gradient coming back from
    the logits, or from a sublayer's input products, is a partial sum over
    `model`; left so, the sublayer's backward products would meet it and
    gather their weights, giving every `model` rank the whole product (16x a
    down projection's input gradient on a 16x16 mesh), where XLA reduces the
    gradient first."""
    return reduce_grad(h + _residual_enter(x, cfg))


def init_decoder_layer(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    if cfg.mla is not None:
        attn = mla.init_mla(gen, cfg, device, lead)
    else:
        attn = attention.init_attention(gen, cfg, device, lead)
    if cfg.family == "moe":
        ffn = moe.init_moe(gen, cfg, device, lead)
    else:
        ffn = layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, layers.dtype_of(cfg), device, lead)
    return {
        "attn": attn,
        "ffn": ffn,
        "ln1": layers.init_rmsnorm(cfg.d_model, device, lead),
        "ln2": layers.init_rmsnorm(cfg.d_model, device, lead),
    }


def decoder_layer_specs(cfg: ModelConfig) -> dict:
    attn = mla.mla_specs(cfg) if cfg.mla is not None else attention.attention_specs(cfg)
    ffn = moe.moe_specs(cfg) if cfg.family == "moe" else layers.swiglu_specs()
    return {"attn": attn, "ffn": ffn, "ln1": layers.rmsnorm_specs(),
            "ln2": layers.rmsnorm_specs()}


def _ffn(p, hn: torch.Tensor, cfg: ModelConfig):
    """(ffn output, aux loss): the routed experts for the moe family, else SwiGLU and 0.0."""
    if cfg.family == "moe":
        return moe.moe_ffn(hn, p, cfg)
    return layers.swiglu(hn, p), 0.0


def decoder_layer(p, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  impl: str = "auto"):
    """Train/prefill. Returns (h, aux_loss, kv_for_cache): (k, v), or for MLA
    (c_kv, k_rope)."""
    h = _residual_enter(h, cfg)
    hn = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, kv = mla.mla_attention(p["attn"], hn, cfg, positions=positions, impl=impl)
    else:
        a, kv = attention.self_attention(
            p["attn"], hn, cfg, positions=positions, causal=True, return_kv=True, impl=impl
        )
    h, hn = rmsnorm_ops.fused_add_rmsnorm(h, a, p["ln2"]["scale"], cfg.norm_eps, impl)
    f, aux = _ffn(p["ffn"], hn, cfg)
    return _add_residual(h, f, cfg), aux, kv


def decoder_layer_decode(p, h: torch.Tensor, cache: dict, pos: torch.Tensor,
                         cfg: ModelConfig, impl: str = "auto"):
    """One token. ``cache`` ({"k", "v"}, (B, S, KV, hd) each; for MLA {"ckv",
    "krope"}, (B, S, kv_lora) and (B, S, rope)) is updated in place."""
    hn = layers.rmsnorm(h, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, (ckv, krope) = mla.mla_attention_decode(
            p["attn"], hn, cache["ckv"], cache["krope"], pos, cfg, impl=impl
        )
        new_cache = {"ckv": ckv, "krope": krope}
    else:
        a, (k, v) = attention.self_attention_decode(
            p["attn"], hn, cache["k"], cache["v"], pos, cfg, impl=impl
        )
        new_cache = {"k": k, "v": v}
    h, hn = rmsnorm_ops.fused_add_rmsnorm(h, a, p["ln2"]["scale"], cfg.norm_eps, impl)
    f, _ = _ffn(p["ffn"], hn, cfg)
    return h + f, new_cache


def init_decoder_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                       lead: Tuple[int, ...] = ()):
    """Zero cache; ``lead`` stacks it (the model passes ``(n_layers,)``)."""
    dt = layers.dtype_of(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "ckv": torch.zeros((*lead, batch, cache_len, m.kv_lora_rank), dtype=dt, device=device),
            "krope": torch.zeros((*lead, batch, cache_len, m.qk_rope_dim), dtype=dt,
                                 device=device),
        }
    shape = (*lead, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def decoder_cache_specs(cfg: ModelConfig) -> dict:
    """Logical axes of one layer's ``init_decoder_cache``. KV heads shard over
    `model` when divisible; otherwise the sequence dim takes the model axis
    (a seq-sharded cache; the decode kernel reads it replicated)."""
    if cfg.mla is not None:
        return {"ckv": ("batch", "seq_shard", None), "krope": ("batch", "seq_shard", None)}
    seq_name = "seq" if _kv_heads_shardable(cfg) else "seq_shard"
    return {"k": ("batch", seq_name, "kv_heads", None), "v": ("batch", seq_name, "kv_heads", None)}


def _kv_heads_shardable(cfg: ModelConfig) -> bool:
    ctx = partition.current()
    if ctx is None or ctx.mesh is None:
        return True
    size = ctx.shape.get("model", 1)
    return size <= 1 or cfg.n_kv_heads % size == 0


# ------------------------------------------------------------------------ ssm
def init_ssm_layer(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    return {
        "mamba": mamba2.init_mamba2(gen, cfg, device, lead),
        "ln": layers.init_rmsnorm(cfg.d_model, device, lead),
    }


def ssm_layer_specs(cfg: ModelConfig) -> dict:
    return {"mamba": mamba2.mamba2_specs(cfg), "ln": layers.rmsnorm_specs()}


def ssm_layer(p, h: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False,
              impl: str = "auto"):
    """Train/prefill. Returns (h, state or None)."""
    h = _residual_enter(h, cfg)
    hn = layers.rmsnorm(h, p["ln"], cfg.norm_eps)
    y, state = mamba2.mamba2_block(p["mamba"], hn, cfg, return_state=return_state, impl=impl)
    return _add_residual(h, y, cfg), state


def ssm_layer_decode(p, h: torch.Tensor, state: dict, cfg: ModelConfig):
    """One token. ``state`` ({"conv", "ssm"}) is updated in place."""
    hn = layers.rmsnorm(h, p["ln"], cfg.norm_eps)
    y, state = mamba2.mamba2_decode(p["mamba"], hn, state, cfg)
    return h + y, state


# --------------------------------------------------------------------- encdec
def init_encoder_layer(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    dt = layers.dtype_of(cfg)
    return {
        "attn": attention.init_attention(gen, cfg, device, lead),
        "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device, lead),
        "ln1": layers.init_layernorm(cfg.d_model, device, lead),
        "ln2": layers.init_layernorm(cfg.d_model, device, lead),
    }


def encoder_layer_specs(cfg: ModelConfig) -> dict:
    return {"attn": attention.attention_specs(cfg), "mlp": layers.gelu_mlp_specs(),
            "ln1": layers.layernorm_specs(), "ln2": layers.layernorm_specs()}


def encoder_layer(p, h: torch.Tensor, cfg: ModelConfig, impl: str = "auto") -> torch.Tensor:
    """LayerNorm -> non-causal self-attention (no positions) -> residual ->
    LayerNorm -> GELU MLP -> residual."""
    h = _residual_enter(h, cfg)
    hn = layers.layernorm(h, p["ln1"], cfg.norm_eps)
    a, _ = attention.self_attention(p["attn"], hn, cfg, positions=None, causal=False,
                                    impl=impl)
    h = _add_residual(h, a, cfg)
    hn = layers.layernorm(h, p["ln2"], cfg.norm_eps)
    return _add_residual(h, layers.gelu_mlp(hn, p["mlp"]), cfg)


def init_cross_decoder_layer(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    dt = layers.dtype_of(cfg)
    return {
        "self": attention.init_attention(gen, cfg, device, lead),
        "cross": attention.init_attention(gen, cfg, device, lead),
        "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt, device, lead),
        "ln1": layers.init_layernorm(cfg.d_model, device, lead),
        "ln2": layers.init_layernorm(cfg.d_model, device, lead),
        "ln3": layers.init_layernorm(cfg.d_model, device, lead),
    }


def cross_decoder_layer_specs(cfg: ModelConfig) -> dict:
    return {"self": attention.attention_specs(cfg), "cross": attention.attention_specs(cfg),
            "mlp": layers.gelu_mlp_specs(), "ln1": layers.layernorm_specs(),
            "ln2": layers.layernorm_specs(), "ln3": layers.layernorm_specs()}


def cross_decoder_layer(p, h: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
                        impl: str = "auto"):
    """Train/prefill decoder layer. Returns (h, ((self_k, self_v), (cross_k, cross_v)))."""
    h = _residual_enter(h, cfg)
    hn = layers.layernorm(h, p["ln1"], cfg.norm_eps)
    a, self_kv = attention.self_attention(p["self"], hn, cfg, positions=None, causal=True,
                                          return_kv=True, impl=impl)
    h = _add_residual(h, a, cfg)
    hn = layers.layernorm(h, p["ln2"], cfg.norm_eps)
    c, cross_kv = attention.cross_attention(p["cross"], hn, kv_source=enc_out, cfg=cfg,
                                            impl=impl)
    h = _add_residual(h, c, cfg)
    hn = layers.layernorm(h, p["ln3"], cfg.norm_eps)
    return _add_residual(h, layers.gelu_mlp(hn, p["mlp"]), cfg), (self_kv, cross_kv)


def cross_decoder_layer_decode(p, h: torch.Tensor, cache: dict, pos: torch.Tensor,
                               cfg: ModelConfig, impl: str = "auto"):
    """One token. ``cache`` ({"k", "v", "cross_k", "cross_v"}) is updated in
    place: k and v at ``pos``; the cross leaves are only read."""
    hn = layers.layernorm(h, p["ln1"], cfg.norm_eps)
    a, _ = attention.self_attention_decode(p["self"], hn, cache["k"], cache["v"], pos, cfg,
                                           impl=impl)
    h = h + a
    hn = layers.layernorm(h, p["ln2"], cfg.norm_eps)
    c, _ = attention.cross_attention(p["cross"], hn,
                                     kv_cache=(cache["cross_k"], cache["cross_v"]), cfg=cfg,
                                     impl=impl)
    h = h + c
    hn = layers.layernorm(h, p["ln3"], cfg.norm_eps)
    return h + layers.gelu_mlp(hn, p["mlp"]), cache
