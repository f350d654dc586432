"""qwen3-moe-235b-a22b [moe] — hf:Qwen/Qwen3-235B-A22B (family per Qwen3-30B-A3B).

94L, d_model=4096, 64H (kv=4, head_dim=128), MoE 128 experts top-8 with
expert d_ff=1536, vocab=151936, per-head q/k RMSNorm (Qwen3 style).
"""
from .base import ModelConfig, MoEConfig, register_arch

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # expert d_ff (Qwen3-MoE has no dense MLP path)
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, capacity_factor=1.25),
)

REDUCED = ModelConfig(
    name="qwen3-moe-235b-a22b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, capacity_factor=1.5),
)

register_arch(FULL, REDUCED)
