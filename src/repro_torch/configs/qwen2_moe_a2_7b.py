"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L, d_model=2048, 16H (kv=16), 60 routed experts top-4 (d_ff=1408) plus
4 shared experts (merged shared d_ff=5632) with a sigmoid shared-expert
gate, vocab=151936, QKV bias. 60 % 16 != 0 -> the partitioner falls back
to TP-MoE (expert d_ff sharded over `model`, experts replicated).
"""
from .base import ModelConfig, MoEConfig, register_arch

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(
        n_experts=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared_experts=4,
        d_ff_shared=5632,
        capacity_factor=1.25,
        norm_topk_prob=False,
    ),
)

REDUCED = ModelConfig(
    name="qwen2-moe-a2.7b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=256,
    qkv_bias=True,
    moe=MoEConfig(
        n_experts=6, top_k=2, d_ff_expert=64, n_shared_experts=2, d_ff_shared=128,
        capacity_factor=1.5, norm_topk_prob=False,
    ),
)

register_arch(FULL, REDUCED)
