"""qwen1.5-0.5b [dense] — hf:Qwen/Qwen1.5-0.5B.

24L, d_model=1024, 16H (kv=16, head_dim=64), d_ff=2816, vocab=151936,
QKV bias, tied embeddings. Fully TP-shardable on the 16-way model axis.
"""
from .base import ModelConfig, register_arch

FULL = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen1.5-0.5b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
)

register_arch(FULL, REDUCED)
