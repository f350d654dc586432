"""qwen2-0.5b [dense] — arXiv:2407.10671.

24L, d_model=896, 14H (GQA kv=2, head_dim=64), d_ff=4864, vocab=151936,
QKV bias, tied embeddings. 14 heads % 16 != 0 -> attention projections
replicate over `model` on the production mesh (d_ff and vocab still shard).
"""
from .base import ModelConfig, register_arch

FULL = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen2-0.5b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    tie_embeddings=True,
)

register_arch(FULL, REDUCED)
