"""internvl2-26b [vlm] — arXiv:2404.16821 (InternViT-6B + InternLM2-20B).

LM backbone: 48L, d_model=6144, 48H (kv=8, head_dim=128), d_ff=16384,
vocab=92553. The InternViT frontend is a STUB: input_specs() provides 256
precomputed patch embeddings (B, 256, 6144) prepended to the text tokens.
"""
from .base import ModelConfig, register_arch

FULL = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    n_patches=256,
)

REDUCED = ModelConfig(
    name="internvl2-26b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    n_patches=8,
)

register_arch(FULL, REDUCED)
