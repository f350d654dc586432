"""deepseek-67b [dense] — arXiv:2401.02954 (llama-arch).

95L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=22016, vocab=102400.
The flagship dense cell of the assignment.
"""
from .base import ModelConfig, register_arch

FULL = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=102400,
)

REDUCED = ModelConfig(
    name="deepseek-67b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=256,
)

register_arch(FULL, REDUCED)
