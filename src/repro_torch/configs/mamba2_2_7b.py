"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

64L, d_model=2560 (attention-free), d_inner=5120, head_dim=64 -> 80 SSD
heads, state N=128, conv kernel 4, vocab=50280. Runs long_500k: decode
state is O(1) in sequence length.
"""
from .base import ModelConfig, SSMConfig, register_arch

FULL = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4, chunk=256),
)

REDUCED = ModelConfig(
    name="mamba2-2.7b-reduced",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4, chunk=16),
)

register_arch(FULL, REDUCED)
