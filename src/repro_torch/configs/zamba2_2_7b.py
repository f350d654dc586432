"""zamba2-2.7b [hybrid] — arXiv:2411.15242.

54 Mamba2 layers, d_model=2560, ssm_state=64; one shared attention(+MLP)
block (32H, kv=32) applied every 6 Mamba layers with re-used parameters
(Zamba2's shared-block scheme, simplified to a single shared block).
Runs long_500k: SSM state is O(1) in sequence length and the shared
attention decode is a single-query pass.
"""
from .base import ModelConfig, SSMConfig, register_arch

FULL = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    shared_attn_every=6,
)

REDUCED = ModelConfig(
    name="zamba2-2.7b-reduced",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4, chunk=16),
    shared_attn_every=2,
)

register_arch(FULL, REDUCED)
