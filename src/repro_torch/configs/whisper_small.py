"""whisper-small [audio enc-dec] — arXiv:2212.04356.

12L enc + 12L dec, d_model=768, 12H (kv=12), d_ff=3072, vocab=51865.
Conv frontend is a STUB: input_specs() provides precomputed 1500-frame
embeddings (B, 1500, 768); assigned shapes apply to the decoder sequence.
"""
from .base import ModelConfig, register_arch

FULL = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    n_enc_layers=12,
    enc_seq=1500,
    rope_theta=0.0,  # whisper uses sinusoidal absolute positions, not RoPE
)

REDUCED = ModelConfig(
    name="whisper-small-reduced",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    n_enc_layers=2,
    enc_seq=24,
    rope_theta=0.0,
)

register_arch(FULL, REDUCED)
