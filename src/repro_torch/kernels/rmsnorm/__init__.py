"""Fused residual add + RMSNorm: ``ref`` (plain), ``kernel`` (CUDA), ``ops`` (dispatch)."""
