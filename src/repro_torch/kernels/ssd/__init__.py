"""Mamba2 SSD chunked scan: ``ref`` (plain), ``kernel`` (CUDA), ``ops`` (dispatch)."""
