"""Flash (prefill) and decode attention: ``ref`` (plain), ``kernel`` (CUDA), ``ops`` (dispatch)."""
