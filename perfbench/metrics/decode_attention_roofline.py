"""The decode-attention kernel's share of its roofline in the profiled
slice: the calls (its split kernels counted in the trace) times the least
time of a call at the slice's rows' positions (``counts``: K/V, q, o and
lengths at HBM's rate, or the products at the bf16 peak), over the device
time of its split and combine kernels."""
from perfbench import counts


def _split(name):
    return "decode_split_kernel" in name


def _both(name):
    return "decode_split_kernel" in name or "decode_combine_kernel" in name


def read(ctx):
    w = ctx["win"]
    piece, steps = w.get("slice"), w.get("slice_replays") or []
    if piece is None or not steps or not piece.count(_split):
        return None
    m = ctx["cell"].model
    per_call = sum(counts.least_ms(counts.decode_attention_bytes(k, m),
                                   counts.decode_attention_flops(k, m)) for k in steps) / len(steps)
    return 100.0 * piece.count(_split) * per_call / (piece.device_s(_both) * 1e3)
