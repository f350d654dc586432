"""The device's idle share in the profiled slice: the time no device
activity covers, over the slice."""
from perfbench import counts


def read(ctx):
    piece = ctx["win"].get("slice")
    if piece is None or not piece.device:
        return None
    return 100.0 * counts.idle_share(piece.busy_s(), piece.window_s)
