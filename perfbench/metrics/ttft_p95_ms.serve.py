"""The tail of the time to the first token in a saturated closed loop: the
95th percentile over every request submitted in the window, from the
client's ``service.run`` to the engine's first-token stamp, a failed
request, or one with no first token, missed (``stats.percentile``). At saturation a tail swings with the
smallest change, so it is read here, not bounded as an end-to-end metric."""
from perfbench import stats


def read(ctx):
    w = ctx["win"]
    inside = [r for r in w["records"] if w["t0"] <= r.submit < w["t1"]]
    return stats.percentile([(r.request.first_token_at - r.submit) * 1e3
                             if r.request is not None and r.request.first_token_at is not None
                             else stats.MISSED for r in inside], 95)
