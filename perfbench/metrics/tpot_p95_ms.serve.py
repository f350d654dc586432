"""The tail of the time per output token in a saturated closed loop: the
95th percentile over the requests that finished in the window with two
tokens or more of (finished - first token) / (tokens - 1), from the
engine's ``Request`` stamps (``stats.time_per_output_token``)."""
from perfbench import stats


def read(ctx):
    w = ctx["win"]
    done = [r.request for r in w["records"] if r.request is not None
            and r.request.finished_at is not None and w["t0"] <= r.request.finished_at < w["t1"]
            and len(r.request.tokens) >= 2]
    return stats.percentile([stats.time_per_output_token(q.first_token_at, q.finished_at,
                                                         len(q.tokens)) * 1e3 for q in done], 95)
