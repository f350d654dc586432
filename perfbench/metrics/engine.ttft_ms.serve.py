"""Engine admission: the median over the window's requests of the engine's
own time to the first token (``Request.first_token_at - Request.submitted``)."""
import statistics


def read(ctx):
    w = ctx["win"]
    vals = [(r.request.first_token_at - r.request.submitted) * 1e3 for r in w["records"]
            if w["t0"] <= r.submit < w["t1"] and r.request is not None
            and r.request.first_token_at is not None]
    return statistics.median(vals) if vals else None
