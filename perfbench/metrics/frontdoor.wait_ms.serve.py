"""The front door's wait: the median over the window's requests of the time
from the client's call to the worker's start (``TaskFuture.timestamps``:
``exec_start - client_submit``, the paper's Fig. 5 legs t_c + t_w + t_m)."""
import statistics


def read(ctx):
    w = ctx["win"]
    vals = [(r.stamps.exec_start - r.stamps.client_submit) * 1e3
            for r in w["records"] if w["t0"] <= r.submit < w["t1"]
            and r.stamps is not None and r.stamps.exec_start]
    return statistics.median(vals) if vals else None
