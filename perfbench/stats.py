"""The window arithmetic: rates over the whole window, tails over all requests.

A rate is the work completed inside the window over the window's length. A
tail is taken over every request the window counts; a request that failed or
never answered counts as missing any limit (an infinite time).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

MISSED = math.inf


def rate(work: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (the smallest value with at least q% of
    the values at or below it); None for no values. A missed request is +inf
    and ranks last."""
    vals = sorted(values)
    if not vals:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def time_per_output_token(first_token_at: float, finished_at: float, n_tokens: int) -> float:
    """(finished - first token) / (tokens - 1): the mean gap between a
    request's tokens after its first; it needs at least two tokens."""
    if n_tokens < 2:
        raise ValueError("a time per output token needs at least two tokens")
    return (finished_at - first_token_at) / (n_tokens - 1)
