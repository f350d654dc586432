"""The window arithmetic: a rate over the whole window, a tail over every
request with failures counted as missed, and the time per output token."""
import math
from types import SimpleNamespace

import pytest

from perfbench import stats
from perfbench.bench import resolve
from perfbench.drivers import frontdoor


def test_a_rate_is_the_work_over_the_whole_window():
    assert stats.rate(600, 40.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_the_p95_is_nearest_rank_over_all_requests_and_a_failure_is_missed():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 95) is None
    # 5 failures of 100 sit at the top: the p95 is still a number, a 6th makes it missed
    five = list(range(1, 96)) + [stats.MISSED] * 5
    assert stats.percentile(five, 95) == 95
    assert stats.percentile(list(range(1, 95)) + [stats.MISSED] * 6, 95) == math.inf


def test_the_time_per_output_token_counts_the_gaps_after_the_first():
    assert stats.time_per_output_token(10.0, 12.0, 5) == 0.5
    with pytest.raises(ValueError):
        stats.time_per_output_token(1.0, 2.0, 1)


def _rec(submit, first=None, done=None, n=4, n_new=4):
    req = None if first is None and n else SimpleNamespace(first_token_at=first, finished_at=done,
                                                     tokens=[0] * n, submitted=submit)
    return frontdoor.Record(client=0, prompt=None, n_new=n_new, submit=submit, request=req)


def _readers():
    return resolve("moe-chat").readers


def test_the_front_door_rate_and_tails_take_every_request_of_the_window():
    win = dict(t0=10.0, t1=20.0, tokens=500, records=[
        _rec(9.0, 9.5, 10.5),              # submitted before the window: no TTFT, a TPOT
        _rec(11.0, 11.2, 12.2, n=11),      # 0.2 s to its first token, 0.1 s a token after
        _rec(12.0, 12.4, 25.0),            # finished after the close: no TPOT
        _rec(13.0),                        # never answered: missed
    ])
    ctx = {"win": win}
    assert frontdoor.end_to_end(win) == {"serve_tokens_per_s": 50.0}
    readers = _readers()
    assert readers["ttft_p95_ms.serve"].read(ctx) == math.inf          # 1 of 3 missed
    assert readers["tpot_p95_ms.serve"].read(ctx) == pytest.approx(1000 / 3)
    win["records"] = win["records"][:3]
    assert readers["ttft_p95_ms.serve"].read(ctx) == pytest.approx(400.0)


def test_a_request_cut_at_the_close_counts_for_its_first_token_and_nothing_else():
    cut = _rec(11.0, 11.3, None, n=2, n_new=8)          # two of its 8 tokens at the close
    done = _rec(12.0, 12.1, 13.1, n=11, n_new=11)
    cut.prompt = done.prompt = [0] * 5
    assert cut.cut and not cut.answered and done.answered and not done.cut
    win = dict(t0=10.0, t1=20.0, tokens=100, records=[cut, done])
    readers = _readers()
    assert readers["ttft_p95_ms.serve"].read({"win": win}) == pytest.approx(300.0)
    assert readers["tpot_p95_ms.serve"].read({"win": win}) == pytest.approx(100.0)
    assert frontdoor.sample(win["records"], 1, 6) == [done]
    # queued at the close with no first token: missed
    win["records"] = [_rec(11.0, None, None, n=0) for _ in range(3)] + [done]
    assert readers["ttft_p95_ms.serve"].read({"win": win}) == math.inf

