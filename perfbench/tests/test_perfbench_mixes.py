"""The one request generator: the same seed gives the same requests, every
seed the same sizes, the strata reach the laws' tails, and two mixes with
the same lengths give the same requests."""
import itertools
import math
from collections import Counter

import numpy as np

from perfbench import mixes
from perfbench.bench import resolve

BIG_SEED = 2**40 + 17


def _take(mix, seed, client, n, vocab=151936):
    return list(itertools.islice(mixes.client_requests(mix, seed, client, vocab), n))


def test_a_seed_repeats_its_requests():
    mix = resolve("moe-chat").mix
    a, b = _take(mix, BIG_SEED, 3, 20), _take(mix, BIG_SEED, 3, 20)
    assert all(np.array_equal(p, q) and n == m for (p, n), (q, m) in zip(a, b))
    other = _take(mix, BIG_SEED + 1, 3, 20)
    assert any(not np.array_equal(p, q) for (p, _), (q, _) in zip(a, other))


def test_every_seed_gets_the_same_sizes_in_another_order():
    mix = resolve("moe-chat").mix
    n, clients = mix["strata"], mix["clients"]
    cycles = [mixes.cycle_of(mix, s) for s in (1, 2, BIG_SEED)]
    assert sorted(p for p, _ in cycles[0]) == sorted(p for p, _ in cycles[1]) \
        == sorted(p for p, _ in cycles[2])
    assert sorted(k for _, k in cycles[0]) == sorted(k for _, k in cycles[2])
    assert cycles[0] != cycles[1] or cycles[1] != cycles[2]   # paired and ordered by the seed
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    assert all(lo <= p <= hi for p, _ in cycles[0])
    # the clients' first requests sit evenly over the cycle, n / clients apart
    firsts = [(len(p), k) for c in range(clients) for p, k in _take(mix, 7, c, 1)]
    cycle = mixes.cycle_of(mix, 7)
    assert firsts == [cycle[c * n // clients] for c in range(clients)]


def test_the_strata_follow_the_law_from_its_median_to_its_tails():
    law = {"median": 1020, "sigma": 0.6, "min": 16, "max": 4096}
    q = mixes.lognormal_strata(law, 64)
    assert q == sorted(q) and len(q) == 64
    # the middle strata straddle the median; the top one is clipped to the range
    assert q[31] < 1020 < q[32]
    assert q[-1] == 4096 and q[-2] < 4096
    # the bottom stratum is the law's 1/128 quantile: median x exp(-2.418 sigma)
    assert q[0] == round(1020 * math.exp(0.6 * -2.4175590162365035))


def test_the_chat_mix_keeps_the_sources_medians_and_prompts_longer_than_answers():
    mix = resolve("moe-chat").mix
    assert (mix["prompt"]["median"], mix["output"]["median"]) == (1020, 129)
    sizes = mixes.cycle_of(mix, 3)
    prompts = sorted(p for p, _ in sizes)
    outputs = sorted(k for _, k in sizes)
    assert prompts[0] < 300 and prompts[-1] == 4096        # heavy-tailed, both ways
    assert outputs[0] < 16 and outputs[-1] == 1024
    assert max(p + k for p, k in sizes) < mix["max_len"]
    assert 5 < sum(prompts) / sum(outputs) < 7


def test_a_mix_with_the_same_lengths_draws_the_same_requests_whatever_drives_it():
    chat = resolve("moe-chat").mix
    other = dict(chat, driver="another", clients=16)
    for client in (0, 15):
        a, b = _take(chat, 7, client, 10), _take(other, 7, client, 10)
        assert all(np.array_equal(p, q) and n == m for (p, n), (q, m) in zip(a, b))
    assert Counter(k for _, k in _take(chat, 7, 0, 64)) == Counter(
        k for _, k in mixes.cycle_of(chat, 7))
