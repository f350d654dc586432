"""The one generator of request mixes: each client's requests from the run's seed.

A mix file gives the prompt and output lengths as lognormal laws, each by its
median, its ``sigma`` (of the log) and the range it is clipped to. Every seed
gets the same set of sizes: the prompt lengths and the output lengths sit at
the midpoints of ``strata`` equally likely strata of their laws, from the
bottom stratum to the top one, so the tail is in every cycle; the seed pairs
them and orders the pairs, once for all clients, and draws the prompts'
tokens. Each client runs that cycle over and over from its own offset, the
clients' offsets spread evenly over it, so whatever part of a cycle a window
holds, the clients together hold about the same sizes. Two seeds give the
same work in another order, and two mixes with the same lengths give the
same requests, whatever drives them.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np

Request = Tuple[np.ndarray, int]   # prompt tokens (int32), tokens to generate


def lognormal_strata(law: dict, n: int) -> List[int]:
    """The lengths at quantiles (i + 1/2) / n of the lognormal law
    ``median`` x exp(``sigma`` x Z), rounded and clipped to [``min``, ``max``]."""
    z = NormalDist()
    return [min(law["max"], max(law["min"], int(round(
        law["median"] * math.exp(law["sigma"] * z.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]


def cycle_of(mix: dict, seed: int) -> List[Tuple[int, int]]:
    """The seed's cycle of (prompt length, tokens to generate)."""
    n = mix["strata"]
    prompts = lognormal_strata(mix["prompt"], n)
    outputs = lognormal_strata(mix["output"], n)
    rng = np.random.default_rng([seed, 1 << 21])
    return [(prompts[i], outputs[j]) for i, j in zip(rng.permutation(n), rng.permutation(n))]


def client_requests(mix: dict, seed: int, client: int, vocab: int) -> Iterator[Request]:
    """Client ``client``'s requests, endlessly, the same for the same seed."""
    cycle = cycle_of(mix, seed)
    n = len(cycle)
    offset = client * n // mix["clients"]
    k = 0
    while True:
        length, n_new = cycle[(k + offset) % n]
        rng = np.random.default_rng([seed, client, k])
        yield rng.integers(0, vocab, length, dtype=np.int64).astype(np.int32), n_new
        k += 1


def warmup_request(mix: dict, seed: int, vocab: int) -> Request:
    """One request at the mix's longest prompt, generating two tokens."""
    rng = np.random.default_rng([seed, 1 << 20])
    return rng.integers(0, vocab, mix["prompt"]["max"], dtype=np.int64).astype(np.int32), 2
