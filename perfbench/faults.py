"""Faults planted in the program, for the checks that ``correct`` must fail.

Each is a context manager that breaks the timed path underneath while it is
active, by wrapping a function of the program:

- ``state_unchanged``: a step leaves its state as it was (each decode step
  writes into a copy of the cache);
- ``token_altered``: a token is altered where it is produced (every greedy
  token the engine's captured decode step samples, plus one).
"""
from __future__ import annotations

import contextlib


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def serve_state_unchanged():
    from repro_torch.models.model import Model

    def make(orig):
        return lambda self, token, cache, pos: orig(self, token, _clone(cache), pos)

    with _patched(Model, "decode_step", make):
        yield


def serve_token_altered():
    """Every greedy token the engine's captured decode step samples, plus one."""
    from repro_torch.serving.engine import ServeEngine

    def make(orig):
        def decode(self):
            orig(self)
            self._sampled.add_(1).remainder_(self.cfg.vocab)
        return decode

    return _patched(ServeEngine, "_decode", make)


SERVE = {"state_unchanged": serve_state_unchanged, "token_altered": serve_token_altered}


def of(driver: str) -> dict:
    """The faults a cell driven by ``driver`` can have, by name."""
    return {"frontdoor": SERVE}[driver]
