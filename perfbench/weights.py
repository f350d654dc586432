"""Weights drawn from the run's seed, the same for the program and the reference.

A configuration's reference declares its weights (``weight_specs``): each
leaf's path (the program's parameter name), shape, dtype and the normal
distribution it is drawn from. Each leaf has a generator of its own, seeded
from the run's seed and the leaf's path, so a leaf is drawn in one call, on
the card, in the dtype it is served in, and either side can draw any leaf
again without the others. ``fill`` draws into the program's parameters in
place; ``draw`` gives the reference its own copy.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterable, Tuple

import torch

Spec = Tuple[Tuple[int, ...], torch.dtype, float, float]   # shape, dtype, mean, std


def leaf_seed(seed: int, path: str) -> int:
    """A 63-bit seed for one leaf: any whole ``seed`` (larger than 32 bits too)
    mixed with the leaf's path."""
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(path.encode())) % (1 << 63)


def draw_into(t: torch.Tensor, seed: int, path: str, spec: Spec) -> torch.Tensor:
    _, _, mean, std = spec
    gen = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, path))
    return t.normal_(mean, std, generator=gen)


def draw(seed: int, path: str, spec: Spec, device) -> torch.Tensor:
    shape, dtype, _, _ = spec
    return draw_into(torch.empty(shape, dtype=dtype, device=device), seed, path, spec)


def check(params: Iterable[Tuple[str, torch.Tensor]], specs: Dict[str, Spec]) -> None:
    """The program's parameters are exactly the reference's leaves, in shape and dtype."""
    got = {name: (tuple(p.shape), p.dtype) for name, p in params}
    want = {name: (tuple(s[0]), s[1]) for name, s in specs.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        differ = sorted(n for n in set(got) & set(want) if got[n] != want[n])
        raise ValueError(f"the program's weights differ from the reference's: missing "
                         f"{missing}, extra {extra}, other shape or dtype "
                         f"{[(n, got[n], want[n]) for n in differ]}")


@torch.no_grad()
def fill(params: Iterable[Tuple[str, torch.Tensor]], specs: Dict[str, Spec], seed: int) -> None:
    """Draw every leaf into the program's parameter of the same name, in place."""
    params = list(params)
    check(params, specs)
    for name, p in params:
        draw_into(p.data, seed, name, specs[name])
