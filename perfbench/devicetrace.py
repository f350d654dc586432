"""A slice of the window under ``torch.profiler``, reduced to what the
per-layer readers and the result's ``breakdown`` need: every device
activity (kernels, copies, sets), the time the device was busy, and the
longest idle gaps, each named by the device operations around it.

Only device activity is traced: recording the host's operations on every
thread of a serving process slowed it."""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

Span = Tuple[float, float]   # start, end in microseconds of the profiler's clock


def union_us(spans: List[Span]) -> float:
    """The time that some span covers. The gap arithmetic is copied from
    ``tools/profile_torch_serve.py`` ``_gaps_us`` at 8d0f43b."""
    covered, reach, start0 = 0.0, None, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            if reach is not None:
                covered += reach - start0
            start0, reach = start, end
        else:
            reach = max(reach, end)
    if reach is not None:
        covered += reach - start0
    return covered


@dataclass
class Slice:
    """What a profiled slice holds once reduced."""
    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)   # name, start, end

    def busy_s(self) -> float:
        return union_us([(s, e) for _, s, e in self.device]) / 1e6

    def device_s(self, match) -> float:
        """Seconds of the device activities whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name] += (e - s) / 1e6
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between device activities, each named by the
        activity that ended last before it and the one that starts it."""
        gaps, reach, last = [], None, None
        for name, start, end in sorted(self.device, key=lambda d: d[1]):
            if reach is not None and start > reach:
                gaps.append((start - reach, last, name))
            if reach is None or end > reach:
                reach, last = end, name
        return [[f"after {a[:90]} / before {b[:90]}", g / 1e6]
                for g, a, b in sorted(gaps, reverse=True)[:n]]


class Profiler:
    """``start()`` and ``stop()`` around a slice, each synchronizing the card
    first; ``slice()`` then reduces the trace. Call ``start`` and ``stop``
    where no other thread launches work on the card: a trace started or
    stopped beside another thread's graph replays has hung."""

    def __init__(self):
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._t0: Optional[float] = None
        self._window: Optional[float] = None

    @classmethod
    def warm(cls) -> None:
        """One empty slice, so that the profiler's first start, which sets up
        its tracing of the card, falls in set-up and not in a window."""
        prof = cls()
        prof.start()
        prof.stop()

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._window = time.perf_counter() - self._t0
        self._prof.stop()

    def slice(self) -> Slice:
        return Slice(window_s=self._window, device=[(e.name, e.time_range.start, e.time_range.end)
                                                    for e in self._prof.events()
                                                    if e.device_type == DeviceType.CUDA])
