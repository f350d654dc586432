"""The profiled slice's arithmetic: busy time as the union of the device's
activities (overlaps counted once), and the idle gaps between them."""
import pytest

from perfbench.devicetrace import Slice, union_us


def test_busy_time_counts_overlapping_activities_once():
    assert union_us([(0, 100), (50, 200), (400, 500)]) == 300
    assert union_us([]) == 0


def test_idle_gaps_are_named_by_the_activities_around_them():
    piece = Slice(window_s=1e-3, device=[("a", 0, 100), ("b", 50, 200), ("c", 400, 500),
                                         ("d", 700, 750)])
    assert piece.busy_s() == pytest.approx(350e-6)
    gaps = piece.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([200e-6, 200e-6])
    assert {g[0] for g in gaps} == {"after b / before c", "after c / before d"}
    assert piece.device_s(lambda n: n in "ab") == pytest.approx(250e-6)
    assert piece.count(lambda n: n == "c") == 1


def test_the_engine_profiler_runs_its_commands_on_the_engines_thread():
    import threading

    import torch

    from perfbench.drivers import frontdoor
    from perfbench.tests.cells import small

    torch.set_num_threads(2)
    fd = frontdoor.FrontDoor(small("moe-chat"), 3, "cpu")
    try:
        ran = []
        with frontdoor.EngineProfiler() as ep:
            ep.run(lambda: ran.append(threading.current_thread()))
        assert ran == [fd._loop]
    finally:
        fd.close()
