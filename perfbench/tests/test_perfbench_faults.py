"""A whole run of each cell, past the look for a card, on the CPU at a small
size: the sound program comes out correct, and with each fault the cell can
have planted underneath (``perfbench/faults.py``) it comes out not correct,
by the cell's own limits. The control (the reference in fp8 in the
program's place) is read on the card at the cell's own size
(``test_perfbench_control_cuda.py``)."""
import time

import pytest
import torch

from perfbench import faults, report
from perfbench.tests.cells import WORKLOADS, small

SEED = 2**40 + 5


def _correct(cell, out) -> bool:
    return report.is_correct(report.judge(cell.limits, out["readings"]), out["failed"],
                             out.get("sampled_ok", True))


def _run(cell):
    torch.set_num_threads(2)
    return cell.driver().run(cell, SEED, 2.0, False, time.monotonic(), device="cpu")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_sound_program_is_correct(workload):
    cell = small(workload)
    out = _run(cell)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert _correct(cell, out), report.judge(cell.limits, out["readings"])


FAULTS = [(w, name) for w in WORKLOADS for name in faults.of(small(w).mix["driver"])]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault):
    cell = small(workload)
    with faults.of(cell.mix["driver"])[fault]():
        out = _run(cell)
    assert not _correct(cell, out), report.judge(cell.limits, out["readings"])
