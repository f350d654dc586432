"""The control on the card at the cell's own size: the plain reference,
computed with fp8 products in the program's place, must come out not
correct by the cell's limits, on three seeds. Needs the card: the cells'
configuration fills much of one H100 (run with ``python -m pytest
--noconftest -m cuda perfbench/tests``)."""
import pytest
import torch

from perfbench import report
from perfbench.bench import resolve

SEEDS = (2**40 + 101, 2**40 + 102, 2**40 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


def _fails(cell, readings) -> bool:
    return not report.is_correct(report.judge(cell.limits, readings), 0)


@pytest.mark.cuda
def test_the_serving_control_fails(card):
    from perfbench.drivers import frontdoor as fdm

    cell = resolve("moe-chat")
    fd = fdm.FrontDoor(cell, SEEDS[0])
    try:
        for seed in SEEDS:
            fd.refill(seed)
            win = fdm.window(fd, seed, 12.0)
            r = fdm.check(cell, seed, fdm.sample(win["records"], seed, 6), control=True)
            control = {k[len("control_"):]: v for k, v in r.items() if k.startswith("control_")}
            assert _fails(cell, control), control
    finally:
        fd.close()

