"""The port's mesh dry run against the reference's on the production mesh (F13).

Both dry runs, each in a subprocess of its own as their command lines run
them, on the (16, 16) mesh: the reference's ``python -m repro.launch.dryrun``
(XLA's cost analysis of unrolled compiles at two depths, on forced host
devices) and the port's ``python -m repro_torch.launch.dryrun --mesh 16,16
--calibrated`` (each rank's local ops under PyTorch's fake process group, at
the same two depths). The port's FLOPs a device stay within 1.10x the
reference's. Before the repair they were 1.30x on the dense cell (the down
projection's input gradient, met by a partial gradient, computed whole on
every `model` rank) and 3.80x on the MoE cell (4 KV heads on a 16-way `model`
axis: every rank ran all 64 query heads' attention).

Wire bytes are not held: DTensor issues other collectives than XLA's
partitioner (PERF.md gives both).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RATIO = 1.10
TIMEOUT = 600


def _run(module: str, arch: str, results: Path, *extra: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", module, "--arch", arch, "--shape", "train_4k",
           "--results", str(results), *extra]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    (record,) = json.loads(results.read_text()).values()
    assert record["status"] == "ok", record
    return record


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-235b-a22b"])
def test_port_flops_per_device_meet_the_reference_on_16x16(tmp_path, arch):
    ref = _run("repro.launch.dryrun", arch, tmp_path / "reference.json")
    port = _run("repro_torch.launch.dryrun", arch, tmp_path / "port.json",
                "--mesh", "16,16", "--calibrated")
    assert ref["mesh"]["devices"] == port["mesh"]["devices"] == 256
    want = ref["analysis"]["calibrated"]["flops_per_device"]
    got = port["analysis"]["cost"]["flops_per_device"]
    assert got <= FLOPS_RATIO * want, (got, want, got / want)
    # the port counts the products (FlopCounterMode), XLA every op: the port
    # may fall short, but not by more than the elementwise share
    assert got >= 0.8 * want, (got, want, got / want)
