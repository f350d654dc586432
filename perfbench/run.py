"""Run one cell of BENCHMARK.json once, and print its result as the last line.

    python3 perfbench/run.py --workload moe-chat --seed 7 --seconds 30 --trace 0

From the root of a checkout. The cell's configuration, traffic mix, metric
readers and correctness limits are found by name (``perfbench/bench.py``).
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from spans, counters and a
profiled slice of the window, with the device's busy time. Every number
compared for ``correct`` is printed beside its limit, as the last lines on
standard error and under ``compared``, the last key of the result.

Exit codes: 0 with a result; 2 for a workload that is not in the benchmark;
3 without the CUDA cards the cell asks for; 4 when JAX, flax or the JAX
package was loaded in this process. No result is printed unless 0.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names, compared whole


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    kernels' own libraries go to ``build/repro_torch_kernels/``)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import bench, report

    try:
        cell = bench.resolve(args.workload)
    except KeyError as exc:
        print(exc, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    result = report.result(cell, out, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs without JAX and the JAX package",
              file=sys.stderr)
        return 4
    for line in report.compared_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
