"""The readings a cell's correctness limits are set from, on the card.

    python3 perfbench/limits.py --workload moe-chat --seeds 1-12 --control 3 \\
        --faults 3 --seconds 20 --out chiprun_out/limits-moe-chat.jsonl

For each seed: the program's numbers (a short window at the cell's own load,
every request of it finished) against the plain reference: the lower
reading is their largest over the seeds. For the
first ``--control`` seeds also the control: the reference computed with fp8
products in the program's place. For the first ``--faults`` seeds each fault
the cell can have (``faults.py``), planted in the program. One JSON line a
reading. The benchmark's own runs do not run this.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def _free() -> None:
    from perfbench import program

    program.release()


def serve_readings(cell, seeds, n_control, n_faults, seconds, device, emit) -> None:
    from perfbench import faults
    from perfbench.drivers import frontdoor

    drv = cell.driver()

    def window(sys_, seed):
        win = drv.window(sys_, seed, seconds)
        failed = sum(1 for r in win["records"] if not r.answered and not r.cut)
        return win, failed, frontdoor.sample(win["records"], seed, cell.mix["check_requests"])

    sys_ = drv.build(cell, seeds[0], device)
    for i, seed in enumerate(seeds):
        sys_.refill(seed)
        win, failed, picked = window(sys_, seed)
        r = frontdoor.check(cell, seed, picked, device, control=i < n_control)
        emit(dict(kind="program", seed=seed, failed=failed, requests=len(win["records"]),
                  **{k: v for k, v in r.items() if not k.startswith("control_")}))
        if control := {k[len("control_"):]: v for k, v in r.items() if k.startswith("control_")}:
            emit(dict(kind="control", seed=seed, **control))
    sys_.close()
    del sys_
    _free()
    for name, plant in faults.of(cell.mix["driver"]).items():
        for seed in seeds[:n_faults]:
            with plant():
                sys_ = drv.build(cell, seed, device)
                win, failed, picked = window(sys_, seed)
                sys_.close()
            del sys_
            _free()
            r = frontdoor.check(cell, seed, picked, device) if picked else {"logit_gap": None}
            emit(dict(kind=f"fault:{name}", seed=seed, failed=failed, **r))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import bench

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = bench.resolve(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = dict(workload=args.workload, t=round(time.monotonic() - T_START, 1), **row)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    serve_readings(cell, seeds_of(args.seeds), args.control, args.faults, args.seconds,
                   "cuda", emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
