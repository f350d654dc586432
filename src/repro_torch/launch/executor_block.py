"""Pilot-job entrypoint: one executor block on a compute node.

Port of ``repro.launch.executor_block`` over ``repro_torch.core``: the same
flags and the same idle exit. The submit scripts generated by
`repro_torch.core.provider` launch this module on each provisioned node. In
a networked deployment the block
would connect back to the endpoint manager over a socket; in this repo the
in-process LocalThreadProvider covers the live path, so this entrypoint
hosts a self-contained endpoint (useful for single-node pilot jobs) and
documents the wire contract for a remote manager.

    python -m repro_torch.launch.executor_block --block-id b0 --workers 8 \\
        [--manager-url tcp://manager:5555]
"""
from __future__ import annotations

import argparse
import signal
import time

from repro_torch.core import FunctionService


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--block-id", required=True)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--prefetch", type=int, default=4)
    ap.add_argument("--manager-url", default=None,
                    help="endpoint manager address (remote mode; not used by "
                         "the in-process deployment in this container)")
    ap.add_argument("--heartbeat-s", type=float, default=2.0)
    ap.add_argument("--idle-exit-s", type=float, default=0.0,
                    help="exit after this much idle time (0 = run forever)")
    args = ap.parse_args()

    service = FunctionService()
    ep = service.make_endpoint(
        f"block-{args.block_id}",
        n_executors=1,
        workers_per_executor=args.workers,
        prefetch=args.prefetch,
        heartbeat_interval_s=args.heartbeat_s,
    )
    print(f"[executor_block {args.block_id}] up: {args.workers} workers, "
          f"prefetch {args.prefetch}, endpoint {ep.endpoint_id}", flush=True)
    if args.manager_url:
        print(f"[executor_block {args.block_id}] remote manager registration "
              f"to {args.manager_url} is deployment-specific (ZeroMQ/gRPC); "
              "this container runs in-process endpoints only.", flush=True)

    stop = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *a: stop.update(flag=True))
    idle_since = time.monotonic()
    try:
        while not stop["flag"]:
            time.sleep(min(args.heartbeat_s, 1.0))
            busy = ep.queue_depth() or any(
                len(e.in_flight) for e in ep.executors.values()
            )
            if busy:
                idle_since = time.monotonic()
            elif args.idle_exit_s and time.monotonic() - idle_since > args.idle_exit_s:
                break
    finally:
        service.shutdown()
        print(f"[executor_block {args.block_id}] shut down", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
