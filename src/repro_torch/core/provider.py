"""Resource providers (paper §5.4: Parsl-provider-style pilot jobs).

funcX provisions compute via Parsl's provider interface (Slurm, PBS, Cobalt,
clouds). Here:

- :class:`LocalThreadProvider` actually provisions (thread-pool "nodes") and
  backs every live endpoint in tests/benchmarks.
- :class:`SlurmProvider` / :class:`TPUPodProvider` generate real submit
  scripts (sbatch / pod-launch) under ``launch/generated/`` — the deliverable
  launch scripts for the production mesh — and only execute them when
  ``submit=True`` (never true in this container).

Scaling policy (elasticity) lives in the endpoint; providers expose
``scale_out``/``scale_in`` blocks like Parsl.
"""
from __future__ import annotations

import abc
import os
import textwrap
from dataclasses import dataclass

from typing import Callable, Dict, List, Optional


@dataclass
class ProviderSpec:
    min_blocks: int = 0
    max_blocks: int = 8
    init_blocks: int = 1
    workers_per_block: int = 4
    # batch-scheduler knobs
    queue: str = "normal"
    walltime: str = "01:00:00"
    account: str = "funcjax"


class Provider(abc.ABC):
    """A block == one node-equivalent (maps to one Executor)."""

    def __init__(self, spec: ProviderSpec):
        self.spec = spec
        self._blocks: Dict[str, object] = {}

    @abc.abstractmethod
    def scale_out(self, n: int) -> List[str]:
        """Provision n blocks; returns block ids."""

    @abc.abstractmethod
    def scale_in(self, block_ids: List[str]) -> None:
        """Release blocks."""

    def release(self, block_ids: List[str]) -> None:
        """Forget blocks without tearing them down — dead-block bookkeeping.
        A watchdog-declared-dead executor may be a false positive (heartbeat
        stall): its threads must stay up to deliver late results, but the
        block must stop counting against ``max_blocks`` so replacements fit."""
        for bid in block_ids:
            self._blocks.pop(bid, None)

    def status(self) -> dict:
        return {"blocks": len(self._blocks), "spec": self.spec}


class LocalThreadProvider(Provider):
    """Blocks are thread-backed Executors created via a factory injected by
    the endpoint (avoids a circular import)."""

    def __init__(self, spec: Optional[ProviderSpec] = None):
        super().__init__(spec or ProviderSpec())
        self._factory: Optional[Callable[[str], object]] = None
        self._counter = 0

    def bind_factory(self, factory: Callable[[str], object]) -> None:
        self._factory = factory

    def scale_out(self, n: int) -> List[str]:
        if self._factory is None:
            raise RuntimeError("provider not bound to an endpoint")
        out = []
        for _ in range(n):
            if len(self._blocks) >= self.spec.max_blocks:
                break
            bid = f"block-{self._counter}"
            self._counter += 1
            self._blocks[bid] = self._factory(bid)
            out.append(bid)
        return out

    def scale_in(self, block_ids: List[str]) -> None:
        for bid in block_ids:
            ex = self._blocks.pop(bid, None)
            if ex is not None and hasattr(ex, "shutdown"):
                ex.shutdown()

    def block(self, block_id: str):
        return self._blocks.get(block_id)


class ScriptProvider(Provider):
    """Base for providers that emit submit scripts instead of local threads."""

    def __init__(self, spec: Optional[ProviderSpec] = None, out_dir: str = "launch/generated",
                 submit: bool = False):
        super().__init__(spec or ProviderSpec())
        self.out_dir = out_dir
        self.submit = submit
        self._counter = 0
        self.generated: List[str] = []

    def _write(self, name: str, content: str) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, name)
        with open(path, "w") as f:
            f.write(content)
        os.chmod(path, 0o755)
        self.generated.append(path)
        return path

    def scale_in(self, block_ids: List[str]) -> None:
        for bid in block_ids:
            self._blocks.pop(bid, None)


class SlurmProvider(ScriptProvider):
    """Generates sbatch pilot-job scripts that start funcJAX executors."""

    def scale_out(self, n: int) -> List[str]:
        out = []
        for _ in range(n):
            bid = f"slurm-{self._counter}"
            self._counter += 1
            script = textwrap.dedent(
                f"""\
                #!/bin/bash
                #SBATCH --job-name=funcjax-{bid}
                #SBATCH --partition={self.spec.queue}
                #SBATCH --time={self.spec.walltime}
                #SBATCH --account={self.spec.account}
                #SBATCH --nodes=1
                #SBATCH --ntasks-per-node=1

                # funcJAX pilot job: start one executor block that connects
                # back to the endpoint manager (capacity advertising + heartbeats).
                export PYTHONPATH=src
                python -m repro.launch.executor_block \\
                    --block-id {bid} \\
                    --workers {self.spec.workers_per_block} \\
                    --manager-url "$FUNCJAX_MANAGER_URL"
                """
            )
            path = self._write(f"{bid}.sbatch", script)
            self._blocks[bid] = path
            out.append(bid)
            if self.submit:  # pragma: no cover - no scheduler in this container
                os.system(f"sbatch {path}")
        return out


class TPUPodProvider(ScriptProvider):
    """Generates pod-slice launch scripts (gcloud/xpk style) for the
    production mesh: one process per host, 4 chips per host, v5e-256 slices."""

    def __init__(self, spec: Optional[ProviderSpec] = None, out_dir: str = "launch/generated",
                 submit: bool = False, pod_slices: int = 2, chips_per_slice: int = 256):
        super().__init__(spec, out_dir, submit)
        self.pod_slices = pod_slices
        self.chips_per_slice = chips_per_slice

    def scale_out(self, n: int) -> List[str]:
        out = []
        for _ in range(n):
            bid = f"pod-{self._counter}"
            self._counter += 1
            hosts = self.chips_per_slice // 4
            script = textwrap.dedent(
                f"""\
                #!/bin/bash
                # funcJAX pod-slice launcher ({self.chips_per_slice} chips, {hosts} hosts).
                # Every host runs the same binary; jax.distributed.initialize()
                # derives coordinator/rank from the TPU environment.
                set -euo pipefail
                SLICE_ID={bid}
                gcloud compute tpus tpu-vm ssh funcjax-$SLICE_ID --worker=all --command '
                  export PYTHONPATH=src
                  export FUNCJAX_NUM_SLICES={self.pod_slices}
                  python -m repro.launch.train \\
                      --arch "$FUNCJAX_ARCH" --shape "$FUNCJAX_SHAPE" \\
                      --multi-pod --slice-id '$SLICE_ID'
                '
                """
            )
            path = self._write(f"{bid}.sh", script)
            self._blocks[bid] = path
            out.append(bid)
        return out
