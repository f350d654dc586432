"""Resolve a cell of ``BENCHMARK.json`` into what a run needs, by name.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name the benchmark gives it:

- a configuration: the ``file`` its entry names (under ``perfbench/configs/``),
  whose ``reference`` names its plain reference, ``perfbench/reference/<name>.py``;
- a traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``driver`` names
  the code that drives it, ``perfbench/drivers/<driver>.py``;
- a per-layer metric: its reader, ``perfbench/metrics/<name>.py``, a
  ``read(ctx)`` that returns a number or None when it finds nothing to read;
- a cell's correctness limits: ``perfbench/limits/<workload>.json``.

A later change adds a cell, a mix or a metric by adding such files and
entries; no file here lists them.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def _load_reader(path: Path) -> ModuleType:
    """A metric's reader, by file: its name holds dots, so it is no module name."""
    spec = importlib.util.spec_from_file_location(f"perfbench_metric:{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                      # the configuration file's contents
    mix: dict                         # the traffic file's contents
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]
    limits: dict

    @property
    def model(self) -> dict:
        """The sizes the program and the reference run (the file's ``model``)."""
        return self.config["model"]

    def reference(self) -> ModuleType:
        return importlib.import_module(f"perfbench.reference.{self.config['reference']}")

    def driver(self) -> ModuleType:
        return importlib.import_module(f"perfbench.drivers.{self.mix['driver']}")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    pkg = root / "perfbench"
    with open(pkg / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    limits_file = pkg / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: _load_reader(pkg / "metrics" / f"{m['name']}.py") for m in per_layer}
    return Cell(name=workload, chips=w["chips"], config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=per_layer, readers=readers, limits=limits)
