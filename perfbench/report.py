"""The result line of a run: ``correct``, the counts, the metrics, the device,
the trace's breakdown, and last the numbers compared with their limits."""
from __future__ import annotations

from typing import Dict, List

import torch


def judge(limits: Dict[str, float], readings: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell's limits name, beside its limit (None when the run
    gave no such number, which fails)."""
    return {name: {"value": readings.get(name), "limit": limit} for name, limit in limits.items()}


def is_correct(compared: Dict[str, dict], failed: int, settled: bool = True) -> bool:
    return (bool(compared) and failed == 0 and settled
            and all(c["value"] is not None and c["value"] <= c["limit"]
                    for c in compared.values()))


def result(cell, out: dict, trace: bool) -> dict:
    compared = judge(cell.limits, out["readings"])
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {name: reader.read(out["ctx"]) for name, reader in cell.readers.items()}
    else:
        values = {m["name"]: out["e2e"].get(m["name"]) for m in cell.end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["peak"]}
    res = {"correct": is_correct(compared, out["failed"], out.get("sampled_ok", True)),
           "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
           "device": device}
    piece = out["ctx"]["win"].get("slice") if trace else None
    if piece is not None:
        device.update(busy_s=piece.busy_s(), window_s=piece.window_s)
        res["breakdown"] = {"device_ops": piece.top_ops(), "idle_gaps": piece.idle_gaps()}
    res["compared"] = compared
    return res


def compared_lines(res: dict) -> List[str]:
    return [f"{name} {c['value']} limit {c['limit']}" for name, c in res["compared"].items()]
