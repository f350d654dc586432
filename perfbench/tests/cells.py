"""Cells of the benchmark cut to a size the CPU runs in seconds, for the tests.

Each is the real cell (its driver, reference, readers and limits) with the
configuration's ``model`` block and the mix's sizes made small and float32.
"""
from __future__ import annotations

import copy
import json

from perfbench import bench

SMALL_MODELS = {   # by configuration
    "qwen2-moe-a2.7b": dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256, dtype="float32",
        moe=dict(n_experts=6, top_k=2, d_ff_expert=64, n_shared_experts=2, d_ff_shared=128,
                 capacity_factor=3.0, norm_topk_prob=False)),
}
SMALL_MIXES = {    # by traffic mix
    "chat": dict(clients=3, max_batch=4, max_len=96,
                 prompt={"median": 16, "sigma": 0.6, "min": 8, "max": 40},
                 output={"median": 6, "sigma": 1.0, "min": 2, "max": 16}, strata=6,
                 warm_s=0.3, check_requests=3),
}
WORKLOADS = [w["name"] for w in bench.load_benchmark()["workloads"]]


def small(workload: str) -> bench.Cell:
    entry = {w["name"]: w for w in bench.load_benchmark()["workloads"]}[workload]
    cell = bench.resolve(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(copy.deepcopy(SMALL_MODELS[entry["config"]]))
    cell.mix = dict(json.loads(json.dumps(cell.mix)), **copy.deepcopy(SMALL_MIXES[entry["traffic"]]))
    return cell
