"""Dry run on one H100: FLOPs, memory fit and roofline of every (arch x shape) cell.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
    python -m repro_torch.launch.dryrun --all                   # every cell, no card needed
    python -m repro_torch.launch.dryrun --arch X --shape Y --override remat_policy=dots
    python -m repro_torch.launch.dryrun --arch mamba2-2.7b --shape long_500k --run

Port of ``repro.launch.dryrun`` over one device. For each cell it records
whether the cell applies (``cell_applicable``); the FLOPs of one step,
counted by ``FlopCounterMode`` over the cell's ``BuiltStep`` traced on the
meta device at full depth and at the reference's two calibration depths,
extrapolated and held equal to the full count; the modeled HBM traffic; the
memory fit on the card (``analysis.memory_fit``: fits, the largest batch that
does, the terms); and the roofline terms at the H100's figures. Tracing needs
no card. ``--run`` then runs each cell that fits on the card (``--device``,
default cuda): random weights from seed 0, the step timed with CUDA events
(median of 5), the peak allocated memory and the fraction of the roofline
bound; a cell that does not fit records why.

``--mesh`` / ``--multi-pod`` / ``--both-meshes`` exit non-zero: sharding over a
mesh is the next slice (ROADMAP A5b). Results accumulate in ``--results``
(default ``build/dryrun.json``, git-ignored) keyed by arch|shape|device|
overrides, so reruns are incremental; ``--force`` recomputes.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, cell_applicable, get_config
from repro_torch.launch import analysis
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt
from repro_torch.training import steps as steps_mod

RESULTS_PATH = str(Path(__file__).resolve().parents[3] / "build" / "dryrun.json")
DEVICE_KEY = "1xH100"
# the calibrated FLOPs against the full-depth count: equal up to float sums
CALIBRATION_RTOL = 1e-9
RUN_REPS = 5   # timed steps of --run


def _parse_overrides(pairs) -> dict:
    out = {}
    for pair in pairs or ():
        k, v = pair.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k] = v
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE); D = tokens processed.
    For decode steps D = global_batch (one token each); for train, the 3x
    factor for bwd is included by the 6 (2 fwd + 4 bwd); prefill/decode use
    2·N·D (forward only)."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _config(arch: str, overrides: Optional[dict]):
    """(config with ``overrides``, the optimizer's "opt_"-prefixed ones)."""
    cfg = get_config(arch)
    overrides = dict(overrides or {})
    opt_kwargs = {k[4:]: overrides.pop(k) for k in list(overrides) if k.startswith("opt_")}
    return (cfg.with_(**overrides) if overrides else cfg), opt_kwargs


def build_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
               device="meta", kernel_impl: str = "ref"):
    """(cfg, shape, model, BuiltStep) of a cell: by default a meta model whose
    kernels take their plain versions, and the step's meta stand-ins."""
    cfg, opt_kwargs = _config(arch, overrides)
    shape = SHAPES[shape_name]
    model = Model(cfg, device=device, kernel_impl=kernel_impl)
    if shape.kind == "train":
        model.requires_grad_(True)
        built = steps_mod.build_train_step(model, opt.OptimizerConfig(**opt_kwargs), None, shape)
    elif shape.kind == "prefill":
        built = steps_mod.build_prefill_step(model, None, shape)
    else:
        built = steps_mod.build_decode_step(model, None, shape)
    return cfg, shape, model, built


def _calibration_depths(cfg) -> tuple:
    """(L1, L2, units): shallow traces at depths L1 < L2; the per-unit cost
    is (cost(L2)-cost(L1)) / (units(L2)-units(L1)) and
    total = base(L1) + (units-1) * delta, exact for layer-homogeneous stacks
    (every assigned arch). The reference needs them because XLA counts a
    scan body once; the port's loop is unrolled, so they check the full
    count."""
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return k, 2 * k, cfg.n_layers // k
    return 1, 2, cfg.n_layers


def _flops(arch, shape_name, overrides) -> dict:
    return analysis.trace_costs(build_cell(arch, shape_name, overrides)[3])


def _random_args(model: Model, shape: ShapeSpec, ocfg, gen: torch.Generator) -> tuple:
    """The step's arguments on the model's device: seeded random tokens (and
    frames or patches), the decode cache zeroed, pos = seq_len - 1."""
    cfg, dev = model.cfg, model.device
    batch = {}
    for k, v in steps_mod.batch_avals(cfg, shape, device=dev).items():
        if v.dtype == torch.int32:
            batch[k] = torch.randint(0, cfg.vocab, v.shape, generator=gen, device=dev,
                                     dtype=torch.int32)
        else:
            batch[k] = torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
    params = model.params
    if shape.kind == "train":
        return params, opt.init_state(params, ocfg), batch
    if shape.kind == "prefill":
        return params, batch
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    return params, batch["token"], cache, torch.tensor(shape.seq_len - 1, device=dev)


def measure_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
                 device="cuda") -> dict:
    """Run one step of the cell on the card: random weights from seed 0, a
    warm-up step, then RUN_REPS steps timed with CUDA events. Returns the
    median and each time in ms and the peak allocated bytes."""
    _, opt_kwargs = _config(arch, overrides)
    _, shape, model, built = build_cell(arch, shape_name, overrides, device=device,
                                        kernel_impl="auto")
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        model.init(gen)
    args = _random_args(model, shape, opt.OptimizerConfig(**opt_kwargs), gen)
    built.fn(*args)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(RUN_REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        built.fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    del model, built, args
    torch.cuda.empty_cache()
    return {"batch": shape.global_batch, "device_ms": float(np.median(times)),
            "device_ms_each": times, "peak_allocated_bytes": int(peak),
            "device": torch.cuda.get_device_name(0)}


def run_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
             verbose: bool = True, run: bool = False, device="cuda",
             full_depth: bool = True) -> dict:
    """One cell's record. ``full_depth`` False counts the FLOPs from the two
    calibration traces alone (the reference's way, seconds instead of a
    minute for every cell); otherwise the full-depth count is the record's and
    the calibrated one must equal it."""
    cfg, opt_kwargs = _config(arch, overrides)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": reason}
    record: dict = {"arch": arch, "shape": shape_name, "device": DEVICE_KEY,
                    "overrides": overrides or {}, "status": "ok"}
    try:
        t0 = time.monotonic()
        full = _flops(arch, shape_name, overrides) if full_depth else None
        L1, L2, units = _calibration_depths(cfg)
        cal = [_flops(arch, shape_name, dict(overrides or {}, n_layers=depth, microbatches=1))
               for depth in (L1, L2)]
        total = analysis.extrapolate(cal[0], cal[1], units)
        total["matches_full_depth"] = full is None or bool(np.isclose(
            total["flops_per_device"], full["flops_per_device"], rtol=CALIBRATION_RTOL))
        if full is None:
            full = {"flops_per_device": total["flops_per_device"],
                    "source": f"calibrated at L={L1},{L2}"}
        a = record["analysis"] = {"cost": full, "calibrated": total}
        if not total["matches_full_depth"]:
            raise AssertionError(
                f"calibrated FLOPs {total['flops_per_device']:.6e} (L={L1},{L2} -> "
                f"{units} units) differ from the full-depth count "
                f"{full['flops_per_device']:.6e}")
        record["trace_s"] = round(time.monotonic() - t0, 2)
        mflops = model_flops(cfg, shape)
        mm = a["modeled_memory"] = analysis.modeled_hbm_bytes(cfg, shape)
        a["roofline"] = analysis.roofline_terms(full["flops_per_device"], mm["total"],
                                                model_flops_total=mflops)
        ocfg = opt.OptimizerConfig(**opt_kwargs)
        fit = a["fit"] = analysis.memory_fit(cfg, shape, ocfg=ocfg)
        fit["max_batch"] = analysis.max_batch(cfg, shape, ocfg=ocfg)
        if run:
            if not fit["fits"]:
                record["run"] = {"status": "not run", "reason": (
                    f"the modeled peak {fit['total'] / 1e9:.1f} GB exceeds "
                    f"{analysis.FIT_SHARE:.0%} of the card's {fit['capacity'] / 1e9:.1f} GB "
                    f"(largest batch that fits: {fit['max_batch']})")}
            else:
                meas = measure_cell(arch, shape_name, overrides, device=device)
                bound_ms = a["roofline"]["step_time_lower_bound_s"] * 1e3
                meas["bound_ms"] = bound_ms
                meas["roofline_fraction"] = bound_ms / meas["device_ms"]
                meas["modeled_peak_bytes"] = fit["total"]
                record["run"] = dict(meas, status="ok")
        if verbose:
            r = a["roofline"]
            line = (f"[{arch} x {shape_name} x {DEVICE_KEY}] flops={full['flops_per_device']:.4e} "
                    f"bytes={mm['total']:.4e} fits={fit['fits']} "
                    f"({fit['total'] / 1e9:.1f} of {fit['usable'] / 1e9:.1f} GB, max batch "
                    f"{fit['max_batch']}) compute={r['compute_s']:.4g}s "
                    f"memory={r['memory_s']:.4g}s -> {r['bottleneck']} "
                    f"[trace {record['trace_s']}s]")
            if "run" in record:
                run_r = record["run"]
                line += (f" run: {run_r['device_ms']:.3f} ms, {run_r['roofline_fraction']:.3f} "
                         "of the bound" if run_r["status"] == "ok" else f" {run_r['reason']}")
            print(line, flush=True)
    except Exception as e:  # noqa: BLE001
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=10)
        if verbose:
            print(f"[{arch} x {shape_name}] FAILED: {record['error']}", flush=True)
    return record


def _key(arch, shape, overrides, run: bool = False) -> str:
    ov = ",".join(f"{k}={v}" for k, v in sorted((overrides or {}).items()))
    return f"{arch}|{shape}|{DEVICE_KEY}{'|run' if run else ''}|{ov}"


def load_results(path: str = RESULTS_PATH) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(results: dict, path: str = RESULTS_PATH) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="every cell")
    ap.add_argument("--multi-pod", action="store_true", help="not ported (ROADMAP A5b)")
    ap.add_argument("--both-meshes", action="store_true", help="not ported (ROADMAP A5b)")
    ap.add_argument("--mesh", help="not ported (ROADMAP A5b)")
    ap.add_argument("--override", action="append", help="cfg field=value")
    ap.add_argument("--run", action="store_true", help="run each cell that fits on the card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results", default=RESULTS_PATH)
    args = ap.parse_args()

    if args.mesh or args.multi_pod or args.both_meshes:
        ap.exit(2, "dryrun: a mesh is not ported yet: sharding over a DeviceMesh is the "
                   "next slice (ROADMAP A5b); this dry run covers one H100\n")
    if args.run and torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.exit(2, "dryrun: --run needs a CUDA card (the analysis alone runs without one)\n")
    overrides = _parse_overrides(args.override)
    results = load_results(args.results)

    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        key = _key(arch, shape, overrides, args.run)
        if key in results and not args.force and results[key].get("status") != "error":
            print(f"[cached] {key}", flush=True)
            continue
        rec = run_cell(arch, shape, overrides=overrides, run=args.run, device=args.device)
        results[key] = rec
        save_results(results, args.results)
        if rec["status"] == "error":
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
