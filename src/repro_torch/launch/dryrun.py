"""Dry run: FLOPs, memory fit and roofline of every (arch x shape [x mesh]) cell.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
    python -m repro_torch.launch.dryrun --all                   # every cell, no card needed
    python -m repro_torch.launch.dryrun --arch X --shape Y --override remat_policy=dots
    python -m repro_torch.launch.dryrun --arch mamba2-2.7b --shape long_500k --run
    python -m repro_torch.launch.dryrun --arch X --shape Y --mesh 16,16   # (data, model)
    python -m repro_torch.launch.dryrun --all --multi-pod       # the 2x16x16 mesh
    python -m repro_torch.launch.dryrun --all --both-meshes     # 16x16, then 2x16x16
    python -m repro_torch.launch.dryrun --arch X --shape Y --mesh 16,16 --calibrated --by-op

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

A mesh cell (``--mesh "2,4"`` names the trailing axes of ("pod", "data",
"model"); ``--multi-pod`` the (2, 16, 16) production mesh, the (16, 16) one
otherwise; ``--both-meshes`` both) runs in a subprocess of its own under
PyTorch's fake process group of that many ranks (``mesh.fake_world``), the
counterpart of the reference's forced host devices: the model is built on
the meta device and distributed onto the mesh, and the step is traced on
meta DTensors. It records the resolved shardings of the weights, the
per-device FLOPs (each rank's local ops) at full depth and at the
calibration depths, the per-device modeled HBM traffic and memory fit, the
collectives the step issues with their wire bytes, and the roofline with its
collective term. ``--calibrated`` skips the full-depth trace. ``--by-op``
also prints one layer's FLOPs a device (the two calibration depths'
difference) by aten op and its largest products by local operand shapes:
a product a rank computes whole shows its full width there.

Results accumulate in ``--results`` (default ``build/dryrun.json``,
git-ignored) keyed by arch|shape|device (or mesh)|overrides, so reruns are
incremental; ``--force`` recomputes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, cell_applicable, get_config
from repro_torch.launch import analysis
from repro_torch.launch.mesh import describe, fake_world, make_mesh
from repro_torch.models.model import Model
from repro_torch.sharding import partition
from repro_torch.training import optimizer as opt
from repro_torch.training import steps as steps_mod

RESULTS_PATH = str(Path(__file__).resolve().parents[3] / "build" / "dryrun.json")
DEVICE_KEY = "1xH100"
# the calibrated FLOPs against the full-depth count: equal up to float sums
CALIBRATION_RTOL = 1e-9
RUN_REPS = 5   # timed steps of --run
BY_OP_PRODUCTS = 12   # products --by-op lists by their local operand shapes


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
               device="meta", kernel_impl: str = "ref", mesh=None):
    """(cfg, shape, model, BuiltStep) of a cell: by default a meta model whose
    kernels take their plain versions, and the step's meta stand-ins (on
    ``mesh``: the model distributed there, meta DTensors)."""
    cfg, opt_kwargs = _config(arch, overrides)
    shape = SHAPES[shape_name]
    model = Model(cfg, device=device, kernel_impl=kernel_impl)
    if shape.kind == "train":
        model.requires_grad_(True)
        built = steps_mod.build_train_step(model, opt.OptimizerConfig(**opt_kwargs), mesh, shape)
    elif shape.kind == "prefill":
        built = steps_mod.build_prefill_step(model, mesh, shape)
    else:
        built = steps_mod.build_decode_step(model, mesh, shape)
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


MESH_AXES = ("pod", "data", "model")


def mesh_of(mesh_spec: Optional[str] = None, multi_pod: bool = False
            ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(dims, axis names) of ``--mesh "2,4"`` (the trailing axes of
    ("pod", "data", "model")) or of the production mesh."""
    if mesh_spec:
        dims = tuple(int(x) for x in mesh_spec.split(","))
        return dims, MESH_AXES[-len(dims):]
    if multi_pod:
        return (2, 16, 16), MESH_AXES
    return (16, 16), MESH_AXES[1:]


def _mesh_flops(arch, shape_name, overrides, mesh) -> dict:
    return analysis.trace_device(build_cell(arch, shape_name, overrides, mesh=mesh)[3])


def _weight_specs(model: Model, mesh) -> dict:
    """{weight key: its resolved PartitionSpec} of a distributed model."""
    sh = partition.named_shardings(model.specs(), model.abstract_params(), mesh,
                                   partition.rules_for(model.cfg))
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = [list(a) if isinstance(a, tuple) else a for a in t.spec]

    walk(sh, "")
    return out


def _print_by_op(total: dict) -> None:
    """One layer's FLOPs a device by aten op, then its largest products by
    their local operand shapes."""
    for op, n in sorted(total["flops_by_op_per_layer"].items()):
        print(f"  {op:16s} {n:.4e} a layer", flush=True)
    shapes = sorted(total["flops_by_shape_per_layer"].items(), key=lambda kv: -kv[1])
    for key, n in shapes[:BY_OP_PRODUCTS]:
        print(f"  {n:.4e}  {key}", flush=True)


def run_mesh_cell(arch: str, shape_name: str, dims: Sequence[int], names: Sequence[str],
                  overrides: Optional[dict] = None, verbose: bool = True,
                  full_depth: bool = True, by_op: bool = False) -> dict:
    """One mesh cell's record, in this process, under a fake world that holds
    the mesh (``fake_world``); ``by_op`` prints one layer's breakdown."""
    cfg, opt_kwargs = _config(arch, overrides)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": reason}
    mesh = make_mesh(tuple(dims), tuple(names), "cpu")
    n_chips = int(np.prod(dims))
    axes = dict(zip(names, dims))
    record: dict = {"arch": arch, "shape": shape_name, "mesh": describe(mesh),
                    "overrides": overrides or {}, "status": "ok"}
    try:
        t0 = time.monotonic()
        _, _, model, built = build_cell(arch, shape_name, overrides, mesh=mesh)
        record["shardings"] = _weight_specs(model, mesh)
        full = analysis.trace_device(built) if full_depth else None
        del model, built
        L1, L2, units = _calibration_depths(cfg)
        cal = [_mesh_flops(arch, shape_name, dict(overrides or {}, n_layers=depth,
                                                 microbatches=1), mesh)
               for depth in (L1, L2)]
        total = analysis.extrapolate(cal[0], cal[1], units)
        total["collectives_base"] = cal[0]["collectives"]
        total["collectives_delta"] = cal[1]["collectives"]
        if full is None:
            full = {k: total[k] for k in ("flops_per_device", "wire_bytes_per_device",
                                           "pod_wire_bytes_per_device")}
            full["source"] = f"calibrated at L={L1},{L2}"
        else:
            total["matches_full_depth"] = bool(np.isclose(
                total["flops_per_device"], full["flops_per_device"], rtol=CALIBRATION_RTOL))
        record["trace_s"] = round(time.monotonic() - t0, 2)
        a = record["analysis"] = {"cost": full, "calibrated": total}
        mflops = model_flops(cfg, shape)
        mm = a["modeled_memory"] = analysis.modeled_hbm_bytes(
            cfg, shape, n_chips, model_axis=axes.get("model", 1))
        a["fit"] = analysis.memory_fit_mesh(cfg, shape, record["shardings"], axes,
                                            opt.OptimizerConfig(**opt_kwargs))
        a["roofline"] = analysis.roofline_terms(
            full["flops_per_device"], mm["total"], model_flops_total=mflops,
            wire_bytes=full["wire_bytes_per_device"],
            pod_wire_bytes=full["pod_wire_bytes_per_device"], n_chips=n_chips)
        if verbose:
            r, fit = a["roofline"], a["fit"]
            print(f"[{arch} x {shape_name} x {'x'.join(map(str, dims))}] "
                  f"flops/device={full['flops_per_device']:.4e} "
                  f"wire/device={full['wire_bytes_per_device']:.4e} "
                  f"fits={fit['fits']} ({fit['total'] / 1e9:.1f} of {fit['usable'] / 1e9:.1f} GB) "
                  f"compute={r['compute_s']:.4g}s memory={r['memory_s']:.4g}s "
                  f"collective={r['collective_s']:.4g}s -> {r['bottleneck']} "
                  f"[trace {record['trace_s']}s]", flush=True)
            if by_op:
                _print_by_op(total)
    except Exception as e:  # noqa: BLE001
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=10)
        if verbose:
            print(f"[{arch} x {shape_name}] FAILED: {record['error']}", flush=True)
    return record


def run_mesh_cell_subprocess(arch: str, shape_name: str, dims: Sequence[int],
                             overrides: Optional[dict] = None, full_depth: bool = True,
                             timeout: float = 3600, by_op: bool = False) -> dict:
    """``run_mesh_cell`` in a subprocess of its own (a fake world per process),
    its progress line passed through, its record read back as JSON."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--child", "--arch", arch,
           "--shape", shape_name, "--mesh", ",".join(map(str, dims))]
    for k, v in (overrides or {}).items():
        cmd += ["--override", f"{k}={v}"]
    if not full_depth:
        cmd.append("--calibrated")
    if by_op:
        cmd.append("--by-op")
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        return {"arch": arch, "shape": shape_name, "status": "error",
                "error": f"the mesh cell's process exited {out.returncode}",
                "stderr": out.stderr[-4000:]}


def _key(arch, shape, overrides, run: bool = False, mesh: Optional[Sequence[int]] = None) -> str:
    ov = ",".join(f"{k}={v}" for k, v in sorted((overrides or {}).items()))
    where = f"mesh={'x'.join(map(str, mesh))}" if mesh else DEVICE_KEY
    return f"{arch}|{shape}|{where}{'|run' if run else ''}|{ov}"


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
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) pod x data x model mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the (16, 16) mesh, then the (2, 16, 16) one")
    ap.add_argument("--mesh", help='explicit mesh dims, e.g. "2,4" (data, model)')
    ap.add_argument("--calibrated", action="store_true",
                    help="mesh cells: FLOPs from the calibration depths alone")
    ap.add_argument("--by-op", action="store_true",
                    help="mesh cells: print one layer's FLOPs by op and by product shape")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--override", action="append", help="cfg field=value")
    ap.add_argument("--run", action="store_true", help="run each cell that fits on the card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results", default=RESULTS_PATH)
    args = ap.parse_args()

    meshes = []
    if args.mesh or args.multi_pod or args.both_meshes:
        if args.run:
            ap.error("--run times cells on one card; a mesh cell is traced only")
        pods = [False, True] if args.both_meshes else [args.multi_pod]
        meshes = [mesh_of(None if args.both_meshes else args.mesh, pod) for pod in pods]
    if args.child:
        (dims, names), = meshes
        with fake_world(int(np.prod(dims))):
            rec = run_mesh_cell(args.arch, args.shape, dims, names,
                                _parse_overrides(args.override), full_depth=not args.calibrated,
                                by_op=args.by_op)
        print(json.dumps(rec), flush=True)
        return 1 if rec["status"] == "error" else 0
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
    for (arch, shape), (dims, _) in ((c, m) for m in meshes or [((), ())] for c in cells):
        key = _key(arch, shape, overrides, args.run, dims)
        if key in results and not args.force and results[key].get("status") != "error":
            print(f"[cached] {key}", flush=True)
            continue
        if dims:
            rec = run_mesh_cell_subprocess(arch, shape, dims, overrides,
                                           full_depth=not args.calibrated, by_op=args.by_op)
        else:
            rec = run_cell(arch, shape, overrides=overrides, run=args.run, device=args.device)
        results[key] = rec
        save_results(results, args.results)
        if rec["status"] == "error":
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
