#!/usr/bin/env python3
"""Where the time of the port's serve path goes on the card (torch.profiler).

    python tools/profile_torch_serve.py [--arch minicpm3-4b] [--eager] [--steps 20] \
        [--trace out.json]

Builds a full-width bf16 model (``--arch``: qwen2-0.5b by default,
mamba2-2.7b, zamba2-2.7b, qwen2-moe-a2.7b, minicpm3-4b, whisper-small or
internvl2-26b; random weights, seed 0) and a ServeEngine
(max_batch 8, max_len 1024; its decode step a CUDA graph replay, or eager with
``--eager``), fills its 8 slots with prompts of 64..512 tokens, then profiles
two windows through the engine's own entry points: one admission (a prefill of
one 512-token prompt plus its cache insertion, eager either way) and
``--steps`` batched decode steps. whisper-small runs at its published text
context instead: max_len 448, prompts of 4..64 tokens, a 64-token admission,
each request with its own random frames (1500 x 768), so an admission runs
the encoder too. internvl2-26b's requests each carry their own random patches
(256 x 6144), so its admission prefills 256 patches + 512 tokens. For each
window it prints the host wall time, the device busy time (the device
activities' own time, summed), the device's idle share, the sum of the gaps
between consecutive device activities (the idle time inside their span), and
the twelve kernels with the most device time, each with its rank, plus every
kernel of the port wherever it ranks;
then the device memory allocated after the model's init (the weights), after
the engine's construction (its cache and the captured step's pool), and the
peak of each window.
For the MoE it also times the decode step's expert products alone (CUDA
events, L2 flushed): every layer's three batched products over its 60
experts at the step's capacity, as the step runs them, against the least
time the card needs to read those weights. For MLA (minicpm3-4b) it times
the decode step's absorbed attention alone: every layer's
``mla_decode_attention`` over the engine's latent caches at its slots'
positions, against the least time to read the caches once, beside the path
the kernel replaced (each layer's ``cat`` of the two caches into one K, then
``decode_attention``). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.engine import SIDE_INPUTS, ServeEngine  # noqa: E402


HBM_BYTES_S = 3.35e12   # H100 SXM, NVIDIA data sheet


def _gaps_us(spans) -> float:
    """The time inside the span of (start, end) device activities that none
    of them covers, in microseconds."""
    gaps, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is not None and start > reach:
            gaps += start - reach
        reach = end if reach is None else max(reach, end)
    return gaps


def _gib(n: int) -> str:
    return f"{n / 2**30:.3f} GiB"


def _window(name: str, fn, n: int, trace: str = "") -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)
    by_kernel = defaultdict(lambda: [0, 0.0])
    spans = []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_kernel[evt.name][0] += 1
            by_kernel[evt.name][1] += evt.time_range.elapsed_us() / 1e3
            spans.append((evt.time_range.start, evt.time_range.end))
    if not by_kernel:
        raise SystemExit("the profiler recorded no device events: time with CUDA events instead")
    busy = sum(ms for _, ms in by_kernel.values())
    launches = sum(c for c, _ in by_kernel.values())
    print(f"[{name}] {n} call(s): host wall {wall_ms / n:.3f} ms each, device busy "
          f"{busy / n:.3f} ms each, idle share {1 - busy / wall_ms:.3f}, gaps between "
          f"device activities {_gaps_us(spans) / 1e3 / n:.3f} ms each, "
          f"{launches / n:.0f} device launches each; max_memory_allocated "
          f"{_gib(torch.cuda.max_memory_allocated())}")
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    for rank, (kname, (count, ms)) in enumerate(ranked):
        if rank < 12 or "repro_torch" in kname:   # the top 12, and every kernel of the port
            print(f"[{name}] {rank + 1:3d} {ms / n:9.4f} ms {count / n:6.1f}x  {kname[:110]}")


def _expert_products(model: Model, n_tokens: int, reps: int = 20) -> None:
    """Median device time of the expert products of one decode step over
    `n_tokens` tokens (per layer: xe @ wi, xe @ wg, h @ wo over (E, C) rows,
    C the step's capacity), CUDA events around the whole chain after a 256 MB
    write that flushes the L2; and the least time to read their weights."""
    cfg, m = model.cfg, model.cfg.moe
    C = moe._capacity(n_tokens, m)
    gen = torch.Generator(device="cuda").manual_seed(1)
    xe = torch.randn((m.n_experts, C, cfg.d_model), generator=gen, device="cuda").bfloat16()
    h = torch.randn((m.n_experts, C, m.d_ff_expert), generator=gen, device="cuda").bfloat16()
    experts = [lp["ffn"] for lp in model._layer_params]

    def chain():
        for p in experts:
            torch.bmm(xe, p["wi"])
            torch.bmm(xe, p["wg"])
            torch.bmm(h, p["wo"])

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    chain()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(20_000_000)               # the host enqueues the chain meanwhile
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    weight_bytes = sum(p[k].numel() * p[k].element_size()
                       for p in experts for k in ("wi", "wg", "wo"))
    print(f"[experts] a decode step's expert products ({len(experts)} layers x 3 batched products "
          f"over {m.n_experts} experts x C = {C} rows): {np.median(times):.4f} ms (median of "
          f"{reps}, L2 flushed); their weights {weight_bytes / 1e9:.3f} GB, read once in "
          f"{weight_bytes / HBM_BYTES_S * 1e3:.4f} ms at 3.35 TB/s")


def _mla_attention(engine: ServeEngine, reps: int = 20) -> None:
    """Median device time of a decode step's absorbed attention alone (CUDA
    events, L2 flushed): every layer's ``mla_decode_attention`` over the
    engine's latent caches at its slots' current positions, with a random
    query; then the path it replaced, each layer's ``cat`` of the caches and
    ``decode_attention``, on the same tensors."""
    from repro_torch.kernels.flash_attention import kernel as attn_kernel

    cfg = engine.model.cfg
    m = cfg.mla
    ckv, krope = engine.cache["ckv"], engine.cache["krope"]    # (L, B, S, ·)
    L, B, S, dl = ckv.shape
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    pos = engine._positions
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((B, 1, cfg.n_heads, dl + krope.shape[-1]), generator=gen,
                    device="cuda").to(ckv.dtype)

    def kernel():
        for i in range(L):
            attn_kernel.mla_decode_attention(q, ckv[i], krope[i], pos, scale=scale)

    def replaced():
        for i in range(L):
            k = torch.cat([ckv[i], krope[i]], dim=-1)[:, :, None, :]
            attn_kernel.decode_attention(q, k, ckv[i][:, :, None, :], pos, scale=scale)

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    ms = {}
    for name, chain in (("kernel", kernel), ("replaced", replaced)):
        chain()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(20_000_000)           # the host enqueues the chain meanwhile
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms[name] = float(np.median(times))
    lens = (pos.clamp(min=-1) + 1).clamp(max=S)
    read = int(lens.sum()) * (dl + krope.shape[-1]) * ckv.element_size() * L
    print(f"[mla] a decode step's absorbed attention ({L} layers, {B} slots at lengths "
          f"{lens.tolist()}): mla_decode_attention {ms['kernel']:.4f} ms (median of {reps}, "
          f"L2 flushed); the caches read once {read / 1e6:.1f} MB, "
          f"{read / HBM_BYTES_S * 1e3:.4f} ms at 3.35 TB/s; the path it replaced (cat + "
          f"decode_attention) {ms['replaced']:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=["qwen2-0.5b", "mamba2-2.7b", "zamba2-2.7b",
                                       "qwen2-moe-a2.7b", "minicpm3-4b", "whisper-small",
                                       "internvl2-26b"],
                    default="qwen2-0.5b")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager decode step (ServeEngine(cuda_graph=False))")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default="", help="write the decode window's chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    cfg = get_config(args.arch)
    model = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    weights = torch.cuda.memory_allocated()
    rng = np.random.default_rng(0)
    encdec = cfg.family == "encdec"
    max_len, lo, hi = (448, 4, 64) if encdec else (1024, 64, 512)
    side = SIDE_INPUTS.get(cfg.family)     # whisper's frames, internvl2's patches

    def side_input() -> dict:
        if side is None:
            return {}
        name, rows = side
        return {name: rng.standard_normal((getattr(cfg, rows), cfg.d_model)).astype(np.float32)}

    engine = ServeEngine(model, max_batch=8, max_len=max_len, cuda_graph=not args.eager)
    print(f"[memory] allocated after init {_gib(weights)} (the weights), after the engine "
          f"{_gib(torch.cuda.memory_allocated())} (its cache: "
          f"{_gib(kv_cache.cache_bytes(cfg, 8, max_len))} by cache_bytes)")
    for n in rng.integers(lo, hi + 1, 8):
        engine.submit(rng.integers(0, cfg.vocab, int(n)), max_new_tokens=10_000, **side_input())
    engine._admit()                       # fills the 8 slots (also warms cuBLAS)
    for _ in range(3):
        engine._step()

    admitted = side_input()               # drawn outside the profiled window

    def admit_one():
        engine.slot_req[0] = None         # free slot 0 for one prompt of `hi` tokens
        engine.submit(rng.integers(0, cfg.vocab, hi), max_new_tokens=10_000, **admitted)
        engine._admit()

    admit_one()
    _window("prefill", admit_one, 3)
    _window("decode, eager" if args.eager else "decode, graphed", engine._step, args.steps,
            args.trace)
    if cfg.family == "moe":
        _expert_products(model, engine.max_batch)
    if cfg.mla is not None:
        _mla_attention(engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
