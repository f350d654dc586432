#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA card and ``nvcc``. Phases, in
order, each printing its lines; any failure raises and the exit code is not 0:

1. device          - require CUDA and compute capability 9.0; print the card's
                     name and power limit (nvidia-smi); fp32 products in full fp32.
2. build            - compile the four kernels from ``src/repro_torch`` with nvcc
                     for sm_90a, one nvcc per source, all started together.
3. kernels          - hold each attention kernel against its plain PyTorch version
                     (ref.py) at 2e-5 (f32) / 2e-2 (bf16) on the reference's test
                     shapes, prefill at hd 80, 128 and 24 (the bf16 wgmma kernel's
                     two-slab and zero-padded head dims), decode at lengths around
                     the split-KV boundary, and the slices' own shapes (qwen2-0.5b
                     GQA hd 64, zamba2-2.7b MHA hd 80); time kernel, plain version
                     and ``F.scaled_dot_product_attention`` (a yardstick only) there.
4. kernels-rmsnorm  - hold the fused add + RMSNorm kernel against its plain
                     version at 1e-6 (f32) / 1e-2 (bf16) on the reference's sweep
                     and the slices' rows (d_model 896 and 2560, 512-token prefill
                     and 8-slot decode); time kernel and plain version there
                     (no single PyTorch call computes add + norm: no library
                     time; the two-call
                     chain ``x + d`` then ``F.rms_norm`` is printed beside it,
                     labelled as two calls); time the launch floor (an empty
                     kernel of the same library, after a write and after a
                     read-only flush) and the norm's marginal time in a chain of
                     24 (attention output product, add + norm) pairs at both
                     decode rows. The launcher's one rule: a block a row, each
                     thread holding ceil(D / 4096) 8-wide chunks, just enough
                     threads in whole warps (128 of one chunk at D = 896, 320
                     at 2560).
5. kernels-ssd      - hold the SSD scan against its plain version at 1e-4 (f32) /
                     5e-2 (bf16) on the reference's shapes, a ragged chunk, a
                     dt = 0 padded tail, a nonzero initial state and, at the full
                     80 heads, three chunks, chunks of 1 and 2, a batch of 2 from
                     an initial state, one chunk against two and three (the bf16
                     branches), and the slices' shapes (mamba2 N = 128, zamba2
                     N = 64); time kernel and plain version there (no single
                     PyTorch call computes the scan, so there is no library time),
                     and each bf16 pass's device time (torch.profiler).
6. slice            - full-width qwen2-0.5b, random weights from seed 0: prefill
                     4 x 384 tokens then 16 teacher-forced decode steps with vector
                     positions, kernel path against the plain path on the same
                     weights.
7. serve            - ServeEngine on full-width bf16 qwen2-0.5b answers 16
                     requests, its decode step one CUDA graph replay (the main
                     path); the launch counters must show both attention
                     kernels and the fused add + RMSNorm on the path. One
                     replay under torch.profiler must launch on the device what
                     the capture counted (decode_attention two kernels a call,
                     fused_add_rmsnorm one). Then an eager engine
                     (cuda_graph=False) answers the same 16: the two token
                     streams must be equal, or part only at a near-tie within
                     the slice's bf16 tolerance. Each engine's throughput,
                     TTFT, step time and peak memory are printed, and the
                     graph's build time and node count.
8. slice-ssm        - the same for full-width mamba2-2.7b (prefills pad 384 to 512).
9. serve-ssm        - the same for full-width bf16 mamba2-2.7b; the counters
                     must show the SSD kernel in every layer's prefill and none
                     of the other three (its step runs no kernel of the repo).
10. slice-hybrid    - the same for full-width zamba2-2.7b (54 Mamba2 layers in 9
                     groups of 6, one shared attention + MLP block before each).
11. serve-hybrid    - the same for full-width bf16 zamba2-2.7b; the counters
                     must show all four kernels: the shared block's attention
                     and add + norm 9 times per prefill and per step, the SSD
                     scan 54 times per prefill.

Each serve phase resets the launch counters just before it submits its
requests and reads them just after, for each engine; a replay adds the calls
its capture counted. The summary's ``launches`` of a kernel is its sum over
the three graphed runs.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCH = "qwen2-0.5b"
DEVICE = "cuda"
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels_flash.py:18
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, tensor-core bf16 and
# plain fp32 flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/flash_attention/csrc/decode_attention.cu",
    "fused_add_rmsnorm": "src/repro_torch/kernels/rmsnorm/csrc/fused_add_rmsnorm.cu",
    "ssd": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:107",
    "decode_attention": "src/repro/kernels/flash_attention/kernel.py:173",
    "fused_add_rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:30",
    "ssd": "src/repro/kernels/ssd/kernel.py:93",
}
KERNEL_MODULES = (attn_kernel, rms_kernel, ssd_kernel)
# slice shapes: prefill of one 512-token prompt; decode over B=8 slots of a
# 1024-long cache (qwen2-0.5b: H=14 query heads over KV=2, hd=64)
PREFILL_SHAPE = (1, 512, 14, 2, 64)          # B, S, H, KV, hd
DECODE_SHAPE = (8, 1024, 14, 2, 64)          # B, S, H, KV, hd
# zamba2-2.7b's shared block: MHA, 32 heads over 32 KV heads (G = 1), hd 80
# (a multiple of 8, not of 16), at the same prefill and decode sizes
HYBRID_PREFILL_SHAPE = (1, 512, 32, 32, 80)
HYBRID_DECODE_SHAPE = (8, 1024, 32, 32, 80)
# 2 prefill + teacher-forced decode in fp32: the kernel sums in another order
# than cuBLAS; 24 layers amplify ~1e-6 differences to ~1e-4 at most
SLICE_F32_TOL = 1e-3
# bf16: both paths round attention outputs to bf16, so a one-ulp difference
# (2^-8 relative) in one element propagates through 24 layers, and the logits
# themselves are bf16 products (one ulp is 2^-5 at |logit| 4..8), so the top
# logits of a random model often tie. Held: max|dlogit| within 8 such ulps,
# and wherever the greedy tokens differ, the plain path ranks the kernel
# path's token within that same margin of its own top logit (a near-tie).
SLICE_BF16_TOL = 0.25

SSM_ARCH = "mamba2-2.7b"
# bf16 slice of mamba2-2.7b, held as the qwen2 slice is: both paths round the
# scan's output y to bf16 once per layer, so a one-ulp difference in one element
# propagates through 64 layers (2.7x qwen2's 24), and the logits are bf16
# products (one ulp is 2^-5 at |logit| 4..8). Held: max|dlogit| within 16 such
# ulps, and every top-1 disagreement a near-tie within that same margin.
SLICE_SSM_BF16_TOL = 0.5
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # tests/test_kernels_ssd.py:10
# the slice's SSD call: one 512-token prefill (a 384-token prompt padded to two
# chunks of 256) of mamba2-2.7b: 80 heads of P=64 over one group of N=128
SSD_SHAPE = (1, 512, 80, 64, 1, 128, 256)    # B, S, H, P, G, N, chunk
# zamba2-2.7b's scan: the same heads over a state of N = 64
HYBRID_SSD_SHAPE = (1, 512, 80, 64, 1, 64, 256)
RMS_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}  # tests/test_kernels_rmsnorm.py:10
# the add + norm rows of the slices: a 512-token prefill and an 8-slot decode
# step, at qwen2-0.5b's and zamba2-2.7b's d_model; the first is the summary's row
RMS_SHAPES = ((1, 512, 2560), (8, 1, 2560), (1, 512, 896), (8, 1, 896))

HYBRID_ARCH = "zamba2-2.7b"
# bf16 slice of zamba2-2.7b, held as the mamba2 slice is: 54 Mamba2 layers each
# round the scan's output y to bf16 once and the shared block rounds attention
# outputs 9 times (63 rounding points against mamba2's 64), and the logits are
# bf16 products (one ulp is 2^-5 at |logit| 4..8). Held: max|dlogit| within 16
# such ulps, and every top-1 disagreement a near-tie within that same margin.
SLICE_HYBRID_BF16_TOL = 0.5


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ------------------------------------------------------------------ helpers
def cuda_ms(fn, reps: int = 30, warmup: int = 3, flush: str = "write",
            spin: int = 2_000_000) -> float:
    """Median device time of fn() in ms, CUDA events around each call, with the
    50 MB L2 flushed before each (the main path finds the cache cold): by
    writing 256 MB ("write", which leaves the L2 full of dirty lines) or by
    reading them ("read"). A spin of ``spin`` clock cycles on the device
    after the flush (2e6: about 1 ms at ~1.98 GHz) lets the host enqueue all
    of fn() before the start event fires, so the events time the device's
    work and not the host's wrapper code (which, for a kernel of a few
    microseconds, would otherwise dominate)."""
    buf = torch.empty(256 << 20, dtype=torch.int8, device=DEVICE)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush == "write":
            buf.zero_()
        else:
            buf.view(torch.int64).max()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(out: torch.Tensor, exp: torch.Tensor, tol: float, what: str) -> float:
    out, exp = out.float(), exp.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (out - exp).abs()
    bad = err > tol + tol * exp.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements beyond {tol} "
                             f"(max abs err {err.max().item():.3e})")
    return err.max().item()


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say("device", f"{name}, capability {cap}, torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels are built for sm_90a; this card is {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    sources = {name: src for mod in KERNEL_MODULES for name, src in mod.SOURCES.items()}
    info = _build.build(list(sources.values()))   # one nvcc per source, all at once
    for mod in KERNEL_MODULES:
        mod.build()                                # loads the libraries just built
    wall = time.perf_counter() - t0
    for name, src in sources.items():
        r = info[src]
        say("build", f"{name}: {r['seconds']:.1f} s -> {Path(r['path']).name}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say("build", f"  ptxas: {line.strip()}")
    say("build", f"{len(sources)} kernels built in {wall:.1f} s wall "
                 "(one nvcc per source, in parallel)")


def _prefill_case(gen, B, Sq, Skv, H, KV, hd, dtype, causal, **kw):
    q = randn(gen, (B, Sq, H, hd), dtype)
    k = randn(gen, (B, Skv, KV, hd), dtype)
    v = randn(gen, (B, Skv, KV, hd), dtype)
    out = attn_kernel.flash_attention(q, k, v, causal=causal, **kw)
    torch.cuda.synchronize()
    exp = attn_ref.mha_reference(q, k, v, causal=causal, **kw)
    what = f"flash {tuple(q.shape)} kv {Skv}x{KV} causal={causal} {kw} {dtype}"
    return max_err(out, exp, TOL[dtype], what), (q, k, v)


def _decode_case(gen, B, S, H, KV, hd, dtype, pos):
    q = randn(gen, (B, 1, H, hd), dtype)
    kc = randn(gen, (B, S, KV, hd), dtype)
    vc = randn(gen, (B, S, KV, hd), dtype)
    out = attn_kernel.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    exp = attn_ref.decode_attention_reference(q, kc, vc, pos)
    what = f"decode B={B} S={S} H={H} KV={KV} hd={hd} {dtype}"
    return max_err(out, exp, TOL[dtype], what), (q, kc, vc)


def phase_kernels() -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, H, KV, hd in [(1, 64, 64, 4, 4, 32), (2, 128, 128, 8, 2, 64),
                                      (1, 96, 96, 6, 1, 16), (1, 100, 132, 4, 2, 32),
                                      (2, 32, 256, 4, 4, 64)]:
            for causal in (True, False):
                if causal and Sq != Skv:
                    continue  # the reference's causal sweep uses square shapes
                _prefill_case(gen, B, Sq, Skv, H, KV, hd, dtype, causal)
                n += 1
        _prefill_case(gen, 1, 16, 64, 2, 2, 16, dtype, False, kv_len=20)
        _prefill_case(gen, 2, 16, 64, 2, 2, 16, dtype, True, q_offset=48)
        _prefill_case(gen, 2, 64, 64, 4, 2, 128, dtype, True,
                      kv_len=torch.tensor([17, 64], device=DEVICE))
        for KV in (1, 2, 4):
            for pos in (0, 47):
                _decode_case(gen, 2, 48, 4, KV, 16, dtype, pos)
        _decode_case(gen, 3, 32, 4, 2, 16, dtype,
                     torch.tensor([3, 17, 31], dtype=torch.int32, device=DEVICE))
        n += 3 + 7
        # hd in 64-column slabs: two at 80 and 128, one zero-padded at 24
        for hd in (80, 128, 24):
            for causal in (True, False):
                _prefill_case(gen, 2, 130, 130, 6, 3, hd, dtype, causal)
                n += 1
        # decode lengths around the split-KV boundary, and a full cache, in one batch
        split = attn_kernel.DECODE_SPLIT
        S = 3 * split + 44
        lens = torch.tensor([1, split - 1, split, split + 1, S], device=DEVICE)
        for H, KV in ((4, 4), (14, 2)):
            _decode_case(gen, len(lens), S, H, KV, 80, dtype, lens - 1)
            n += 1
    say("kernels", f"{n} reference-sweep cases within {TOL[torch.float32]:g} (f32) / "
                   f"{TOL[torch.bfloat16]:g} (bf16), among them prefill at hd 80, 128, 24 "
                   f"and decode lengths 1, {split - 1}, {split}, {split + 1}, {S} "
                   f"(split {split}) at G = 1 and 7")

    rng = np.random.default_rng(0)
    B, S = DECODE_SHAPE[:2]
    pos_np = rng.integers(64, S - 1, B).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, S - 1          # an empty-but-one row and a full row
    rows = _attn_slice_rows(gen, PREFILL_SHAPE, DECODE_SHAPE, pos_np, ARCH)
    _attn_slice_rows(gen, HYBRID_PREFILL_SHAPE, HYBRID_DECODE_SHAPE, pos_np, HYBRID_ARCH)
    return rows


def _attn_slice_rows(gen, prefill_shape, decode_shape, pos_np, arch) -> dict:
    """Both attention kernels at one slice's shapes, f32 and bf16 against the
    plain version; timed in bf16 (the serve dtype)."""
    rows = {}
    B, S, H, KV, hd = decode_shape
    pos = torch.from_numpy(pos_np).to(DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        Bp, Sp, Hp, KVp, hdp = prefill_shape
        err_p, (q, k, v) = _prefill_case(gen, Bp, Sp, Sp, Hp, KVp, hdp, dtype, True)
        err_d, (qd, kc, vc) = _decode_case(gen, B, S, H, KV, hd, dtype, pos)
        say("kernels", f"{arch} shapes {dtype}: prefill {prefill_shape} max_abs_err "
                       f"{err_p:.3e}, decode {decode_shape} (pos {pos_np.tolist()}) "
                       f"max_abs_err {err_d:.3e}")
    # timing in bf16 (q, k, v ... from the bf16 pass above)
    pairs = Sp * (Sp + 1) // 2                       # causal: keys each query row needs
    p_bytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()
    p_flops = 4 * Bp * pairs * Hp * hdp
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    rows["flash_attention"] = dict(
        max_abs_err=err_p,
        ms=cuda_ms(lambda: attn_kernel.flash_attention(q, k, v, causal=True)),
        plain_ms=cuda_ms(lambda: attn_ref.mha_reference(q, k, v, causal=True)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound=bound(p_bytes, p_flops, torch.bfloat16),
        work=f"{p_flops/1e9:.3f} GFLOP, {p_bytes/1e6:.3f} MB",
    )
    lens = pos_np.astype(np.int64) + 1
    d_bytes = (2 * int(lens.sum()) * KV * hd + 2 * B * H * hd) * qd.element_size() + 4 * B
    d_flops = 4 * int(lens.sum()) * H * hd
    qdt = qd.transpose(1, 2).contiguous()
    kct, vct = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=DEVICE)[None, :] < pos[:, None] + 1)[:, None, None, :]
    rows["decode_attention"] = dict(
        max_abs_err=err_d,
        ms=cuda_ms(lambda: attn_kernel.decode_attention(qd, kc, vc, pos)),
        plain_ms=cuda_ms(lambda: attn_ref.decode_attention_reference(qd, kc, vc, pos)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qdt, kct, vct, attn_mask=mask, enable_gqa=True)),
        bound=bound(d_bytes, d_flops, torch.bfloat16),
        work=f"{d_flops/1e9:.4f} GFLOP, {d_bytes/1e6:.3f} MB",
    )
    for name, r in rows.items():
        say("kernels", f"{arch} {name} bf16: kernel {r['ms']:.4f} ms, plain "
                       f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                       f"{r['bound'][0]:.5f} ms by {r['bound'][1]} ({r['work']})")
    split = attn_kernel.DECODE_SPLIT
    n_split, live = -(-S // split), int(np.sum(-(-lens // split)))
    say("kernels", f"{arch} occupancy: prefill (bf16) one warpgroup of 128 threads per "
                   f"(head, row, 64-row query tile) = {Hp} x {Bp} x {-(-Sp // 64)} = "
                   f"{-(-Sp // 64) * Hp * Bp} blocks; decode pass 1 one block of 128 threads "
                   f"per (split of {split}, KV head, row) = {n_split} x {KV} x {B} = "
                   f"{n_split * KV * B} blocks ({live * KV} live at these lengths), pass 2 "
                   f"one per (head, row) = {H * B}; on "
                   f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    return rows


def _rms_case(gen, shape, dtype, eps=1e-6):
    x, d = randn(gen, shape, dtype), randn(gen, shape, dtype)
    scale = torch.rand((shape[-1],), generator=gen, device=DEVICE) + 0.5
    res, out = rms_kernel.fused_add_rmsnorm(x, d, scale, eps)
    torch.cuda.synchronize()
    want_res, want_out = rms_ref.fused_add_rmsnorm_reference(x, d, scale, eps)
    what = f"fused_add_rmsnorm {shape} {dtype}"
    err = max(max_err(res, want_res, RMS_TOL[dtype], what + " res"),
              max_err(out, want_out, RMS_TOL[dtype], what + " out"))
    return err, (x, d, scale)


def phase_kernels_rmsnorm() -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(4, 32, 64), (2, 100, 128), (1, 8, 256), (7, 96)]:
            _rms_case(gen, shape, dtype)       # tests/test_kernels_rmsnorm.py:14
            n += 1
    say("kernels-rmsnorm", f"{n} reference-sweep cases within {RMS_TOL[torch.float32]:g} "
                           f"(f32) / {RMS_TOL[torch.bfloat16]:g} (bf16)")
    rows = {}
    for shape in RMS_SHAPES:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            errs[dtype], (x, d, scale) = _rms_case(gen, shape, dtype)
        # timing in bf16 (the serve dtype), the inputs of the bf16 case
        T, D = x.numel() // shape[-1], shape[-1]
        r_bytes = 4 * T * D * x.element_size() + D * 4     # x, d in; res, out out; scale
        r_flops = 5 * T * D                                 # add, square-sum, two products
        r = dict(
            max_abs_err=errs[torch.bfloat16],
            ms=cuda_ms(lambda: rms_kernel.fused_add_rmsnorm(x, d, scale, 1e-6)),
            plain_ms=cuda_ms(lambda: rms_ref.fused_add_rmsnorm_reference(x, d, scale, 1e-6)),
            library_ms=None,
            bound=bound(r_bytes, r_flops, torch.bfloat16),
            work=f"{r_flops/1e6:.3f} MFLOP, {r_bytes/1e6:.4f} MB",
        )
        two_calls = cuda_ms(lambda: F.rms_norm(x + d, (D,), scale.to(x.dtype), 1e-6))
        say("kernels-rmsnorm", f"{shape}: max_abs_err {errs[torch.float32]:.3e} (f32), "
                               f"{errs[torch.bfloat16]:.3e} (bf16); bf16 kernel {r['ms']:.4f} ms, "
                               f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
                               f"{r['bound'][1]} ({r['work']}); two PyTorch calls (x + d, "
                               f"F.rms_norm) {two_calls:.4f} ms")
        rows.setdefault("fused_add_rmsnorm", r)   # the first shape is the summary's row
    say("kernels-rmsnorm", "library: none (no single PyTorch call computes add + norm); "
                           "layout: a block a row, 128 threads of one 8-wide chunk at "
                           "D = 896, 320 at 2560")
    floor_w = cuda_ms(rms_kernel.empty_launch)
    floor_r = cuda_ms(rms_kernel.empty_launch, flush="read")
    say("kernels-rmsnorm", f"launch floor (an empty kernel of the same library, launched "
                           f"through the same ctypes path and cudaLaunchKernelEx): "
                           f"{floor_w:.4f} ms after a 256 MB write flush, {floor_r:.4f} ms "
                           "after a 256 MB read flush")
    for D in (896, 2560):
        chain, products = rms_chain_ms(D, rms_kernel.fused_add_rmsnorm)
        say("kernels-rmsnorm", f"(8, 1, {D}) in a decode step's chain: {CHAIN_PAIRS} x "
                               f"(torch.matmul (8, 1, {D}) @ ({D}, {D}), add + norm) "
                               f"{chain:.4f} ms, the products alone {products:.4f} ms: "
                               f"marginal {(chain - products) / CHAIN_PAIRS:.4f} ms a norm "
                               "(bf16, one write flush before the chain)")
    return rows


CHAIN_PAIRS = 24   # a qwen2-0.5b decode step's layers


def rms_chain_ms(D: int, norm) -> tuple:
    """(ms of CHAIN_PAIRS (attention output product, add + norm) pairs, ms of
    the products alone), bf16 at a decode step's 8 rows: each pair's product
    (8, 1, D) @ (D, D) with its own weight, then ``norm(res, product, scale)``
    with the residual threaded from pair to pair, as the step runs them; one
    pair of events around the whole chain after one flush. The spin before it
    covers the host's enqueue of the 48 calls."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    w = randn(gen, (CHAIN_PAIRS, D, D), torch.bfloat16) * D ** -0.5
    scale = torch.rand((CHAIN_PAIRS, D), generator=gen, device=DEVICE) + 0.5
    a, x = randn(gen, (8, 1, D), torch.bfloat16), randn(gen, (8, 1, D), torch.bfloat16)

    def chain():
        res = x
        for i in range(CHAIN_PAIRS):
            res, _ = norm(res, torch.matmul(a, w[i]), scale[i], 1e-6)

    def products():
        for i in range(CHAIN_PAIRS):
            torch.matmul(a, w[i])

    spin = 20_000_000                             # ~10 ms
    return cuda_ms(chain, spin=spin), cuda_ms(products, spin=spin)


def _ssd_inputs(gen, B, S, H, P, G, N, dtype):
    """As tests/test_kernels_ssd.py draws them: dt = softplus(randn) / 2,
    A = -exp(0.3 randn), B and C scaled by 0.3."""
    x = randn(gen, (B, S, H, P), dtype)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=DEVICE)) * 0.5
    A = -torch.exp(torch.randn((H,), generator=gen, device=DEVICE) * 0.3)
    Bm = (torch.randn((B, S, G, N), generator=gen, device=DEVICE) * 0.3).to(dtype)
    Cm = (torch.randn((B, S, G, N), generator=gen, device=DEVICE) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


def _ssd_case(gen, B, S, H, P, G, N, chunk, dtype, init=False, args=None):
    """Kernel against plain on one case; returns ((max abs err of y, of the
    state), inputs, outputs)."""
    args = args if args is not None else _ssd_inputs(gen, B, S, H, P, G, N, dtype)
    h0 = torch.randn((B, H, P, N), generator=gen, device=DEVICE) if init else None
    y, st = ssd_kernel.ssd(*args, chunk=chunk, initial_state=h0, return_final_state=True)
    torch.cuda.synchronize()
    ey, est = ssd_ref.ssd_reference(*args, chunk=chunk, initial_state=h0,
                                    return_final_state=True)
    what = f"ssd {tuple(args[0].shape)} G={G} N={N} chunk={chunk} init={init} {dtype}"
    errs = (max_err(y, ey, SSD_TOL[dtype], what + " y"),
            max_err(st, est, SSD_TOL[dtype], what + " state"))
    return errs, args, (y, st)


def phase_kernels_ssd() -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in [(1, 64, 2, 16, 1, 16, 16), (2, 128, 4, 32, 2, 8, 32),
                      (1, 96, 6, 16, 1, 32, 32), (2, 64, 8, 64, 4, 16, 64)]:
            _ssd_case(gen, *shape, dtype)      # tests/test_kernels_ssd.py:41-46
            n += 1
        _ssd_case(gen, 2, 96, 4, 64, 2, 32, 32, dtype, init=True)
        # a ragged chunk (a 137-token prompt is one chunk of 137), then the same
        # inputs padded with dt = 0 to one chunk of 256, as the model pads them
        S, pad = 137, 119
        _, args, (y, st) = _ssd_case(gen, 1, S, 8, 64, 1, 128, S, dtype)
        padded = [F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad)) if a.ndim > 1 else a for a in args]
        _, _, (yp, stp) = _ssd_case(gen, 1, S + pad, 8, 64, 1, 128, 256, dtype, args=padded)
        max_err(yp[:, :S], y, 1e-5, f"ssd dt=0 tail {dtype}: y")
        max_err(stp, st, 1e-5, f"ssd dt=0 tail {dtype}: state")
        n += 3
    say("kernels-ssd", f"{n} cases (reference sweep, initial state, ragged chunk, dt=0 tail) "
                       f"within {SSD_TOL[torch.float32]:g} (f32) / "
                       f"{SSD_TOL[torch.bfloat16]:g} (bf16); the padded tail changes y[:S] "
                       "and the state by at most 1e-5")

    # the full 80 heads: zamba2-2.7b's state N = 64 at a ragged chunk of 137;
    # three chunks; chunks of 1 and 2 (1- and 2-token prompts); a batch of 2
    # from a nonzero initial state at two chunks and at one
    cases = [(1, 137, 80, 64, 1, 64, 137, False), (1, 768, 80, 64, 1, 128, 256, False),
             (1, 1, 80, 64, 1, 128, 1, False), (1, 2, 80, 64, 1, 64, 2, False),
             (2, 512, 80, 64, 1, 128, 256, True), (2, 137, 80, 64, 1, 64, 137, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for *shape, init in cases:
            _ssd_case(gen, *shape, dtype, init=init)
        # the bf16 branches on the same inputs: a 137-token prompt as one chunk
        # (pass 1 writes the final state), then padded with dt = 0 to two and
        # three chunks of 256 (the state-passing pass writes it)
        S = 137
        args = _ssd_inputs(gen, 2, S, 80, 64, 1, 128, dtype)
        h0 = torch.randn((2, 80, 64, 128), generator=gen, device=DEVICE)
        y, st = ssd_kernel.ssd(*args, chunk=S, initial_state=h0, return_final_state=True)
        for total in (512, 768):
            padded = [F.pad(a, (0, 0) * (a.ndim - 2) + (0, total - S)) if a.ndim > 1 else a
                      for a in args]
            yp, stp = ssd_kernel.ssd(*padded, chunk=256, initial_state=h0,
                                     return_final_state=True)
            torch.cuda.synchronize()
            what = f"ssd one chunk vs {total // 256} chunks {dtype}"
            max_err(yp[:, :S], y, 1e-5, what + ": y")
            max_err(stp, st, 1e-5, what + ": state")
    say("kernels-ssd", "full 80 heads within the same tolerances: " + ", ".join(
        f"x {tuple(c[:4])} N {c[5]} chunk {c[6]}{' init' if c[7] else ''}" for c in cases)
        + "; one, two and three chunks agree within 1e-5 on a 137-token prompt padded with "
          "dt = 0, from a nonzero initial state")
    row = _ssd_slice_row(gen, SSD_SHAPE, SSM_ARCH)
    _ssd_slice_row(gen, HYBRID_SSD_SHAPE, HYBRID_ARCH)
    return {"ssd": row}


# the previous design's times at the slices' shapes (one block per (row, head)
# walking its chunks; PERF.md, call E of PR 14, H100 80GB HBM3 at 700 W)
SSD_PR14_MS = {SSM_ARCH: 0.5117, HYBRID_ARCH: 0.3837}


def _ssd_passes(fn, calls: int = 20) -> dict:
    """{kernel name: (device ms per call, device launches per call)} of each
    SSD kernel, from torch.profiler over `calls` calls, each after a 256 MB
    write that flushes the L2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.int8, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.events():
        m = re.search(r"\bssd_\w+", evt.name)  # e.g. ...::ssd_output_bf16<128, 64>(...)
        if evt.device_type == DeviceType.CUDA and m:
            ms, n = out.get(m.group(0), (0.0, 0.0))
            out[m.group(0)] = (ms + evt.time_range.elapsed_us() / 1e3 / calls, n + 1 / calls)
    return out


def _ssd_slice_row(gen, shape, arch) -> dict:
    """The scan at one slice's shape, f32 and bf16 against the plain version;
    timed in bf16 (the serve dtype), with the final state as prefill asks for it."""
    B, S, H, P, G, N, chunk = shape
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype], args, _ = _ssd_case(gen, B, S, H, P, G, N, chunk, dtype)
    say("kernels-ssd", f"{arch} shape x {(B, S, H, P)}, B/C {(B, S, G, N)}, chunk {chunk}: "
                       "max_abs_err of y, of the final state: " + "; ".join(
                           f"{e[0]:.3e}, {e[1]:.3e} ({'f32' if d == torch.float32 else 'bf16'})"
                           for d, e in errs.items()))
    x, dt, A, Bm, Cm = args
    esz = x.element_size()
    s_bytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * esz + (dt.numel() + A.numel()) * 4 \
        + B * H * P * N * 4                             # x in, y out, B, C, dt, A, state out
    nc, tri = S // chunk, chunk * (chunk + 1) // 2       # causal: pairs j <= i per chunk
    least_flops = 2 * B * nc * (G * tri * N              # C B^T once per group
                                + H * tri * P            # (C B^T o L) (dt x)
                                + 2 * H * chunk * P * N)  # C h^T read-out, state update
    tpu_flops = 2 * B * nc * H * (chunk * chunk * (N + P) + 2 * chunk * P * N)
    row = dict(
        max_abs_err=max(errs[torch.bfloat16]),
        ms=cuda_ms(lambda: ssd_kernel.ssd(x, dt, A, Bm, Cm, chunk=chunk,
                                          return_final_state=True)),
        plain_ms=cuda_ms(lambda: ssd_ref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk,
                                                       return_final_state=True)),
        library_ms=None,
        bound=bound(s_bytes, least_flops, torch.bfloat16),
        work=f"{least_flops/1e9:.3f} GFLOP ({tpu_flops/1e9:.3f} as the TPU kernel does them: "
             f"C B^T per head, full squares), {s_bytes/1e6:.3f} MB",
    )
    say("kernels-ssd", f"{arch} ssd bf16: kernel {row['ms']:.4f} ms (previous design "
                       f"{SSD_PR14_MS[arch]:.4f} ms, PR 14), plain {row['plain_ms']:.4f} ms, "
                       f"bound {row['bound'][0]:.5f} ms by {row['bound'][1]} ({row['work']}); "
                       "library: none (no single PyTorch call computes the SSD scan)")
    passes = _ssd_passes(lambda: ssd_kernel.ssd(x, dt, A, Bm, Cm, chunk=chunk,
                                                return_final_state=True))
    launches = (f"{sum(n for _, n in passes.values()):g} device launches per call, counted "
                "by the profiler" if passes else "device launches per call not measured: the "
                "profiler recorded no device event")
    n_tiles = -(-chunk // 128)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say("kernels-ssd", f"{arch} occupancy (bf16, {launches}): chunk state one block of 256 "
                       f"threads per "
                       f"(chunk, head, row) = {nc} x {H} x {B} = {nc * H * B} blocks"
                       + (f"; state passing 4 state entries a thread, blocks of 256 = "
                          f"{-(-P * N // 1024)} x {H} x {B} = {-(-P * N // 1024) * H * B} blocks"
                          if nc > 1 else "; no state-passing pass at one chunk")
                       + f"; output one block of 256 threads per (128-row tile, chunk, head, "
                         f"row) = {n_tiles} x {nc} x {H} x {B} = {n_tiles * nc * H * B} "
                         f"blocks; on {sms} SMs. f32: one block of 256 threads per (row, "
                         f"head) = {B * H}, one launch, each walking its {nc} chunks in order")
    say("kernels-ssd", f"{arch} bf16 device time per pass (profiler, mean of 20 calls, L2 "
                       f"flushed; the passes overlap, so they sum to more than the call): "
                       + (", ".join(f"{k} {ms * 1e3:.2f} us ({n:g} a call)"
                                    for k, (ms, n) in passes.items()) or "not measured"))
    return row


def _blit(cache: dict, seq_cache: dict) -> None:
    """Copy a prefill cache into the leading entries of a zero decode cache
    (the k/v sequence axis; the SSM leaves are the same shape; the hybrid's
    nested tree is walked)."""
    for name, dst in cache.items():
        src = seq_cache[name]
        if isinstance(dst, dict):
            _blit(dst, src)
        else:
            dst[tuple(slice(0, n) for n in src.shape)].copy_(src)


def _teacher_forced(model: Model, tokens: np.ndarray, n_prefill: int) -> torch.Tensor:
    """Logits at the last prefill position and after each teacher-forced decode
    step: (steps + 1, B, V)."""
    B, total = tokens.shape
    tok = torch.from_numpy(tokens).to(DEVICE)
    logits, seq_cache = model.prefill({"tokens": tok[:, :n_prefill]})
    cache = model.init_cache(B, total)
    _blit(cache, seq_cache)
    out = [logits]
    for i in range(total - n_prefill):
        pos = torch.full((B,), n_prefill + i, dtype=torch.int32, device=DEVICE)
        logits, cache = model.decode_step(tok[:, n_prefill + i:n_prefill + i + 1], cache, pos)
        out.append(logits)
    return torch.stack(out)


def phase_slice(arch: str, tag: str, bf16_tol: float) -> Model:
    cfg = get_config(arch)
    B, n_prefill, steps = 4, 384, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, n_prefill + steps))
    tokens = tokens.astype(np.int32)
    model = None
    for dtype in ("float32", "bfloat16"):
        del model
        torch.cuda.empty_cache()
        model = Model(cfg.with_(dtype=dtype), device=DEVICE).init(
            torch.Generator(device=DEVICE).manual_seed(0))
        model.kernel_impl = "auto"
        got = _teacher_forced(model, tokens, n_prefill)
        model.kernel_impl = "ref"
        want = _teacher_forced(model, tokens, n_prefill)
        model.kernel_impl = "auto"
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{tag} {dtype}: non-finite logits")
        diff = (got - want).abs().max().item()
        got_top, want_top = got.argmax(-1), want.argmax(-1)
        top1 = (got_top == want_top).float().mean().item()
        # how far below its own top logit the plain path ranks the kernel's pick
        gap = (want.amax(-1) - want.gather(-1, got_top[..., None])[..., 0]).max().item()
        positions = got.shape[0] * got.shape[1]
        say(tag, f"{arch} {dtype}: {B}x{n_prefill} prefill + {steps} decode steps, "
                     f"{positions} positions: max|dlogit| {diff:.3e}, top-1 agreement "
                     f"{top1:.4f}, largest near-tie gap {gap:.3e} (logit range "
                     f"{want.min().item():.2f}..{want.max().item():.2f})")
        if dtype == "float32" and (diff > SLICE_F32_TOL or top1 < 1.0):
            raise AssertionError(f"{tag} f32: max|dlogit| {diff:.3e} > {SLICE_F32_TOL} "
                                 f"or top-1 agreement {top1} < 1")
        if dtype == "bfloat16" and (diff > bf16_tol or gap > bf16_tol):
            raise AssertionError(f"{tag} bf16: max|dlogit| {diff:.3e} or near-tie gap "
                                 f"{gap:.3e} > {bf16_tol}")
    say(tag, f"tolerances: f32 max|dlogit| <= {SLICE_F32_TOL:g} and the same argmax "
             f"everywhere; bf16 max|dlogit| <= {bf16_tol:g} and every top-1 "
             f"disagreement a near-tie within {bf16_tol:g}")
    return model  # the bf16 model, reused by the serve phase


class _TimedEngine(ServeEngine):
    """ServeEngine that records the host time of each decode step (the step
    ends in a device-to-host copy of the sampled tokens, so it is synchronous)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.step_s = []

    def _step(self) -> bool:
        t0 = time.perf_counter()
        ran = super()._step()
        if ran:
            self.step_s.append(time.perf_counter() - t0)
        return ran


# device launches per wrapper call of the kernels a decode step runs
# (decode_attention: the split-KV pass, then the combine); ssd and
# flash_attention run only in prefill
STEP_DEVICE_LAUNCHES = {"decode_attention": 2, "fused_add_rmsnorm": 1}


def _port_kernel(name: str):
    """The port kernel a device kernel's (demangled) name belongs to, or None."""
    if "decode_split_kernel" in name or "decode_combine_kernel" in name:
        return "decode_attention"
    if "repro_torch_rmsnorm::" in name:
        return "fused_add_rmsnorm"
    if "repro_torch_ssd::" in name:
        return "ssd"
    if "repro_torch::" in name and "flash_attention" in name:
        return "flash_attention"
    return None


def _replay_device_launches(graph, kernel_impl: str) -> tuple:
    """({port kernel: device launches}, all device events) of one replay of a
    decode graph, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay(kernel_impl)
        torch.cuda.synchronize()
    counts, events = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            events += 1
            k = _port_kernel(evt.name)
            if k is not None:
                counts[k] = counts.get(k, 0) + 1
    return counts, events


def _graph_nodes(graph):
    """The node count of a captured graph (``cuGraphGetNodes``), or None
    where PyTorch does not keep the graph."""
    import ctypes
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(raw), None,
                                                      ctypes.byref(n))
    return int(n.value) if err == 0 else None


def _serve_run(model: Model, prompts, new_tokens: int, cuda_graph: bool) -> dict:
    """One engine (max_batch 8, max_len 1024) serves `prompts`; the launch
    counters are reset just before the requests are submitted and read just
    after they are drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = _TimedEngine(model, max_batch=8, max_len=1024, cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()     # the graph's pool stays reserved, not allocated
    for mod in KERNEL_MODULES:                 # the run starts here
        mod.reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    engine.run_until_drained(timeout=900)
    wall = time.monotonic() - t0
    launches = {k: v for mod in KERNEL_MODULES for k, v in mod.LAUNCHES.items()}  # ... and here
    return dict(engine=engine, reqs=reqs, wall=wall, launches=launches, build_s=build_s,
                peak=torch.cuda.max_memory_allocated(),
                peak_reserved=torch.cuda.max_memory_reserved())


def _check_streams(model: Model, prompts, graphed, eager, tol: float, tag: str) -> int:
    """The graphed and the eager engine's token streams, request by request:
    where they part, both tokens must be a near-tie, each within ``tol`` of
    the top logit of an eager B = 1 prefill of the prompt and the common
    prefix. Returns the number of requests whose streams part."""
    parted = 0
    for i, (p, g, e) in enumerate(zip(prompts, graphed, eager)):
        j = next((j for j, (a, b) in enumerate(zip(g.tokens, e.tokens)) if a != b), None)
        if j is None:
            continue
        parted += 1
        seq = np.concatenate([np.asarray(p), np.asarray(g.tokens[:j])]).astype(np.int64)
        with torch.inference_mode():
            logits, _ = model.prefill({"tokens": torch.from_numpy(seq[None]).to(DEVICE)})
        top = logits[0].max().item()
        gaps = [top - logits[0, t].item() for t in (g.tokens[j], e.tokens[j])]
        say(tag, f"request {i} parts at token {j}: graphed {g.tokens[j]}, eager "
                 f"{e.tokens[j]}, below the top logit by {gaps[0]:.3e} / {gaps[1]:.3e}")
        if max(gaps) > tol:
            raise AssertionError(f"{tag}: request {i}'s streams part at token {j} by more "
                                 f"than a near-tie ({max(gaps):.3e} > {tol})")
    return parted


def _launch_floor(cfg, n_req: int, steps: int) -> dict:
    """The least calls of each kernel a serve run of `n_req` prefills and
    `steps` decode steps makes on this family's path."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        # one scan per layer per prefill; decode is the plain one-token
        # recurrence (as in JAX) and launches no kernel of the repo
        return {"ssd": n_req * L}
    if cfg.family == "hybrid":
        # the shared block runs before each of the G groups, in every prefill
        # and every decode step; the scan once per mamba layer per prefill
        G = L // cfg.shared_attn_every
        return {"flash_attention": n_req * G, "decode_attention": steps * G,
                "fused_add_rmsnorm": (n_req + steps) * G, "ssd": n_req * L}
    return {"flash_attention": n_req * L, "decode_attention": steps * L,
            "fused_add_rmsnorm": (n_req + steps) * L}


def phase_serve(model: Model, tag: str, bf16_tol: float) -> dict:
    """Serve 16 requests through a graphed ServeEngine (the main path), then
    the same 16 through an eager one; returns the launches of the kernels on
    this family's path, counted over the graphed run alone."""
    cfg = model.cfg
    n_req, new_tokens, max_batch, max_len = 16, 64, 8, 1024
    # warm-up through the same entry points (cuBLAS handles, allocator)
    warm = ServeEngine(model, max_batch=2, max_len=128)
    warm.submit(np.arange(16) % cfg.vocab, max_new_tokens=4)
    warm.run_until_drained(timeout=300)
    del warm

    rng = np.random.default_rng(2)
    lens = rng.integers(64, 513, n_req)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    say(tag, f"{cfg.name} bf16, {n_req} requests (prompts {lens.min()}..{lens.max()} "
             f"tokens, {new_tokens} new each), max_batch {max_batch}, max_len {max_len}; "
             f"cache {kv_cache.summarize(cfg, max_batch, max_len)}")

    runs = {}
    for mode, cuda_graph in (("graphed", True), ("eager", False)):
        run = runs[mode] = _serve_run(model, prompts, new_tokens, cuda_graph)
        engine, reqs, launches = run["engine"], run["reqs"], run["launches"]
        for r in reqs:
            if not r.done.is_set() or len(r.tokens) != new_tokens:
                raise AssertionError(f"{mode} request {r.request_id}: done={r.done.is_set()} "
                                     f"with {len(r.tokens)} of {new_tokens} tokens")
            if not all(0 <= t < cfg.vocab for t in r.tokens):
                raise AssertionError(f"{mode} request {r.request_id}: token out of range")
        need = _launch_floor(cfg, n_req, engine.steps)
        absent = [k for k in launches if k not in need]
        if any(launches[k] < n for k, n in need.items()) or any(launches[k] != 0 for k in absent):
            raise AssertionError(f"{mode} launch counters {launches} do not meet {need}: the "
                                 "path skipped a kernel or ran another family's")
        total = sum(len(r.tokens) for r in reqs)
        ttft = np.array([(r.first_token_at - r.submitted) * 1e3 for r in reqs])
        say(tag, f"{mode}: {total} tokens in {run['wall']:.3f} s = {total / run['wall']:.1f} "
                 f"tokens/s; TTFT p50 {np.percentile(ttft, 50):.1f} ms, p99 "
                 f"{np.percentile(ttft, 99):.1f} ms (16 samples); {engine.steps} decode steps, "
                 f"mean {np.mean(engine.step_s) * 1e3:.3f} ms, median "
                 f"{np.median(engine.step_s) * 1e3:.3f} ms; max_memory_allocated "
                 f"{run['peak'] / 2**30:.3f} GiB, max_memory_reserved "
                 f"{run['peak_reserved'] / 2**30:.3f} GiB; engine built in "
                 f"{run['build_s']:.3f} s")
        say(tag, f"{mode}: launches {launches} (need >= {need}, none of {list(absent)})")
        if mode == "graphed":
            graph = engine._graph
            nodes = _graph_nodes(graph.graph)
            profiled, events = _replay_device_launches(graph, model.kernel_impl)
            want = {k: n * STEP_DEVICE_LAUNCHES[k] for k, n in graph.launches.items() if n}
            say(tag, f"graph: built with its warm-up and capture in {run['build_s']:.3f} s, "
                     f"{'node count not exposed' if nodes is None else f'{nodes} nodes'}; "
                     f"captured calls {graph.launches}; one replay under torch.profiler: "
                     f"{events} device events, the port's kernels {profiled} (want {want})")
            if events == 0:
                raise AssertionError(f"{tag}: the profiler recorded no device event of a replay")
            if profiled != want:
                raise AssertionError(f"{tag}: a replay launched {profiled} on the device, the "
                                     f"capture counted {want}")
        run["steps"] = engine.steps
        del engine, run["engine"]              # free the cache and the graph's pool
        torch.cuda.empty_cache()
    graphed, eager = runs["graphed"]["reqs"], runs["eager"]["reqs"]
    parted = _check_streams(model, prompts, graphed, eager, bf16_tol, tag)
    say(tag, f"graphed and eager token streams: {n_req - parted} of {n_req} requests equal; "
             f"{parted} part, each at a near-tie within {bf16_tol:g}")
    launches = runs["graphed"]["launches"]
    return {k: launches[k] for k in _launch_floor(cfg, n_req, runs["graphed"]["steps"])}


def main() -> int:
    name = phase_device()
    phase_build()
    rows = phase_kernels()
    rows.update(phase_kernels_rmsnorm())
    rows.update(phase_kernels_ssd())
    launches = dict.fromkeys(rows, 0)
    for arch, tag, tol in ((ARCH, "", SLICE_BF16_TOL), (SSM_ARCH, "-ssm", SLICE_SSM_BF16_TOL),
                           (HYBRID_ARCH, "-hybrid", SLICE_HYBRID_BF16_TOL)):
        model = phase_slice(arch, "slice" + tag, tol)
        for k, n in phase_serve(model, "serve" + tag, tol).items():
            launches[k] += n
        del model                               # free the weights before the next family
        torch.cuda.empty_cache()
    kernels = []
    for kname, r in rows.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
