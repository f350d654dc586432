#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA card and ``nvcc``. Phases, in
order, each printing its lines; any failure raises and the exit code is not 0:

1. device   - require CUDA and compute capability 9.0; print the card's name
              and power limit (nvidia-smi); fp32 products in full fp32.
2. build    - compile both attention kernels from ``src/repro_torch`` with
              nvcc for sm_90a, in parallel.
3. kernels  - hold each kernel against its plain PyTorch version (ref.py) at
              2e-5 (f32) / 2e-2 (bf16) on the reference's test shapes and the
              slice's own shapes; time kernel, plain version and
              ``F.scaled_dot_product_attention`` (a yardstick only) there.
4. slice    - full-width qwen2-0.5b, random weights from seed 0: prefill 4 x 384
              tokens then 16 teacher-forced decode steps with vector positions,
              kernel path against the plain path on the same weights.
5. serve    - ServeEngine on full-width bf16 qwen2-0.5b answers 16 requests;
              the launch counters must show both kernels on the path.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
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
}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:107",
    "decode_attention": "src/repro/kernels/flash_attention/kernel.py:173",
}
# slice shapes: prefill of one 512-token prompt; decode over B=8 slots of a
# 1024-long cache (qwen2-0.5b: H=14 query heads over KV=2, hd=64)
PREFILL_SHAPE = (1, 512, 14, 2, 64)          # B, S, H, KV, hd
DECODE_SHAPE = (8, 1024, 14, 2, 64)          # B, S, H, KV, hd
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


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ------------------------------------------------------------------ helpers
def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() in ms, CUDA events around each call, with the
    50 MB L2 flushed before each (the main path finds the cache cold)."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device=DEVICE)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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
    info = attn_kernel.build()
    wall = time.perf_counter() - t0
    for name, r in info.items():
        say("build", f"{name}: {r['seconds']:.1f} s -> {Path(r['path']).name}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"  ptxas: {line.strip()}")
    say("build", f"both kernels built in {wall:.1f} s wall (one nvcc per source, in parallel)")


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
    say("kernels", f"{n} reference-sweep cases within {TOL[torch.float32]:g} (f32) / "
                   f"{TOL[torch.bfloat16]:g} (bf16)")

    # the slice's own shapes, both dtypes; timed in bf16 (the serve dtype)
    rows = {}
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = DECODE_SHAPE
    pos_np = rng.integers(64, S - 1, B).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, S - 1          # an empty-but-one row and a full row
    pos = torch.from_numpy(pos_np).to(DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        Bp, Sp, Hp, KVp, hdp = PREFILL_SHAPE
        err_p, (q, k, v) = _prefill_case(gen, Bp, Sp, Sp, Hp, KVp, hdp, dtype, True)
        err_d, (qd, kc, vc) = _decode_case(gen, B, S, H, KV, hd, dtype, pos)
        say("kernels", f"slice shapes {dtype}: prefill max_abs_err {err_p:.3e}, "
                       f"decode (pos {pos_np.tolist()}) max_abs_err {err_d:.3e}")
    # timing at the slice's shapes in bf16 (q, k, v ... from the bf16 pass above)
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
        say("kernels", f"{name} bf16: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                       f"sdpa {r['library_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
                       f"{r['bound'][1]} ({r['work']})")
    say("kernels", "decode occupancy: one block per (row, KV head) = "
                   f"{B * KV} blocks of 256 threads on "
                   f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    return rows


def _blit(cache: dict, seq_cache: dict, S: int) -> None:
    for name in cache:
        cache[name][:, :, :S].copy_(seq_cache[name])


def _teacher_forced(model: Model, tokens: np.ndarray, n_prefill: int) -> torch.Tensor:
    """Logits at the last prefill position and after each teacher-forced decode
    step: (steps + 1, B, V)."""
    B, total = tokens.shape
    tok = torch.from_numpy(tokens).to(DEVICE)
    logits, seq_cache = model.prefill({"tokens": tok[:, :n_prefill]})
    cache = model.init_cache(B, total)
    _blit(cache, seq_cache, n_prefill)
    out = [logits]
    for i in range(total - n_prefill):
        pos = torch.full((B,), n_prefill + i, dtype=torch.int32, device=DEVICE)
        logits, cache = model.decode_step(tok[:, n_prefill + i:n_prefill + i + 1], cache, pos)
        out.append(logits)
    return torch.stack(out)


def phase_slice() -> Model:
    cfg = get_config(ARCH)
    B, n_prefill, steps = 4, 384, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, n_prefill + steps))
    tokens = tokens.astype(np.int32)
    model = None
    for dtype in ("float32", "bfloat16"):
        del model
        torch.cuda.empty_cache()
        model = Model(cfg.with_(dtype=dtype), device=DEVICE).init(
            torch.Generator(device=DEVICE).manual_seed(0))
        model.attn_impl = "auto"
        got = _teacher_forced(model, tokens, n_prefill)
        model.attn_impl = "ref"
        want = _teacher_forced(model, tokens, n_prefill)
        model.attn_impl = "auto"
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"slice {dtype}: non-finite logits")
        diff = (got - want).abs().max().item()
        got_top, want_top = got.argmax(-1), want.argmax(-1)
        top1 = (got_top == want_top).float().mean().item()
        # how far below its own top logit the plain path ranks the kernel's pick
        gap = (want.amax(-1) - want.gather(-1, got_top[..., None])[..., 0]).max().item()
        positions = got.shape[0] * got.shape[1]
        say("slice", f"{ARCH} {dtype}: {B}x{n_prefill} prefill + {steps} decode steps, "
                     f"{positions} positions: max|dlogit| {diff:.3e}, top-1 agreement "
                     f"{top1:.4f}, largest near-tie gap {gap:.3e} (logit range "
                     f"{want.min().item():.2f}..{want.max().item():.2f})")
        if dtype == "float32" and (diff > SLICE_F32_TOL or top1 < 1.0):
            raise AssertionError(f"slice f32: max|dlogit| {diff:.3e} > {SLICE_F32_TOL} "
                                 f"or top-1 agreement {top1} < 1")
        if dtype == "bfloat16" and (diff > SLICE_BF16_TOL or gap > SLICE_BF16_TOL):
            raise AssertionError(f"slice bf16: max|dlogit| {diff:.3e} or near-tie gap "
                                 f"{gap:.3e} > {SLICE_BF16_TOL}")
    say("slice", f"tolerances: f32 max|dlogit| <= {SLICE_F32_TOL:g} and the same argmax "
                 f"everywhere; bf16 max|dlogit| <= {SLICE_BF16_TOL:g} and every top-1 "
                 f"disagreement a near-tie within {SLICE_BF16_TOL:g}")
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


def phase_serve(model: Model) -> dict:
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
    engine = _TimedEngine(model, max_batch=max_batch, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn_kernel.reset_launches()               # the main path starts here
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    engine.run_until_drained(timeout=900)
    wall = time.monotonic() - t0
    launches = dict(attn_kernel.LAUNCHES)      # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    for r in reqs:
        if not r.done.is_set() or len(r.tokens) != new_tokens:
            raise AssertionError(f"request {r.request_id}: done={r.done.is_set()} "
                                 f"with {len(r.tokens)} of {new_tokens} tokens")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: token out of range")
    need_prefill, need_decode = n_req * cfg.n_layers, engine.steps * cfg.n_layers
    if launches["flash_attention"] < need_prefill or launches["decode_attention"] < need_decode:
        raise AssertionError(f"launch counters {launches} below prefill {need_prefill} / "
                             f"decode {need_decode}: the path skipped a kernel")
    total = sum(len(r.tokens) for r in reqs)
    ttft = np.array([(r.first_token_at - r.submitted) * 1e3 for r in reqs])
    say("serve", f"{cfg.name} bf16, {n_req} requests (prompts {lens.min()}..{lens.max()} "
                 f"tokens, {new_tokens} new each), max_batch {max_batch}, max_len {max_len}")
    say("serve", f"{total} tokens in {wall:.3f} s = {total / wall:.1f} tokens/s; "
                 f"TTFT p50 {np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms "
                 f"(16 samples); {engine.steps} decode steps, mean "
                 f"{np.mean(engine.step_s) * 1e3:.3f} ms, median "
                 f"{np.median(engine.step_s) * 1e3:.3f} ms")
    say("serve", f"max_memory_allocated {peak / 2**30:.3f} GiB (cache "
                 f"{kv_cache.summarize(cfg, max_batch, max_len)['gib']} GiB); launches {launches} "
                 f"(need >= {need_prefill} prefill, >= {need_decode} decode)")
    return launches


def main() -> int:
    name = phase_device()
    phase_build()
    rows = phase_kernels()
    model = phase_slice()
    launches = phase_serve(model)
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
