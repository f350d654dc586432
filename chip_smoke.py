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
                     GQA hd 64, zamba2-2.7b MHA hd 80, qwen2-moe-a2.7b MHA 16/16
                     hd 128, minicpm3-4b's MLA: prefill 40 heads of dqk 96 and
                     dv 64, decode 40 heads over one KV head of dqk 288 and
                     dv 256, with a row of length 0; whisper-small's non-causal
                     flash calls: the encoder at Sq = Skv = 1500, cross-attention
                     at prefill, 64 queries against 1500 keys, and at decode,
                     Sq = 1 against 1500 keys at B = 8 with an all-zero (idle)
                     slot, and its self decode at B = 8 over 448 positions;
                     internvl2-26b's GQA 48/8 (G = 6) hd 128: prefill of 256
                     patches + 512 tokens, decode at B = 8 over 1024
                     positions); time kernel, plain version and
                     ``F.scaled_dot_product_attention`` (a yardstick only) there,
                     and each SDPA backend that takes the shape; beside the Sq = 1
                     cross row, ``decode_attention`` at pos 1499 on the same
                     tensors (the same function by the other kernel, timed only).
4. kernels-rmsnorm  - hold the fused add + RMSNorm kernel against its plain
                     version at 1e-6 (f32) / 1e-2 (bf16) on the reference's sweep
                     and the slices' rows (d_model 896, 2560 and 2048, 512-token
                     prefill and 8-slot decode; internvl2-26b's 6144, a
                     768-position prefill and 8-slot decode); time kernel and
                     plain version there
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
                     at 2560, 384 of two chunks at 6144).
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
8. fabric-frontdoor - the same 16 requests as fabric tasks through the serve
                     driver's path (``launch/serve.py``: FunctionService ->
                     Forwarder -> Endpoint -> worker -> a pass-through
                     ``generate`` on a graphed engine); streams held to the
                     serve phase's graphed ones under its near-tie rule;
                     throughput and TTFT beside the direct engine's.
9. fabric           - ``serve_model`` over two ``torch`` endpoints and a
                     journal: 8 concurrent sessions of 64 tokens (the serve
                     phase's first 8 prompts) on batched hosts (a graph replay
                     a coalesced step), then on unbatched hosts, then 4
                     sessions of 16 tokens with the first session's endpoint
                     killed after the third step. Each run: every session's
                     tokens, streams held to the direct engine's under the
                     near-tie rule, one affinity hit per decode task, no
                     duplicate commitment in the journal, the kernels' floor;
                     the batched run must coalesce (fewer steps than decode
                     tasks, a step of more than one slot), the failover run
                     must migrate a session. Prints tokens/s, TTFT, the mean
                     decode-task wall as a client sees it, the graphed step's
                     device time, and the wire codec's time for one decode
                     task's payload.
10. slice-ssm       - the same as slice for full-width mamba2-2.7b (prefills pad
                     384 to 512).
11. serve-ssm       - the same as serve for full-width bf16 mamba2-2.7b; the
                     counters must show the SSD kernel in every layer's prefill
                     and none of the other three (its step runs no kernel of
                     the repo).
12. slice-hybrid    - the same for full-width zamba2-2.7b (54 Mamba2 layers in 9
                     groups of 6, one shared attention + MLP block before each).
13. serve-hybrid    - the same for full-width bf16 zamba2-2.7b; the counters
                     must show all four kernels: the shared block's attention
                     and add + norm 9 times per prefill and per step, the SSD
                     scan 54 times per prefill.
14. fabric-hybrid   - 4 sessions of 32 tokens on one ``torch`` endpoint through
                     the unbatched host (each session's cache holds max_len
                     positions), held to serve-hybrid's graphed streams under
                     the hybrid's near-tie bound; all four kernels must launch.
15. slice-moe       - the same as slice for full-width qwen2-moe-a2.7b (60 routed
                     experts top-4 with capacity drop, a gated shared expert);
                     the f32 check runs 8 of its 24 layers (a depth cut: the
                     full-width f32 model is 57 GB), bf16 all 24. Routing flips
                     between the two paths (tokens x layers whose top-4 expert
                     set differs) are counted and printed.
16. serve-moe       - the same as serve for full-width bf16 qwen2-moe-a2.7b: flash
                     attention, decode attention and the add + norm 24 times a
                     prefill and a step.
17. fabric-moe      - ``serve_model`` on two ``torch`` endpoints with a journal, 8
                     sessions of 64 tokens on batched hosts: at the published
                     capacity factor (every session's tokens, one affinity hit a
                     decode task, no duplicate commitment, coalescing; how many
                     streams equal the direct engine's is printed, not held:
                     the drops depend on which slots share a step), then on the
                     same weights at capacity factor E / k = 15, where nothing
                     drops, held to a direct graphed engine's streams under the
                     near-tie rule.
18. slice-mla       - the same as slice for full-width minicpm3-4b (62 layers of
                     Multi-head Latent Attention, 40 heads, d_model 2560, vocab
                     73448), f32 (17 GB) and bf16, no cut.
19. serve-mla       - the same as serve for full-width bf16 minicpm3-4b: flash
                     attention (dv 64 != dqk 96), decode attention (dqk 288, dv
                     256) and the add + norm 62 times a prefill and a step.
20. fabric-mla      - ``serve_model`` on one ``torch`` endpoint, a batched host
                     whose slots a ``cache_bytes`` budget of 4 sessions sets: 4
                     sessions of 32 tokens held to serve-mla's graphed streams
                     under the near-tie rule; then a fifth session refused by a
                     full host and admitted once a slot is released.
21. slice-encdec    - the same as slice for full-width whisper-small (12 encoder
                     and 12 decoder layers, d_model 768, MHA 12/12 hd 64, vocab
                     51865), each prompt with its own random frames (1500 x 768,
                     numpy seed 3), f32 and bf16, no cut.
22. serve-encdec    - a graphed ServeEngine(max_batch=8, max_len=448: whisper's
                     published text context) answers 16 requests of 4..64
                     tokens, each with its own random frames, then an eager one
                     answers the same 16, held as serve is; the counters must
                     show flash attention exactly 36 times a prefill (12 encoder,
                     12 causal self, 12 cross) and 12 a step (cross-attention,
                     Sq = 1, captured in the graph), decode attention 12 a step,
                     and no add + norm (LayerNorms) and no scan.
23. fabric-encdec   - ``serve_model`` on one ``torch`` endpoint with a journal: 4
                     sessions of 32 tokens, each with its frames (put once into
                     an object store; each task carries their key), through the
                     unbatched host, held to serve-encdec's graphed streams for
                     the same prompts and frames under the near-tie rule.
24. slice-vlm       - the same as slice for full-width internvl2-26b (48 layers,
                     d_model 6144, GQA 48/8 hd 128, d_ff 16384, vocab 92553),
                     each prompt after its own 256 random patches (256 x 6144,
                     numpy seed 3); the f32 check runs 8 of its 48 layers (a
                     depth cut: the full-width f32 model is 79.6 GB, 8 layers
                     17.2 GB), bf16 all 48.
25. serve-vlm       - a graphed ServeEngine(max_batch=8, max_len=1024) answers
                     16 requests of 64..512 tokens, each after its own random
                     patches (a slot's positions count them), then an eager one
                     answers the same 16, held as serve is; the counters must
                     show exactly 48 flash calls a prefill, 48 decode
                     attention calls a step and 48 add + norm calls a prefill
                     and a step. Prints the step against its byte bound.
26. fabric-vlm      - ``serve_model`` on two ``torch`` endpoints with a journal:
                     4 sessions of 32 tokens, each with its patches (put once
                     into an object store; each task carries their key),
                     through the unbatched host; the endpoint holding the
                     first session is killed after every session's third
                     step, and the sessions it held re-prefill on the survivor
                     with their patches from the store. Held to serve-vlm's
                     graphed streams under the near-tie rule.

The VLM phases run last, after every other model is freed: internvl2-26b's
39.8 GB of bf16 weights leave about 38 GB for its engine and hosts.
Each family's slice, serve and fabric phases print their wall time.

Each serve and fabric phase resets the launch counters just before it submits
its requests and reads them just after; a replay adds the calls its capture
counted. The summary's ``launches`` of a kernel is its sum over the seven
graphed serve runs and the fabric runs; the fabric phases together must have
launched every kernel.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import FunctionService, MetricsRegistry, serializer  # noqa: E402
from repro_torch.core.containers import ContainerSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.launch.serve import serve_through_front_door  # noqa: E402
from repro_torch.serving import fabric, kv_cache  # noqa: E402
from repro_torch.serving.engine import SIDE_INPUTS, ServeEngine, prefix_len  # noqa: E402

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
PREFILL_SHAPE = (1, 512, 14, 2, 64, 64)      # B, S, H, KV, dqk, dv
DECODE_SHAPE = (8, 1024, 14, 2, 64, 64)      # B, S, H, KV, dqk, dv
# zamba2-2.7b's shared block: MHA, 32 heads over 32 KV heads (G = 1), hd 80
# (a multiple of 8, not of 16), at the same prefill and decode sizes
HYBRID_PREFILL_SHAPE = (1, 512, 32, 32, 80, 80)
HYBRID_DECODE_SHAPE = (8, 1024, 32, 32, 80, 80)
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
RMS_SHAPES = ((1, 512, 2560), (8, 1, 2560), (1, 512, 896), (8, 1, 896),
              (1, 512, 2048), (8, 1, 2048), (1, 768, 6144), (8, 1, 6144))

HYBRID_ARCH = "zamba2-2.7b"
# bf16 slice of zamba2-2.7b, held as the mamba2 slice is: 54 Mamba2 layers each
# round the scan's output y to bf16 once and the shared block rounds attention
# outputs 9 times (63 rounding points against mamba2's 64), and the logits are
# bf16 products (one ulp is 2^-5 at |logit| 4..8). Held: max|dlogit| within 16
# such ulps, and every top-1 disagreement a near-tie within that same margin.
SLICE_HYBRID_BF16_TOL = 0.5

MOE_ARCH = "qwen2-moe-a2.7b"
# its attention: MHA, 16 heads over 16 KV heads, hd 128, at the same prefill
# and decode sizes
MOE_PREFILL_SHAPE = (1, 512, 16, 16, 128, 128)
MOE_DECODE_SHAPE = (8, 1024, 16, 16, 128, 128)
# the f32 check of the MoE slice runs 8 of the 24 layers (a depth cut): the
# full-width f32 model is 57 GB and cannot sit beside the bf16 one; 8 layers
# are about 21 GB
MOE_F32_LAYERS = 8
# bf16 slice of qwen2-moe-a2.7b: the kernel and plain attention paths differ by
# bf16 rounding, and where two router probabilities are that close a token goes
# to another expert (a routing flip, counted and printed by the phase). On an
# H100 at seed 0, 2210 of the 38400 (token, layer) routes flip between the two
# paths, each moving a token's output, and the later positions that attend to
# it, by more than the dense slice's rounding alone; max|dlogit| read 0.149
# there. Held: max|dlogit| within 16 ulps of a logit of 4..8 (0.5, the SSM
# slices' bound, for the flips on top of qwen2-0.5b's 8) and every top-1
# disagreement a near-tie within that same margin.
SLICE_MOE_BF16_TOL = 0.5

MLA_ARCH = "minicpm3-4b"
# its attention (models/mla.py): the expanded prefill, 40 heads of dqk
# 64 + 32 and dv 64; the absorbed decode, 40 query heads over one KV head of
# dqk 256 + 32 and dv 256; both at the scale (64 + 32)^-0.5
MLA_PREFILL_SHAPE = (1, 512, 40, 40, 96, 64)
MLA_DECODE_SHAPE = (8, 1024, 40, 1, 288, 256)
MLA_SCALE = 96 ** -0.5
# bf16 slice of minicpm3-4b, held as the mamba2 slice is: both paths round
# attention outputs to bf16 twice a layer (prefill and decode) in 62 layers,
# against mamba2's 64 rounding points, and the logits are bf16 products (one
# ulp is 2^-5 at |logit| 4..8). Held: max|dlogit| within 16 such ulps, and
# every top-1 disagreement a near-tie within that same margin.
SLICE_MLA_BF16_TOL = 0.5

ENCDEC_ARCH = "whisper-small"
# its attention: MHA 12/12, hd 64, every flash call non-causal but the decoder's
# own: the encoder over 1500 frames, cross-attention of a 64-token prompt and
# of one decode token (8 slots) against the 1500 encoder keys; and the self
# decode over 8 slots of a 448-position cache. (B, Sq, Skv, H, KV, hd)
WHISPER_FLASH_SHAPES = {"encoder": (1, 1500, 1500, 12, 12, 64),
                        "cross prefill": (1, 64, 1500, 12, 12, 64),
                        "cross decode": (8, 1, 1500, 12, 12, 64)}
WHISPER_DECODE_SHAPE = (8, 448, 12, 12, 64, 64)     # B, S, H, KV, dqk, dv
WHISPER_MAX_LEN = 448                                # the published text context
# bf16 slice of whisper-small: both paths round attention outputs to bf16 in
# 12 encoder layers and twice in each of 12 decoder layers at prefill (36
# rounding points, against qwen2's 24 and mamba2's 64), and the logits are
# bf16 products (one ulp is 2^-5 at |logit| 4..8). Held as the mamba2 slice
# is: max|dlogit| within 16 such ulps, and every top-1 disagreement a near-tie
# within that same margin.
SLICE_ENCDEC_BF16_TOL = 0.5
# each request's side input (whisper's frames, internvl2's patches), standard
# normal from this numpy seed
SIDE_SEED = 3

VLM_ARCH = "internvl2-26b"
# its attention: GQA, 48 query heads over 8 KV heads (G = 6), hd 128; prefill of
# one request's 256 patches + 512 tokens, decode over 8 slots of 1024 positions
VLM_PREFILL_SHAPE = (1, 768, 48, 8, 128, 128)
VLM_DECODE_SHAPE = (8, 1024, 48, 8, 128, 128)
# the f32 check of the VLM slice runs 8 of the 48 layers (a depth cut): the
# full-width f32 model is 79.6 GB and does not fit on the card; 8 layers and
# the f32 embedding and unembedding are 17.2 GB
VLM_F32_LAYERS = 8
# bf16 slice of internvl2-26b, held as the other families past qwen2 are: both
# paths round attention outputs to bf16 in 48 layers (twice qwen2's 24), and
# the logits are bf16 products (one ulp is 2^-5 at |logit| 4..8). Held:
# max|dlogit| within 16 such ulps, and every top-1 disagreement a near-tie
# within that same margin.
SLICE_VLM_BF16_TOL = 0.5


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


def _prefill_case(gen, B, Sq, Skv, H, KV, hd, dtype, causal, dv=None, **kw):
    """hd is q's and k's head dim, dv v's (hd when None)."""
    q = randn(gen, (B, Sq, H, hd), dtype)
    k = randn(gen, (B, Skv, KV, hd), dtype)
    v = randn(gen, (B, Skv, KV, dv or hd), dtype)
    out = attn_kernel.flash_attention(q, k, v, causal=causal, **kw)
    torch.cuda.synchronize()
    exp = attn_ref.mha_reference(q, k, v, causal=causal, **kw)
    what = f"flash {tuple(q.shape)} kv {Skv}x{KV} dv {dv or hd} causal={causal} {kw} {dtype}"
    return max_err(out, exp, TOL[dtype], what), (q, k, v)


def _decode_case(gen, B, S, H, KV, hd, dtype, pos, dv=None, scale=None):
    q = randn(gen, (B, 1, H, hd), dtype)
    kc = randn(gen, (B, S, KV, hd), dtype)
    vc = randn(gen, (B, S, KV, dv or hd), dtype)
    out = attn_kernel.decode_attention(q, kc, vc, pos, scale=scale)
    torch.cuda.synchronize()
    exp = attn_ref.decode_attention_reference(q, kc, vc, pos, scale=scale)
    what = f"decode B={B} S={S} H={H} KV={KV} dqk={hd} dv={dv or hd} {dtype}"
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
    _attn_slice_rows(gen, MOE_PREFILL_SHAPE, MOE_DECODE_SHAPE, pos_np, MOE_ARCH)
    pos_mla = pos_np.copy()
    pos_mla[1] = -1                           # and a row of length 0
    _attn_slice_rows(gen, MLA_PREFILL_SHAPE, MLA_DECODE_SHAPE, pos_mla, MLA_ARCH, scale=MLA_SCALE)
    _whisper_attn_rows(gen)
    _attn_slice_rows(gen, VLM_PREFILL_SHAPE, VLM_DECODE_SHAPE, pos_np, VLM_ARCH)
    return rows


def _sdpa_backends(call) -> str:
    """Which of PyTorch's SDPA backends take ``call()``'s inputs, each with
    its time (ms), for the record beside ``library_ms`` (the default
    dispatch)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(b):
                call()
                torch.cuda.synchronize()
                out.append(f"{b.name} {cuda_ms(call):.4f}")
        except RuntimeError:
            out.append(f"{b.name} refuses")
    return ", ".join(out)


def _attn_slice_rows(gen, prefill_shape, decode_shape, pos_np, arch, scale=None) -> dict:
    """Both attention kernels at one slice's shapes ((B, S, H, KV, dqk, dv)
    each), f32 and bf16 against the plain version; timed in bf16 (the serve
    dtype)."""
    rows = {}
    B, S, H, KV, dqk, dv = decode_shape
    pos = torch.from_numpy(pos_np).to(DEVICE)
    Bp, Sp, Hp, KVp, dqkp, dvp = prefill_shape
    for dtype in (torch.float32, torch.bfloat16):
        err_p, (q, k, v) = _prefill_case(gen, Bp, Sp, Sp, Hp, KVp, dqkp, dtype, True, dv=dvp,
                                         scale=scale)
        err_d, (qd, kc, vc) = _decode_case(gen, B, S, H, KV, dqk, dtype, pos, dv=dv,
                                           scale=scale)
        say("kernels", f"{arch} shapes {dtype}: prefill {prefill_shape} max_abs_err "
                       f"{err_p:.3e}, decode {decode_shape} (pos {pos_np.tolist()}) "
                       f"max_abs_err {err_d:.3e}")
    # timing in bf16 (q, k, v ... from the bf16 pass above)
    pairs = Sp * (Sp + 1) // 2                       # causal: keys each query row needs
    p_bytes = (q.numel() + k.numel() + v.numel() + Bp * Sp * Hp * dvp) * q.element_size()
    p_flops = 2 * Bp * pairs * Hp * (dqkp + dvp)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa_prefill():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True,
                                              scale=scale)

    rows["flash_attention"] = dict(
        max_abs_err=err_p,
        ms=cuda_ms(lambda: attn_kernel.flash_attention(q, k, v, causal=True, scale=scale)),
        plain_ms=cuda_ms(lambda: attn_ref.mha_reference(q, k, v, causal=True, scale=scale)),
        library_ms=cuda_ms(sdpa_prefill),
        backends=_sdpa_backends(sdpa_prefill),
        bound=bound(p_bytes, p_flops, torch.bfloat16),
        work=f"{p_flops/1e9:.3f} GFLOP, {p_bytes/1e6:.3f} MB",
    )
    lens = np.maximum(pos_np.astype(np.int64) + 1, 0)
    d_bytes = ((int(lens.sum()) * KV + B * H) * (dqk + dv)) * qd.element_size() + 4 * B
    d_flops = 2 * int(lens.sum()) * H * (dqk + dv)
    qdt = qd.transpose(1, 2).contiguous()
    kct, vct = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=DEVICE)[None, :] < pos[:, None] + 1)[:, None, None, :]

    def sdpa_decode():
        return F.scaled_dot_product_attention(qdt, kct, vct, attn_mask=mask, enable_gqa=True,
                                              scale=scale)

    rows["decode_attention"] = dict(
        max_abs_err=err_d,
        ms=cuda_ms(lambda: attn_kernel.decode_attention(qd, kc, vc, pos, scale=scale)),
        plain_ms=cuda_ms(lambda: attn_ref.decode_attention_reference(qd, kc, vc, pos,
                                                                     scale=scale)),
        library_ms=cuda_ms(sdpa_decode),
        backends=_sdpa_backends(sdpa_decode),
        bound=bound(d_bytes, d_flops, torch.bfloat16),
        work=f"{d_flops/1e9:.4f} GFLOP, {d_bytes/1e6:.3f} MB",
    )
    for name, r in rows.items():
        say("kernels", f"{arch} {name} bf16: kernel {r['ms']:.4f} ms, plain "
                       f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms (default "
                       f"dispatch; by backend: {r['backends']}), bound "
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


def _idle_slot(*tensors) -> None:
    """Row 0 of each (B, S, ...) tensor set to zeros: an engine slot no
    request holds, whose cache admission never wrote."""
    for t in tensors:
        t[0].zero_()


def _whisper_attn_rows(gen) -> None:
    """whisper-small's attention calls against their plain versions, f32 and
    bf16, each with a row of all-zero keys and values where the call reads a
    slot of the engine's cache; timed in bf16 beside SDPA by backend. Beside
    the Sq = 1 cross row, ``decode_attention`` at pos Skv - 1 on the same
    tensors: the same function by the other kernel (a number for the roadmap,
    not a switch)."""
    arch = ENCDEC_ARCH
    for what, (B, Sq, Skv, H, KV, hd) in WHISPER_FLASH_SHAPES.items():
        idle = what == "cross decode"
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, Sq, H, hd), dtype)
            k, v = randn(gen, (B, Skv, KV, hd), dtype), randn(gen, (B, Skv, KV, hd), dtype)
            if idle:
                _idle_slot(k, v)
            out = attn_kernel.flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            exp = attn_ref.mha_reference(q, k, v, causal=False)
            errs[dtype] = max_err(out, exp, TOL[dtype], f"{arch} flash {what} {dtype}")
            if idle and not torch.equal(out[0], torch.zeros_like(out[0])):
                raise AssertionError(f"{arch} flash {what} {dtype}: the idle slot's rows are "
                                     "not zeros")
        if idle:   # the same function by the decode kernel, on the same tensors
            pos = torch.full((B,), Skv - 1, dtype=torch.int32, device=DEVICE)
            dec = attn_kernel.decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
            dec_err = max_err(dec, attn_ref.mha_reference(q, k, v, causal=False),
                              TOL[torch.bfloat16], f"{arch} decode_attention as {what}")
        io_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
        flops = 2 * B * Sq * Skv * H * 2 * hd
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt)

        t = dict(ms=cuda_ms(lambda: attn_kernel.flash_attention(q, k, v, causal=False)),
                 plain=cuda_ms(lambda: attn_ref.mha_reference(q, k, v, causal=False)),
                 sdpa=cuda_ms(sdpa), backends=_sdpa_backends(sdpa),
                 bound=bound(io_bytes, flops, torch.bfloat16))
        say("kernels", f"{arch} flash {what} q {(B, Sq, H, hd)} kv {(B, Skv, KV, hd)} "
                       f"non-causal{' (row 0 an idle slot: zeros)' if idle else ''}: "
                       f"max_abs_err {errs[torch.float32]:.3e} (f32), "
                       f"{errs[torch.bfloat16]:.3e} (bf16); bf16 kernel {t['ms']:.4f} ms, plain "
                       f"{t['plain']:.4f} ms, sdpa {t['sdpa']:.4f} ms (default dispatch; by "
                       f"backend: {t['backends']}), bound {t['bound'][0]:.5f} ms by "
                       f"{t['bound'][1]} ({flops / 1e9:.3f} GFLOP, {io_bytes / 1e6:.3f} MB)")
        if idle:
            dec_ms = cuda_ms(lambda: attn_kernel.decode_attention(q, k, v, pos))
            say("kernels", f"{arch} the same {what} function by decode_attention (pos "
                           f"{Skv - 1}, every key valid; timed only, the path calls flash as "
                           f"the reference does): max_abs_err {dec_err:.3e} (bf16), kernel "
                           f"{dec_ms:.4f} ms against flash's {t['ms']:.4f} ms")
    # the decoder's self-attention decode over the 448-position cache
    B, S, H, KV, dqk, dv = WHISPER_DECODE_SHAPE
    pos_np = np.random.default_rng(5).integers(4, S - 1, B).astype(np.int32)
    pos_np[0], pos_np[-1] = 0, S - 1      # an idle slot (zero cache, pos 0) and a full row
    pos = torch.from_numpy(pos_np).to(DEVICE)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (B, 1, H, dqk), dtype)
        kc, vc = randn(gen, (B, S, KV, dqk), dtype), randn(gen, (B, S, KV, dv), dtype)
        _idle_slot(kc, vc)
        out = attn_kernel.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        exp = attn_ref.decode_attention_reference(q, kc, vc, pos)
        errs[dtype] = max_err(out, exp, TOL[dtype], f"{arch} self decode {dtype}")
    lens = pos_np.astype(np.int64) + 1
    d_bytes = (int(lens.sum()) * KV + B * H) * (dqk + dv) * q.element_size() + 4 * B
    d_flops = 2 * int(lens.sum()) * H * (dqk + dv)
    qt, kct, vct = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    mask = (torch.arange(S, device=DEVICE)[None, :] < pos[:, None] + 1)[:, None, None, :]

    def sdpa_decode():
        return F.scaled_dot_product_attention(qt, kct, vct, attn_mask=mask)

    t = dict(ms=cuda_ms(lambda: attn_kernel.decode_attention(q, kc, vc, pos)),
             plain=cuda_ms(lambda: attn_ref.decode_attention_reference(q, kc, vc, pos)),
             sdpa=cuda_ms(sdpa_decode), backends=_sdpa_backends(sdpa_decode),
             bound=bound(d_bytes, d_flops, torch.bfloat16))
    say("kernels", f"{arch} self decode {WHISPER_DECODE_SHAPE} (pos {pos_np.tolist()}, row 0 "
                   f"an idle slot): max_abs_err {errs[torch.float32]:.3e} (f32), "
                   f"{errs[torch.bfloat16]:.3e} (bf16); bf16 kernel {t['ms']:.4f} ms, plain "
                   f"{t['plain']:.4f} ms, sdpa {t['sdpa']:.4f} ms (default dispatch; by "
                   f"backend: {t['backends']}), bound {t['bound'][0]:.5f} ms by "
                   f"{t['bound'][1]} ({d_flops / 1e9:.4f} GFLOP, {d_bytes / 1e6:.3f} MB)")


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
                           "D = 896, 320 at 2560; at D = 6144 (internvl2-26b) 384 threads "
                           "of two 8-wide chunks")
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


def _teacher_forced(model: Model, tokens: np.ndarray, n_prefill: int,
                    side=None) -> torch.Tensor:
    """Logits at the last prefill position and after each teacher-forced decode
    step: (steps + 1, B, V). ``side`` (``_random_side``): the encoder-decoder's
    frames or the VLM's patches, one row a prompt; a VLM's positions count
    its patches."""
    B, total = tokens.shape
    P = prefix_len(model.cfg)
    tok = torch.from_numpy(tokens).to(DEVICE)
    batch = {"tokens": tok[:, :n_prefill]}
    if side is not None:
        batch[side[0]] = torch.from_numpy(side[1]).to(DEVICE)
    logits, seq_cache = model.prefill(batch)
    cache = model.init_cache(B, P + total)
    _blit(cache, seq_cache)
    out = [logits]
    for i in range(total - n_prefill):
        pos = torch.full((B,), P + n_prefill + i, dtype=torch.int32, device=DEVICE)
        logits, cache = model.decode_step(tok[:, n_prefill + i:n_prefill + i + 1], cache, pos)
        out.append(logits)
    return torch.stack(out)


def _random_side(cfg, n: int, seed: int):
    """n requests' side inputs (``SIDE_INPUTS``: whisper's frames, (enc_seq,
    d_model); internvl2's patches, (n_patches, d_model)), f32 standard normal
    from a numpy seed, as (name, an (n, rows, d_model) array); None for a
    family that takes none."""
    spec = SIDE_INPUTS.get(cfg.family)
    if spec is None:
        return None
    name, rows = spec
    rng = np.random.default_rng(seed)
    return name, rng.standard_normal((n, getattr(cfg, rows), cfg.d_model)).astype(np.float32)


def _side_kw(side, i: int) -> dict:
    """Request i's side input as the keyword the entry points take, or none."""
    return {} if side is None else {side[0]: side[1][i]}


def _side_rows(side, rows: slice):
    return None if side is None else (side[0], side[1][rows])


class _RouteLog:
    """While active, records the top-k expert ids of every ``moe.route``
    call, in call order (layer by layer, prefill then each decode step)."""

    def __enter__(self) -> list:
        self._route, self.topi = moe.route, []

        def recording(*args, **kw):
            topw, topi, probs = self._route(*args, **kw)
            self.topi.append(topi)
            return topw, topi, probs

        moe.route = recording
        return self.topi

    def __exit__(self, *exc) -> None:
        moe.route = self._route


def _route_flips(got: list, want: list) -> tuple:
    """(tokens x layers whose top-k expert set differs between two runs of
    the same calls, tokens x layers routed)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} route calls against {len(want)}")
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(got, want))
    return flips, sum(a.shape[0] for a in got)


def phase_slice(arch: str, tag: str, bf16_tol: float, f32_layers: int = 0) -> Model:
    """Kernel path against plain path on the same weights, f32 (at
    ``f32_layers`` layers when given: a depth cut, the MoE's 8 of 24 and the
    VLM's 8 of 48) then bf16 at full depth, each prompt with its own side
    input (whisper's frames, internvl2's 256 patches before the prompt); the
    MoE's routing flips between the two paths are counted and printed."""
    cfg = get_config(arch)
    B, n_prefill, steps = 4, 384, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, n_prefill + steps))
    tokens = tokens.astype(np.int32)
    side = _random_side(cfg, B, SIDE_SEED)
    patches = f" after {cfg.n_patches} patches" if prefix_len(cfg) else ""
    model = None
    for dtype in ("float32", "bfloat16"):
        del model
        torch.cuda.empty_cache()
        n_layers = f32_layers if dtype == "float32" and f32_layers else cfg.n_layers
        model = Model(cfg.with_(dtype=dtype, n_layers=n_layers), device=DEVICE).init(
            torch.Generator(device=DEVICE).manual_seed(0))
        model.kernel_impl = "auto"
        with _RouteLog() as got_routes:
            got = _teacher_forced(model, tokens, n_prefill, side)
        model.kernel_impl = "ref"
        with _RouteLog() as want_routes:
            want = _teacher_forced(model, tokens, n_prefill, side)
        model.kernel_impl = "auto"
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{tag} {dtype}: non-finite logits")
        diff = (got - want).abs().max().item()
        got_top, want_top = got.argmax(-1), want.argmax(-1)
        top1 = (got_top == want_top).float().mean().item()
        # how far below its own top logit the plain path ranks the kernel's pick
        gap = (want.amax(-1) - want.gather(-1, got_top[..., None])[..., 0]).max().item()
        positions = got.shape[0] * got.shape[1]
        routing = ""
        if cfg.family == "moe":
            flips, routed = _route_flips(got_routes, want_routes)
            routing = (f"; routing flips (tokens x layers whose top-{cfg.moe.top_k} expert set "
                       f"differs between the paths) {flips} of {routed}")
        say(tag, f"{arch} {dtype}, {n_layers} layers: {B}x{n_prefill} prefill{patches} + "
                 f"{steps} decode "
                 f"steps, {positions} positions: max|dlogit| {diff:.3e}, top-1 agreement "
                 f"{top1:.4f}, largest near-tie gap {gap:.3e} (logit range "
                 f"{want.min().item():.2f}..{want.max().item():.2f}){routing}")
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
# (decode_attention: the split-KV pass, then the combine; flash_attention,
# the encoder-decoder's cross-attention, one); ssd runs only in prefill
STEP_DEVICE_LAUNCHES = {"decode_attention": 2, "fused_add_rmsnorm": 1, "flash_attention": 1}


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


def _serve_run(model: Model, prompts, new_tokens: int, cuda_graph: bool, max_len: int = 1024,
               side=None) -> dict:
    """One engine (max_batch 8, `max_len`) serves `prompts` (each with its
    row of `side`: the encoder-decoder's frames, the VLM's patches); the
    launch counters are reset just before the requests are submitted and read
    just after they are drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = _TimedEngine(model, max_batch=8, max_len=max_len, cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()     # the graph's pool stays reserved, not allocated
    for mod in KERNEL_MODULES:                 # the run starts here
        mod.reset_launches()
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=new_tokens, **_side_kw(side, i))
            for i, p in enumerate(prompts)]
    engine.run_until_drained(timeout=900)
    wall = time.monotonic() - t0
    launches = {k: v for mod in KERNEL_MODULES for k, v in mod.LAUNCHES.items()}  # ... and here
    return dict(engine=engine, reqs=reqs, wall=wall, launches=launches, build_s=build_s,
                peak=torch.cuda.max_memory_allocated(),
                peak_reserved=torch.cuda.max_memory_reserved())


def _check_streams(model: Model, prompts, got, want, tol: float, tag: str,
                   names=("graphed", "eager"), side=None) -> int:
    """Two runs' token streams (lists of tokens), request by request: where
    they part, both tokens must be a near-tie, each within ``tol`` of the top
    logit of an eager B = 1 prefill of the prompt and the common prefix (with
    the request's row of `side`: the encoder-decoder's frames, the VLM's
    patches). Returns the number of requests whose streams part."""
    parted = 0
    for i, (p, g, e) in enumerate(zip(prompts, got, want)):
        j = next((j for j, (a, b) in enumerate(zip(g, e)) if a != b), None)
        if j is None:
            continue
        parted += 1
        seq = np.concatenate([np.asarray(p), np.asarray(g[:j])]).astype(np.int64)
        batch = {"tokens": torch.from_numpy(seq[None]).to(DEVICE)}
        if side is not None:
            batch[side[0]] = torch.from_numpy(side[1][i][None]).to(DEVICE)
        with torch.inference_mode():
            logits, _ = model.prefill(batch)
        top = logits[0].max().item()
        gaps = [top - logits[0, t].item() for t in (g[j], e[j])]
        say(tag, f"request {i} parts at token {j}: {names[0]} {g[j]}, {names[1]} "
                 f"{e[j]}, below the top logit by {gaps[0]:.3e} / {gaps[1]:.3e}")
        if max(gaps) > tol:
            raise AssertionError(f"{tag}: request {i}'s streams part at token {j} by more "
                                 f"than a near-tie ({max(gaps):.3e} > {tol})")
    return parted


def _launch_floor(cfg, n_req: int, steps: int) -> dict:
    """The least calls of each kernel a serve run of `n_req` prefills and
    `steps` decode steps makes on this family's path."""
    L = cfg.n_layers
    if cfg.family == "encdec":
        # a prefill: the encoder's, the causal self and the cross flash calls
        # in every layer; a step: cross-attention by flash (Sq = 1) and self
        # decode attention in every decoder layer; LayerNorms, no add + norm
        return {"flash_attention": n_req * (cfg.n_enc_layers + 2 * L) + steps * L,
                "decode_attention": steps * L}
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
    the same 16 through an eager one. Returns the launches of the kernels on
    this family's path, counted over the graphed run alone, the prompts, the
    graphed run's token streams and its summary, for the fabric phases."""
    cfg = model.cfg
    encdec = cfg.family == "encdec"
    n_req, new_tokens, max_batch = 16, 64, 8
    # the encoder-decoder at whisper's published text context, short prompts
    max_len, lo, hi = (WHISPER_MAX_LEN, 4, 64) if encdec else (1024, 64, 512)
    # warm-up through the same entry points (cuBLAS handles, allocator)
    warm = ServeEngine(model, max_batch=2, max_len=prefix_len(cfg) + 128)
    warm.submit(np.arange(16) % cfg.vocab, max_new_tokens=4)
    warm.run_until_drained(timeout=300)
    del warm

    rng = np.random.default_rng(2)
    lens = rng.integers(lo, hi + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]
    side = _random_side(cfg, n_req, SIDE_SEED)
    own = f", each with its own random {side[0]}" if side else ""
    say(tag, f"{cfg.name} bf16, {n_req} requests (prompts {lens.min()}..{lens.max()} "
             f"tokens, {new_tokens} new each{own}"
             f"), max_batch {max_batch}, max_len {max_len}; "
             f"cache {kv_cache.summarize(cfg, max_batch, max_len)}")

    runs = {}
    for mode, cuda_graph in (("graphed", True), ("eager", False)):
        run = runs[mode] = _serve_run(model, prompts, new_tokens, cuda_graph, max_len, side)
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
        if cfg.family in ("encdec", "vlm") and any(launches[k] != n for k, n in need.items()):
            raise AssertionError(f"{mode} launch counters {launches} are not exactly {need}")
        total = sum(len(r.tokens) for r in reqs)
        ttft = np.array([(r.first_token_at - r.submitted) * 1e3 for r in reqs])
        run["summary"] = dict(tokens_s=total / run["wall"], ttft_p50=np.percentile(ttft, 50),
                              ttft_p99=np.percentile(ttft, 99),
                              step_median_ms=np.median(engine.step_s) * 1e3)
        say(tag, f"{mode}: {total} tokens in {run['wall']:.3f} s = {total / run['wall']:.1f} "
                 f"tokens/s; TTFT p50 {np.percentile(ttft, 50):.1f} ms, p99 "
                 f"{np.percentile(ttft, 99):.1f} ms (16 samples); {engine.steps} decode steps, "
                 f"mean {np.mean(engine.step_s) * 1e3:.3f} ms, median "
                 f"{np.median(engine.step_s) * 1e3:.3f} ms; max_memory_allocated "
                 f"{run['peak'] / 2**30:.3f} GiB, max_memory_reserved "
                 f"{run['peak_reserved'] / 2**30:.3f} GiB; engine built in "
                 f"{run['build_s']:.3f} s")
        say(tag, f"{mode}: launches {launches} (need >= {need}, none of {list(absent)})")
        say(tag, f"{mode}: step mean {np.mean(engine.step_s) * 1e3:.3f} ms, median "
                 f"{np.median(engine.step_s) * 1e3:.3f} ms against "
                 f"{_step_bound(model, max_batch, max_len)}")
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
    graphed = [r.tokens for r in runs["graphed"]["reqs"]]
    eager = [r.tokens for r in runs["eager"]["reqs"]]
    parted = _check_streams(model, prompts, graphed, eager, bf16_tol, tag, side=side)
    say(tag, f"graphed and eager token streams: {n_req - parted} of {n_req} requests equal; "
             f"{parted} part, each at a near-tie within {bf16_tol:g}")
    launches = runs["graphed"]["launches"]
    return dict(launches={k: launches[k]
                          for k in _launch_floor(cfg, n_req, runs["graphed"]["steps"])},
                prompts=prompts, streams=graphed, new_tokens=new_tokens,
                direct=runs["graphed"]["summary"], side=side, max_len=max_len)


def _step_bound(model: Model, max_batch: int, max_len: int) -> str:
    """The least time of a decode step by bytes: the weights every step reads
    once, at HBM's rate, plus at most the whole cache. Left out are a table
    the step only gathers rows of (an untied embedding), what runs only at
    prefill (an encoder, the cross-attention's K/V projections, a VLM's patch
    projection), and all but top_k of each MoE layer's n_experts routed
    experts (the fewest a step can read)."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    prefill_only = ("enc_", "patch_proj", "layers.cross.wk", "layers.cross.wv")
    routed = ("layers.ffn.wi", "layers.ffn.wg", "layers.ffn.wo")
    w = 0.0
    for n, p in params.items():
        if n.startswith(prefill_only) or (n == "embed.tok" and "unembed.w" in params):
            continue
        share = cfg.moe.top_k / cfg.moe.n_experts if cfg.moe and n in routed else 1.0
        w += p.numel() * p.element_size() * share
    kv = kv_cache.cache_bytes(cfg, max_batch, max_len)
    return (f"a byte bound of {w / HBM_BYTES_S * 1e3:.3f} ms (its {w / 1e9:.3f} GB of weights "
            f"read once at 3.35 TB/s) plus at most {kv / HBM_BYTES_S * 1e3:.3f} ms of cache "
            f"({kv / 1e9:.3f} GB at {max_batch} x {max_len})")


# ------------------------------------------------------------------ the fabric
def _launch_counts() -> dict:
    return {k: v for mod in KERNEL_MODULES for k, v in mod.LAUNCHES.items()}


def _reset_launches() -> None:
    for mod in KERNEL_MODULES:
        mod.reset_launches()


def _check_launches(tag: str, launches: dict, need: dict) -> None:
    """Every kernel of the family's path launched at least its floor in the
    phase's run, and no other kernel of the port."""
    absent = [k for k in launches if k not in need]
    if any(launches[k] < n for k, n in need.items()) or any(launches[k] for k in absent):
        raise AssertionError(f"{tag}: launch counters {launches} do not meet {need}: the "
                             "fabric path skipped a kernel or ran another family's")
    say(tag, f"launches {launches} (need >= {need}, none of {absent})")


def phase_fabric_frontdoor(model: Model, served: dict, tol: float) -> dict:
    """The serve phase's 16 prompts as fabric tasks through the serve driver's
    path (FunctionService -> Forwarder -> Endpoint -> worker -> a pass-through
    ``generate`` on a graphed ServeEngine), held to the serve phase's graphed
    streams. Returns the run's launches."""
    tag = "fabric-frontdoor"
    cfg = model.cfg
    prompts, new_tokens = served["prompts"], served["new_tokens"]
    engine = _TimedEngine(model, max_batch=8, max_len=1024)
    torch.cuda.synchronize()
    _reset_launches()                          # the run starts here
    outs, wall = serve_through_front_door(engine, prompts, new_tokens, timeout=900)
    launches = _launch_counts()                 # ... and ends here
    for i, o in enumerate(outs):
        toks = [int(t) for t in o["tokens"]]
        if len(toks) != new_tokens or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{tag}: request {i} returned {len(toks)} tokens of "
                                 f"{new_tokens}, or one out of range")
    streams = [[int(t) for t in o["tokens"]] for o in outs]
    parted = _check_streams(model, prompts, streams, served["streams"], tol, tag,
                            names=("front door", "direct"))
    total = sum(len(s) for s in streams)
    ttft = np.array([o["ttft_ms"] for o in outs])
    client_ttft = np.array([o["client_ttft_ms"] for o in outs])
    d = served["direct"]
    say(tag, f"{cfg.name} bf16, {len(prompts)} requests through one endpoint of 2 workers: "
             f"{total} tokens in {wall:.3f} s = {total / wall:.1f} tokens/s (direct engine "
             f"{d['tokens_s']:.1f}); TTFT in the engine p50 {np.percentile(ttft, 50):.1f} ms, "
             f"p99 {np.percentile(ttft, 99):.1f} ms; from service.run p50 "
             f"{np.percentile(client_ttft, 50):.1f} ms, p99 {np.percentile(client_ttft, 99):.1f} "
             f"ms (direct engine p50 {d['ttft_p50']:.1f} ms, p99 {d['ttft_p99']:.1f} ms); "
             f"{engine.steps} decode steps, median {np.median(engine.step_s) * 1e3:.3f} ms "
             f"(direct {d['step_median_ms']:.3f})")
    say(tag, f"streams against the serve phase's graphed engine: {len(prompts) - parted} of "
             f"{len(prompts)} equal; {parted} part, each at a near-tie within {tol:g}")
    _check_launches(tag, launches, _launch_floor(cfg, len(prompts), engine.steps))
    del engine
    torch.cuda.empty_cache()
    return launches


def _fabric_service(model: Model, name: str, n_endpoints: int, journal_dir: str,
                    fabric_mod=fabric, **serve_kw):
    """A service with a journal and `n_endpoints` endpoints, each one pool of
    the ``torch`` capability, serving `model` under `name` (through
    ``fabric_mod.serve_model``: the port's fabric unless another build of it
    is given)."""
    svc = FunctionService(journal_dir=journal_dir)
    spec = ContainerSpec(name="torch", capabilities={"cpu", "torch"}, min_workers=0,
                         max_workers=16)
    eps = [svc.make_endpoint(f"{name}-site{i}", n_executors=1, containers=[spec])
           for i in range(n_endpoints)]
    client = fabric_mod.serve_model(svc, model, name=name, **serve_kw)
    # each endpoint builds its host (for a batched host, the graph capture)
    # with its first task: one short session per endpoint, outside the timing
    for ep in eps:
        with client.session(np.arange(8) % model.cfg.vocab, endpoint_id=ep.endpoint_id) as s:
            list(s.stream(3))
    return svc, eps, client


def _counters(svc) -> dict:
    return dict(svc.metrics.snapshot()["counters"])


def _fabric_users(client, prompts, new_tokens: int, kill=None, side=None) -> list:
    """One client thread per prompt: a session (with its row of `side`: the
    encoder-decoder's frames, the VLM's patches) streams `new_tokens` tokens
    (``ServingClient.generate``'s loop, each step timed as the client sees
    it). With ``kill``,
    every thread waits after its third step while ``kill(sessions)`` runs.
    Returns one dict per session."""
    out = [None] * len(prompts)
    errors = []
    barrier = threading.Barrier(len(prompts) + 1) if kill else None
    sessions = [None] * len(prompts)

    def user(k):
        try:
            with client.session(prompts[k], timeout=300, **_side_kw(side, k)) as s:
                sessions[k] = s
                steps, t = [], time.perf_counter()
                for j, _ in enumerate(s.stream(new_tokens, timeout=300)):
                    now = time.perf_counter()
                    if j:
                        steps.append(now - t)
                    if barrier is not None and j == 3:
                        barrier.wait(timeout=300)
                        barrier.wait(timeout=300)
                    t = time.perf_counter()
                out[k] = dict(tokens=list(s.tokens), ttft=s.ttft_s, steps=steps,
                              endpoints=list(s.endpoints), migrations=s.migrations)
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append(exc)
            if barrier is not None:
                barrier.abort()

    threads = [threading.Thread(target=user, args=(k,)) for k in range(len(prompts))]
    for t in threads:
        t.start()
    if kill:
        barrier.wait(timeout=600)              # every session has made its third step
        kill(sessions)
        barrier.wait(timeout=600)              # ... and each goes on
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    if any(o is None for o in out):
        raise AssertionError("a client thread did not finish")
    return out


def _codec_us(history: list, reps: int = 200) -> float:
    """Median host time (us) of one decode task's payload through the wire
    codec: ``serializer.packb`` at the service, ``unpackb`` at the worker."""
    doc = {"model": "qwen2-0.5b", "session": "s-0123456789ab", "tokens": history}
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        serializer.unpackb(serializer.packb(doc))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def _graph_step_ms(host, reps: int = 50) -> float:
    """Median device time of one replay of a host's decode graph (CUDA events,
    the raw graph, so no launch is counted)."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        host._graph.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _fabric_run(model: Model, run: str, prompts, new_tokens: int, n_endpoints: int,
                kill: bool = False, fabric_mod=fabric, max_len: int = 1024, side=None,
                **serve_kw) -> dict:
    """One fabric run on a fresh journaled service, its hosts warmed first: a
    client thread per prompt streams its session (with its row of `side`);
    with ``kill``, the endpoint holding the first session is killed after
    every session's third step. The launch counters are reset just before the
    sessions open and read just after they close. Returns the run's numbers."""
    name = f"{model.cfg.name}-{run}"
    with tempfile.TemporaryDirectory() as journal_dir:
        svc, eps, client = _fabric_service(model, name, n_endpoints, journal_dir, fabric_mod,
                                           max_len=max_len, max_sessions=8, **serve_kw)
        by_id = {ep.endpoint_id: ep for ep in eps}
        killed = []

        def kill_home(sessions):
            victim = by_id[sessions[0].endpoints[-1]]
            victim.kill()
            svc.forwarder.check_endpoints()
            killed.append(victim.endpoint_id)

        try:
            before = _counters(svc)
            torch.cuda.synchronize()
            _reset_launches()                   # the run starts here
            t0 = time.monotonic()
            outs = _fabric_users(client, prompts, new_tokens, kill=kill_home if kill else None,
                                 side=side)
            wall = time.monotonic() - t0
            launches = _launch_counts()          # ... and ends here
            after = _counters(svc)
            merged = svc.metrics.histogram("serving.merged_per_step")
            max_merged = merged.percentile(100) if merged.count else 0
            dup = svc.journal.state().duplicate_completions
            hosts = [ep.site.get_or_create(("serving-host", name), None) for ep in eps]
            step_ms = _graph_step_ms(hosts[0]) if hosts[0]._graph is not None else None
        finally:
            svc.shutdown()
            fabric_mod.reset_serving()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return dict(outs=outs, wall=wall, launches=launches, delta=delta, dup=dup,
                max_merged=max_merged, step_ms=step_ms, batching=hosts[0].batching,
                killed=killed)


def _report_fabric_run(model: Model, tag: str, run: str, r: dict, prompts, want,
                       new_tokens: int, tol: float, hold_streams: bool = True,
                       side=None) -> None:
    """Check one run (every session's tokens, the streams against `want`
    under the near-tie rule unless ``hold_streams`` is False, one affinity
    hit per decode task, no duplicate commitment in the journal, the kernels'
    floor) and print its numbers."""
    cfg = model.cfg
    outs, delta = r["outs"], r["delta"]
    for i, o in enumerate(outs):
        if len(o["tokens"]) != new_tokens or not all(0 <= t < cfg.vocab for t in o["tokens"]):
            raise AssertionError(f"{tag} {run}: session {i} ended with {len(o['tokens'])} "
                                 f"tokens of {new_tokens}, or one out of range")
    streams, direct = [o["tokens"] for o in outs], [w[:new_tokens] for w in want]
    if hold_streams:
        parted = _check_streams(model, prompts, streams, direct, tol, f"{tag} {run}",
                                names=("fabric", "direct"), side=side)
        held = f"each at a near-tie within {tol:g}"
    else:
        parted = sum(g != d for g, d in zip(streams, direct))
        held = "not held (the capacity drops depend on which slots share a step)"
    migrations = sum(o["migrations"] for o in outs)
    decode_tasks = sum(len(o["steps"]) for o in outs)
    if delta.get("serving.affinity_hits", 0) != decode_tasks - migrations:
        raise AssertionError(f"{tag} {run}: {delta.get('serving.affinity_hits', 0)} affinity "
                             f"hits for {decode_tasks} decode tasks ({migrations} migrated)")
    if r["dup"] != 0:
        raise AssertionError(f"{tag} {run}: journal.duplicate_completions = {r['dup']}")
    batches = delta.get("serving.decode_batches", 0)
    steps = batches if r["batching"] else delta.get("serving.affinity_hits", 0)
    _check_launches(f"{tag} {run}", r["launches"],
                    _launch_floor(cfg, delta.get("serving.prefills", 0), steps))
    total = sum(len(o["tokens"]) for o in outs)
    ttft = np.array([o["ttft"] * 1e3 for o in outs])
    task_ms = np.mean([t for o in outs for t in o["steps"]]) * 1e3
    say(tag, f"{run}: {len(outs)} sessions x {new_tokens} tokens, "
             f"{'batched' if r['batching'] else 'unbatched'} hosts: {total} tokens in "
             f"{r['wall']:.3f} s = {total / r['wall']:.1f} tokens/s; TTFT p50 "
             f"{np.percentile(ttft, 50):.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms; "
             f"{decode_tasks} decode tasks, mean wall as the client sees it {task_ms:.3f} ms; "
             f"{batches} batched steps (largest merge {r['max_merged']:g}); "
             f"{delta.get('serving.affinity_hits', 0)} affinity hits, {migrations} migrated, "
             f"{delta.get('serving.cache_migrations', 0)} re-prefills; "
             f"journal.duplicate_completions {r['dup']}"
             + (f"; graphed step device time {r['step_ms']:.4f} ms (CUDA events, median of 50)"
                if r["step_ms"] is not None else ""))
    say(tag, f"{run}: streams against the direct graphed engine: {len(outs) - parted} of "
             f"{len(outs)} equal; {parted} part, {held}")
    r.update(decode_tasks=decode_tasks, migrations=migrations, batches=batches,
             tokens_s=total / r["wall"], ttft_p50=np.percentile(ttft, 50),
             ttft_p99=np.percentile(ttft, 99), task_ms=task_ms)


def _eager_step_ms(model: Model, reps: int = 20) -> float:
    """Median host wall of one eager B = 1 decode step over a 1024-long cache
    (the unbatched host's step), synchronised."""
    cache = model.init_cache(1, 1024)
    tok = torch.zeros((1, 1), dtype=torch.int32, device=DEVICE)
    pos = torch.full((1,), 600, dtype=torch.int32, device=DEVICE)
    times = []
    with torch.inference_mode():
        for _ in range(reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step(tok, cache, pos)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return float(np.median(times[2:])) * 1e3


def phase_fabric(model: Model, served: dict, tol: float) -> dict:
    """serve_model over two ``torch`` endpoints and a journal: a batched run
    (8 concurrent sessions of 64 tokens over the serve phase's first 8
    prompts), an unbatched run (the same, ``batching=False``) and a failover
    run (4 sessions of 16 tokens, the first session's endpoint killed after
    the third step). Returns the launches of the three runs together."""
    tag = "fabric"
    prompts, want = served["prompts"][:8], served["streams"][:8]
    n_new = served["new_tokens"]
    runs = {}
    for run, kw in (("batched", {}), ("unbatched", {"batching": False})):
        r = runs[run] = _fabric_run(model, run, prompts, n_new, 2, **kw)
        _report_fabric_run(model, tag, run, r, prompts, want, n_new, tol)
    b = runs["batched"]
    if not b["batches"] < b["decode_tasks"]:
        raise AssertionError(f"{tag}: {b['batches']} batched steps for {b['decode_tasks']} "
                             "decode tasks: no coalescing")
    if not b["max_merged"] > 1:
        raise AssertionError(f"{tag}: the largest merged step served {b['max_merged']} slots")
    if runs["unbatched"]["batches"] != 0:
        raise AssertionError(f"{tag}: the unbatched hosts ran batched steps")
    r = runs["failover"] = _fabric_run(model, "failover", prompts[:4], 16, 2, kill=True)
    _report_fabric_run(model, tag, "failover", r, prompts[:4], want[:4], 16, tol)
    if r["migrations"] < 1 or not r["killed"]:
        raise AssertionError(f"{tag} failover: {r['migrations']} sessions migrated")
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    history = [int(t) for t in prompts[longest]] + [int(t) for t in want[longest]]
    say(tag, f"failover: killed {r['killed'][0]} after the third step; every session "
             f"ended with its 16 tokens")
    say(tag, f"wire codec: pack + unpack of one decode task's payload (a history of "
             f"{len(history)} ints) {_codec_us(history):.1f} us (host, median of 200); eager "
             f"B = 1 decode step (the unbatched host's) {_eager_step_ms(model):.3f} ms wall "
             "(median of 20)")
    launches = dict.fromkeys(SOURCES, 0)
    for r in runs.values():
        for k, n in r["launches"].items():
            launches[k] += n
    return launches


def phase_fabric_hybrid(model: Model, served: dict, tol: float) -> dict:
    """4 sessions of 32 tokens on one ``torch`` endpoint: the hybrid serves
    through the unbatched host (F2 repaired: each session's cache holds
    max_len positions), held to the serve-hybrid phase's graphed streams."""
    tag = "fabric-hybrid"
    prompts, want = served["prompts"][:4], served["streams"][:4]
    r = _fabric_run(model, "unbatched", prompts, 32, 1)
    _report_fabric_run(model, tag, "unbatched", r, prompts, want, 32, tol)
    return r["launches"]


@contextlib.contextmanager
def _capacity_factor(model: Model, factor: float):
    """The model's MoE capacity factor set to `factor` while the block runs.
    A captured step keeps the capacity of its capture: build the engines and
    hosts inside the block and free them before it ends."""
    cfg = model.cfg
    model.cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    try:
        yield
    finally:
        model.cfg = cfg


def phase_fabric_moe(model: Model, served: dict, tol: float) -> dict:
    """``serve_model`` over two ``torch`` endpoints and a journal, 8 sessions
    of 64 tokens (the serve phase's first 8 prompts) on batched hosts: at the
    published capacity, where which assignments drop depends on which slots
    share a step (so the streams are counted against the direct engine's,
    not held), then on the same weights at capacity factor E / k, where C >= T
    and nothing drops, held to a direct graphed engine's streams on the same
    8 prompts under the near-tie rule. Returns the launches of both runs."""
    tag = "fabric-moe"
    m = model.cfg.moe
    prompts, n_new = served["prompts"][:8], served["new_tokens"]
    r = _fabric_run(model, "batched", prompts, n_new, 2)
    _report_fabric_run(model, tag, "batched", r, prompts, served["streams"][:8], n_new, tol,
                       hold_streams=False)
    if not r["batches"] < r["decode_tasks"]:
        raise AssertionError(f"{tag}: {r['batches']} batched steps for {r['decode_tasks']} "
                             "decode tasks: no coalescing")
    no_drop = m.n_experts / m.top_k
    with _capacity_factor(model, no_drop):
        direct = _serve_run(model, prompts, n_new, cuda_graph=True)
        want = [req.tokens for req in direct["reqs"]]
        del direct
        torch.cuda.empty_cache()
        r2 = _fabric_run(model, "batched-nodrop", prompts, n_new, 2)
        _report_fabric_run(model, tag, f"batched at capacity factor {no_drop:g}", r2, prompts,
                           want, n_new, tol)
    launches = dict.fromkeys(SOURCES, 0)
    for run in (r, r2):
        for k, n in run["launches"].items():
            launches[k] += n
    return launches


def phase_fabric_mla(model: Model, served: dict, tol: float) -> dict:
    """``serve_model`` on one ``torch`` endpoint with a journal, its batched
    host's slots set by a ``cache_bytes`` budget of 4 sessions: 4 concurrent
    sessions of 32 tokens (the serve-mla phase's first 4 prompts), held to
    its graphed streams. Then admission on a host of the same budget: 4
    sessions fill it, a fifth is refused (``CacheAdmissionError``), and a
    released slot admits it. Returns the run's launches."""
    tag = "fabric-mla"
    cfg = model.cfg
    prompts, want = served["prompts"][:4], served["streams"][:4]
    per_seq = kv_cache.cache_bytes(cfg, 1, 1024)
    budget = 4 * per_seq
    r = _fabric_run(model, "batched", prompts, 32, 1, cache_bytes_budget=budget)
    _report_fabric_run(model, tag, "batched", r, prompts, want, 32, tol)
    if not r["batches"] < r["decode_tasks"]:
        raise AssertionError(f"{tag}: {r['batches']} batched steps for {r['decode_tasks']} "
                             "decode tasks: no coalescing")
    metrics = MetricsRegistry()
    host = fabric.ModelHost(model, max_len=1024, max_sessions=8, cache_bytes_budget=budget,
                            metrics=metrics)
    try:
        for i in range(4):
            host.prefill(f"s{i}", prompts[i][:64])
        try:
            host.prefill("s4", prompts[0][:64])
            raise AssertionError(f"{tag}: a fifth session was admitted past the budget")
        except fabric.CacheAdmissionError:
            pass
        host.release("s0")
        host.prefill("s4", prompts[0][:64])
        gauge = metrics.gauge("serving.cache_bytes").value
        rejects = metrics.counter("serving.admission_rejects").value
        if host.n_slots != 4 or gauge != kv_cache.cache_bytes(cfg, 4, 1024) or rejects != 1:
            raise AssertionError(f"{tag}: {host.n_slots} slots, cache_bytes gauge {gauge}, "
                                 f"{rejects} rejects under a budget of 4 sessions")
    finally:
        del host
        torch.cuda.empty_cache()
    say(tag, f"admission: a budget of 4 x {per_seq} bytes (the latent cache of one "
             f"1024-position session, (256 + 32) x 2 B x 62 layers a position) gives 4 "
             f"slots ({int(gauge)} bytes); a fifth session refused, admitted once a slot was "
             "released")
    return r["launches"]


def phase_fabric_encdec(model: Model, served: dict, tol: float) -> dict:
    """4 sessions of 32 tokens on one ``torch`` endpoint, each with its frames
    (F9 repaired: put once into an object store, each task carrying their
    key), through the unbatched host (encdec is not batched, as in the
    reference), held to serve-encdec's graphed streams for the same prompts
    and frames. Returns the run's launches."""
    tag = "fabric-encdec"
    prompts, want = served["prompts"][:4], served["streams"][:4]
    frames = _side_rows(served["side"], slice(0, 4))
    r = _fabric_run(model, "unbatched", prompts, 32, 1, max_len=served["max_len"],
                    side=frames)
    _report_fabric_run(model, tag, "unbatched", r, prompts, want, 32, tol, side=frames)
    if r["batching"] or not all(r["launches"][k] for k in ("flash_attention",
                                                          "decode_attention")):
        raise AssertionError(f"{tag}: batched host, or an attention kernel not launched: "
                             f"{r['launches']}")
    return r["launches"]


def phase_fabric_vlm(model: Model, served: dict, tol: float) -> dict:
    """4 sessions of 32 tokens over two ``torch`` endpoints with a journal,
    each with its own patches (F7 repaired: put once into an object store,
    each task carrying their key), through the unbatched host (the reference
    batches only dense and moe); the endpoint holding the first session is
    killed after every session's third step, and the sessions it held
    re-prefill on the survivor with their patches fetched from the store.
    Held to serve-vlm's graphed streams for the same prompts and patches
    under the near-tie rule. Returns the run's launches."""
    tag = "fabric-vlm"
    prompts, want = served["prompts"][:4], served["streams"][:4]
    patches = _side_rows(served["side"], slice(0, 4))
    r = _fabric_run(model, "failover", prompts, 32, 2, kill=True, max_len=served["max_len"],
                    side=patches)
    _report_fabric_run(model, tag, "failover", r, prompts, want, 32, tol, side=patches)
    reprefills = r["delta"].get("serving.cache_migrations", 0)
    if r["batching"] or not r["killed"] or r["migrations"] < 1 or reprefills != r["migrations"]:
        raise AssertionError(f"{tag}: batched host {r['batching']}, killed {r['killed']}, "
                             f"{r['migrations']} sessions migrated, {reprefills} re-prefills")
    say(tag, f"failover: killed {r['killed'][0]} after the third step; {r['migrations']} "
             f"session(s) re-prefilled on the survivor with their own patches from the "
             "object store; every session ended with its 32 tokens")
    return r["launches"]


def main() -> int:
    name = phase_device()
    phase_build()
    rows = phase_kernels()
    rows.update(phase_kernels_rmsnorm())
    rows.update(phase_kernels_ssd())
    launches = dict.fromkeys(rows, 0)
    fabric_launches = dict.fromkeys(rows, 0)
    for arch, tag, tol in ((ARCH, "", SLICE_BF16_TOL), (SSM_ARCH, "-ssm", SLICE_SSM_BF16_TOL),
                           (HYBRID_ARCH, "-hybrid", SLICE_HYBRID_BF16_TOL),
                           (MOE_ARCH, "-moe", SLICE_MOE_BF16_TOL),
                           (MLA_ARCH, "-mla", SLICE_MLA_BF16_TOL),
                           (ENCDEC_ARCH, "-encdec", SLICE_ENCDEC_BF16_TOL),
                           (VLM_ARCH, "-vlm", SLICE_VLM_BF16_TOL)):
        t0 = time.perf_counter()
        f32_layers = {MOE_ARCH: MOE_F32_LAYERS, VLM_ARCH: VLM_F32_LAYERS}.get(arch, 0)
        model = phase_slice(arch, "slice" + tag, tol, f32_layers=f32_layers)
        t1 = time.perf_counter()
        say("slice" + tag, f"wall {t1 - t0:.1f} s")
        served = phase_serve(model, "serve" + tag, tol)
        t2 = time.perf_counter()
        say("serve" + tag, f"wall {t2 - t1:.1f} s")
        phase_launches = [served["launches"]]
        # the fabric phases reuse the served bf16 model before it is freed
        if arch == ARCH:
            phase_launches += [phase_fabric_frontdoor(model, served, tol),
                               phase_fabric(model, served, tol)]
        elif arch == HYBRID_ARCH:
            phase_launches.append(phase_fabric_hybrid(model, served, tol))
        elif arch == MOE_ARCH:
            phase_launches.append(phase_fabric_moe(model, served, tol))
        elif arch == MLA_ARCH:
            phase_launches.append(phase_fabric_mla(model, served, tol))
        elif arch == ENCDEC_ARCH:
            phase_launches.append(phase_fabric_encdec(model, served, tol))
        elif arch == VLM_ARCH:
            phase_launches.append(phase_fabric_vlm(model, served, tol))
        if len(phase_launches) > 1:
            say("fabric" + tag, f"wall {time.perf_counter() - t2:.1f} s")
        for i, counts in enumerate(phase_launches):
            for k, n in counts.items():
                launches[k] += n
                if i:
                    fabric_launches[k] += n
        del model                               # free the weights before the next family
        torch.cuda.empty_cache()
    if not all(fabric_launches.values()):
        raise AssertionError(f"the fabric phases launched {fabric_launches}: a kernel of the "
                             "port ran in none of them")
    say("fabric", f"the port's kernels in the fabric phases: {fabric_launches}")
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
