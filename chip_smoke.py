#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA card and ``nvcc``. Phases, in
order, each printing its lines; any failure raises and the exit code is not 0:

1. device          - require CUDA and compute capability 9.0; print the card's
                     name and power limit (nvidia-smi); fp32 products in full fp32.
2. build           - compile the eight kernels from ``src/repro_torch`` (flash,
                     decode and MLA decode attention, flash attention's
                     backward, the add + norm and its backward, the SSD scan
                     and its backward) with nvcc for sm_90a, one nvcc per
                     source, all started together.
3. kernels         - hold each attention kernel against its plain PyTorch version
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
                     tensors (the same function by the other kernel, timed only);
                     decode attention at the shapes phase's lengths (B 128
                     over 32768 positions at qwen2's heads, B 1 over 524288 at
                     zamba2's) against its plain version on 8 rows, timed
                     whole and by pass (split, combine); and
                     ``decode_attention_partials`` (a sequence shard's max,
                     sum and accumulator) at qwen2-0.5b's decode_32k row
                     shape and minicpm3-4b's MLA decode, f32 and bf16: the
                     cache cut into 2 and 4 shards, each shard at its offset,
                     merged by log-sum-exp and held against the plain decode
                     on the whole cache, with a row that ends in the first
                     shard and a row of length 0 (-inf, 0, 0 where a shard
                     holds none of a row); the partials over one of two
                     shards timed beside the whole call. MLA's own decode
                     kernel (``mla_decode_attention``, K and V read from the
                     two latent caches) at minicpm3-4b's served shape, f32
                     and bf16, at the slice row's lengths (a row of length
                     0) and at lengths 1, split - 1, split, split + 1 and S,
                     and its partials over 2 and 4 shards merged; timed in
                     bf16 beside the path it replaced (``cat`` of the caches,
                     then ``decode_attention``), ``decode_attention`` alone
                     on a ready K, its plain version and SDPA's math backend.
                     Flash attention's backward kernel (B10) on the forward
                     kernel's (o, lse), f32 and bf16, against
                     ``ref.mha_backward_reference`` (each gradient within
                     relative L2 1e-5 / 2e-2; the lse against the plain one)
                     at qwen2-0.5b's and zamba2-2.7b's training calls
                     (8 x 1024, 14/2 hd 64 and 32/32 hd 80, causal),
                     minicpm3-4b's prefill (dqk 96, dv 64), whisper-small's
                     cross attention (64 queries over 1500 keys,
                     non-causal), internvl2-26b's (G 6, hd 128) and per-row
                     kv_len with a row of length 0 (exact zero gradients)
                     and a q_offset; timed in bf16 at the two training
                     calls beside its plain version, the plain autograd
                     backward it replaced, SDPA's backward alone and the
                     bound of its five products.
4. kernels-rmsnorm - hold the fused add + RMSNorm kernel against its plain
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
                     at 2560, 384 of two chunks at 6144). Then the add + norm's
                     backward kernel against its plain version
                     (``fused_add_rmsnorm_backward_reference``), each gradient
                     within relative L2 1e-5 (f32) / 1e-2 (bf16), at qwen2's
                     and zamba2's training rows (8 x 1024, 896 and 2560) and
                     internvl2's width (1 x 768, 6144); timed in bf16 at the
                     training rows beside its plain version, the plain
                     autograd backward it replaced, the backward of the two
                     calls ``x + d``, ``F.rms_norm`` (labelled as two calls)
                     and its bound.
5. kernels-ssd     - hold the SSD scan against its plain version at 1e-4 (f32) /
                     5e-2 (bf16) on the reference's shapes, a ragged chunk, a
                     dt = 0 padded tail, a nonzero initial state and, at the full
                     80 heads, three chunks, chunks of 1 and 2, a batch of 2 from
                     an initial state, one chunk against two and three (the bf16
                     branches), and the slices' shapes (mamba2 N = 128, zamba2
                     N = 64); time kernel and plain version there (no single
                     PyTorch call computes the scan, so there is no library time),
                     and each bf16 pass's device time (torch.profiler). Then
                     the scan's backward kernel against its plain version
                     (``ssd_backward_reference``), each gradient within
                     relative L2 1e-4 (f32) / 2e-2 (bf16), at the reference's
                     sweep (G 2 and 4 among it), chunks of 1 and 2, one chunk
                     and three, an initial state with a final-state gradient,
                     a dt = 0 padded tail (dx exactly 0 there) and mamba2's and
                     zamba2's training calls (8 x 1024, 80 heads, N 128 and 64);
                     timed in bf16 at the training calls beside its plain
                     version, the plain autograd backward it replaced and its
                     bound, with each pass's device time.
5b. warming        - the worker's compiled-function path: the torch twins of
                     benchmarks/bench_warming.py's three functions (tanh x 2
                     of a 64x64, the sum of a 512x512 product, the port's
                     reduced qwen1.5-0.5b's loss at tokens (2, 32) through
                     the port's kernels) registered with
                     ``torch_compile=True`` on a FunctionService endpoint:
                     the cold task (the compile, in the warm pool) and the
                     mean of 20 warm ones, Inductor's and Triton's caches in
                     a fresh temporary directory; warm < cold, one cold
                     start, each result equal to the eager call's, the LM's
                     graph breaks (one a kernel launch) printed.
6. slice           - full-width qwen2-0.5b, random weights from seed 0: prefill
                     4 x 384 tokens then 16 teacher-forced decode steps with vector
                     positions, kernel path against the plain path on the same
                     weights.
7. serve           - ServeEngine on full-width bf16 qwen2-0.5b answers 16
                     requests, its decode step one CUDA graph replay (the main
                     path); the launch counters must show both attention
                     kernels and the fused add + RMSNorm on the path. One
                     replay under torch.profiler must launch on the device what
                     the capture counted (decode_attention two kernels a call,
                     fused_add_rmsnorm one): the graph's kernel nodes
                     exactly, and the profile no fewer than the records it
                     lost allow (the profiler drops a few late in a long
                     process). Then an eager engine
                     (cuda_graph=False) answers the same 16: the two token
                     streams must be equal, or part only at a near-tie within
                     the slice's bf16 tolerance. Each engine's throughput,
                     TTFT, step time and peak memory are printed, and the
                     graph's build time and node count.
8. fabric-frontdoor- the same 16 requests as fabric tasks through the serve
                     driver's path (``launch/serve.py``: FunctionService ->
                     Forwarder -> Endpoint -> worker -> a pass-through
                     ``generate`` on a graphed engine); streams held to the
                     serve phase's graphed ones under its near-tie rule;
                     throughput and TTFT beside the direct engine's.
9. fabric          - ``serve_model`` over two ``torch`` endpoints and a
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
10. train          - full-width qwen2-0.5b trained on the card (its own model,
                     bf16, B = 8, S = 1024, remat on, the reference's synthetic
                     token stream), after the served qwen2 is freed: (a) one
                     step's loss and every gradient leaf through the kernels
                     against the plain path (impl="ref") on the same weights
                     and batch, f32 within 1e-4 (loss) / 1e-3 (each leaf's
                     relative L2 difference) and bf16 within 0.02 / 0.05;
                     (b) one ``build_train_step`` step with the counters set to
                     0 just before it launches exactly 48 flash attention and
                     48 add + norm calls (24 layers x forward and remat's
                     recompute) and 24 of each of their backward kernels and
                     no decode attention or scan, and ``ref.mha_reference``,
                     ``ref.fused_add_rmsnorm_reference`` and
                     ``ref.ssd_reference`` run on no CUDA tensor there, in the
                     timed steps or in the trainer runs; the step split by
                     CUDA events into forward, backward (each backward
                     kernel's share from one call timed alone) and optimizer,
                     tokens/s, model FLOP utilisation against the bf16 dense
                     peak, peak allocated memory; (c) a ``Trainer`` runs 20
                     steps through a FunctionService (one endpoint, one worker)
                     with checkpoints at 10 and 20; with step 20's removed, a
                     second Trainer on the same directory resumes at 10 and its
                     losses for steps 11-20 match the first's within 1e-2;
                     every loss finite, the last 5 below the first 5 on average,
                     48 + 48 + 24 + 24 launches a step; (d) a bf16 checkpoint of the
                     weights restores to bf16 tensors equal to those saved.
11. slice-ssm      - the same as slice for full-width mamba2-2.7b (prefills pad
                     384 to 512).
12. serve-ssm      - the same as serve for full-width bf16 mamba2-2.7b; the
                     counters must show the SSD kernel in every layer's prefill
                     and none of the other three (its step runs no kernel of
                     the repo).
13. train-ssm      - full-width mamba2-2.7b trained on the card on its own model
                     after serve-ssm frees its (bf16, B = 8 unless one step's
                     peak leaves under 8 GiB free, then 4, said on the line; S =
                     1024, remat on): (a) on the bf16 weights' values in f32,
                     the loss and every gradient leaf through the kernels
                     against the plain path within 1e-4 / 1e-3; in bf16 |dloss|
                     within 0.02 and each leaf's relative L2 distance to those
                     f32 plain gradients at most 1.25 x the plain bf16 path's
                     own (both ~9% there: two bf16 paths cannot meet 0.05);
                     (b) one step launches exactly 128 `ssd` calls (64 forward
                     + 64 remat) and 64 of its backward kernel and nothing
                     else, no plain version on the card, the step split into
                     forward, backward (the backward kernel's time a call
                     beside the kernel forward) and optimizer, tokens/s, MFU,
                     peak; (c) 10 steps through a ``Trainer`` on a
                     FunctionService, the mean of the last 3 losses below the
                     first 3's, 128 + 64 launches a step.
14. slice-hybrid   - the same for full-width zamba2-2.7b (54 Mamba2 layers in 9
                     groups of 6, one shared attention + MLP block before each).
15. serve-hybrid   - the same for full-width bf16 zamba2-2.7b; the counters
                     must show all four kernels: the shared block's attention
                     and add + norm 9 times per prefill and per step, the SSD
                     scan 54 times per prefill.
16. fabric-hybrid  - 4 sessions of 32 tokens on one ``torch`` endpoint through
                     the unbatched host (each session's cache holds max_len
                     positions), held to serve-hybrid's graphed streams under
                     the hybrid's near-tie bound; all four kernels must launch.
17. train-hybrid   - the same for full-width zamba2-2.7b after fabric-hybrid:
                     108 `ssd`, 18 flash attention and 18 add + norm calls a
                     step (54 Mamba2 layers and 9 shared-block calls, each
                     twice), 54 of the scan's backward kernel and 9 each of the
                     attention's and the add + norm's.
18. slice-moe      - the same as slice for full-width qwen2-moe-a2.7b (60 routed
                     experts top-4 with capacity drop, a gated shared expert);
                     the f32 check runs 8 of its 24 layers (a depth cut: the
                     full-width f32 model is 57 GB), bf16 all 24. Routing flips
                     between the two paths (tokens x layers whose top-4 expert
                     set differs) are counted and printed.
19. serve-moe      - the same as serve for full-width bf16 qwen2-moe-a2.7b: flash
                     attention, decode attention and the add + norm 24 times a
                     prefill and a step.
20. fabric-moe     - ``serve_model`` on two ``torch`` endpoints with a journal, 8
                     sessions of 64 tokens on batched hosts: at the published
                     capacity factor (every session's tokens, one affinity hit a
                     decode task, no duplicate commitment, coalescing; how many
                     streams equal the direct engine's is printed, not held:
                     the drops depend on which slots share a step), then on the
                     same weights at capacity factor E / k = 15, where nothing
                     drops, held to a direct graphed engine's streams under the
                     near-tie rule.
21. slice-mla      - the same as slice for full-width minicpm3-4b (62 layers of
                     Multi-head Latent Attention, 40 heads, d_model 2560, vocab
                     73448), f32 (17 GB) and bf16, no cut.
22. serve-mla      - the same as serve for full-width bf16 minicpm3-4b: flash
                     attention (dv 64 != dqk 96) and the add + norm 62 times a
                     prefill, and MLA's decode kernel (the latent caches read
                     as they lie, no concatenated copy) and the add + norm 62
                     times a step.
23. fabric-mla     - ``serve_model`` on one ``torch`` endpoint, a batched host
                     whose slots a ``cache_bytes`` budget of 4 sessions sets: 4
                     sessions of 32 tokens held to serve-mla's graphed streams
                     under the near-tie rule; then a fifth session refused by a
                     full host and admitted once a slot is released.
24. slice-encdec   - the same as slice for full-width whisper-small (12 encoder
                     and 12 decoder layers, d_model 768, MHA 12/12 hd 64, vocab
                     51865), each prompt with its own random frames (1500 x 768,
                     numpy seed 3), f32 and bf16, no cut.
25. serve-encdec   - a graphed ServeEngine(max_batch=8, max_len=448: whisper's
                     published text context) answers 16 requests of 4..64
                     tokens, each with its own random frames, then an eager one
                     answers the same 16, held as serve is; the counters must
                     show flash attention exactly 36 times a prefill (12 encoder,
                     12 causal self, 12 cross) and 12 a step (cross-attention,
                     Sq = 1, captured in the graph), decode attention 12 a step,
                     and no add + norm (LayerNorms) and no scan.
26. fabric-encdec  - ``serve_model`` on one ``torch`` endpoint with a journal: 4
                     sessions of 32 tokens, each with its frames (put once into
                     an object store; each task carries their key), through the
                     unbatched host, held to serve-encdec's graphed streams for
                     the same prompts and frames under the near-tie rule.
27. shapes         - on an otherwise empty card, before the VLM's phases: the
                     dry run's analysis (``launch/dryrun.py``, FLOPs from two
                     calibration traces on the meta device) of all 40 cells of
                     the reference's ``SHAPES``, one line each (applicable,
                     FLOPs, modeled bytes, fits, the binding roofline term);
                     then each decode cell that fits runs through
                     ``build_decode_step`` at full width, bf16, its cache
                     filled with seeded normal values, at pos = S - 1: the
                     first 8 slots' next tokens through the kernels against
                     the plain path's (the serve phases' near-tie rule), then
                     the step at every slot, the median of 5 with the counters
                     set to 0 just before them (exact counts); and qwen2-0.5b's
                     prefill_32k through ``build_prefill_step`` at the largest
                     batch the analysis fits (the cut printed), flash against
                     its plain version on one row and one head at S = 32768,
                     and each row's next token against a B = 1 prefill of it.
                     Each cell: device ms, the analysis's bound (max(compute,
                     memory) at 989 TFLOP/s and 3.35 TB/s), the fraction, the
                     step's peak against the modeled one.
28. slice-vlm      - the same as slice for full-width internvl2-26b (48 layers,
                     d_model 6144, GQA 48/8 hd 128, d_ff 16384, vocab 92553),
                     each prompt after its own 256 random patches (256 x 6144,
                     numpy seed 3); the f32 check runs 8 of its 48 layers (a
                     depth cut: the full-width f32 model is 79.6 GB, 8 layers
                     17.2 GB), bf16 all 48.
29. serve-vlm      - a graphed ServeEngine(max_batch=8, max_len=1024) answers
                     16 requests of 64..512 tokens, each after its own random
                     patches (a slot's positions count them), then an eager one
                     answers the same 16, held as serve is; the counters must
                     show exactly 48 flash calls a prefill, 48 decode
                     attention calls a step and 48 add + norm calls a prefill
                     and a step. Prints the step against its byte bound.
30. fabric-vlm     - ``serve_model`` on two ``torch`` endpoints with a journal:
                     4 sessions of 32 tokens, each with its patches (put once
                     into an object store; each task carries their key),
                     through the unbatched host; the endpoint holding the
                     first session is killed after every session's third
                     step, and the sessions it held re-prefill on the survivor
                     with their patches from the store. Held to serve-vlm's
                     graphed streams under the near-tie rule.

31. mesh-probe     - two ranks on the one card over gloo (child processes
                     started with ``spawn``, meeting through a file in a
                     temporary directory): which of all_reduce, broadcast,
                     all_gather_into_tensor, reduce_scatter_tensor and
                     all_to_all_single take CUDA tensors, f32 and bf16, each
                     result checked, by the ``torch.distributed`` call and
                     by the functional collective DTensor issues; a call
                     that hangs (30 s) or crashes the ranks is named and
                     ends the probe.
31b. mesh-decode   - decode over a cache split by sequence across two ranks
                     on the one card (gloo, a (model = 2) mesh): at the
                     partials' two shapes, f32 and bf16, each rank's
                     ``decode_attention_partials`` over its half (at the MLA
                     shape ``mla_decode_attention_partials`` over its half
                     of the two latent caches) and the combine's two
                     all-reduces (max, then the rescaled sums), through
                     ``ops.decode_attention`` (``ops.mla_decode_attention``)
                     as a model's decode calls it, held to the plain decode
                     on the whole cache;
                     one partials launch a call and nothing else; the call
                     timed on each rank.
32. mesh-moe       - full-width qwen2-moe-a2.7b's experts split over two ranks
                     on the one card: the reference run (during the MoE
                     family's turn, before its model is freed) keeps each
                     layer's MoE input and output of the global path's prefill
                     over 4 x 512 synthetic tokens; then two ranks on a
                     (model = 2) mesh over gloo, each drawing the weights part
                     by part from seed 0 and keeping the router, the shared
                     expert and its 30 of 60 experts of every layer, run every
                     layer's ``moe_ffn`` with ``moe_impl="local"`` on those
                     inputs: y within the serve phases' bf16 bound of the
                     global path's, aux equal (no data axis), one all-reduce a
                     layer and no kernel launch; per layer the local experts'
                     and the gloo all-reduce's times (CUDA events; the
                     all-reduce also on the host's clock).
33. mesh-steps     - on a 1-rank NCCL mesh (data 1, model 1): full-width
                     qwen2-0.5b's ``build_train_step(mesh=)`` (3 steps, B = 8,
                     S = 1024, remat on) and ``build_decode_step(mesh=)`` (32
                     greedy tokens) against the unsharded builders' (losses
                     and grad norms within 1e-6 relative, tokens equal),
                     minicpm3-4b cut to 4 of 62 layers for the same decode,
                     and mamba2-2.7b cut to 4 of 64 layers for one train
                     step, so that every single-card kernel launches through
                     the wrappers' ``local_map``; each step's wall beside the unsharded
                     one's. Then the collectives a (data 1, model 2) step
                     issues (traced under a fake group); where mesh-probe
                     shows gloo takes them all on CUDA tensors as functional
                     collectives, qwen2-0.5b's train step on two ranks at B =
                     4 within 2e-2 of the unsharded loss; else the phase
                     names the ones it does not take.
34. mesh-dryrun    - ``python -m repro_torch.launch.dryrun --arch
                     qwen3-moe-235b-a22b --shape train_4k --mesh 16,16
                     --calibrated`` in a subprocess under a fake group of 256:
                     the experts' placements, the per-device FLOPs and memory
                     fit, the collectives' wire bytes and the roofline; then
                     the F14 cell, qwen2-0.5b ``decode_32k`` on 2 x 4 (its
                     cache sequence-sharded): its wire bytes a device within
                     twice the reference's 3.1070e8 and its bound not the
                     collective term.

The VLM phases run last of the families, after every other model is freed:
internvl2-26b's 39.8 GB of bf16 weights leave about 38 GB for its engine and
hosts; the mesh phases follow on a card they have freed.
Each family's slice, serve and fabric phases print their wall time.

Each serve, fabric, train and shapes run resets the launch counters just
before it and reads them just after; a replay adds the calls its capture
counted. The summary's ``launches`` of a kernel is its sum over the seven
graphed serve runs, the fabric runs, the train phase's two trainer runs, the
train-ssm and train-hybrid trainer runs, the shapes phase's timed runs, the
warming phase's compiled LM loss and the mesh-decode, mesh-moe and
mesh-steps phases' runs on a mesh; the fabric phases together must have
launched every kernel of a single card's serving paths, mesh-steps those and
the three backward kernels (which only training runs) too, and
mesh-decode the two partials kernels (which only a cache split by
sequence over ranks runs). The whole script's wall, the build included, is
printed before the summary.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
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
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training import optimizer as train_opt  # noqa: E402
from repro_torch.training.steps import (  # noqa: E402
    build_decode_step, build_prefill_step, build_train_step)
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, Trainer  # noqa: E402
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
    "decode_attention_partials":
        "src/repro_torch/kernels/flash_attention/csrc/decode_attention.cu",
    "mla_decode_attention": "src/repro_torch/kernels/flash_attention/csrc/mla_decode.cu",
    "mla_decode_attention_partials":
        "src/repro_torch/kernels/flash_attention/csrc/mla_decode.cu",
    "flash_attention_backward":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_backward.cu",
    "fused_add_rmsnorm": "src/repro_torch/kernels/rmsnorm/csrc/fused_add_rmsnorm.cu",
    "fused_add_rmsnorm_backward":
        "src/repro_torch/kernels/rmsnorm/csrc/fused_add_rmsnorm_backward.cu",
    "ssd": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
    "ssd_backward": "src/repro_torch/kernels/ssd/csrc/ssd_backward.cu",
}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:107",
    "decode_attention": "src/repro/kernels/flash_attention/kernel.py:173",
    # the same TPU kernel, over one sequence shard of a mesh's cache
    "decode_attention_partials": "src/repro/kernels/flash_attention/kernel.py:173",
    # ... at MLA's absorbed decode (src/repro/models/mla.py:133), whole and by shard
    "mla_decode_attention": "src/repro/kernels/flash_attention/kernel.py:173",
    "mla_decode_attention_partials": "src/repro/kernels/flash_attention/kernel.py:173",
    # attention's gradient: the reference trains through jax.grad of its plain
    # mha_reference, flash_attention_pallas having no VJP (F10)
    "flash_attention_backward": "src/repro/kernels/flash_attention/ref.py:16",
    "fused_add_rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:30",
    "ssd": "src/repro/kernels/ssd/kernel.py:93",
    # the add + norm's and the scan's gradients: the reference trains through
    # jax.grad of their plain versions, the Pallas kernels having no VJP (F10)
    "fused_add_rmsnorm_backward": "src/repro/kernels/rmsnorm/ref.py:10",
    "ssd_backward": "src/repro/kernels/ssd/ref.py:25",
}
KERNEL_MODULES = (attn_kernel, rms_kernel, ssd_kernel)
# kernels that run only where a decode cache is split by sequence over more
# than one rank (a mesh whose `model` axis the KV heads do not divide, or
# MLA's latent cache): no single-card path and no 1-rank mesh launches them
MESH_SEQ_KERNELS = ("decode_attention_partials", "mla_decode_attention_partials")
# kernels that run only where autograd records a forward (the train phases and
# mesh-steps' train steps): no serve or fabric path launches them
TRAIN_KERNELS = ("flash_attention_backward", "fused_add_rmsnorm_backward", "ssd_backward")
# decode over a sequence-sharded cache (F14): qwen2-0.5b's decode_32k row shape
# and minicpm3-4b's absorbed MLA decode at its served shape, each cut into 2
# and 4 shards; the first is the summary's row (bf16, a shard of 2).
# B, S, H, KV, dqk, dv
PARTIALS_SHAPES = {"qwen2-0.5b decode_32k": (128, 32768, 14, 2, 64, 64),
                   "minicpm3-4b MLA decode": (8, 1024, 40, 1, 288, 256)}
PARTIALS_SHARDS = (2, 4)
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
# the scan's backward kernel: held against ref.ssd_backward_reference on the
# same tensors, each gradient within SSD_BWD_TOL (relative L2: f32 sums in
# another order; bf16 rounds dx, dB and dC once, at the store). (B, S, H, P,
# G, N, chunk), an initial state with a final-state gradient, a dt = 0 tail of
# that many positions: the reference's sweep (G 2 and 4 among it), chunks of 1
# and 2, one chunk and several, and the two training calls, which are timed
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_BWD_SHAPES = {
    "sweep (1, 64, 2, 16) N 16, 4 chunks of 16": ((1, 64, 2, 16, 1, 16, 16), False, 0),
    "sweep G 2 (2, 128, 4, 32) N 8, 4 chunks of 32": ((2, 128, 4, 32, 2, 8, 32), False, 0),
    "sweep (1, 96, 6, 16) N 32, 3 chunks of 32": ((1, 96, 6, 16, 1, 32, 32), False, 0),
    "sweep G 4 (2, 64, 8, 64) N 16, one chunk": ((2, 64, 8, 64, 4, 16, 64), False, 0),
    "chunk 1, both states": ((2, 5, 80, 64, 1, 128, 1), True, 0),
    "chunk 2, both states": ((1, 6, 80, 64, 1, 64, 2), True, 0),
    "3 chunks of 256, both states": ((2, 768, 80, 64, 1, 128, 256), True, 0),
    "a dt = 0 tail of 375 of 512, both states": ((1, 512, 80, 64, 1, 128, 256), True, 375),
    "mamba2-2.7b": ((8, 1024, 80, 64, 1, 128, 256), False, 0),
    "zamba2-2.7b": ((8, 1024, 80, 64, 1, 64, 256), False, 0),
}
SSD_BWD_TIMED = ("mamba2-2.7b", "zamba2-2.7b")
RMS_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}  # tests/test_kernels_rmsnorm.py:10
# the add + norm rows of the slices: a 512-token prefill and an 8-slot decode
# step, at qwen2-0.5b's and zamba2-2.7b's d_model; the first is the summary's row
RMS_SHAPES = ((1, 512, 2560), (8, 1, 2560), (1, 512, 896), (8, 1, 896),
              (1, 512, 2048), (8, 1, 2048), (1, 768, 6144), (8, 1, 6144))

# the add + norm's backward kernel: held against
# ref.fused_add_rmsnorm_backward_reference, each gradient within RMS_BWD_TOL
# (relative L2), at qwen2-0.5b's and zamba2-2.7b's training rows (timed) and
# internvl2-26b's width
RMS_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
RMS_BWD_SHAPES = {"qwen2-0.5b": (8, 1024, 896), "zamba2-2.7b": (8, 1024, 2560),
                  "internvl2-26b": (1, 768, 6144)}
RMS_BWD_TIMED = ("qwen2-0.5b", "zamba2-2.7b")

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

# the attention backward kernel: held against ref.mha_backward_reference on
# the forward kernel's (o, lse), each gradient within BWD_TOL (relative L2:
# f32 sums in another order; bf16 rounds P and dS for the products); timed
# at qwen2-0.5b's and zamba2-2.7b's training calls, the first the summary's
# row, and held at the other families' training shapes. (B, Sq, Skv, H, KV,
# dqk, dv, kwargs; causal unless the kwargs say otherwise)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TIMED_SHAPES = {ARCH: (8, 1024, 1024, 14, 2, 64, 64, {}),
                    HYBRID_ARCH: (8, 1024, 1024, 32, 32, 80, 80, {})}
BWD_HELD_SHAPES = {
    "minicpm3-4b prefill (dqk 96, dv 64)": (1, 512, 512, 40, 40, 96, 64, {"scale": MLA_SCALE}),
    "whisper-small cross (64 over 1500 keys)": (1, 64, 1500, 12, 12, 64, 64, {"causal": False}),
    "internvl2-26b (G 6, hd 128)": (1, 768, 768, 48, 8, 128, 128, {}),
    "per-row kv_len with a 0 row, q_offset 64": (3, 100, 164, 8, 2, 64, 64,
                                                 {"q_offset": 64, "kv_len": [0, 37, 164]}),
}


# the train phase: full-width qwen2-0.5b, bf16, seed 0, remat on (the config's)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
TRAIN_TIMED_STEPS = 5
# one step's loss and every gradient leaf, kernels against the plain path on
# the same weights and batch: |dloss| and each leaf's relative L2 difference
TRAIN_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (0.02, 0.05)}
TRAIN_RESUME_TOL = 1e-2     # a resumed run's losses against the straight run's
# the scan families' bf16 gradients: each leaf's relative L2 distance to the
# f32 plain gradients on the same weights at most this multiple of the plain
# bf16 path's own distance (on an H100 at seed 0 both are ~9% for mamba2-2.7b,
# against ~2.6% for qwen2-0.5b; the kernel path's ratio read 1.01 at most
# there, qwen2's 1.11)
TRAIN_BF16_TRUTH_RATIO = 1.25
# the train-ssm and train-hybrid phases: TRAIN_BATCH unless one step's peak
# leaves under TRAIN_MIN_FREE_GIB free, then TRAIN_SMALL_BATCH;
# TRAIN_SCAN_STEPS steps through the fabric
TRAIN_MIN_FREE_GIB, TRAIN_SMALL_BATCH, TRAIN_SCAN_STEPS = 8, 4, 10

# the shapes phase: the reference's assigned cells (launch/dryrun.py); each
# decode cell's kernel-against-plain check takes the first 8 slots (so the
# plain attention's expanded K/V fits beside the cache), each family at its
# serve phases' near-tie bound
SHAPES_CHECK_SLOTS, SHAPES_DECODE_REPS = 8, 5
# one layer's decode attention in qwen2-0.5b's decode_32k cell and
# zamba2-2.7b's long_500k cell: B, S, H, KV, hd
LONG_DECODE_SHAPES = {"decode_32k": (128, 32768, 14, 2, 64),
                      "long_500k": (1, 524288, 32, 32, 80)}
SHAPES_TOL = {ARCH: SLICE_BF16_TOL, SSM_ARCH: SLICE_SSM_BF16_TOL,
              HYBRID_ARCH: SLICE_HYBRID_BF16_TOL}


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


# the warming phase: warm calls timed after the cold one, as
# benchmarks/bench_warming.py times them
WARM_CALLS = 20
# the period of the thread that reads how long the cold compile held the GIL
WARM_STALL_PERIOD_S = 0.005


class _StallMeter:
    """A thread that sleeps WARM_STALL_PERIOD_S at a time and keeps the
    longest gap between two wake-ups: how long another thread (the worker's
    compile) kept it from the GIL. The endpoint's heartbeat thread waits as
    it does, and its liveness allows 2 beats of 0.25 s."""

    def __enter__(self):
        self.longest, self._stop = 0.0, threading.Event()

        def run():
            last = time.perf_counter()
            while not self._stop.wait(WARM_STALL_PERIOD_S):
                now = time.perf_counter()
                self.longest, last = max(self.longest, now - last), now

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _warming_functions() -> dict:
    """The torch twins of ``benchmarks/bench_warming.py``'s three functions:
    name -> (function, payload, rtol of its result against the eager call's).
    A payload travels as CPU tensors; each function moves its input to the
    card. The LM's loss is the port's reduced qwen1.5-0.5b in f32, random
    weights from seed 0, through the port's kernels: Inductor fuses its
    elementwise ops and sums in another order than the eager ops, so it is
    held within 1e-5; the products of ones are exact; tanh is held within
    one f32 ulp."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced("qwen1.5-0.5b").with_(dtype="float32")
    model = Model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))

    def small(doc):  # elementwise
        return {"y": torch.tanh(doc["x"].to(DEVICE)) * 2}

    def medium(doc):  # one product
        x = doc["x"].to(DEVICE)
        return {"y": (x @ x).sum()}

    def lm_step(doc):  # a whole reduced-LM loss
        return {"loss": model.loss({"tokens": doc["tokens"].to(DEVICE)})[0]}

    return {"small_elementwise": (small, {"x": torch.ones((64, 64))}, 2 ** -23),
            "medium_matmul": (medium, {"x": torch.ones((512, 512))}, 0.0),
            "reduced_lm_loss": (lm_step, {"tokens": torch.ones((2, 32), dtype=torch.int32)},
                                1e-5)}


def phase_warming() -> dict:
    """The worker's compiled-function path (``torch_compile=True``), the
    reference's ``jax_jit=True`` (``benchmarks/bench_warming.py``): each of
    ``_warming_functions`` registered on a fresh FunctionService (one
    endpoint, one worker); the first task pays the compile in the warm pool
    (Dynamo's trace, Inductor's and Triton's code generation: the paper's
    container instantiation, Table 4), then WARM_CALLS warm tasks. Inductor's
    and Triton's caches point at a fresh temporary directory, so no earlier
    run's cache passes for a cold start; Inductor's compile workers are shut
    down after the phase. The endpoint keeps its default liveness (2 beats
    of 0.25 s): its heartbeat watchdog does not count a stall of the
    process against the executor, and the longest time the cold task kept
    another thread from the GIL is printed. Held: warm < cold, one cold start and
    WARM_CALLS warm hits, no executor lost, each result equal to the eager
    call's (within its function's rtol), and the LM's loss through the
    port's kernels (the counters set to 0 before its first task and read
    after its last; Dynamo breaks its graph around each ctypes launch, and
    the breaks are printed)."""
    import torch._dynamo
    from torch._dynamo.utils import counters
    from torch._inductor import async_compile

    t0 = time.perf_counter()
    launches = dict.fromkeys(_launch_counts(), 0)
    env = {k: os.environ.get(k) for k in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR")}
    with tempfile.TemporaryDirectory() as d:
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(Path(d) / "inductor")
        os.environ["TRITON_CACHE_DIR"] = str(Path(d) / "triton")
        try:
            for name, (fn, payload, rtol) in _warming_functions().items():
                torch._dynamo.reset()
                counters.clear()
                svc = FunctionService()
                svc.make_endpoint("warm", n_executors=1, workers_per_executor=1)
                fid = svc.register_function(fn, name=name, torch_compile=True)
                try:
                    _reset_launches()
                    with _StallMeter() as stall:
                        t1 = time.perf_counter()
                        cold_out = svc.run(fid, payload).result(600)
                        cold = time.perf_counter() - t1
                    t1 = time.perf_counter()
                    for _ in range(WARM_CALLS):
                        warm_out = svc.run(fid, payload).result(60)
                    warm = (time.perf_counter() - t1) / WARM_CALLS
                    counts = _launch_counts()
                    starts = (svc.metrics.counter("warming.cold_starts").value,
                              svc.metrics.counter("warming.warm_hits").value)
                    lost = svc.metrics.counter("endpoint.executors_lost").value
                finally:
                    svc.shutdown()
                breaks = sum(counters["graph_break"].values())
                graphs = counters["stats"]["unique_graphs"]
                with torch.no_grad():
                    eager = fn(payload)
                errs = []
                for out in (cold_out, warm_out):
                    for key, want in eager.items():
                        got, want = out[key].float(), want.float().cpu()
                        errs.append(float(((got - want).abs() / want.abs()).max()))
                say("warming", f"{name}: cold {cold * 1e3:.3f} ms (compile in the warm pool), "
                               f"warm {warm * 1e3:.3f} ms (mean of {WARM_CALLS}), cold/warm "
                               f"{cold / warm:.0f}x; {graphs} graph(s), {breaks} graph break(s); "
                               f"cold starts / warm hits {starts}, executors lost {lost} "
                               f"(the endpoint's default liveness; the cold task kept a "
                               f"{WARM_STALL_PERIOD_S * 1e3:g} ms sleeper from the GIL for "
                               f"{stall.longest * 1e3:.1f} ms at most); "
                               f"result against the eager "
                               f"call's: max relative difference {max(errs):.3e} (rtol {rtol:g}); "
                               f"launches {counts}")
                if not warm < cold:
                    raise AssertionError(f"warming {name}: warm {warm} s is not below cold {cold} s")
                if starts != (1, WARM_CALLS):
                    raise AssertionError(f"warming {name}: cold starts / warm hits {starts}")
                if lost:
                    raise AssertionError(f"warming {name}: the endpoint lost {lost} executor(s)")
                if max(errs) > rtol:
                    raise AssertionError(f"warming {name}: the compiled result differs from the "
                                         f"eager call's by {max(errs):.3e} (rtol {rtol:g})")
                if name == "reduced_lm_loss":
                    if not (counts["flash_attention"] and counts["fused_add_rmsnorm"]):
                        raise AssertionError(f"warming {name}: launches {counts}: the compiled "
                                             "loss did not run through the port's kernels")
                    for k, n in counts.items():
                        launches[k] += n
        finally:
            async_compile.shutdown_compile_workers()
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            torch._dynamo.reset()
    say("warming", f"wall {time.perf_counter() - t0:.1f} s")
    return launches


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
    rows.update(_mla_decode_rows(gen, pos_mla))
    _whisper_attn_rows(gen)
    rows.update(_flash_backward_rows(gen))
    _attn_slice_rows(gen, VLM_PREFILL_SHAPE, VLM_DECODE_SHAPE, pos_np, VLM_ARCH)
    _long_decode_rows(gen)
    rows.update(_partials_rows(gen))
    return rows


def _mla_caches(gen, B: int, S: int, H: int, dqk: int, dv: int, dtype) -> tuple:
    """q (B, 1, H, dqk) and minicpm3-4b's two latent caches, ckv (B, S, dv)
    and krope (B, S, dqk - dv)."""
    return (randn(gen, (B, 1, H, dqk), dtype), randn(gen, (B, S, dv), dtype),
            randn(gen, (B, S, dqk - dv), dtype))


def _mla_decode_rows(gen, pos_np) -> dict:
    """MLA's absorbed decode kernel (``mla_decode.cu``) at MLA_DECODE_SHAPE, f32
    and bf16, against its plain version (the caches concatenated, then the
    plain decode) at the slice rows' lengths ``pos_np`` (a row of length 0)
    and at lengths 1, split - 1, split, split + 1 and S; its partials over 2
    and 4 sequence shards merged by log-sum-exp against the plain decode on
    the whole caches, (-inf, 0, 0) where a shard holds none of a row. Timed
    in bf16 at ``pos_np``, in one call: the kernel, the path it replaced
    (the ``cat`` of the two caches into one K, then ``decode_attention``),
    ``decode_attention`` alone on a ready K, the plain version, and SDPA's
    math backend on the ready K (the only backend that takes 288 / 256, a
    yardstick); the partials over one of two shards beside the plain ones."""
    B, S, H, _, dqk, dv = MLA_DECODE_SHAPE
    split = attn_kernel._lib("mla_decode_attention").mla_decode_split(B, S)
    pos = torch.from_numpy(pos_np).to(DEVICE)
    edges = torch.tensor([1, split - 1, split, split + 1, S, 0, 3 * split + 5, S // 2 + 1],
                         device=DEVICE)[:B] - 1
    kw = dict(scale=MLA_SCALE)
    errs, perrs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, ckv, krope = _mla_caches(gen, B, S, H, dqk, dv, dtype)
        for p in (pos, edges):
            out = attn_kernel.mla_decode_attention(q, ckv, krope, p, **kw)
            torch.cuda.synchronize()
            empty = (p < 0).nonzero().flatten()
            if not torch.equal(out[empty], torch.zeros_like(out[empty])):
                raise AssertionError(f"mla_decode_attention {dtype}: a row of length 0 is not "
                                     "zeros")
            errs[dtype] = max(errs.get(dtype, 0.0), max_err(
                out, attn_ref.mla_decode_reference(q, ckv, krope, p, **kw), TOL[dtype],
                f"mla_decode_attention {MLA_DECODE_SHAPE} pos {p.tolist()} {dtype}"))
        for shards in PARTIALS_SHARDS:
            L = S // shards
            parts = [attn_kernel.mla_decode_attention_partials(
                q, ckv[:, i * L:(i + 1) * L], krope[:, i * L:(i + 1) * L], edges,
                pos_offset=i * L, **kw) for i in range(shards)]
            torch.cuda.synchronize()
            lens = edges + 1
            for i, (m, l, acc) in enumerate(parts):
                none = (lens <= i * L).nonzero().flatten()   # rows with no position here
                if not (torch.isneginf(m[none]).all() and (l[none] == 0).all()
                        and (acc[none] == 0).all()):
                    raise AssertionError(f"mla partials {dtype} shard {i} of {shards}: a row "
                                         "with no position here is not (-inf, 0, 0)")
            perrs[dtype] = max(perrs.get(dtype, 0.0), max_err(
                attn_ref.combine_partials(parts, dtype),
                attn_ref.mla_decode_reference(q, ckv, krope, edges, **kw), TOL[dtype],
                f"mla partials {shards} shards {dtype}"))
        say("kernels", f"{MLA_ARCH} mla_decode_attention {dtype}: max_abs_err {errs[dtype]:.3e} "
                       f"at pos {pos_np.tolist()} and {edges.tolist()} (split {split}; tol "
                       f"{TOL[dtype]:g}); its partials merged over "
                       f"{' and '.join(map(str, PARTIALS_SHARDS))} shards {perrs[dtype]:.3e}, "
                       "(-inf, 0, 0) where a shard holds none of a row")
    # timing in bf16 (q and the caches from the bf16 pass above)
    k_full = torch.cat([ckv, krope], dim=-1)[:, :, None, :]
    v_lat = ckv[:, :, None, :]

    def pr20_path():   # models/mla.py before this kernel: the copy, then decode_attention
        k = torch.cat([ckv, krope], dim=-1)[:, :, None, :]
        return attn_kernel.decode_attention(q, k, ckv[:, :, None, :], pos, **kw)

    lens = np.maximum(pos_np.astype(np.int64) + 1, 0)
    d_bytes = int(lens.sum()) * dqk * 2 + q.numel() * 2 + B * H * dv * 2 + 4 * B
    d_flops = 2 * int(lens.sum()) * H * (dqk + dv)
    qt = q.transpose(1, 2)
    kt, vt = k_full.transpose(1, 2), v_lat.transpose(1, 2)
    mask = (torch.arange(S, device=DEVICE)[None, :] < pos[:, None] + 1)[:, None, None, :]

    def sdpa_math():
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel(SDPBackend.MATH):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True,
                                                  scale=MLA_SCALE)

    fns = {"kernel": lambda: attn_kernel.mla_decode_attention(q, ckv, krope, pos, **kw),
           "pr20": pr20_path,
           "decode": lambda: attn_kernel.decode_attention(q, k_full, v_lat, pos, **kw),
           "plain": lambda: attn_ref.mla_decode_reference(q, ckv, krope, pos, **kw),
           "sdpa": sdpa_math}
    t = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:   # two readings each, in turns
        t[k].append(cuda_ms(fns[k]))
    t = {k: float(np.mean(v)) for k, v in t.items()}
    passes = _kernel_passes(lambda: attn_kernel.mla_decode_attention(q, ckv, krope, pos, **kw),
                            calls=10, pattern=r"mla_\w+_kernel")
    b = bound(d_bytes, d_flops, torch.bfloat16)
    live = int(np.sum(-(-lens // split)))
    say("kernels", f"{MLA_ARCH} mla_decode_attention bf16 (pos {pos_np.tolist()}): kernel "
                   f"{t['kernel']:.4f} ms; the path it replaced (cat + decode_attention) "
                   f"{t['pr20']:.4f} ms, decode_attention alone on a ready K {t['decode']:.4f} ms; "
                   f"plain {t['plain']:.4f} ms; SDPA math on a ready K {t['sdpa']:.4f} ms "
                   f"(each the mean of two readings, in turns); bound {b[0]:.5f} ms by {b[1]} "
                   f"({d_flops / 1e9:.4f} GFLOP, {d_bytes / 1e6:.3f} MB: the caches read once); "
                   f"by pass (profiler, mean of 10): " + (", ".join(
                       f"{kn} {ms:.4f} ms" for kn, (ms, _) in passes.items()) or "not measured"))
    say("kernels", f"{MLA_ARCH} mla_decode_attention occupancy: pass 1 one block of 128 threads "
                   f"per (split of {split}, row) = {-(-S // split)} x {B} blocks ({live} live at "
                   f"these lengths), mma.sync over 48 rows for {H} heads; pass 2 one per "
                   f"(head, row) = {H * B}; on "
                   f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    # the partials over one of two shards, every row full
    L = S // 2
    full = torch.tensor(S - 1, device=DEVICE)
    cs, rs = ckv[:, :L], krope[:, :L]
    p_ms = cuda_ms(lambda: attn_kernel.mla_decode_attention_partials(q, cs, rs, full, **kw))
    p_plain = cuda_ms(lambda: attn_ref.mla_decode_partials_reference(q, cs, rs, full, **kw),
                      reps=10)
    pb = bound(B * L * dqk * 2 + q.numel() * 2 + B * H * (dv + 2) * 4,
               2 * B * L * H * (dqk + dv), torch.bfloat16)
    say("kernels", f"{MLA_ARCH} mla_decode_attention_partials over one of 2 shards (B {B}, "
                   f"{L} of {S} positions, bf16): {p_ms:.4f} ms against its bound {pb[0]:.5f} "
                   f"ms by {pb[1]}; plain partials {p_plain:.4f} ms; library: none")
    del q, ckv, krope, k_full, v_lat, cs, rs
    torch.cuda.empty_cache()
    return {"mla_decode_attention": dict(max_abs_err=errs[torch.bfloat16], ms=t["kernel"],
                                         plain_ms=t["plain"], library_ms=t["sdpa"], bound=b),
            "mla_decode_attention_partials": dict(max_abs_err=perrs[torch.bfloat16], ms=p_ms,
                                                  plain_ms=p_plain, library_ms=None, bound=pb)}


def _partials_positions(rng, B: int, S: int) -> torch.Tensor:
    """Per-row positions for the sequence-shard checks: a row that ends in the
    first of 4 shards (the later shards hold none of it), a row of length 0,
    a full row, a row that ends on the first position of the second half,
    the rest at random."""
    pos = rng.integers(0, S, B).astype(np.int64)
    pos[:4] = (S // 4 - 7, -1, S - 1, S // 2)
    return torch.from_numpy(pos).to(DEVICE)


def _partials_rows(gen) -> dict:
    """``decode_attention_partials`` at PARTIALS_SHAPES, f32 and bf16: the
    cache cut into 2 and 4 shards, the kernel on each shard at its offset,
    the shards merged by log-sum-exp (``ref.combine_partials``, as the mesh's
    two all-reduces merge them) and held against the plain decode on the
    whole cache; each later shard of the rows that end in the first, and
    every shard of the row of length 0, must give m = -inf, l = 0, acc = 0.
    Then at the summary's shape, bf16, every row full: the partials over the
    first of two shards against the whole ``decode_attention`` call, the
    plain partials, and the shard's byte bound (its K and V, q, the fp32
    outputs). No PyTorch call returns a shard's (max, sum, accumulator), so
    there is no library time."""
    rng = np.random.default_rng(5)
    row = None
    for name, (B, S, H, KV, dqk, dv) in PARTIALS_SHAPES.items():
        scale = MLA_SCALE if dqk == MLA_DECODE_SHAPE[4] else None
        pos = _partials_positions(rng, B, S)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, 1, H, dqk), dtype)
            k, v = randn(gen, (B, S, KV, dqk), dtype), randn(gen, (B, S, KV, dv), dtype)
            want = attn_ref.decode_attention_reference(q, k, v, pos, scale=scale)
            errs = []
            for shards in PARTIALS_SHARDS:
                L = S // shards
                parts = [attn_kernel.decode_attention_partials(
                    q, k[:, i * L:(i + 1) * L], v[:, i * L:(i + 1) * L], pos, pos_offset=i * L,
                    scale=scale) for i in range(shards)]
                torch.cuda.synchronize()
                for i, (m, l, acc) in enumerate(parts):
                    empty = [1] + ([0] if i else [])      # rows with no position in shard i
                    if not (torch.isneginf(m[empty]).all() and (l[empty] == 0).all()
                            and (acc[empty] == 0).all()):
                        raise AssertionError(f"partials {name} {dtype} shard {i} of {shards}: "
                                             "a row with no valid position here is not "
                                             "(-inf, 0, 0)")
                errs.append(max_err(attn_ref.combine_partials(parts, dtype), want, TOL[dtype],
                                    f"partials {name} {shards} shards {dtype}"))
            say("kernels", f"decode_attention_partials at {name} (B {B}, S {S}, {H}/{KV} heads, "
                           f"dqk {dqk}, dv {dv}) {dtype}: merged over "
                           f"{' and '.join(map(str, PARTIALS_SHARDS))} shards, max_abs_err "
                           f"{max(errs):.3e} against the whole cache (tol {TOL[dtype]:g}); rows "
                           f"ending in the first shard and of length 0 give (-inf, 0, 0) "
                           "where they hold no position")
            del q, k, v, want
            torch.cuda.empty_cache()
            if row is None and dtype == torch.bfloat16:
                row = {"max_abs_err": max(errs)}
    B, S, H, KV, dqk, dv = next(iter(PARTIALS_SHAPES.values()))
    L = S // 2
    q = randn(gen, (B, 1, H, dqk), torch.bfloat16)
    k, v = randn(gen, (B, S, KV, dqk), torch.bfloat16), randn(gen, (B, S, KV, dv), torch.bfloat16)
    full = torch.tensor(S - 1, device=DEVICE)
    ks, vs = k[:, :L], v[:, :L]
    ms = cuda_ms(lambda: attn_kernel.decode_attention_partials(q, ks, vs, full))
    whole_ms = cuda_ms(lambda: attn_kernel.decode_attention(q, k, v, full))
    plain_ms = cuda_ms(lambda: attn_ref.decode_attention_partials_reference(q, ks, vs, full),
                       reps=5)
    b = bound(2 * B * L * KV * dqk * 2 + q.numel() * 2 + B * H * (dv + 2) * 4,
              2 * B * H * L * (dqk + dv), torch.bfloat16)
    say("kernels", f"decode_attention_partials over one of 2 shards of "
                   f"{next(iter(PARTIALS_SHAPES))} (B {B}, {L} of {S} positions, bf16): "
                   f"{ms:.4f} ms against its bound {b[0]:.5f} ms by {b[1]} (the shard's K and "
                   f"V); the whole cache's decode_attention {whole_ms:.4f} ms; plain partials "
                   f"{plain_ms:.4f} ms; library: none")
    del q, k, v, ks, vs
    torch.cuda.empty_cache()
    return {"decode_attention_partials": dict(row, ms=ms, plain_ms=plain_ms, bound=b,
                                              library_ms=None)}


def _long_decode_rows(gen) -> None:
    """Decode attention at the shapes phase's lengths, early in the run, where
    the profiler still records every pass: one layer's call at
    LONG_DECODE_SHAPES, bf16, every row at pos = S - 1; the first 8 rows
    against the plain version; the call's device time against its byte
    bound, and each pass's (the combine walks every split of a row in one
    thread per output element)."""
    for name, (B, S, H, KV, hd) in LONG_DECODE_SHAPES.items():
        q = randn(gen, (B, 1, H, hd), torch.bfloat16)
        k, v = (randn(gen, (B, S, KV, hd), torch.bfloat16) for _ in range(2))
        pos = torch.tensor(S - 1, device=DEVICE)
        n = min(B, SHAPES_CHECK_SLOTS)
        err = max_err(attn_kernel.decode_attention(q[:n], k[:n], v[:n], pos),
                      attn_ref.decode_attention_reference(q[:n], k[:n], v[:n], pos),
                      TOL[torch.bfloat16], f"decode attention {name}")
        ms = cuda_ms(lambda: attn_kernel.decode_attention(q, k, v, pos))
        b = bound(2 * k.numel() * 2 + 2 * q.numel() * 2, 4 * B * H * S * hd, torch.bfloat16)
        passes = _kernel_passes(lambda: attn_kernel.decode_attention(q, k, v, pos), calls=5,
                                pattern=r"decode_\w+_kernel")
        say("kernels", f"decode attention at {name}'s shape (B {B}, S {S}, {H}/{KV} heads, hd "
                       f"{hd}; {-(-S // attn_kernel.DECODE_SPLIT)} splits): max_abs_err "
                       f"{err:.3e} on {n} rows; {ms:.4f} ms against its bound {b[0]:.5f} ms by "
                       f"{b[1]}; by pass (profiler, mean of 5): " + (", ".join(
                           f"{kn} {t:.4f} ms" for kn, (t, _) in passes.items()) or "not measured"))
        del q, k, v
        torch.cuda.empty_cache()


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


def _flash_backward_case(gen, shape, dtype) -> tuple:
    """``flash_attention_backward`` on the forward kernel's (o, lse) at
    ``shape`` (a BWD_*_SHAPES entry) against ``ref.mha_backward_reference``
    on the same tensors: each gradient within BWD_TOL (relative L2), exact
    zeros for a row of length 0; the forward's lse against the plain one.
    Returns (max_abs_err over dq, dk, dv, lse's max abs difference, the
    call's tensors and kwargs)."""
    B, Sq, Skv, H, KV, dqk, dv, kw = shape
    kw = {"causal": True, "q_offset": None, "kv_len": None, "scale": None} | {
        n: torch.tensor(x, device=DEVICE) if isinstance(x, list) else x for n, x in kw.items()}
    q, k = randn(gen, (B, Sq, H, dqk), dtype), randn(gen, (B, Skv, KV, dqk), dtype)
    v, do = randn(gen, (B, Skv, KV, dv), dtype), randn(gen, (B, Sq, H, dv), dtype)
    o, lse = attn_kernel._flash_launch(q, k, v, with_lse=True, **kw)
    got = attn_kernel.flash_attention_backward(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    want = attn_ref.mha_backward_reference(q, k, v, o, do, lse, **kw)
    what = f"flash backward {(B, Sq, Skv, H, KV, dqk, dv)} {kw} {dtype}"
    errs = []
    for name, g, w in zip("qkv", got, want):
        g, w = g.float(), w.float()
        rel = ((g - w).norm() / w.norm()).item()
        if not torch.isfinite(g).all() or rel > BWD_TOL[dtype]:
            raise AssertionError(f"{what}: d{name} relative L2 {rel:.3e} > {BWD_TOL[dtype]} "
                                 "or non-finite")
        errs.append((g - w).abs().max().item())
    lens = kw["kv_len"]
    if lens is not None and lens.ndim == 1 and (lens == 0).any():
        empty = lens == 0
        if any(g[empty].count_nonzero() for g in got):
            raise AssertionError(f"{what}: a row of length 0 has a nonzero gradient")
    _, plain_lse = attn_ref.mha_forward_with_lse_reference(q, k, v, **kw)
    finite = torch.isfinite(plain_lse)
    if not torch.equal(torch.isfinite(lse), finite):
        raise AssertionError(f"{what}: the kernel's lse is -inf on other rows than the plain one")
    lse_err = (lse[finite] - plain_lse[finite]).abs().max().item()
    if lse_err > 1e-3:
        raise AssertionError(f"{what}: lse differs from the plain one by {lse_err:.3e}")
    return max(errs), lse_err, (q, k, v, o, do, lse), kw


def _flash_backward_rows(gen) -> dict:
    """The attention backward kernel (B10): held in f32 and bf16 at every
    BWD_TIMED_SHAPES and BWD_HELD_SHAPES entry; timed in bf16 at the timed
    ones beside its plain version (``mha_backward_reference``), the plain
    autograd backward the train step ran before it (``mha_reference``
    recomputed and differentiated), SDPA's backward alone (its forward run
    once, the graph retained) and the bound of the five products (S, dP, dV,
    dQ, dK) and the bytes (q, k, v, o, dO, lse read, dq, dk, dv written).
    Returns the summary's row (the first timed shape)."""
    rows = {}
    for label, shape in list(BWD_TIMED_SHAPES.items()) + list(BWD_HELD_SHAPES.items()):
        errs = {dt: _flash_backward_case(gen, shape, dt)[:2]
                for dt in (torch.float32, torch.bfloat16)}
        say("kernels", f"flash_attention_backward {label} {shape[:7]}: max_abs_err "
                       f"{errs[torch.float32][0]:.3e} (f32) / {errs[torch.bfloat16][0]:.3e} "
                       f"(bf16), each gradient within relative L2 {BWD_TOL[torch.float32]:g} / "
                       f"{BWD_TOL[torch.bfloat16]:g} of mha_backward_reference; the forward's "
                       f"lse within {errs[torch.float32][1]:.1e} / {errs[torch.bfloat16][1]:.1e}")
        if label not in BWD_TIMED_SHAPES:
            continue
        err, _, (q, k, v, o, do, lse), kw = _flash_backward_case(gen, shape, torch.bfloat16)
        B, Sq, Skv, H, KV, dqk, dv, _ = shape
        pairs = B * H * Sq * (Sq + 1) // 2                  # causal: the pairs a row sees
        flops = 2 * pairs * (3 * dqk + 2 * dv)
        # q, k, v, o and dO read, dq, dk and dv written (bf16), the lse read (fp32)
        n_bytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel()) * 2 + lse.numel() * 4
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        r = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: attn_kernel.flash_attention_backward(q, k, v, o, do, lse, **kw)),
            plain_ms=cuda_ms(lambda: attn_ref.mha_backward_reference(q, k, v, o, do, lse, **kw),
                             reps=10),
            autograd_ms=cuda_ms(lambda: torch.autograd.grad(
                attn_ref.mha_reference(qg, kg, vg), (qg, kg, vg), do), reps=10),
            library_ms=cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                                           retain_graph=True)),
            bound=bound(n_bytes, flops, torch.bfloat16),
        )
        say("kernels", f"{label} flash_attention_backward bf16 {shape[:7]} causal: kernel "
                       f"{r['ms']:.4f} ms, plain (mha_backward_reference) {r['plain_ms']:.4f} "
                       f"ms, plain autograd backward (forward recomputed + gradient) "
                       f"{r['autograd_ms']:.4f} ms, SDPA backward alone {r['library_ms']:.4f} "
                       f"ms, bound {r['bound'][0]:.5f} ms by {r['bound'][1]} ({flops / 1e9:.2f} "
                       f"GFLOP, {n_bytes / 1e6:.1f} MB); device launches a call: the dQ "
                       f"pass, the dK/dV pass ({H * B * -(-Skv // 64)} blocks of 128 threads, "
                       f"one per query head and 64-key tile){', the GQA sum' if H > KV else ''}"
                       f" on {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
        rows.setdefault("flash_attention_backward", r)
        del q, k, v, o, do, lse, qg, kg, vg, qt, kt, vt, sdpa_out
        torch.cuda.empty_cache()
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
                           "D = 896, 320 at 2560; at D = 6144 (internvl2-26b) 384 threads "
                           "of two 8-wide chunks")
    floor_w = cuda_ms(rms_kernel.empty_launch)
    floor_r = cuda_ms(rms_kernel.empty_launch, flush="read")
    say("kernels-rmsnorm", f"launch floor (an empty kernel of the same library, launched "
                           f"through the same ctypes path and cudaLaunchKernelEx): "
                           f"{floor_w:.4f} ms after a 256 MB write flush, {floor_r:.4f} ms "
                           "after a 256 MB read flush")
    rows.update(_rms_backward_rows(gen))
    for D in (896, 2560):
        chain, products = rms_chain_ms(D, rms_kernel.fused_add_rmsnorm)
        say("kernels-rmsnorm", f"(8, 1, {D}) in a decode step's chain: {CHAIN_PAIRS} x "
                               f"(torch.matmul (8, 1, {D}) @ ({D}, {D}), add + norm) "
                               f"{chain:.4f} ms, the products alone {products:.4f} ms: "
                               f"marginal {(chain - products) / CHAIN_PAIRS:.4f} ms a norm "
                               "(bf16, one write flush before the chain)")
    return rows


def _rms_backward_case(gen, shape, dtype, eps=1e-6) -> tuple:
    """``fused_add_rmsnorm_backward`` against
    ``ref.fused_add_rmsnorm_backward_reference`` on the same tensors, each
    gradient within RMS_BWD_TOL (relative L2). Returns (max abs err, the
    call's tensors)."""
    x, d, scale = _rms_case(gen, shape, dtype, eps)[1]
    g_res, g_out = randn(gen, shape, dtype), randn(gen, shape, dtype)
    args = (x, d, scale, g_res, g_out)
    got = rms_kernel.fused_add_rmsnorm_backward(*args, eps)
    torch.cuda.synchronize()
    want = rms_ref.fused_add_rmsnorm_backward_reference(*args, eps)
    errs = []
    for name, g, w in zip(("dx", "ddelta", "dscale"), got, want):
        g, w = g.float(), w.float()
        rel = ((g - w).norm() / w.norm()).item()
        if not torch.isfinite(g).all() or rel > RMS_BWD_TOL[dtype]:
            raise AssertionError(f"fused_add_rmsnorm_backward {shape} {dtype}: {name} relative "
                                 f"L2 {rel:.3e} > {RMS_BWD_TOL[dtype]} or non-finite")
        errs.append((g - w).abs().max().item())
    return max(errs), args


def _rms_backward_rows(gen) -> dict:
    """The add + norm's backward kernel (B13): held in f32 and bf16 at every
    RMS_BWD_SHAPES entry; timed in bf16 at the training rows beside its plain
    version, the plain autograd backward the train step ran before it
    (``fused_add_rmsnorm_reference`` recomputed and differentiated), the
    backward alone of the two PyTorch calls ``x + delta``, ``F.rms_norm``
    (their forward run once) and the bound by bytes (x, delta, g_res, g_out
    read and one dh written for dx and ddelta; scale read, dscale written).
    Returns the summary's row (qwen2-0.5b's rows)."""
    rows = {}
    for label, shape in RMS_BWD_SHAPES.items():
        errs = {dt: _rms_backward_case(gen, shape, dt)[0]
                for dt in (torch.float32, torch.bfloat16)}
        say("kernels-rmsnorm", f"fused_add_rmsnorm_backward {label} {shape}: max_abs_err "
                               f"{errs[torch.float32]:.3e} (f32) / {errs[torch.bfloat16]:.3e} "
                               f"(bf16), each gradient within relative L2 "
                               f"{RMS_BWD_TOL[torch.float32]:g} / {RMS_BWD_TOL[torch.bfloat16]:g} "
                               "of fused_add_rmsnorm_backward_reference")
        if label not in RMS_BWD_TIMED:
            continue
        err, args = _rms_backward_case(gen, shape, torch.bfloat16)
        x, d, scale, g_res, g_out = args
        D = shape[-1]
        n_bytes = 5 * x.numel() * 2 + 2 * D * 4
        xs = [t.detach().requires_grad_() for t in (x, d, scale)]
        xt, dt_, wt = (t.detach().requires_grad_() for t in (x, d, scale.to(x.dtype)))
        res = xt + dt_
        out = F.rms_norm(res, (D,), wt, 1e-6)
        r = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: rms_kernel.fused_add_rmsnorm_backward(*args, 1e-6)),
            plain_ms=cuda_ms(lambda: rms_ref.fused_add_rmsnorm_backward_reference(*args, 1e-6)),
            autograd_ms=cuda_ms(lambda: torch.autograd.grad(
                rms_ref.fused_add_rmsnorm_reference(*xs, 1e-6), xs, (g_res, g_out)), reps=10),
            two_calls_ms=cuda_ms(lambda: torch.autograd.grad(
                (res, out), (xt, dt_, wt), (g_res, g_out), retain_graph=True)),
            library_ms=None,
            bound=bound(n_bytes, 10 * x.numel(), torch.bfloat16),
        )
        say("kernels-rmsnorm", f"{label} fused_add_rmsnorm_backward bf16 {shape}: kernel "
                               f"{r['ms']:.4f} ms, plain (fused_add_rmsnorm_backward_reference) "
                               f"{r['plain_ms']:.4f} ms, the plain autograd backward it replaced "
                               f"(forward recomputed + gradient) {r['autograd_ms']:.4f} ms, the "
                               f"backward of two PyTorch calls (x + delta, F.rms_norm) "
                               f"{r['two_calls_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
                               f"{r['bound'][1]} ({n_bytes / 1e6:.1f} MB); library: none (no "
                               "single PyTorch call)")
        rows.setdefault("fused_add_rmsnorm_backward", r)
        del args, x, d, scale, g_res, g_out, xs, xt, dt_, wt, res, out
        torch.cuda.empty_cache()
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
    return {"ssd": row, **_ssd_backward_rows(gen)}


_SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _ssd_backward_case(gen, shape, dtype, states: bool, pad: int) -> tuple:
    """``ssd_backward`` against ``ref.ssd_backward_reference`` on the same
    tensors: each gradient within SSD_BWD_TOL (relative L2), dx exactly 0 on
    a dt = 0 tail. Returns (max abs err over the gradients, the call's
    tensors)."""
    B, S, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, H, P, G, N, dtype)
    dy = randn(gen, (B, S, H, P), dtype)
    h0 = df = None
    if states:
        h0, df = (torch.randn((B, H, P, N), generator=gen, device=DEVICE) for _ in range(2))
    if pad:
        for t in (x, dt, Bm, Cm, dy):
            t[:, S - pad:] = 0
    args, kw = (x, dt, A, Bm, Cm, dy), dict(chunk=chunk, initial_state=h0, dfinal=df)
    got = ssd_kernel.ssd_backward(*args, **kw)
    torch.cuda.synchronize()
    want = ssd_ref.ssd_backward_reference(*args, **kw)
    what = f"ssd_backward x {(B, S, H, P)} G {G} N {N} chunk {chunk} {dtype}"
    errs = []
    for name, g, w in zip(_SSD_GRADS, got, want):
        if w is None:
            continue
        g, w = g.float(), w.float()
        rel = ((g - w).norm() / w.norm()).item()
        if not torch.isfinite(g).all() or rel > SSD_BWD_TOL[dtype]:
            raise AssertionError(f"{what}: {name} relative L2 {rel:.3e} > {SSD_BWD_TOL[dtype]} "
                                 "or non-finite")
        errs.append((g - w).abs().max().item())
    if pad and got[0][:, S - pad:].count_nonzero():
        raise AssertionError(f"{what}: dx is not 0 on the dt = 0 tail")
    return max(errs), args


def _ssd_backward_rows(gen) -> dict:
    """The scan's backward kernel (B11): held in f32 and bf16 at every
    SSD_BWD_SHAPES entry; timed in bf16 at the training calls beside its plain
    version (``ssd_backward_reference``), the plain autograd backward the
    train step ran before it (``ssd_reference`` recomputed and
    differentiated) and the bound: the causal C B^T once per group, the four
    other causal products and five c P N state products a head (S_k, D_k,
    G B, G^T x, H^T dy), and the bytes (x, dy, B, C, dt, A read; dx, dB, dC,
    ddt, dA written). Returns the summary's row (mamba2-2.7b's call)."""
    rows = {}
    for label, (shape, states, pad) in SSD_BWD_SHAPES.items():
        errs = {dt: _ssd_backward_case(gen, shape, dt, states, pad)[0]
                for dt in (torch.float32, torch.bfloat16)}
        say("kernels-ssd", f"ssd_backward {label} {shape}: max_abs_err {errs[torch.float32]:.3e} "
                           f"(f32) / {errs[torch.bfloat16]:.3e} (bf16), each gradient within "
                           f"relative L2 {SSD_BWD_TOL[torch.float32]:g} / "
                           f"{SSD_BWD_TOL[torch.bfloat16]:g} of ssd_backward_reference"
                           + (", dx 0 on the tail" if pad else ""))
        if label not in SSD_BWD_TIMED:
            continue
        B, S, H, P, G, N, chunk = shape
        err, args = _ssd_backward_case(gen, shape, torch.bfloat16, False, 0)
        x, dt, A, Bm, Cm, dy = args
        nc, tri = S // chunk, chunk * (chunk + 1) // 2
        macs = B * nc * (G * tri * N + H * (tri * (2 * N + 2 * P) + 5 * chunk * P * N))
        per_head = B * nc * H * (tri * (3 * N + 2 * P) + 6 * chunk * P * N)
        n_bytes = (3 * x.numel() + 4 * Bm.numel()) * 2 + (2 * dt.numel() + 2 * H) * 4
        xs = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        r = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: ssd_kernel.ssd_backward(*args, chunk=chunk)),
            plain_ms=cuda_ms(lambda: ssd_ref.ssd_backward_reference(*args, chunk=chunk),
                             reps=5),
            autograd_ms=cuda_ms(lambda: torch.autograd.grad(
                ssd_ref.ssd_reference(*xs, chunk=chunk)[0], xs, dy), reps=5),
            library_ms=None,
            bound=bound(n_bytes, 2 * macs, torch.bfloat16),
        )
        say("kernels-ssd", f"{label} ssd_backward bf16 {shape}: kernel {r['ms']:.4f} ms, plain "
                           f"(ssd_backward_reference) {r['plain_ms']:.4f} ms, the plain autograd "
                           f"backward it replaced (forward recomputed + gradient) "
                           f"{r['autograd_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
                           f"{r['bound'][1]} ({2 * macs / 1e9:.2f} GFLOP; {2 * per_head / 1e9:.2f} "
                           f"counting C B^T per head and six state products; "
                           f"{n_bytes / 1e6:.1f} MB); library: none")
        passes = _kernel_passes(lambda: ssd_kernel.ssd_backward(*args, chunk=chunk),
                                pattern=r"\bssd_bwd_\w+")
        say("kernels-ssd", f"{label} ssd_backward bf16 device time per pass (profiler, mean of "
                           "20 calls, L2 flushed): " + (", ".join(
                               f"{k} {ms * 1e3:.2f} us ({n:g} a call)"
                               for k, (ms, n) in passes.items()) or "not measured"))
        rows.setdefault("ssd_backward", r)
        del args, x, dt, A, Bm, Cm, dy, xs
        torch.cuda.empty_cache()
    return rows


# the previous design's times at the slices' shapes (one block per (row, head)
# walking its chunks; PERF.md, call E of PR 14, H100 80GB HBM3 at 700 W)
SSD_PR14_MS = {SSM_ARCH: 0.5117, HYBRID_ARCH: 0.3837}


def _kernel_passes(fn, calls: int = 20, pattern: str = r"\bssd_\w+") -> dict:
    """{kernel name: (device ms per call, device launches per call)} of each
    kernel whose name matches ``pattern`` (the SSD scan's passes), from
    torch.profiler over `calls` calls, each after a 256 MB write that
    flushes the L2."""
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
        m = re.search(pattern, evt.name)  # e.g. ...::ssd_output_bf16<128, 64>(...)
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
    passes = _kernel_passes(lambda: ssd_kernel.ssd(x, dt, A, Bm, Cm, chunk=chunk,
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
# (decode_attention and mla_decode_attention: the split pass, then the
# combine; flash_attention,
# the encoder-decoder's cross-attention, one); ssd runs only in prefill
STEP_DEVICE_LAUNCHES = {"decode_attention": 2, "mla_decode_attention": 2,
                        "fused_add_rmsnorm": 1, "flash_attention": 1}


def _port_kernel(name: str):
    """The port kernel a device kernel's name (demangled, as the profiler
    gives it, or mangled, as libcuda does) belongs to, or None."""
    if "mla_split_kernel" in name or "mla_combine_kernel" in name:
        return "mla_decode_attention"
    if "decode_split_kernel" in name or "decode_combine_kernel" in name:
        return "decode_attention"
    if "repro_torch_rmsnorm_bwd" in name:
        return "fused_add_rmsnorm_backward"
    if "repro_torch_rmsnorm" in name:
        return "fused_add_rmsnorm"
    if "repro_torch_ssd_bwd" in name:
        return "ssd_backward"
    if "repro_torch_ssd" in name:
        return "ssd"
    if "repro_torch" in name and "flash_attention" in name:
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


def _check_replay(tag: str, want: dict, in_graph, profiled: dict, events: int, nodes) -> None:
    """A replay launches what the capture counted: the graph's kernel nodes
    of each port kernel equal ``want`` (every replay launches every node),
    and the profiled replay shows them too. The profiler loses a few
    activity records of a replay late in a long process (8..33 fewer device
    events than nodes in the later phases; every record in a fresh process,
    whisper's graph included): where it recorded fewer events than the graph
    has nodes, the port kernels it missed must be no more than the records
    it lost. Without the graph's kernel names (``_graph_kernels`` None) the
    profile alone must show exactly ``want``."""
    if events == 0:
        raise AssertionError(f"{tag}: the profiler recorded no device event of a replay")
    if in_graph is None or nodes is None:
        if profiled != want:
            raise AssertionError(f"{tag}: a replay launched {profiled} on the device, the "
                                 f"capture counted {want}")
        return
    if in_graph != want:
        raise AssertionError(f"{tag}: the graph holds the port's kernel nodes {in_graph}, "
                             f"the capture counted {want}")
    lost = nodes - events
    missed = {k: n - profiled.get(k, 0) for k, n in want.items()}
    if (set(profiled) - set(want) or any(m < 0 for m in missed.values())
            or sum(missed.values()) > max(lost, 0)):
        raise AssertionError(f"{tag}: a replay launched {profiled} on the device, the capture "
                             f"counted {want} ({events} device events of {nodes} nodes)")
    if sum(missed.values()):
        say(tag, f"the profiler lost {lost} of the replay's {nodes} records, "
                 f"{sum(missed.values())} of them the port's kernels {missed}")


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


def _graph_kernels(graph):
    """{port kernel: kernel nodes} of a captured graph, by each kernel node's
    function name (``cuGraphKernelNodeGetParams_v2``, then ``cuFuncGetName``
    or ``cuKernelGetName``): what every replay launches. None where PyTorch
    does not keep the graph or libcuda cannot name a node's kernel."""
    import ctypes
    from ctypes import POINTER, byref, c_char_p, c_int, c_size_t, c_uint, c_void_p

    class KernelNodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2, cuda.h
        _fields_ = [("func", c_void_p), ("grid", c_uint * 3), ("block", c_uint * 3),
                    ("shared_mem_bytes", c_uint), ("kernel_params", c_void_p),
                    ("extra", c_void_p), ("kern", c_void_p), ("ctx", c_void_p)]

    try:
        raw = graph.raw_cuda_graph()
        cu = ctypes.CDLL("libcuda.so.1")
        get_params, func_name = cu.cuGraphKernelNodeGetParams_v2, cu.cuFuncGetName
        kernel_name = cu.cuKernelGetName
    except (AttributeError, RuntimeError, OSError):
        return None
    get_params.argtypes = [c_void_p, POINTER(KernelNodeParams)]
    func_name.argtypes = kernel_name.argtypes = [POINTER(c_char_p), c_void_p]
    n = c_size_t(0)
    if cu.cuGraphGetNodes(c_void_p(raw), None, byref(n)) != 0:
        return None
    nodes = (c_void_p * n.value)()
    if cu.cuGraphGetNodes(c_void_p(raw), nodes, byref(n)) != 0:
        return None
    counts = {}
    for node in nodes:
        kind = c_int(-1)
        if cu.cuGraphNodeGetType(c_void_p(node), byref(kind)) != 0:
            return None
        if kind.value != 0:                             # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = KernelNodeParams(), c_char_p()
        if get_params(c_void_p(node), byref(params)) != 0:
            return None
        if not ((params.func and func_name(byref(name), params.func) == 0)
                or (params.kern and kernel_name(byref(name), params.kern) == 0)):
            return None
        k = _port_kernel(name.value.decode())
        if k is not None:
            counts[k] = counts.get(k, 0) + 1
    return counts


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
    # MLA's absorbed decode runs its own kernel over the latent caches
    decode = "mla_decode_attention" if cfg.mla is not None else "decode_attention"
    return {"flash_attention": n_req * L, decode: steps * L,
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
            in_graph = _graph_kernels(graph.graph)
            profiled, events = _replay_device_launches(graph, model.kernel_impl)
            want = {k: n * STEP_DEVICE_LAUNCHES[k] for k, n in graph.launches.items() if n}
            say(tag, f"graph: built with its warm-up and capture in {run['build_s']:.3f} s, "
                     f"{'node count not exposed' if nodes is None else f'{nodes} nodes'}, "
                     f"the port's kernel nodes {in_graph}; captured calls {graph.launches}; "
                     f"one replay under torch.profiler: {events} device events, the port's "
                     f"kernels {profiled} (want {want})")
            _check_replay(tag, want, in_graph, profiled, events, nodes)
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


def _counts(**calls) -> dict:
    """Every kernel's launch count: ``calls``, 0 for the rest."""
    out = dict.fromkeys(_launch_counts(), 0)
    out.update(calls)
    return out


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
        try:
            with client.session(np.arange(8) % model.cfg.vocab,
                                endpoint_id=ep.endpoint_id) as s:
                list(s.stream(3))
        except Exception:
            say("fabric", f"{name}: the warm-up session on {ep.name} failed; the service's "
                          f"counters {_counters(svc)}")
            raise
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


# ------------------------------------------------------------------ training
def _train_model(dtype: str, arch: str = ARCH) -> Model:
    cfg = get_config(arch).with_(dtype=dtype)
    model = Model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    return model.requires_grad_(True)


def _train_batch(cfg, step: int = 0, batch: int = TRAIN_BATCH) -> dict:
    return {k: torch.as_tensor(v).to(DEVICE)
            for k, v in synthetic_batch(cfg, batch, TRAIN_SEQ, step).items()}


def _loss_and_grads(model: Model, batch: dict, impl: str) -> tuple:
    model.kernel_impl = impl
    names, leaves = zip(*model.named_parameters())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves)
    model.kernel_impl = "auto"
    return loss.item(), dict(zip(names, grads))


def _rel_l2(got: dict, want: dict) -> dict:
    return {n: ((got[n].float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)).item()
            for n, w in want.items()}


def _train_check_grads(tag: str) -> None:
    """(a): one step's loss and every gradient leaf through the kernels
    against the plain path (impl="ref") on the same weights and batch."""
    for dtype in (torch.float32, torch.bfloat16):
        model = _train_model(str(dtype).removeprefix("torch."))
        batch = _train_batch(model.cfg)
        loss_k, grads_k = _loss_and_grads(model, batch, "auto")
        loss_r, grads_r = _loss_and_grads(model, batch, "ref")
        dloss = abs(loss_k - loss_r)
        rel = _rel_l2(grads_k, grads_r)
        worst = max(rel, key=rel.get)
        loss_tol, leaf_tol = TRAIN_TOL[dtype]
        say(tag, f"(a) {dtype}: loss {loss_k:.6f} (kernels) against {loss_r:.6f} (plain), "
                 f"|dloss| {dloss:.3e}; {len(rel)} gradient leaves, largest relative L2 "
                 f"difference {rel[worst]:.3e} ({worst}), median "
                 f"{float(np.median(list(rel.values()))):.3e} (tolerances {loss_tol:g} / "
                 f"{leaf_tol:g})")
        bad = [n for n, g in grads_k.items() if not torch.isfinite(g).all()]
        if bad or not np.isfinite(loss_k) or dloss > loss_tol or rel[worst] > leaf_tol:
            raise AssertionError(f"{tag} {dtype}: |dloss| {dloss:.3e} > {loss_tol} or leaf "
                                 f"{worst} {rel[worst]:.3e} > {leaf_tol} or non-finite {bad}")
        del model, grads_k, grads_r
        torch.cuda.empty_cache()


def _train_check_scan_grads(tag: str, arch: str, batch: int) -> None:
    """(a) for the scan families, on one set of weights: the bf16 model's
    (seed 0) and the same values in f32. f32: the loss and every gradient
    leaf through the kernels against the plain path within TRAIN_TOL. bf16:
    |dloss| within TRAIN_TOL, and each leaf's relative L2 distance to the
    f32 plain gradients (the truth) at most TRAIN_BF16_TRUTH_RATIO x the
    plain bf16 path's own distance to them: the plain bf16 path is itself
    ~9% from the truth there, so two bf16 paths cannot agree within
    TRAIN_TOL's 0.05 (the kernels-against-plain distance is printed)."""
    bf = _train_model("bfloat16", arch)
    data = _train_batch(bf.cfg, batch=batch)
    f32 = Model(bf.cfg.with_(dtype="float32"), device=DEVICE)
    f32.load_state_dict({k: v.float() for k, v in bf.state_dict().items()})
    f32.requires_grad_(True)
    loss_t, truth = _loss_and_grads(f32, data, "ref")
    loss_k, grads_k = _loss_and_grads(f32, data, "auto")
    rel = _rel_l2(grads_k, truth)
    worst = max(rel, key=rel.get)
    loss_tol, leaf_tol = TRAIN_TOL[torch.float32]
    dloss = abs(loss_k - loss_t)
    say(tag, f"(a) torch.float32 (the bf16 weights' values): loss {loss_k:.6f} (kernels) "
             f"against {loss_t:.6f} (plain), |dloss| {dloss:.3e}; {len(rel)} gradient leaves, "
             f"largest relative L2 difference {rel[worst]:.3e} ({worst}), median "
             f"{float(np.median(list(rel.values()))):.3e} (tolerances {loss_tol:g} / "
             f"{leaf_tol:g})")
    bad = [n for n, g in grads_k.items() if not torch.isfinite(g).all()]
    if bad or dloss > loss_tol or rel[worst] > leaf_tol:
        raise AssertionError(f"{tag} f32: |dloss| {dloss:.3e} > {loss_tol} or leaf {worst} "
                             f"{rel[worst]:.3e} > {leaf_tol} or non-finite {bad}")
    del f32, grads_k
    torch.cuda.empty_cache()
    loss_k, grads_k = _loss_and_grads(bf, data, "auto")
    loss_r, grads_r = _loss_and_grads(bf, data, "ref")
    k_t, r_t, k_r = _rel_l2(grads_k, truth), _rel_l2(grads_r, truth), _rel_l2(grads_k, grads_r)
    ratio = {n: k_t[n] / max(r_t[n], 1e-30) for n in k_t}
    worst = max(ratio, key=ratio.get)
    loss_tol = TRAIN_TOL[torch.bfloat16][0]
    dloss = abs(loss_k - loss_r)
    say(tag, f"(a) torch.bfloat16: loss {loss_k:.6f} (kernels) against {loss_r:.6f} (plain), "
             f"|dloss| {dloss:.3e} (tolerance {loss_tol:g}); relative L2 distance of each "
             f"gradient leaf to the f32 plain gradients: kernels median "
             f"{float(np.median(list(k_t.values()))):.3e}, plain bf16 median "
             f"{float(np.median(list(r_t.values()))):.3e}; largest ratio {ratio[worst]:.3f} "
             f"({worst}: {k_t[worst]:.3e} against {r_t[worst]:.3e}; at most "
             f"{TRAIN_BF16_TRUTH_RATIO:g}); kernels against plain bf16: median "
             f"{float(np.median(list(k_r.values()))):.3e}, largest {max(k_r.values()):.3e}")
    bad = [n for n, g in grads_k.items() if not torch.isfinite(g).all()]
    if bad or not np.isfinite(loss_k) or dloss > loss_tol \
            or ratio[worst] > TRAIN_BF16_TRUTH_RATIO:
        raise AssertionError(f"{tag} bf16: |dloss| {dloss:.3e} > {loss_tol}, or leaf {worst} "
                             f"{ratio[worst]:.3f} x the plain path's distance to the truth, "
                             f"or non-finite {bad}")
    del bf, grads_k, grads_r, truth
    torch.cuda.empty_cache()


def _attention_layers(cfg) -> int:
    """Calls of attention (and of the add + norm) a forward makes: one a dense
    layer or a hybrid group's shared block, none for the ssm family."""
    return {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1)}.get(
        cfg.family, cfg.n_layers)


def _forward_counts(cfg) -> dict:
    """Kernel calls of one forward: flash attention and the add + norm once a
    dense layer or a hybrid group's shared block, the scan once a Mamba2
    layer; whisper's encoder self and decoder self + cross attention (its
    norms are LayerNorms)."""
    if cfg.family == "encdec":
        return _counts(flash_attention=cfg.n_enc_layers + 2 * cfg.n_layers)
    attn = _attention_layers(cfg)
    scan = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return _counts(flash_attention=attn, fused_add_rmsnorm=attn, ssd=scan)


def _train_counts(cfg) -> dict:
    """Kernel calls of one train step (remat on): each forward call twice,
    forward and recompute; each backward kernel once a forward call."""
    fwd = _forward_counts(cfg)
    return {k: 2 * n for k, n in fwd.items()} | {
        f"{k}_backward": fwd[k] for k in ("flash_attention", "fused_add_rmsnorm", "ssd")}


def _backward_ms(model: Model, batch: int = TRAIN_BATCH) -> dict:
    """Each kernel on the model's training path at the training shapes:
    {name: {"backward": device ms of one call of its backward kernel,
    "plain": the plain autograd backward it replaced (the plain forward
    recomputed and differentiated), "kernel": the kernel forward's ms,
    "bound": (the forward's least ms, "bytes" or "operations"), "library":
    {yardstick: ms}}}. The yardsticks: ``F.scaled_dot_product_attention``'s
    forward, its forward + backward and its backward alone (B10); the add +
    norm's two calls ``x + delta`` and ``F.rms_norm``, forward and backward;
    none for the scan."""
    cfg, gen = model.cfg, torch.Generator(device=DEVICE).manual_seed(5)
    dt = model.params["embed"]["tok"].dtype
    esz = torch.empty((), dtype=dt).element_size()
    B, S = batch, TRAIN_SEQ
    counts = _train_counts(cfg)
    out = {}
    if counts["flash_attention"]:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, go = (randn(gen, (B, S, H, hd), dt).requires_grad_() for _ in range(2))
        k, v = (randn(gen, (B, S, KV, hd), dt).requires_grad_() for _ in range(2))
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
        with torch.no_grad():
            sdpa_fwd = cuda_ms(sdpa)
        sdpa_out, got = sdpa(), go.detach().transpose(1, 2)
        qd, kd, vd, god = (t.detach() for t in (q, k, v, go))
        o, lse = attn_kernel._flash_launch(qd, kd, vd, with_lse=True, causal=True, q_offset=None,
                                           kv_len=None, scale=None)
        plain = cuda_ms(lambda: torch.autograd.grad(
            attn_ref.mha_reference(q, k, v), (q, k, v), go.detach()), reps=10)
        out["flash_attention"] = {
            "backward": cuda_ms(lambda: attn_kernel.flash_attention_backward(qd, kd, vd, o, god,
                                                                             lse)),
            "plain": plain,
            "kernel": cuda_ms(lambda: attn_kernel.flash_attention(qd, kd, vd)),
            # q, k, v read, o written; the causal QK^T and PV
            "bound": bound((2 * q.numel() + 2 * k.numel()) * esz,
                           2 * B * H * S * S * hd, dt),
            "library": {"SDPA forward": sdpa_fwd, "SDPA forward + backward": cuda_ms(
                lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), got), reps=10),
                "SDPA backward alone": cuda_ms(lambda: torch.autograd.grad(
                    sdpa_out, (qt, kt, vt), got, retain_graph=True))},
        }
        del sdpa_out, o, lse
    if counts["fused_add_rmsnorm"]:
        x, d = (randn(gen, (B, S, cfg.d_model), dt).requires_grad_() for _ in range(2))
        scale = torch.ones(cfg.d_model, device=DEVICE, requires_grad=True)
        g_res, g_out = (randn(gen, (B, S, cfg.d_model), dt) for _ in range(2))
        xd, dd, sd = x.detach(), d.detach(), scale.detach()
        plain = cuda_ms(lambda: torch.autograd.grad(
            rms_ref.fused_add_rmsnorm_reference(x, d, scale, cfg.norm_eps), (x, d, scale),
            (g_res, g_out)), reps=10)
        xt, dt_, wt = (t.detach().requires_grad_() for t in (x, d, scale.to(dt)))
        res = xt + dt_
        normed = F.rms_norm(res, (cfg.d_model,), wt, cfg.norm_eps)
        out["fused_add_rmsnorm"] = {
            "backward": cuda_ms(lambda: rms_kernel.fused_add_rmsnorm_backward(
                xd, dd, sd, g_res, g_out, cfg.norm_eps)),
            "plain": plain,
            "kernel": cuda_ms(lambda: rms_kernel.fused_add_rmsnorm(xd, dd, sd, cfg.norm_eps)),
            # x and delta read, both outputs written, the fp32 scale read
            "bound": bound(4 * x.numel() * esz + scale.numel() * 4, 0, dt),
            "library": {"x + delta, F.rms_norm (two calls)": cuda_ms(
                lambda: F.rms_norm(xd + dd, (cfg.d_model,), sd.to(dt), cfg.norm_eps)),
                "their backward alone": cuda_ms(lambda: torch.autograd.grad(
                    (res, normed), (xt, dt_, wt), (g_res, g_out), retain_graph=True))},
        }
        del res, normed
    if counts["ssd"]:
        s = cfg.ssm
        H, P, G, N = s.n_heads(cfg.d_model), s.head_dim, s.n_groups, s.d_state
        args = [t.requires_grad_() for t in _ssd_inputs(gen, B, S, H, P, G, N, dt)]
        gy = randn(gen, (B, S, H, P), dt)
        x = args[0]
        plain = cuda_ms(lambda: torch.autograd.grad(
            ssd_ref.ssd_reference(*args, chunk=s.chunk)[0], args, gy), reps=5)
        detached = [t.detach() for t in args]
        out["ssd"] = {
            "backward": cuda_ms(lambda: ssd_kernel.ssd_backward(*detached, gy, chunk=s.chunk)),
            "plain": plain,
            "kernel": cuda_ms(lambda: ssd_kernel.ssd(*detached, chunk=s.chunk)),
            # x in, y out, B, C (the activation dtype), dt and A (fp32)
            "bound": bound((2 * x.numel() + 2 * B * S * G * N) * esz + (B * S * H + H) * 4,
                           _scan_flops(cfg, B, S), dt),
            "library": {},
        }
    return out


def _scan_flops(cfg, B: int, S: int) -> float:
    """The SSD scan's forward FLOPs at (B, S), as the kernels phase counts
    them (the causal pairs of C B^T per group, (C B^T o L)(dt x), the state
    read-out and update)."""
    s = cfg.ssm
    H, P, G, N, chunk = s.n_heads(cfg.d_model), s.head_dim, s.n_groups, s.d_state, s.chunk
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    return 2 * B * nc * (G * tri * N + H * tri * P + 2 * H * chunk * P * N)


def _train_flops(model: Model, batch: int = TRAIN_BATCH) -> float:
    """Model FLOPs of one step (remat's recompute not counted): 6 x the
    non-embedding weights x B*S tokens (a hybrid's shared block counted once
    per group), 6 x a tied unembedding's d x V x the B*(S-1) scored rows, the
    causal attention's QK^T and PV, 3 x the forward's 2*B*H*S^2*hd a layer
    or group, and 3 x the SSD scan's forward a Mamba2 layer."""
    cfg, B, S = model.cfg, batch, TRAIN_SEQ
    counts = _train_counts(cfg)
    weights = _non_embedding(model)
    if cfg.family == "hybrid":
        shared = sum(p.numel() for n, p in model.named_parameters() if n.startswith("shared."))
        weights += (counts["flash_attention"] // 2 - 1) * shared
    flops = 6 * weights * B * S
    if cfg.tie_embeddings:
        flops += 6 * cfg.d_model * cfg.vocab * B * (S - 1)
    if counts["flash_attention"]:
        flops += 3 * 2 * B * cfg.n_heads * S * S * cfg.hd * counts["flash_attention"] // 2
    if counts["ssd"]:
        flops += 3 * _scan_flops(cfg, B, S) * cfg.n_layers
    return flops


def _non_embedding(model: Model) -> int:
    return sum(p.numel() for n, p in model.named_parameters() if n != "embed.tok")


_KERNEL_WORDS = {"flash_attention": "attention", "fused_add_rmsnorm": "add + norm",
                 "ssd": "scan"}


# the plain versions that no step may run on a CUDA tensor: (module, name)
PLAIN_VERSIONS = ((attn_ref, "mha_reference"), (rms_ref, "fused_add_rmsnorm_reference"),
                  (ssd_ref, "ssd_reference"))


@contextlib.contextmanager
def _plain_calls():
    """Counts the calls of each of PLAIN_VERSIONS on CUDA tensors while open
    (the wrappers and ``ops`` reach them through the modules' attributes): a
    plain version, or its gradient, run on the card. Yields {name: calls}."""
    calls = {name: 0 for _, name in PLAIN_VERSIONS}
    saved = [(mod, name, getattr(mod, name)) for mod, name in PLAIN_VERSIONS]

    def counted(name, plain):
        def call(x, *args, **kw):
            calls[name] += int(x.is_cuda)
            return plain(x, *args, **kw)
        return call

    for mod, name, plain in saved:
        setattr(mod, name, counted(name, plain))
    try:
        yield calls
    finally:
        for mod, name, plain in saved:
            setattr(mod, name, plain)


def _check_plain_calls(tag: str, calls: dict, during: str) -> None:
    if any(calls.values()):
        raise AssertionError(f"{tag}: plain versions ran on the card during {during}: {calls}")
    say(tag, f"plain versions on the card during {during}: {calls}")


def _timed_steps(model: Model, state, data: dict, ocfg) -> tuple:
    """TRAIN_TIMED_STEPS steps of ``model`` split by CUDA events: ([[forward,
    backward, optimizer] ms of each step], the optimizer state after them)."""
    params = model.params
    leaves = train_opt.tree_leaves(params)
    dtypes = train_opt.tree_map(lambda p: p.dtype, params)
    gdt = getattr(torch, ocfg.grad_dtype)
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = model.loss(data)
        ev[1].record()
        grads = [g.to(gdt) for g in torch.autograd.grad(loss, leaves)]
        ev[2].record()
        grads = train_opt.tree_unflatten(params, grads)
        new, state = train_opt.apply_updates(grads, state, ocfg, dtypes)
        with torch.no_grad():
            train_opt.tree_map(lambda p, w: p.copy_(w), params, new)
        ev[3].record()
        ev[3].synchronize()
        times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        del grads, new
    return times, state


def _train_time_steps(tag: str, model: Model, batch: int = TRAIN_BATCH) -> None:
    """(b) and the timings: one step through ``build_train_step`` with the
    launch counters set to 0 just before it (exactly ``_train_counts``:
    forward and remat's recompute, attention's backward kernel; no decode
    attention); then TRAIN_TIMED_STEPS steps split by CUDA events into
    forward, backward and optimizer. In both, ``ref.mha_reference`` runs on
    no CUDA tensor."""
    cfg = model.cfg
    ocfg = train_opt.OptimizerConfig()
    params = model.params
    state = train_opt.init_state(params, ocfg)
    step = build_train_step(model, ocfg).fn
    data = _train_batch(cfg, batch=batch)
    for _ in range(2):                      # warm-up: cuBLAS handles, allocator
        step(params, state, data)
    torch.cuda.synchronize()
    need = _train_counts(cfg)
    with _plain_calls() as plain_calls:
        _reset_launches()
        _, _, m = step(params, state, data)
        torch.cuda.synchronize()
        launches = _launch_counts()
        if launches != need:
            raise AssertionError(f"{tag}: one train step launched {launches}, not {need}")
        say(tag, f"(b) one train step launched {launches}: the forward kernels twice a call "
                 "(forward + remat recompute), each backward kernel once a call")
        torch.cuda.reset_peak_memory_stats()
        times, state = _timed_steps(model, state, data, ocfg)
    _check_plain_calls(tag, plain_calls, f"(b) and the {TRAIN_TIMED_STEPS} timed steps")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    fwd, bwd, optim = (float(np.median(c)) for c in zip(*times))
    total = float(np.median([sum(t) for t in times]))
    flops = _train_flops(model, batch)
    tokens = batch * TRAIN_SEQ
    timed = _backward_ms(model, batch)
    parts = []
    for name, r in timed.items():
        n, word = need[name] // 2, _KERNEL_WORDS[name]
        parts.append(f"the {word} backward kernel {r['backward']:.4f} ms a call alone, x {n} = "
                     f"{n * r['backward']:.3f} ms, {n * r['backward'] / bwd:.1%} of it")
    say(tag, f"step (median of {TRAIN_TIMED_STEPS}, CUDA events) {total:.3f} ms: forward "
             f"{fwd:.3f}, backward {bwd:.3f} (remat's recompute included; "
             + "; ".join(parts) + f"), optimizer {optim:.3f}")
    say(tag, f"{tokens / total * 1e3:.1f} tokens/s; model FLOPs {flops / 1e12:.3f} TFLOP a "
             f"step (6 x {_non_embedding(model) / 1e6:.1f} M non-embedding weights x "
             f"{tokens} tokens + the tied unembedding + attention + the scan): "
             f"MFU {flops / (total / 1e3) / PEAK_FLOPS[torch.bfloat16]:.3%} of the bf16 dense "
             f"peak ({flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.3f} ms at 989 TFLOP/s); peak "
             f"allocated {peak:.3f} GiB")
    for name, r in timed.items():
        say(tag, f"{name} at the training shape: kernel forward {r['kernel']:.4f} ms against "
                 f"its bound {r['bound'][0]:.5f} ms by {r['bound'][1]}; backward kernel "
                 f"{r['backward']:.4f} ms a call, the plain backward it replaced "
                 f"{r['plain']:.4f} ms a call" + "".join(
                     f"; {k} {v:.4f} ms" for k, v in r["library"].items()))
    if not np.isfinite(float(m["loss"])):
        raise AssertionError(f"{tag}: non-finite loss {m}")


def _train_run(model: Model, ocfg, steps: int, ckpt_dir, batch: int = TRAIN_BATCH) -> tuple:
    """A Trainer of ``steps`` steps whose steps run as functions through a
    FunctionService (one endpoint, one worker), checkpointing into
    ``ckpt_dir`` (None: no checkpoints); returns (start step, history, seconds)."""
    svc = FunctionService()
    svc.make_endpoint("train", n_executors=1, workers_per_executor=1)
    try:
        trainer = Trainer(model, ocfg, TrainConfig(
            steps=steps, batch=batch, seq=TRAIN_SEQ, ckpt_every=TRAIN_CKPT_EVERY,
            ckpt_dir=ckpt_dir, log_every=5), service=svc)
        start = trainer.step
        t0 = time.perf_counter()
        history = trainer.run()
        wall = time.perf_counter() - t0
        ep = list(svc.endpoints.values())[0]
        if ep.completed < steps - start:
            raise AssertionError(f"the endpoint completed {ep.completed} steps, not "
                                 f"{steps - start}: the steps did not go through the fabric")
    finally:
        svc.shutdown()
    return start, history, wall


def _train_resume(tag: str, model: Model) -> dict:
    """(c) and (d): a Trainer runs TRAIN_STEPS steps through the fabric with a
    checkpoint every TRAIN_CKPT_EVERY; with the newest checkpoint removed, a
    second Trainer on the same directory resumes at TRAIN_CKPT_EVERY and its
    losses must match the first run's; then a bf16 checkpoint's round trip.
    Returns the two runs' launches."""
    ocfg = train_opt.OptimizerConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp, _plain_calls() as plain_calls:
        ckpt = str(Path(tmp) / "ckpt")
        _reset_launches()
        _, first, wall = _train_run(model, ocfg, TRAIN_STEPS, ckpt)
        steps = Checkpointer(ckpt).list_steps()
        if steps != [TRAIN_CKPT_EVERY, TRAIN_STEPS]:
            raise AssertionError(f"{tag}: checkpoints at {steps}")
        size = sum(f.stat().st_size for f in Path(ckpt).rglob("*.npy")) / 1e9 / len(steps)
        shutil.rmtree(Path(ckpt) / f"step_{TRAIN_STEPS:08d}")
        start, second, wall2 = _train_run(model, ocfg, TRAIN_STEPS, ckpt)
        launches = _launch_counts()
        _check_plain_calls(tag, plain_calls, "the two trainer runs")
        losses = [h["loss"] for h in first]
        resumed = [h["loss"] for h in second]
        if start != TRAIN_CKPT_EVERY or [h["step"] for h in second] != list(
                range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1)):
            raise AssertionError(f"{tag}: the second trainer started at {start} and ran "
                                 f"{[h['step'] for h in second]}")
        diff = float(np.max(np.abs(np.subtract(resumed, losses[TRAIN_CKPT_EVERY:]))))
        early, late = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        say(tag, f"(c) {TRAIN_STEPS} steps through a FunctionService (one endpoint, one "
                 f"worker), lr {ocfg.lr:g}: losses {' '.join(f'{x:.4f}' for x in losses)} in "
                 f"{wall:.1f} s with checkpoints at {steps} ({size:.3f} GB each); resumed at "
                 f"step {start} after removing step {TRAIN_STEPS}'s, steps "
                 f"{TRAIN_CKPT_EVERY + 1}-{TRAIN_STEPS} in {wall2:.1f} s: max |dloss| "
                 f"{diff:.3e} (tolerance {TRAIN_RESUME_TOL:g}); mean of the first 5 {early:.4f}, "
                 f"of the last 5 {late:.4f}")
        if not (np.all(np.isfinite(losses + resumed)) and diff <= TRAIN_RESUME_TOL
                and late < early):
            raise AssertionError(f"{tag}: resume |dloss| {diff:.3e}, first 5 {early}, last 5 "
                                 f"{late}, or a non-finite loss")
        need = _train_counts(model.cfg)
        ran = len(first) + len(second)
        if launches != {k: n * ran for k, n in need.items()}:
            raise AssertionError(f"{tag}: {ran} trainer steps launched {launches}")

        # (d) a bf16 checkpoint restores to bf16 tensors equal to those saved
        ck = Checkpointer(str(Path(tmp) / "bf16"), async_save=False)
        ck.save(0, model.params)
        _, back = ck.restore(model.params)
        pairs = list(zip(train_opt.tree_leaves(back), train_opt.tree_leaves(model.params)))
        if any(b.dtype != p.dtype or not torch.equal(b.to(DEVICE), p) for b, p in pairs):
            raise AssertionError(f"{tag}: a restored weight differs in dtype or value")
        n_bf16 = sum(p.dtype == torch.bfloat16 for _, p in pairs)
        say(tag, f"(d) a checkpoint of the {len(pairs)} weights restored equal, the "
                 f"{n_bf16} bf16 leaves as bf16 (the fp32 norm scales as fp32)")
    return launches


def phase_train() -> dict:
    """Full-width qwen2-0.5b trained on the card: (a) kernel gradients against
    the plain path, (b) the launches of one step and the step's time split,
    (c) 20 steps through the fabric and a resume from step 10, (d) a bf16
    checkpoint's round trip. Returns the trainer runs' launches."""
    tag = "train"
    t0 = time.perf_counter()
    say(tag, f"{ARCH} bf16 at full width, B = {TRAIN_BATCH}, S = {TRAIN_SEQ}, remat on, "
             "random weights from seed 0, the reference's synthetic token stream")
    _train_check_grads(tag)
    model = _train_model("bfloat16")
    _train_time_steps(tag, model)
    launches = _train_resume(tag, model)
    del model
    torch.cuda.empty_cache()
    say(tag, f"wall {time.perf_counter() - t0:.1f} s")
    return launches


def _train_peak_batch(tag: str, model: Model) -> int:
    """TRAIN_BATCH, unless one train step's peak there leaves under
    TRAIN_MIN_FREE_GIB of the card free: then TRAIN_SMALL_BATCH (said on the
    phase's line)."""
    ocfg = train_opt.OptimizerConfig()
    params = model.params
    state = train_opt.init_state(params, ocfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build_train_step(model, ocfg).fn(params, state, _train_batch(model.cfg))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    del state
    torch.cuda.empty_cache()
    if total - peak >= TRAIN_MIN_FREE_GIB:
        say(tag, f"B = {TRAIN_BATCH}: one step's peak {peak:.3f} GiB leaves "
                 f"{total - peak:.3f} of {total:.3f} GiB free")
        return TRAIN_BATCH
    say(tag, f"B = {TRAIN_SMALL_BATCH}, not {TRAIN_BATCH}: one step's peak at B = "
             f"{TRAIN_BATCH} is {peak:.3f} GiB, leaving {total - peak:.3f} of {total:.3f} GiB "
             f"free (under {TRAIN_MIN_FREE_GIB} GiB)")
    return TRAIN_SMALL_BATCH


def phase_train_scan(arch: str, tag: str) -> dict:
    """Full-width mamba2-2.7b or zamba2-2.7b trained on the card on its own
    model (bf16, seed 0, remat on, the reference's synthetic tokens), as the
    train phase trains qwen2: (a) kernel gradients against the plain path,
    (b) the launches of one step and the step's time split, with each
    backward kernel's time a call; (c) TRAIN_SCAN_STEPS steps through a
    Trainer on the fabric, the losses falling. Returns (c)'s launches."""
    t0 = time.perf_counter()
    model = _train_model("bfloat16", arch)
    say(tag, f"{arch} bf16 at full width, S = {TRAIN_SEQ}, remat on, random weights from "
             "seed 0, the reference's synthetic token stream")
    batch = _train_peak_batch(tag, model)
    _train_time_steps(tag, model, batch)
    del model
    torch.cuda.empty_cache()
    _train_check_scan_grads(tag, arch, batch)
    model = _train_model("bfloat16", arch)
    ocfg = train_opt.OptimizerConfig(warmup_steps=2, total_steps=TRAIN_SCAN_STEPS)
    _reset_launches()
    with _plain_calls() as plain_calls:
        _, history, wall = _train_run(model, ocfg, TRAIN_SCAN_STEPS, None, batch)
    launches = _launch_counts()
    _check_plain_calls(tag, plain_calls, "the trainer run")
    losses = [h["loss"] for h in history]
    early, late = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    say(tag, f"(c) {TRAIN_SCAN_STEPS} steps of {batch} x {TRAIN_SEQ} through a "
             f"FunctionService (one endpoint, one worker), lr {ocfg.lr:g}: losses "
             f"{' '.join(f'{x:.4f}' for x in losses)} in {wall:.1f} s; mean of the first 3 "
             f"{early:.4f}, of the last 3 {late:.4f}; launches {launches}")
    need = {k: n * TRAIN_SCAN_STEPS for k, n in _train_counts(model.cfg).items()}
    if not (np.all(np.isfinite(losses)) and late < early) or launches != need:
        raise AssertionError(f"{tag}: losses {losses} do not fall, or the trainer's steps "
                             f"launched {launches}, not {need}")
    del model
    torch.cuda.empty_cache()
    say(tag, f"wall {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ shapes
def _cache_leaves(cache: dict, axes: dict, prefix: str = ""):
    """(name, leaf, batch axis) of every cache leaf."""
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, axes[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v, axes[k]


def _rows(cache: dict, axes: dict, n: int) -> dict:
    """Views of the first ``n`` slots of every cache leaf (written through)."""
    return {k: _rows(v, axes[k], n) if isinstance(v, dict) else v.narrow(axes[k], 0, n)
            for k, v in cache.items()}


def _state_leaves(cache: dict, axes: dict):
    """The leaves a decode step changes for good: the SSM conv and state (a
    K/V leaf is only written at pos, by each path with its own values)."""
    return [leaf for name, leaf, _ in _cache_leaves(cache, axes)
            if name.split(".")[-1] in ("conv", "ssm")]


def _shape_decode(arch: str, rec: dict) -> dict:
    """One decode cell at its assigned batch and length on full-width bf16
    (seed 0): the cache filled with seeded normal values, pos = S - 1. The
    first SHAPES_CHECK_SLOTS slots, from the same state: the step's tokens
    through the kernels against the plain path's (near-tie rule); then the
    step at every slot timed (median of SHAPES_DECODE_REPS, counters set to 0
    just before them) against the analysis's bound, and the peak against the
    modeled one. Returns the timed steps' launches."""
    tag = "shapes"
    cfg, shape = get_config(arch), dryrun.SHAPES[rec["shape"]]
    B, S = shape.global_batch, shape.seq_len
    tol = SHAPES_TOL.get(arch, SLICE_SSM_BF16_TOL)
    torch.cuda.empty_cache()
    model = Model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    cache = model.init_cache(B, S)
    axes = model.cache_batch_axes()
    for _, leaf, _ in _cache_leaves(cache, axes):
        leaf.normal_(generator=gen)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=DEVICE, dtype=torch.int32)
    pos = torch.tensor(S - 1, device=DEVICE)
    n = min(SHAPES_CHECK_SLOTS, B)
    view = _rows(cache, axes, n)
    kept = [t.clone() for t in _state_leaves(view, axes)]

    def restore():
        for dst, src in zip(_state_leaves(view, axes), kept):
            dst.copy_(src)

    step = build_decode_step(model).fn
    params = model.params
    got_tok, _ = step(params, token[:n], view, pos)
    out = {}
    for impl in ("auto", "ref"):
        restore()
        model.kernel_impl = impl
        with torch.no_grad():
            out[impl], _ = model.decode_step(token[:n], view, pos)
    model.kernel_impl = "auto"
    restore()
    del kept
    got, want = out["auto"].float(), out["ref"].float()
    diff = (got - want).abs().max().item()
    pick = got.argmax(-1)
    gap = (want.amax(-1) - want.gather(-1, pick[:, None])[:, 0]).max().item()
    agree = int((pick == want.argmax(-1)).sum())
    if not torch.isfinite(got).all() or not torch.equal(got_tok[:, 0].long(), pick) \
            or diff > tol or gap > tol:
        raise AssertionError(f"{tag} {arch} {shape.name}: max|dlogit| {diff:.3e} or near-tie "
                             f"gap {gap:.3e} > {tol}, or the step's tokens are not its logits'")

    step(params, token, cache, pos)                     # warm-up at every slot
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()                # the step's peak, the cache held
    _reset_launches()
    times = []
    for _ in range(SHAPES_DECODE_REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        nxt, _ = step(params, token, cache, pos)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not (nxt.shape == (B, 1) and bool(((nxt >= 0) & (nxt < cfg.vocab)).all())):
        raise AssertionError(f"{tag} {arch} {shape.name}: next tokens {nxt.shape} out of range")
    per_step = _decode_counts(cfg)
    need = {k: c * SHAPES_DECODE_REPS for k, c in per_step.items()}
    if launches != need:
        raise AssertionError(f"{tag} {arch} {shape.name}: {SHAPES_DECODE_REPS} steps "
                             f"launched {launches}, not {need}")
    ms = float(np.median(times))
    _report_cell(arch, rec, B, ms, peak,
                 f"{n} slots from the same state: the kernels' next tokens equal the plain "
                 f"path's at {agree} of {n}, the rest near-ties (max|dlogit| {diff:.3e}, gap "
                 f"{gap:.3e}, tolerance {tol:g}); launches {launches} in "
                 f"{SHAPES_DECODE_REPS} steps")
    del model, cache, view, out
    torch.cuda.empty_cache()
    return launches


def _decode_counts(cfg) -> dict:
    """Kernel calls of one decode step: decode attention (MLA's own kernel for
    MLA) and the add + norm once a dense layer or hybrid group; none for the
    ssm family."""
    attn = _attention_layers(cfg)
    decode = "mla_decode_attention" if cfg.mla is not None else "decode_attention"
    return _counts(**{decode: attn, "fused_add_rmsnorm": attn})


def _report_cell(arch: str, rec: dict, B: int, ms: float, peak: float, checks: str) -> None:
    """One cell's line: device ms against the analysis's bound at the run's
    batch (max(compute, memory) at 989 TFLOP/s and 3.35 TB/s), and the
    measured peak against the modeled one, with the allocator's reserved
    peak beside it."""
    r = rec["analysis"]["roofline"]
    scale = B / dryrun.SHAPES[rec["shape"]].global_batch
    bound_ms = r["step_time_lower_bound_s"] * scale * 1e3
    modeled = rec["run_fit"]["total"]
    say("shapes", f"{arch} {rec['shape']} at B = {B}: {ms:.3f} ms on the device, bound "
                  f"{bound_ms:.3f} ms by {r['bottleneck']} (compute "
                  f"{r['compute_s'] * scale * 1e3:.3f}, memory {r['memory_s'] * scale * 1e3:.3f}"
                  f" ms), {bound_ms / ms:.3f} of the bound; peak allocated "
                  f"{peak / 2 ** 30:.3f} GiB against {modeled / 2 ** 30:.3f} GiB modeled "
                  f"(reserved {torch.cuda.max_memory_reserved() / 2 ** 30:.3f} GiB); "
                  + checks)


def _shape_prefill(arch: str, rec: dict, B: int) -> dict:
    """A prefill cell at ``B`` rows of S positions (seeded tokens) through
    ``build_prefill_step`` on full-width bf16 (seed 0): a warm-up, then one
    run timed with the counters set to 0 just before it. Checks: flash
    attention against its plain version on one row and one query head at S;
    each row's next token against a B = 1 prefill of that row (near-tie
    rule). Returns the timed run's launches."""
    tag = "shapes"
    cfg, shape = get_config(arch), dryrun.SHAPES[rec["shape"]]
    S = shape.seq_len
    tol = SHAPES_TOL.get(arch, SLICE_SSM_BF16_TOL)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    need = _forward_counts(cfg)
    flash = "no attention"
    if need["flash_attention"]:
        q, k, v = (randn(gen, (1, S, 1, cfg.hd), torch.bfloat16) for _ in range(3))
        err = max_err(attn_kernel.flash_attention(q, k, v), attn_ref.mha_reference(q, k, v),
                      TOL[torch.bfloat16], f"flash at S = {S}")
        flash = (f"flash against plain at S = {S}, one row and one head: max_abs_err "
                 f"{err:.3e} (tolerance {TOL[torch.bfloat16]:g})")
        del q, k, v
        torch.cuda.empty_cache()
    model = Model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=DEVICE, dtype=torch.int32)
    step = build_prefill_step(model).fn
    params = model.params
    step(params, {"tokens": tokens})                    # warm-up: its pages stay mapped
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    nxt, logits, cache = step(params, {"tokens": tokens})
    end.record()
    end.synchronize()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ms = start.elapsed_time(end)
    del cache
    torch.cuda.empty_cache()
    if launches != need:
        raise AssertionError(f"{tag} {arch} prefill: launched {launches}, not {need}")
    diff = gap = 0.0
    agree = 0
    for i in range(B):
        one, one_logits, c1 = step(params, {"tokens": tokens[i:i + 1]})
        del c1
        diff = max(diff, (one_logits[0].float() - logits[i].float()).abs().max().item())
        gap = max(gap, (one_logits[0].max() - one_logits[0, nxt[i]]).float().item())
        agree += int(one[0] == nxt[i])
    if not torch.isfinite(logits).all() or diff > tol or gap > tol:
        raise AssertionError(f"{tag} {arch} prefill: max|dlogit| {diff:.3e} or near-tie gap "
                             f"{gap:.3e} against B = 1 prefills > {tol}")
    _report_cell(arch, rec, B, ms, peak,
                 f"{flash}; next tokens equal a B = 1 "
                 f"prefill of the same row at {agree} of {B}, the rest near-ties "
                 f"(max|dlogit| {diff:.3e}, gap {gap:.3e}, tolerance {tol:g}); launches "
                 f"{launches}")
    del model, logits
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _expandable_segments():
    """New segments of the caching allocator are expandable inside: a
    prefill at S = 32768 frees and takes blocks from 1.6 to 16 GB a layer,
    and fixed segments split by them once left 16.4 GiB reserved but unused
    beside its 14.8 GiB fp32 SiLU intermediate on one H100 (an out of memory
    at 46.7 GiB allocated). The setting is restored on the way out, before
    the VLM's CUDA graphs are captured."""
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch._C._cuda_cudaCachingAllocator_set_allocator_settings
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setter("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        setter("expandable_segments:False")


def phase_shapes() -> dict:
    """The reference's assigned shapes on one H100 (after the other families'
    phases, before the VLM's, on an otherwise empty card): the dry run's
    analysis of all 40 cells (FLOPs from the two calibration traces on the
    meta device, the modeled bytes, the memory fit on this card, the binding
    roofline term), one line each; then every cell that fits runs through
    ``build_decode_step`` / ``build_prefill_step`` at full width, bf16, and
    ARCH's prefill_32k at the largest batch that fits. Returns the runs'
    launches."""
    tag = "shapes"
    t0 = time.perf_counter()
    records = {}
    for arch in dryrun.ARCH_IDS:
        for name in dryrun.SHAPES:
            rec = records[arch, name] = dryrun.run_cell(arch, name, verbose=False,
                                                        full_depth=False)
            if rec["status"] == "skipped":
                say(tag, f"{arch} {name}: not applicable ({rec['reason']})")
                continue
            if rec["status"] != "ok":
                raise AssertionError(f"{tag}: the analysis of {arch} {name} failed: "
                                     f"{rec['error']}")
            a = rec["analysis"]
            r, fit = a["roofline"], a["fit"]
            say(tag, f"{arch} {name}: applicable; {a['cost']['flops_per_device']:.4e} FLOP "
                     f"(calibrated at two depths), {a['modeled_memory']['total']:.4e} B "
                     f"modeled; fits {fit['fits']} ({fit['total'] / 1e9:.2f} GB of "
                     f"{fit['usable'] / 1e9:.2f} usable, largest batch {fit['max_batch']}); "
                     f"binds: {r['bottleneck']} ({r['step_time_lower_bound_s'] * 1e3:.4f} ms)")
    say(tag, f"analysis of {len(records)} cells in {time.perf_counter() - t0:.1f} s")
    launches = dict.fromkeys(SOURCES, 0)
    with _expandable_segments():
        for k, n in _shape_runs(records).items():
            launches[k] += n
    say(tag, f"launches {launches}; wall {time.perf_counter() - t0:.1f} s")
    return launches


def _shape_runs(records: dict) -> dict:
    """Runs every analysed cell that fits (ARCH's prefill_32k at the largest
    batch that fits) and returns their launches."""
    tag = "shapes"
    launches = dict.fromkeys(SOURCES, 0)
    for (arch, name), rec in records.items():
        if rec["status"] != "ok":
            continue
        fit, kind = rec["analysis"]["fit"], dryrun.SHAPES[name].kind
        if kind == "decode" and fit["fits"]:
            rec["run_fit"] = fit
            counts = _shape_decode(arch, rec)
        elif kind == "prefill" and (fit["fits"] or arch == ARCH) and fit["max_batch"]:
            B = dryrun.SHAPES[name].global_batch if fit["fits"] else fit["max_batch"]
            if not fit["fits"]:
                say(tag, f"{arch} {name}: run at B = {B}, not {dryrun.SHAPES[name].global_batch}"
                         f": at the assigned batch the modeled peak is "
                         f"{fit['total'] / 1e9:.2f} GB of {fit['usable'] / 1e9:.2f} usable "
                         f"(activations {fit['terms']['activations'] / 1e9:.2f}, the cache and "
                         f"its stacked copy {fit['terms']['cache'] / 1e9:.2f}); {B} is the "
                         "largest batch the analysis fits")
            rec["run_fit"] = analysis.memory_fit(get_config(arch), dryrun.SHAPES[name],
                                                 batch=B)
            counts = _shape_prefill(arch, rec, B)
        else:
            continue
        for k, n in counts.items():
            launches[k] += n
    return launches


# -------------------------------------------------------------------- the mesh
# (b) mesh-moe: full-width qwen2-moe-a2.7b's experts split over two ranks that
# share the card; the reference run is the global path's prefill over B x S
MESH_MOE_BATCH, MESH_MOE_SEQ = 4, 512
MESH_MOE_TIMED_REPS = 10
# (c) mesh-steps: the sharded builders on a 1-rank NCCL mesh against the
# unsharded ones (no collective runs: equal to float rounding of the same ops)
MESH_TRAIN_STEPS, MESH_DECODE_TOKENS, MESH_DECODE_BATCH = 3, 32, 8
MESH_SSM_LAYERS = 4            # mamba2-2.7b at full width, cut to 4 of 64 layers
MESH_MLA_LAYERS = 4            # minicpm3-4b's decode at full width, cut to 4 of 62 layers
MESH_STEP_RTOL = 1e-6
# two ranks over gloo on the one card: (data 1, model 2), B = 4; bf16 losses
MESH_TWO_RANK_BATCH, MESH_TWO_RANK_TOL = 4, 2e-2
MESH_RANK_TIMEOUT = 600        # seconds for a phase's child ranks
# the collectives the probe tries on CUDA tensors over gloo, by their
# torch.distributed names, and the dry run's names of those a step issues
MESH_PROBE_OPS = ("all_reduce", "broadcast", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "all_to_all_single")
MESH_OP_NAMES = {"all-reduce": "all_reduce", "all-gather": "all_gather_into_tensor",
                 "reduce-scatter": "reduce_scatter_tensor", "all-to-all": "all_to_all_single"}


def _rank_entry(rank: int, world: int, init_file: str, out, fn, args, timeout: float) -> None:
    """A child rank: gloo on the one card, then ``fn(rank, *args)``. A rank
    that crashes, or still runs near the parent's timeout, prints every
    thread's stack."""
    import datetime
    import faulthandler
    import traceback

    import torch.distributed as dist

    faulthandler.enable(all_threads=True)
    faulthandler.dump_traceback_later(timeout - 30, exit=False)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        out.put((rank, "ok", fn(rank, *args)))
    except BaseException:  # noqa: BLE001
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(world: int, fn, *args) -> dict:
    """``fn(rank, *args)`` on ``world`` child processes (``spawn``: this process
    already holds a CUDA context) meeting through a file in a temporary
    directory; returns each rank's result, raises on any rank's error."""
    import queue

    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        init = str(Path(d) / "rendezvous")
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, world, init, out, fn, args, MESH_RANK_TIMEOUT))
                 for r in range(world)]
        for p in procs:
            p.start()
        results = {}
        deadline = time.monotonic() + MESH_RANK_TIMEOUT
        try:
            while len(results) < world:
                try:
                    rank, status, value = out.get(timeout=5)
                except queue.Empty:
                    dead = {i: p.exitcode for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)}
                    if dead:
                        raise AssertionError(f"rank(s) exited with {dead} (a negative code is "
                                             "the signal that ended it)") from None
                    if time.monotonic() > deadline:
                        raise AssertionError(f"the ranks did not finish within "
                                             f"{MESH_RANK_TIMEOUT} s") from None
                    continue
                if status != "ok":
                    raise AssertionError(f"rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
    return results


MESH_PROBE_WAIT = 30           # seconds a probed collective may take before it counts as hung


def _probe_call(api: str, name: str, rank: int, dtype) -> str:
    """One collective of two ranks on CUDA tensors, its result checked: by
    the ``torch.distributed`` call (api "c10d") or by the functional
    collective that DTensor issues (api "funcol")."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    x = torch.full((4,), float(rank + 1), dtype=dtype, device=DEVICE)
    group = dist.group.WORLD
    want = {"all_reduce": [3.0] * 4, "broadcast": [1.0] * 4,
            "all_gather_into_tensor": [1.0] * 4 + [2.0] * 4,
            "reduce_scatter_tensor": [3.0] * 2, "all_to_all_single": [1.0, 1.0, 2.0, 2.0]}[name]
    if api == "c10d":
        out = x if name in ("all_reduce", "broadcast") else torch.empty(
            len(want), dtype=dtype, device=DEVICE)
        {"all_reduce": lambda: dist.all_reduce(x),
         "broadcast": lambda: dist.broadcast(x, src=0),
         "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(out, x),
         "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(out, x),
         "all_to_all_single": lambda: dist.all_to_all_single(out, x)}[name]()
    else:
        out = {"all_reduce": lambda: funcol.all_reduce(x, "sum", group),
               "broadcast": lambda: funcol.broadcast(x, 0, group),
               "all_gather_into_tensor": lambda: funcol.all_gather_tensor(x, 0, group),
               "reduce_scatter_tensor": lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group),
               "all_to_all_single": lambda: funcol.all_to_all_single(x, None, None, group),
               }[name]()
        out = funcol.wait_tensor(out)
    torch.cuda.synchronize()
    got = out.float().tolist()
    return "ok" if got == want else f"wrong {got}"


def _probe_rank(rank: int, directory: str) -> None:
    """Each collective by each API in f32 and bf16, each under a watchdog: a
    call that neither returns nor raises within MESH_PROBE_WAIT seconds
    counts as hung, and the rest are not tried (the group may be wedged).
    Each call is written to ``directory``/rank<r> as it starts and as it
    ends, so a call that ends the process (a crash in the collective) is
    known by the line it started."""
    import threading

    with open(Path(directory) / f"rank{rank}", "w") as log:
        for api in ("c10d", "funcol"):
            for name in MESH_PROBE_OPS:
                for dtype in (torch.float32, torch.bfloat16):
                    key = f"{api}.{name}[{str(dtype)[6:]}]"
                    res = {}

                    def call():
                        try:
                            res["v"] = _probe_call(api, name, rank, dtype)
                        except Exception as e:  # noqa: BLE001
                            res["v"] = (f"refused: {type(e).__name__}: "
                                        f"{str(e).splitlines()[0][:140]}")

                    log.write(f"start\t{key}\n")
                    log.flush()
                    t = threading.Thread(target=call, daemon=True)
                    t.start()
                    t.join(MESH_PROBE_WAIT)
                    if t.is_alive():
                        log.write(f"end\t{key}\thung: no answer within {MESH_PROBE_WAIT} s\n")
                        return
                    log.write(f"end\t{key}\t{res['v']}\n")
                    log.flush()


def phase_mesh_probe() -> dict:
    """(a) Two ranks on the one card over gloo: which collectives take CUDA
    tensors (f32 and bf16), by the ``torch.distributed`` call and by the
    functional collective DTensor issues, each result checked; a call that
    crashes the ranks is named by the last call they started. Returns
    {"<api>.<name>[<dtype>]": "ok", or what happened on each rank}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        try:
            _spawn_ranks(2, _probe_rank, d)
            ended = None
        except AssertionError as e:
            ended = str(e).splitlines()[0]
        views = {}
        for r in range(2):
            path = Path(d) / f"rank{r}"
            for line in (path.read_text().splitlines() if path.exists() else []):
                kind, key, *rest = line.split("\t")
                views.setdefault(key, {})[r] = (rest[0] if kind == "end"
                                                else f"crashed: {ended}")
    status = {}
    for key, v in views.items():
        got = [v.get(r, "not tried") for r in range(2)]
        status[key] = got[0] if got[0] == got[1] else " / ".join(got)
        say("mesh-probe", f"gloo on CUDA tensors: {key}: {status[key]}")
    say("mesh-probe", f"wall {time.perf_counter() - t0:.1f} s")
    return status


MESH_DECODE_WORLD, MESH_DECODE_REPS = 2, 10
# rows of the plain decode at a time in mesh-decode: the plain attention
# expands the KV heads to the query heads, 15 GB a tensor at decode_32k in
# f32 for all 128 rows, on each of the two ranks sharing the card
MESH_DECODE_REF_ROWS = 16


def _seqshard_rank(rank: int) -> dict:
    """One rank of mesh-decode: at each of PARTIALS_SHAPES, f32 then bf16,
    the same seeded q, cache and per-row positions on every rank; this rank
    keeps its half of the cache's sequence as a DTensor ``Shard(1)`` over a
    (model = 2) mesh, q replicated, and calls ``ops.decode_attention``, the
    main path's decode over a sequence-sharded cache: the partials kernel
    over its own positions, then gloo's all-reduces of the max and of the
    rescaled sums. At the MLA shape the cache is the model's two latent
    caches, (B, S, 256) and (B, S, 32), each ``Shard(1)``, through
    ``ops.mla_decode_attention`` and its partials kernel. The counters are
    set to 0 just before the call and read just after; the output,
    replicated, is held against the plain decode on
    the whole cache (MESH_DECODE_REF_ROWS rows at a time) at the dtype's
    tolerance, so the f32 call holds the cross-rank rescale and sums at 2e-5.
    Then the bf16 call timed (CUDA events on this rank, and the host's
    clock)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch.mesh import make_mesh

    world = dist.get_world_size()
    mesh = make_mesh((world,), ("model",), DEVICE)
    rng = np.random.default_rng(5)
    rows, launches = {}, dict.fromkeys(_launch_counts(), 0)
    for name, (B, S, H, KV, dqk, dv) in PARTIALS_SHAPES.items():
        mla = dqk == MLA_DECODE_SHAPE[4]
        scale = MLA_SCALE if mla else None
        pos = _partials_positions(rng, B, S)
        if mla:   # q against ckv and krope; K = [ckv | krope], V = ckv
            shapes, kernel = ((B, S, dv), (B, S, dqk - dv)), "mla_decode_attention_partials"
            plain = functools.partial(attn_ref.mla_decode_reference, scale=scale)
            call = functools.partial(attn_ops.mla_decode_attention, scale=scale)
        else:
            shapes, kernel = ((B, S, KV, dqk), (B, S, KV, dv)), "decode_attention_partials"
            plain = functools.partial(attn_ref.decode_attention_reference, scale=scale)
            call = functools.partial(attn_ops.decode_attention, scale=scale)
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=DEVICE).manual_seed(7)
            q = randn(gen, (B, 1, H, dqk), dtype)
            k, v = (randn(gen, shape, dtype) for shape in shapes)
            L = S // world
            kd, vd = (DTensor.from_local(t[:, rank * L:(rank + 1) * L].contiguous(), mesh,
                                         [Shard(1)], run_check=False) for t in (k, v))
            qd = DTensor.from_local(q, mesh, [Replicate()], run_check=False)
            with torch.no_grad():
                _reset_launches()
                o = call(qd, kd, vd, pos)
                torch.cuda.synchronize()
                counts = _launch_counts()
            what = f"mesh-decode rank {rank} {name} {dtype}"
            if counts[kernel] != 1 or sum(counts.values()) != 1:
                raise AssertionError(f"{what}: launches {counts}, want one {kernel} and "
                                     "nothing else")
            if tuple(o.placements) != (Replicate(),):
                raise AssertionError(f"{what}: output placed {o.placements}")
            for kk, n in counts.items():
                launches[kk] += n
            want = torch.cat([plain(
                q[r:r + MESH_DECODE_REF_ROWS], k[r:r + MESH_DECODE_REF_ROWS],
                v[r:r + MESH_DECODE_REF_ROWS], pos[r:r + MESH_DECODE_REF_ROWS])
                for r in range(0, B, MESH_DECODE_REF_ROWS)])
            row = rows[(name, str(dtype))] = {
                "err": max_err(o.to_local(), want, TOL[dtype], what), "tol": TOL[dtype],
                "partial_bytes": B * H * (dv + 1) * 4}
            if dtype == torch.bfloat16:
                ev, wall = [], []
                with torch.no_grad():
                    for _ in range(MESH_DECODE_REPS):
                        torch.cuda.synchronize()
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        t0 = time.perf_counter()
                        start.record()
                        call(qd, kd, vd, pos)
                        end.record()
                        end.synchronize()
                        wall.append((time.perf_counter() - t0) * 1e3)
                        ev.append(start.elapsed_time(end))
                row.update(ms=float(np.median(ev)), wall_ms=float(np.median(wall)))
            del q, k, v, kd, vd, qd, o, want
            torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches}


def phase_mesh_decode() -> dict:
    """(a2) Decode over a cache split by sequence across two ranks on the one
    card (gloo, a (model = 2) mesh): at qwen2-0.5b's decode_32k row shape and
    minicpm3-4b's MLA decode shape, f32 and bf16, each rank's partials
    kernel over its half (at the MLA shape MLA's own, over the two latent
    caches) and the cross-rank combine's two all-reduces, held
    to the plain decode on the whole cache at 2e-5 (f32) and 2e-2 (bf16),
    with a row that ends in the first shard and a row of length 0. Returns
    the launches of the main-path calls."""
    t0 = time.perf_counter()
    results = _spawn_ranks(MESH_DECODE_WORLD, _seqshard_rank)
    launches = dict.fromkeys(_launch_counts(), 0)
    for rank, res in sorted(results.items()):
        for k, n in res["launches"].items():
            launches[k] += n
        for (name, dtype), r in res["rows"].items():
            timed = (f"; the call (partials + two gloo all-reduces of {r['partial_bytes']} B "
                     f"at most) {r['ms']:.4f} ms by CUDA events, {r['wall_ms']:.3f} ms host "
                     f"wall (median of {MESH_DECODE_REPS})" if "ms" in r else "")
            say("mesh-decode", f"rank {rank}, {name} {dtype}: max_abs_err {r['err']:.3e} "
                               f"against the whole cache (tol {r['tol']:g}){timed}")
    # each rank, each shape, f32 and bf16: the MLA shape through MLA's kernel
    want = _counts(decode_attention_partials=MESH_DECODE_WORLD * 2,
                   mla_decode_attention_partials=MESH_DECODE_WORLD * 2)
    if launches != want:
        raise AssertionError(f"mesh-decode: launches {launches}, want {want}")
    say("mesh-decode", f"launches {launches}; wall {time.perf_counter() - t0:.1f} s")
    return launches


def _mesh_moe_reference(model: Model, directory: str) -> str:
    """The reference run of (b), on the served qwen2-moe-a2.7b before it is
    freed: the global path's prefill over MESH_MOE_BATCH x MESH_MOE_SEQ
    synthetic tokens, each layer's ``moe_ffn`` input, output and aux kept
    (saved under ``directory``), and each layer's global ``moe_ffn`` timed."""
    cfg = model.cfg
    captured, orig = [], moe.moe_ffn

    def recording(x, p, c):
        y, aux = orig(x, p, c)
        captured.append((x.detach().clone(), y.detach().clone(), float(aux)))
        return y, aux

    tokens = torch.as_tensor(synthetic_batch(cfg, MESH_MOE_BATCH, MESH_MOE_SEQ, 0)["tokens"])
    moe.moe_ffn = recording
    try:
        with torch.no_grad():
            model.prefill({"tokens": tokens.to(DEVICE)})
    finally:
        moe.moe_ffn = orig
    if len(captured) != cfg.n_layers:
        raise AssertionError(f"mesh-moe: captured {len(captured)} MoE calls, "
                             f"{cfg.n_layers} layers")
    with torch.no_grad():
        ms = [cuda_ms(lambda: orig(x, lp["ffn"], cfg), reps=MESH_MOE_TIMED_REPS)
              for (x, _, _), lp in zip(captured, model._layer_params)]
    path = str(Path(directory) / "moe_reference.pt")
    torch.save({"x": [c[0].cpu() for c in captured], "y": [c[1].cpu() for c in captured],
                "aux": [c[2] for c in captured], "global_ms": ms}, path)
    say("mesh-moe", f"reference: the global path's prefill at {MESH_MOE_BATCH} x "
                    f"{MESH_MOE_SEQ} tokens, {len(captured)} layers' MoE inputs and outputs "
                    f"({captured[0][0].numel() * captured[0][0].element_size() / 1e6:.1f} MB "
                    f"each) kept; the global moe_ffn takes {np.median(ms):.4f} ms a layer "
                    f"(median of {len(ms)})")
    return path


def _moe_rank(rank: int, path: str) -> dict:
    """One rank of (b): draws the weights as ``Model.init`` does, one part at a
    time from seed 0, keeping the router, the shared expert and its half of
    each layer's experts; then every layer's ``moe_ffn`` with
    ``moe_impl="local"`` on the reference's inputs, and the local experts and
    the all-reduce timed alone."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import partition

    cfg = get_config(MOE_ARCH).with_(moe_impl="local")
    E, world = cfg.moe.n_experts, dist.get_world_size()
    n_local, lo = E // world, rank * (E // world)
    meta = Model(cfg, device="meta", kernel_impl="ref")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    kept = []
    with torch.no_grad():
        for where, part in meta._parts(gen, torch.device(DEVICE), per_layer=True):
            if where[0] == "layers":
                f = part["ffn"]
                kept.append({"router": f["router"], "shared": f["shared"],
                             "shared_gate": f["shared_gate"],
                             **{k: f[k][lo:lo + n_local].clone() for k in ("wi", "wg", "wo")}})
            del part
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    draw_peak = torch.cuda.max_memory_allocated()
    ref = torch.load(path)
    mesh = make_mesh((world,), ("model",), DEVICE)
    calls, orig = [0], moe.all_reduce

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    _reset_launches()
    errs, aux_errs = [], []
    moe.all_reduce = counted
    try:
        with torch.no_grad(), partition.use_mesh(mesh, partition.rules_for(cfg)):
            for i, lp in enumerate(kept):
                p = dict(lp, **{k: DTensor.from_local(lp[k], mesh, [Shard(0)], run_check=False)
                                for k in ("wi", "wg", "wo")})
                y, aux = moe.moe_ffn(ref["x"][i].to(DEVICE), p, cfg)
                y, aux = y.to_local(), aux.to_local()
                if not torch.isfinite(y).all():
                    raise AssertionError(f"mesh-moe rank {rank}: layer {i}: non-finite output")
                errs.append(float((y.float() - ref["y"][i].to(DEVICE).float()).abs().max()))
                aux_errs.append(abs(float(aux) - ref["aux"][i]) / abs(ref["aux"][i]))
    finally:
        moe.all_reduce = orig
    launches = _launch_counts()
    local_ms, reduce_ms, reduce_wall_ms = [], [], []
    group = mesh.get_group("model")
    with torch.no_grad():
        for i, lp in enumerate(kept):
            x2d = ref["x"][i].to(DEVICE).reshape(-1, cfg.d_model)
            local_ms.append(cuda_ms(lambda: moe._local_expert_ffn(x2d, lp, cfg.moe, lo, n_local),
                                    reps=MESH_MOE_TIMED_REPS))
            y_part, _ = moe._local_expert_ffn(x2d, lp, cfg.moe, lo, n_local)
            ev, wall = [], []
            for _ in range(MESH_MOE_TIMED_REPS):
                buf = y_part.clone()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                dist.all_reduce(buf, group=group)
                end.record()
                end.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
                ev.append(start.elapsed_time(end))
            reduce_ms.append(float(np.median(ev)))
            reduce_wall_ms.append(float(np.median(wall)))
    return {"errs": errs, "aux_errs": aux_errs, "all_reduce_calls": calls[0],
            "launches": launches, "held": held, "draw_peak": draw_peak,
            "local_ms": local_ms, "reduce_ms": reduce_ms, "reduce_wall_ms": reduce_wall_ms,
            "bytes": int(y_part.numel() * y_part.element_size()), "n_local": n_local}


def phase_mesh_moe(path: str) -> dict:
    """(b) Full-width qwen2-moe-a2.7b's experts split over two ranks on the one
    card (a (model = 2) mesh over gloo), each rank with its 30 of 60 experts of
    every layer: every layer's output within the serve phases' bf16 bound of
    the global path's, aux equal (no data axis), one all-reduce a layer and no
    kernel launch (the expert path reaches none)."""
    t0 = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    res = _spawn_ranks(2, _moe_rank, path)
    ref = torch.load(path)
    for rank, r in sorted(res.items()):
        say("mesh-moe", f"rank {rank}: {r['n_local']} of {cfg.moe.n_experts} experts a layer, "
                        f"{r['held'] / 2**30:.2f} GiB held after the draw (peak "
                        f"{r['draw_peak'] / 2**30:.2f} GiB while drawing)")
        if max(r["errs"]) > SLICE_MOE_BF16_TOL:
            raise AssertionError(f"mesh-moe rank {rank}: max|dy| {max(r['errs'])} over "
                                 f"{SLICE_MOE_BF16_TOL} (per layer {r['errs']})")
        if max(r["aux_errs"]) > 1e-5:
            raise AssertionError(f"mesh-moe rank {rank}: aux off by {max(r['aux_errs'])} "
                                 "relative to the global path's")
        if r["all_reduce_calls"] != cfg.n_layers or any(r["launches"].values()):
            raise AssertionError(f"mesh-moe rank {rank}: {r['all_reduce_calls']} all-reduces for "
                                 f"{cfg.n_layers} layers, launches {r['launches']}")
    r = res[0]
    say("mesh-moe", f"every layer's y against the global path's: max|dy| "
                    f"{max(max(x['errs']) for x in res.values()):.4g} (bound "
                    f"{SLICE_MOE_BF16_TOL}, bf16), aux within "
                    f"{max(max(x['aux_errs']) for x in res.values()):.2e} relative; "
                    f"{r['all_reduce_calls']} all-reduces ({cfg.n_layers} layers), "
                    f"kernel launches {r['launches']}")
    for i in range(cfg.n_layers):
        say("mesh-moe", f"layer {i:2d}: local experts {res[0]['local_ms'][i]:.4f} / "
                        f"{res[1]['local_ms'][i]:.4f} ms (rank 0 / 1), gloo all-reduce of "
                        f"{r['bytes'] / 1e6:.1f} MB {r['reduce_ms'][i]:.3f} ms by events, "
                        f"{r['reduce_wall_ms'][i]:.3f} ms on the host; the global moe_ffn "
                        f"{ref['global_ms'][i]:.4f} ms")
    say("mesh-moe", f"medians: local experts {np.median(r['local_ms']):.4f} ms, all-reduce "
                    f"{np.median(r['reduce_ms']):.3f} ms (host {np.median(r['reduce_wall_ms']):.3f}"
                    f"), global moe_ffn {np.median(ref['global_ms']):.4f} ms; "
                    f"wall {time.perf_counter() - t0:.1f} s")
    return r["launches"]


_MESH_TRACE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import analysis
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt
from repro_torch.training.steps import build_train_step
with fake_world(2):
    mesh = make_mesh((1, 2), ("data", "model"), sys.argv[2])
    cfg = get_config(sys.argv[3]).with_(n_layers=2)
    model = Model(cfg, device="meta", kernel_impl="ref").requires_grad_(True)
    shape = ShapeSpec("mesh", "train", int(sys.argv[5]), int(sys.argv[4]))
    built = build_train_step(model, opt.OptimizerConfig(), mesh, shape)
    print(json.dumps(analysis.trace_collectives(built).to_dict()))
"""


def _step_collectives() -> dict:
    """The collectives one train step of the (data 1, model 2) mesh issues
    (two layers traced on meta DTensors under a fake group of 2, the mesh on
    the card's device type so DTensor picks its CUDA collectives)."""
    # the fake group takes no debug wrapper (TORCH_DISTRIBUTED_DEBUG=DETAIL)
    env = {k: v for k, v in os.environ.items() if k != "TORCH_DISTRIBUTED_DEBUG"}
    out = subprocess.run([sys.executable, "-c", _MESH_TRACE, str(ROOT / "src"), DEVICE, ARCH,
                          str(MESH_TWO_RANK_BATCH), str(TRAIN_SEQ)],
                         capture_output=True, text=True, timeout=600, env=env)
    if out.returncode != 0:
        raise AssertionError(f"mesh-steps: tracing the two-rank step failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _two_rank_step(rank: int, batch: dict) -> tuple:
    """(the first step's loss, the second step's wall in ms) of one rank."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 2), ("data", "model"), DEVICE)
    model = _train_model("bfloat16")
    ocfg = train_opt.OptimizerConfig()
    fn = build_train_step(model, ocfg, mesh=mesh).fn
    state = train_opt.init_state(model.params, ocfg)
    batch = {k: v.to(DEVICE) for k, v in batch.items()}
    if rank == 0:
        say("mesh-steps", "two ranks: the mesh and the model are built; the first step")
    _, state, m = fn(model.params, state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(model.params, state, batch)
    torch.cuda.synchronize()
    return loss, (time.perf_counter() - t0) * 1e3


def _steps_pair(make, batches, mesh) -> tuple:
    """(unsharded metrics, mesh metrics, the mesh run's launches) of train
    steps on two fresh models; each step's wall (host clock, synchronised)
    is in its metrics as "ms"."""
    out = []
    for where in (None, mesh):
        model = make()
        ocfg = train_opt.OptimizerConfig()
        fn = build_train_step(model, ocfg, mesh=where).fn
        state = train_opt.init_state(model.params, ocfg)
        torch.cuda.synchronize()
        _reset_launches()
        got = []
        for b in batches:
            t0 = time.perf_counter()
            _, state, m = fn(model.params, state, b)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got.append(dict({k: float(v) for k, v in m.items()}, ms=ms))
        out.append(got)
        del model, state, fn
        torch.cuda.empty_cache()
    return out[0], out[1], _launch_counts()


def _check_pair(tag: str, want: list, got: list, rtol: float) -> float:
    worst = 0.0
    for i, (w, g) in enumerate(zip(want, got)):
        for k in ("loss", "grad_norm"):
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            worst = max(worst, rel)
            if not np.isfinite(g[k]) or rel > rtol:
                raise AssertionError(f"{tag}: step {i} {k} {g[k]} against {w[k]} "
                                     f"(relative {rel:.2e} over {rtol})")
    return worst


def _mesh_decode_pair(cfg, mesh) -> dict:
    """(c)'s decode step: MESH_DECODE_TOKENS greedy tokens x MESH_DECODE_BATCH
    rows from the same start through ``build_decode_step`` unsharded and on
    ``mesh`` (its cache placed by ``place_cache``), the tokens equal; the mesh
    run's launches."""
    from repro_torch.training.steps import place_cache

    start = torch.as_tensor(synthetic_batch(cfg, MESH_DECODE_BATCH, 1, 7)["tokens"])
    streams = []
    for where in (None, mesh):
        model = Model(cfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
        built = build_decode_step(model, mesh=where)
        cache = model.init_cache(MESH_DECODE_BATCH, MESH_DECODE_TOKENS)
        if where is not None:
            cache = place_cache(model, cache, mesh)
            _reset_launches()
        token, out = start.to(DEVICE), []
        for pos in range(MESH_DECODE_TOKENS):
            token, cache = built.fn(model.params, token, cache, torch.tensor(pos, device=DEVICE))
            token = token.full_tensor() if hasattr(token, "full_tensor") else token
            out.append(token[:, 0].tolist())
        if where is not None:
            counts = _launch_counts()
        streams.append(out)
        del model, built, cache
        torch.cuda.empty_cache()
    if streams[0] != streams[1]:
        raise AssertionError(f"mesh-steps: {cfg.name}'s 1-rank mesh decode step's tokens "
                             "differ from the unsharded step's")
    say("mesh-steps", f"{cfg.name} ({cfg.n_layers} layers) decode, 1-rank mesh: "
                      f"{MESH_DECODE_TOKENS} greedy tokens x {MESH_DECODE_BATCH} rows equal to "
                      f"the unsharded step's; launches {counts}")
    return counts


def _mesh_ssm_step(mesh) -> dict:
    """(c)'s scan: full-width mamba2-2.7b cut to MESH_SSM_LAYERS layers, one
    train step on ``mesh`` against the unsharded builder's; its launches."""
    scfg = get_config(SSM_ARCH).with_(n_layers=MESH_SSM_LAYERS)

    def ssm_model():
        m = Model(scfg, device=DEVICE).init(torch.Generator(device=DEVICE).manual_seed(0))
        return m.requires_grad_(True)

    want, got, counts = _steps_pair(ssm_model, [_train_batch(scfg, 0)], mesh)
    worst = _check_pair("mesh-steps mamba2 train", want, got, MESH_STEP_RTOL)
    say("mesh-steps", f"{SSM_ARCH} ({MESH_SSM_LAYERS} of 64 layers) train, 1-rank "
                      f"mesh: loss {got[0]['loss']:.6f}, worst relative difference "
                      f"{worst:.2e}; launches {counts}")
    return counts


def _mesh_two_rank(probe: dict) -> None:
    """(c)'s two ranks over gloo on the card, (data 1, model 2): qwen2-0.5b's
    train step at B = 4 against the unsharded loss, run where mesh-probe
    showed gloo takes every collective the step issues on CUDA tensors;
    else the refused ones are named."""
    needed = _step_collectives()
    untried = "not tried: an earlier call ended the probe"

    def taken(op):
        """The op's bf16 status, else (not tried after a crash) its f32 one."""
        name = MESH_OP_NAMES.get(op, op)
        st = probe.get(f"funcol.{name}[bfloat16]", untried)
        return probe.get(f"funcol.{name}[float32]", untried) if st == untried else st

    refused = {op: taken(op) for op in needed["counts"] if taken(op) != "ok"}
    say("mesh-steps", f"the (data 1, model 2) train step issues {needed['counts']} "
                      f"({needed['total_wire_bytes'] / 1e6:.1f} MB on the wire a device, "
                      "two layers traced)")
    if refused:
        say("mesh-steps", f"two ranks over gloo: not run: gloo does not take {sorted(refused)} "
                          "as DTensor issues them (functional collectives) on CUDA tensors "
                          f"(mesh-probe: {refused}); the two-rank step waits for four cards "
                          "(ROADMAP)")
    else:
        cfg = get_config(ARCH)
        batch = {k: v.cpu() for k, v in _train_batch(cfg, 0, MESH_TWO_RANK_BATCH).items()}
        model = _train_model("bfloat16")
        ocfg = train_opt.OptimizerConfig()
        _, _, m = build_train_step(model, ocfg).fn(
            model.params, train_opt.init_state(model.params, ocfg),
            {k: v.to(DEVICE) for k, v in batch.items()})
        want = float(m["loss"])
        del model
        torch.cuda.empty_cache()
        got = _spawn_ranks(2, _two_rank_step, batch)
        for rank, (loss, _) in got.items():
            if not abs(loss - want) <= MESH_TWO_RANK_TOL:
                raise AssertionError(f"mesh-steps: two-rank loss {loss} (rank {rank}) against "
                                     f"the unsharded {want}")
        say("mesh-steps", f"two ranks over gloo, (data 1, model 2), B = {MESH_TWO_RANK_BATCH}: "
                          f"loss {got[0][0]:.6f} / {got[1][0]:.6f} against the unsharded "
                          f"{want:.6f} (bound {MESH_TWO_RANK_TOL}); a second step's wall "
                          f"{got[0][1]:.3f} / {got[1][1]:.3f} ms (host, synchronised)")


def phase_mesh_steps(probe: dict) -> dict:
    """(c) The sharded step builders with the port's kernels. On a 1-rank NCCL
    mesh (data 1, model 1): full-width qwen2-0.5b's train step (3 steps, B =
    8, S = 1024, remat on) and decode step (32 greedy tokens) against the
    unsharded builders', the decode step of full-width minicpm3-4b cut to 4
    layers (MLA's decode kernel), and full-width mamba2-2.7b cut to 4 layers
    for one train step; every single-card kernel launches through the
    wrappers' ``local_map``.
    Then, where gloo takes every collective the step issues on CUDA tensors,
    qwen2-0.5b's train step on two ranks, (data 1, model 2), at B = 4."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    launches = dict.fromkeys(_launch_counts(), 0)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rendezvous", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), DEVICE)
            cfg = get_config(ARCH)
            batches = [_train_batch(cfg, step) for step in range(MESH_TRAIN_STEPS)]
            want, got, counts = _steps_pair(lambda: _train_model("bfloat16"), batches, mesh)
            worst = _check_pair("mesh-steps qwen2 train", want, got, MESH_STEP_RTOL)
            for k, n in counts.items():
                launches[k] += n
            say("mesh-steps", f"{ARCH} train, 1-rank mesh: {MESH_TRAIN_STEPS} steps at B = "
                              f"{TRAIN_BATCH}, S = {TRAIN_SEQ}, losses "
                              f"{[round(g['loss'], 6) for g in got]}, grad norms "
                              f"{[round(g['grad_norm'], 6) for g in got]}, worst relative "
                              f"difference from the unsharded builder's {worst:.2e} (bound "
                              f"{MESH_STEP_RTOL}); launches {counts}")
            say("mesh-steps", f"{ARCH} train step wall (host, synchronised; the first "
                              f"warms up): mesh {[round(g['ms'], 3) for g in got]} ms, "
                              f"unsharded {[round(w['ms'], 3) for w in want]} ms")
            for dcfg in (cfg, get_config(MLA_ARCH).with_(n_layers=MESH_MLA_LAYERS)):
                for k, n in _mesh_decode_pair(dcfg, mesh).items():
                    launches[k] += n
            for k, n in _mesh_ssm_step(mesh).items():
                launches[k] += n
        finally:
            dist.destroy_process_group()
    if not all(n for k, n in launches.items() if k not in MESH_SEQ_KERNELS):
        raise AssertionError(f"mesh-steps: launches {launches}: a kernel of the port did not "
                             "run through the sharded builders")
    _mesh_two_rank(probe)
    say("mesh-steps", f"wall {time.perf_counter() - t0:.1f} s")
    return launches


def _dryrun_cells(cells) -> list:
    """``python -m repro_torch.launch.dryrun --calibrated`` of each (arch, shape,
    mesh) cell, each in a subprocess of its own, all started together: per
    cell (its progress line, its key, its record)."""
    with tempfile.TemporaryDirectory() as d:
        runs = []
        for i, (arch, shape, mesh) in enumerate(cells):
            results = Path(d) / f"dryrun{i}.json"
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--calibrated", "--results", str(results)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            runs.append((arch, shape, results, proc))
        out = []
        for arch, shape, results, proc in runs:
            try:
                stdout, stderr = proc.communicate(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
            if proc.returncode != 0:
                raise AssertionError(f"mesh-dryrun {arch} {shape} failed:\n{stdout[-2000:]}\n"
                                     f"{stderr[-3000:]}")
            (key, rec), = json.loads(results.read_text()).items()
            out.append((stdout.strip().splitlines()[-1], key, rec))
    return out


# the F14 cell's wire bytes a device: at most twice the reference's (3.1070e8,
# ``python -m repro.launch.dryrun --arch qwen2-0.5b --shape decode_32k --mesh 2,4``)
F14_WIRE_BOUND = 2 * 3.1070e8


def phase_mesh_dryrun() -> None:
    """(d) The production-mesh dry run of qwen3-moe-235b-a22b ``train_4k`` on
    16 x 16 under a fake group of 256 (``launch/dryrun.py`` in a subprocess):
    the experts' placements, the per-device FLOPs and memory fit, the
    collectives' wire bytes. Beside it the F14 cell, qwen2-0.5b ``decode_32k``
    on 2 x 4, whose cache is sequence-sharded: its wire bytes a device within
    F14_WIRE_BOUND, its bound not the collective term, no all-gather of its
    cache."""
    t0 = time.perf_counter()
    (line, key, rec), f14 = _dryrun_cells([("qwen3-moe-235b-a22b", "train_4k", "16,16"),
                                           ("qwen2-0.5b", "decode_32k", "2,4")])
    a = rec["analysis"]
    say("mesh-dryrun", line)
    experts = {k: v for k, v in rec["shardings"].items() if "/ffn/" in k}
    say("mesh-dryrun", f"{key}: mesh {rec['mesh']['axes']}; the experts' placements "
                       f"{json.dumps(experts)}")
    fit = a["fit"]
    say("mesh-dryrun", f"per device: {a['cost']['flops_per_device']:.6e} FLOPs "
                       f"({a['cost']['source']}), modeled HBM traffic "
                       f"{a['modeled_memory']['total']:.6e} B, memory "
                       f"{fit['total'] / 1e9:.2f} GB against {fit['usable'] / 1e9:.2f} usable: "
                       f"fits={fit['fits']} (terms {json.dumps({k: round(v / 1e9, 3) for k, v in fit['terms'].items()})} GB)")
    say("mesh-dryrun", f"collectives a step (calibrated): {a['cost']['wire_bytes_per_device']:.6e} "
                       f"wire bytes a device; one layer's {json.dumps(a['calibrated']['collectives_delta'])}")
    r = a["roofline"]
    say("mesh-dryrun", f"roofline: compute {r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
                       f"collective {r['collective_s']:.4f} s -> {r['bottleneck']}; useful FLOPs "
                       f"{r['useful_flops_ratio']:.3f}")
    line, key, rec = f14
    a, r = rec["analysis"], rec["analysis"]["roofline"]
    say("mesh-dryrun", line)
    cal = a["calibrated"]
    layer = {op: cal["collectives_delta"]["result_bytes"].get(op, 0)
             - cal["collectives_base"]["result_bytes"].get(op, 0)
             for op in cal["collectives_delta"]["result_bytes"]}
    wire = a["cost"]["wire_bytes_per_device"]
    say("mesh-dryrun", f"{key} (F14): {wire:.6e} wire bytes a device (bound {F14_WIRE_BOUND:.4e}); "
                       f"one layer's result bytes by collective {json.dumps(layer)}; {r['bottleneck']}"
                       f"-bound (compute {r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
                       f"collective {r['collective_s']:.4g} s); wall {time.perf_counter() - t0:.1f} s")
    if wire > F14_WIRE_BOUND or r["bottleneck"] == "collective":
        raise AssertionError(f"mesh-dryrun: the F14 cell reads {wire:.4e} wire bytes a device, "
                             f"bound by {r['bottleneck']}: the sequence-sharded cache is gathered")


def main() -> int:
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    rows = phase_kernels()
    rows.update(phase_kernels_rmsnorm())
    rows.update(phase_kernels_ssd())
    launches = dict.fromkeys(rows, 0)
    fabric_launches = {k: 0 for k in rows if k not in MESH_SEQ_KERNELS + TRAIN_KERNELS}
    for k, n in phase_warming().items():
        launches[k] += n
    mesh_dir = tempfile.TemporaryDirectory()    # the mesh-moe phase's reference run
    for arch, tag, tol in ((ARCH, "", SLICE_BF16_TOL), (SSM_ARCH, "-ssm", SLICE_SSM_BF16_TOL),
                           (HYBRID_ARCH, "-hybrid", SLICE_HYBRID_BF16_TOL),
                           (MOE_ARCH, "-moe", SLICE_MOE_BF16_TOL),
                           (MLA_ARCH, "-mla", SLICE_MLA_BF16_TOL),
                           (ENCDEC_ARCH, "-encdec", SLICE_ENCDEC_BF16_TOL),
                           (VLM_ARCH, "-vlm", SLICE_VLM_BF16_TOL)):
        if arch == VLM_ARCH:                    # the assigned shapes, on an empty card
            for k, n in phase_shapes().items():
                launches[k] += n
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
            moe_reference = _mesh_moe_reference(model, mesh_dir.name)
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
                if i and k in fabric_launches:
                    fabric_launches[k] += n
        del model                               # free the weights before the next family
        torch.cuda.empty_cache()
        trained = {ARCH: phase_train, SSM_ARCH: lambda: phase_train_scan(arch, "train-ssm"),
                   HYBRID_ARCH: lambda: phase_train_scan(arch, "train-hybrid")}.get(arch)
        if trained is not None:                 # training, on its own model
            for k, n in trained().items():
                launches[k] += n
    if not all(fabric_launches.values()):
        raise AssertionError(f"the fabric phases launched {fabric_launches}: a kernel of the "
                             "port ran in none of them")
    say("fabric", f"the port's kernels in the fabric phases: {fabric_launches}")
    # the mesh phases, on a card the phases above have freed
    probe = phase_mesh_probe()
    for k, n in phase_mesh_decode().items():
        launches[k] += n
    for k, n in phase_mesh_moe(moe_reference).items():
        launches[k] += n
    mesh_dir.cleanup()
    for k, n in phase_mesh_steps(probe).items():
        launches[k] += n
    phase_mesh_dryrun()
    if not all(launches.values()):
        raise AssertionError(f"launches {launches}: a kernel of the port ran on no main path")
    say("main", f"wall {time.perf_counter() - t_start:.1f} s, the kernels' build included")
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
