"""Roofline terms, FLOP counts and the memory fit of one cell on one H100.

Port of ``repro.launch.analysis`` for one device. Two terms, in seconds:

    compute = flops / peak_flops   (the bf16 dense tensor-core rate)
    memory  = hbm_bytes / hbm_bw   (``modeled_hbm_bytes``: the fused traffic)

The reference's third term, the collective wire bytes it parses out of XLA's
HLO (``parse_collectives``), has no counterpart on one device; its torch
counterpart, collective counts under a fake process group, comes with the
sharding slice (ROADMAP A5b).

FLOPs (the counterpart of ``extract_costs`` / ``analyze_compiled``):
``trace_costs`` runs a cell's ``BuiltStep.fn`` on its meta stand-ins under
``torch.utils.flop_counter.FlopCounterMode``. The model is built on the meta
device with ``kernel_impl="ref"``, so every kernel call takes its plain
version and nothing reaches a ctypes launch; shapes flow, no storage is
allocated, so a full-size cell costs no memory. It counts the matrix
products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, attention),
forward, remat's recompute and backward, and no elementwise work.

Memory (the counterpart of ``memory_analysis``): ``memory_fit`` adds the
weights, for ``train`` the fp32 master and moments, the gradients and the new
weights, the batch, the cache (``serving.kv_cache.cache_bytes``) and a
modeled activation peak (``activation_bytes``), and holds the sum against the
card's memory. Its constants describe the port's own forward (which
intermediates it keeps live), and ``chip_smoke.py`` prints each run cell's
model beside the measured peak.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from ..kernels.flash_attention.kernel import DECODE_SPLIT
from ..serving.kv_cache import cache_bytes
from ..training.optimizer import OptimizerConfig

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W limit)
HW = {
    "name": "NVIDIA H100 80GB HBM3, 700 W",
    "peak_flops_bf16": 989e12,   # FLOP/s, the tensor cores' dense bf16 rate
    "hbm_bw": 3.35e12,           # B/s
    "hbm_bytes": 80e9,           # capacity without a card to ask
}
# the share of the card's memory a cell may plan to use: the allocator's
# rounding and fragmentation, cuBLAS workspaces and the CUDA context take the rest
FIT_SHARE = 0.92


def hbm_capacity() -> float:
    """The card's memory in bytes when a card is present, else HW["hbm_bytes"]."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HW["hbm_bytes"]


def modeled_hbm_bytes(cfg, shape, n_chips: int = 1, model_axis: int = 1) -> dict:
    """Analytic per-device HBM traffic of the fused execution (flash attention
    keeps the S^2 scores on chip; fusions keep elementwise chains out of HBM),
    the reference's model term for term (``model_axis`` 1: one device).

    Terms (documented coarse constants):
      params  train: 8x bf16 param bytes (fwd read, bwd read, remat read,
              grad write) + 24x fp32-equivalent optimizer r/w + 2x write-back
              prefill/decode: one bf16 read
      acts    per layer: residual/proj I/O ~8 D-wide + 4 F-wide passes per
              token, x3 for train (fwd+remat+bwd), x1 inference
      attn    flash traffic: q,k,v,o only (+cache r/w at decode)
    """
    N_loc = cfg.param_count() / n_chips
    data_total = max(n_chips // model_axis, 1)
    bpe = 2  # bf16

    if shape.kind == "train":
        param_traffic = (4 * 2 + 24 + 2) * N_loc  # ~34 bytes/param/step
        tokens_loc = shape.global_batch * shape.seq_len / data_total
        passes = 3
    elif shape.kind == "prefill":
        param_traffic = 2 * N_loc
        tokens_loc = shape.global_batch * shape.seq_len / data_total
        passes = 1
    else:  # decode
        param_traffic = 2 * N_loc
        tokens_loc = shape.global_batch / data_total
        passes = 1

    D = cfg.d_model
    if cfg.family == "moe":
        F_eff = cfg.moe.top_k * cfg.moe.d_ff_expert + (
            cfg.moe.d_ff_shared if cfg.moe.n_shared_experts else 0
        )
    elif cfg.family in ("ssm", "hybrid"):
        F_eff = 2 * cfg.ssm.d_inner(D)
    else:
        F_eff = cfg.d_ff
    act_per_layer = tokens_loc * (8 * D + 4 * F_eff / max(model_axis, 1)) * bpe
    act_traffic = cfg.n_layers * act_per_layer * passes

    cache_traffic = 0.0
    if shape.kind == "decode":
        cache_traffic = 2.0 * cache_bytes(cfg, shape.global_batch, shape.seq_len) / n_chips

    total = param_traffic + act_traffic + cache_traffic
    return {
        "total": float(total),
        "param_traffic": float(param_traffic),
        "act_traffic": float(act_traffic),
        "cache_traffic": float(cache_traffic),
    }


def roofline_terms(flops: float, hbm_bytes: float,
                   model_flops_total: Optional[float] = None) -> dict:
    """The two terms on one H100, the one that binds, the bound
    ``max(compute, memory)`` and, given the model's useful FLOPs, their share
    of the counted FLOPs and the roofline fraction (useful FLOP/s at the
    bound over the card's peak)."""
    terms = {"compute_s": flops / HW["peak_flops_bf16"], "memory_s": hbm_bytes / HW["hbm_bw"]}
    bottleneck = max(terms, key=terms.get)
    out = {**terms, "bottleneck": bottleneck.replace("_s", ""),
           "step_time_lower_bound_s": max(terms.values())}
    if model_flops_total is not None:
        out["model_flops_total"] = model_flops_total
        out["useful_flops_ratio"] = model_flops_total / flops if flops else 0.0
        t = out["step_time_lower_bound_s"]
        out["roofline_fraction"] = (model_flops_total / t / HW["peak_flops_bf16"]
                                    if t > 0 else 0.0)
    return out


def trace_costs(built) -> dict:
    """FLOPs of one call of ``built.fn`` on ``built.abstract_args`` (meta
    tensors), counted by ``FlopCounterMode``: the total and by aten op."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        built.fn(*built.abstract_args)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops_per_device": float(counter.get_total_flops()), "flops_by_op": by_op}


def extrapolate(base: dict, two_units: dict, units: int) -> dict:
    """Depth calibration: cost(L) = cost(L1) + (units-1) * (cost(L2)-cost(L1)).
    Exact for layer-homogeneous stacks."""
    delta = two_units["flops_per_device"] - base["flops_per_device"]
    return {"flops_per_device": base["flops_per_device"] + (units - 1) * delta,
            "flops_per_device_per_layer": delta, "units": units}


# ------------------------------------------------------------ memory fit
def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def activation_bytes_per_token(cfg) -> float:
    """Modeled live bytes a token holds at the peak of one layer's forward in
    the port (a = the activation dtype's bytes; fp32 intermediates 4):
    residual stream and norm 3a·D + 4·D, plus the larger of the mixer and the
    MLP. Attention: q, k, v, their fp32 rotary copies and the output,
    a·(2H + 2KV)·hd + 8·(H + KV)·hd. SwiGLU / GELU MLP: h and g, and the
    activation's fp32 input and output while it runs (12·F in bf16), or the
    product beside h, g and the activation (4a·F in fp32). MoE: each routed
    copy (capacity factor x top_k) holds its row, its expert's MLP and its
    output, plus the shared expert and fp32 router probabilities.
    Mamba2: the projections, the conv's padded and shifted partial sums, the
    fp32 SiLU and gated norm, (6a + 8)·(d_inner + 2·G·N)."""
    a = _itemsize(cfg.dtype)
    D = cfg.d_model
    base = 3 * a * D + 4 * D
    if cfg.family == "ssm":
        s = cfg.ssm
        return base + (6 * a + 8) * (s.d_inner(D) + 2 * s.n_groups * s.d_state)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        m = cfg.mla
        hd, KV = m.qk_nope_dim + m.qk_rope_dim, H
    else:
        hd = cfg.hd
    attn = a * (2 * H + 2 * KV) * hd + 8 * (H + KV) * hd
    mlp = max(2 * a + 8, 4 * a)
    if cfg.family == "moe":
        m = cfg.moe
        copies = m.capacity_factor * m.top_k
        ffn = (copies * (2 * a * D + mlp * m.d_ff_expert) + 4 * m.n_experts
               + (mlp * m.d_ff_shared if m.n_shared_experts else 0))
    else:
        ffn = mlp * cfg.d_ff
    peak = base + max(attn, ffn)
    if cfg.family == "hybrid":
        s = cfg.ssm
        peak = max(peak, base + (6 * a + 8) * (s.d_inner(D) + 2 * s.n_groups * s.d_state))
    return float(peak)


def activation_bytes(cfg, shape, batch: int) -> dict:
    """The modeled activation peak of one step at ``batch`` rows: train (remat
    on: each layer's input kept, one layer's forward recomputed beside its
    backward; off: every layer's working set) with the fp32 logits, their
    log-softmax and gradient; prefill, one layer's working set at full length
    plus the last position's logits; decode, one token's and the decode
    attention's fp32 split scratch."""
    a = _itemsize(cfg.dtype)
    per_tok = activation_bytes_per_token(cfg)
    L = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    logits_row = 4.0 * cfg.vocab
    if shape.kind == "train":
        T = batch * shape.seq_len
        layers = (L * T * cfg.d_model * a + 3 * T * per_tok if cfg.remat
                  else L * T * per_tok)
        return {"layers": layers, "logits": 3 * T * logits_row}
    if shape.kind == "prefill":
        T = batch * shape.seq_len
        enc = batch * cfg.enc_seq * per_tok if cfg.family == "encdec" else 0.0
        return {"layers": T * per_tok + enc, "logits": batch * logits_row}
    scratch = 0.0
    if cfg.family != "ssm":
        H = cfg.n_heads
        dv = cfg.mla.kv_lora_rank if cfg.mla is not None else cfg.hd
        scratch = batch * math.ceil(shape.seq_len / DECODE_SPLIT) * H * (dv + 2) * 4.0
    return {"layers": batch * per_tok + scratch, "logits": batch * logits_row}


@functools.lru_cache(maxsize=None)
def weight_bytes(cfg) -> tuple:
    """(bytes, elements) of the model's weights, from a meta model."""
    from ..models.model import Model
    meta = Model(cfg, device="meta", kernel_impl="ref")
    return (float(sum(p.numel() * p.element_size() for p in meta.parameters())),
            float(sum(p.numel() for p in meta.parameters())))


def memory_fit(cfg, shape, batch: Optional[int] = None, capacity: Optional[float] = None,
               ocfg: Optional[OptimizerConfig] = None) -> dict:
    """Whether one step of the cell fits the card, with its terms in bytes.
    ``batch`` defaults to the cell's global batch, ``capacity`` to the
    card's memory, ``ocfg`` (the gradients' and moments' dtypes) to the
    optimizer's defaults."""
    B = shape.global_batch if batch is None else batch
    param_bytes, n_elems = weight_bytes(cfg)
    capacity = hbm_capacity() if capacity is None else capacity
    ocfg = ocfg or OptimizerConfig()
    a = _itemsize(cfg.dtype)
    terms: Dict[str, float] = {"params": param_bytes}
    if shape.kind == "train":
        terms["optimizer"] = n_elems * (4 + 2 * _itemsize(ocfg.moments_dtype))
        terms["grads"] = n_elems * _itemsize(ocfg.grad_dtype)
        terms["new_params"] = param_bytes
    if shape.kind in ("train", "prefill"):
        S_tok = shape.seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
        side = (cfg.enc_seq if cfg.family == "encdec" else
                cfg.n_patches if cfg.family == "vlm" else 0) * cfg.d_model * a
        terms["batch"] = float(B * (S_tok * 4 + side))
    else:
        terms["batch"] = float(B * 4)
    if shape.kind != "train":
        # a prefill returns its cache stacked from the per-layer caches: both
        # are live at the stack
        cache = float(cache_bytes(cfg, B, shape.seq_len))
        terms["cache"] = 2 * cache if shape.kind == "prefill" else cache
    act = activation_bytes(cfg, shape, B)
    terms["activations"] = act["layers"]
    terms["logits"] = act["logits"]
    total = float(sum(terms.values()))
    return {"batch": B, "terms": terms, "total": total, "capacity": capacity,
            "usable": FIT_SHARE * capacity, "fits": total <= FIT_SHARE * capacity}


def max_batch(cfg, shape, **kw) -> int:
    """The largest global batch (at most the cell's) whose step fits, 0 if none."""
    lo, hi = 0, shape.global_batch
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if memory_fit(cfg, shape, batch=mid, **kw)["fits"]:
            lo = mid
        else:
            hi = mid - 1
    return lo
