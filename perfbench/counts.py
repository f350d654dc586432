"""The yardstick's arithmetic: the card's peaks, and the least time of a
kernel call or a decode step from its shapes.

Each function says where its arithmetic was copied from (at commit 8d0f43b);
the copies count from the reference's weight specs (name -> shape, dtype)
where the originals counted the program's parameters, so the program cannot
change what they count.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 products, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def _numel(shape) -> int:
    return math.prod(shape)


def _bytes(spec) -> int:
    shape, dtype = spec[0], spec[1]
    return _numel(shape) * torch.empty((), dtype=dtype).element_size()


def least_ms(n_bytes: float, flops: float) -> float:
    """The least time of work that reads and writes ``n_bytes`` and computes
    ``flops`` bf16 operations: the larger of the two bounds, in ms."""
    return max(n_bytes / HBM_BYTES_S, flops / PEAK_BF16_FLOPS) * 1e3


def step_weight_bytes(specs: Dict[str, tuple], m: dict) -> float:
    """The weights one decode step reads at least: every leaf but a table the
    step only gathers rows of (an untied embedding), and of each MoE layer's
    routed experts only top_k of n_experts (the fewest a step can read).
    Copied from ``chip_smoke.py`` ``_step_bound`` (its byte count) at 8d0f43b."""
    routed = ("layers.ffn.wi", "layers.ffn.wg", "layers.ffn.wo")
    e = m.get("moe")
    total = 0.0
    for name, spec in specs.items():
        if name == "embed.tok" and "unembed.w" in specs:
            continue
        share = e["top_k"] / e["n_experts"] if e and name in routed else 1.0
        total += _bytes(spec) * share
    return total


def attention_calls(m: dict) -> int:
    """Decode-attention calls a step: one a layer, or a hybrid's one a group."""
    if m["family"] == "hybrid":
        return m["n_layers"] // m["shared_attn_every"]
    return m["n_layers"] if m["family"] in ("dense", "moe", "vlm", "encdec") else 0


def decode_state_bytes(m: dict, batch: int) -> float:
    """A Mamba2 layer's decode state, read and written once a step, over the
    layers: the fp32 (H, P, N) state and the (K-1, conv channels) window in
    the model's dtype, for ``batch`` rows."""
    if m["family"] not in ("ssm", "hybrid"):
        return 0.0
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    H, gn = d_in // s["head_dim"], s.get("n_groups", 1) * s["d_state"]
    esz = torch.empty((), dtype=getattr(torch, m.get("dtype", "bfloat16"))).element_size()
    per_row = H * s["head_dim"] * s["d_state"] * 4 + (s["conv_kernel"] - 1) * (d_in + 2 * gn) * esz
    return 2.0 * m["n_layers"] * batch * per_row


def decode_attention_bytes(keys: Iterable[int], m: dict, esz: int = 2) -> float:
    """One decode-attention call over rows that attend to ``keys[r]`` cached
    positions each: the K/V rows read, q read and o written, the lengths.
    Copied from ``chip_smoke.py``'s decode-attention bound (``d_bytes``) at 8d0f43b."""
    keys = list(keys)
    H, KV = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    return (sum(keys) * KV + len(keys) * H) * (2 * hd) * esz + 4 * len(keys)


def decode_attention_flops(keys: Iterable[int], m: dict) -> float:
    H = m["n_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    return 2 * sum(keys) * H * (2 * hd)


def idle_share(busy_s: float, window_s: float) -> float:
    """The share of the window in which no operation ran on the device. Copied
    from ``tools/profile_torch_serve.py`` ``_window`` (1 - busy / wall) at 8d0f43b."""
    return 1.0 - busy_s / window_s
