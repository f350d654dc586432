"""Shared model primitives: norms, RoPE, sinusoidal positions, MLPs, embeddings, logits.

Port of ``repro.models.layers``. Every ``init_*`` takes an explicit
``torch.Generator`` and device, and returns a dict of tensors; ``lead`` is a
shape prefix so a stack of layers is drawn in one call (layers on axis 0).
Compute follows the reference's mixed-precision recipe: bf16 weights and
activations, fp32 norms/softmax/rope.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig

Params = dict


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype, device) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(fan_in ** -0.5).to(dtype)


# -- norms ---------------------------------------------------------------
def init_rmsnorm(d: int, device, lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def init_layernorm(d: int, device, lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device),
            "bias": torch.zeros((*lead, d), dtype=torch.float32, device=device)}


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """fp32 inside with the population variance, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# -- rotary / sinusoidal positions --------------------------------------------
def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (..., S). Split-half halves
    (not interleaved pairs), angles in fp32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                         # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed absolute positional embedding (n, d) in f32:
    ``[sin | cos]`` of position x ``exp(-log(10000) / max(d/2 - 1, 1) * i)``.
    Row i does not depend on n."""
    half = d // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32, device=device))
    scaled = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


# -- MLPs -------------------------------------------------------------------
def init_swiglu(gen, d: int, f: int, dtype, device, lead: Tuple[int, ...] = ()) -> Params:
    return {
        "wi": dense_init(gen, (*lead, d, f), d, dtype, device),
        "wg": dense_init(gen, (*lead, d, f), d, dtype, device),
        "wo": dense_init(gen, (*lead, f, d), f, dtype, device),
    }


def swiglu(x: torch.Tensor, p: Params) -> torch.Tensor:
    h = x @ p["wi"]
    g = x @ p["wg"]
    # silu in fp32, cast back to the activation dtype before the product
    h = h * F.silu(g.float()).to(x.dtype)
    return h @ p["wo"]


def init_gelu_mlp(gen, d: int, f: int, dtype, device, lead: Tuple[int, ...] = ()) -> Params:
    return {
        "wi": dense_init(gen, (*lead, d, f), d, dtype, device),
        "bi": torch.zeros((*lead, f), dtype=dtype, device=device),
        "wo": dense_init(gen, (*lead, f, d), f, dtype, device),
        "bo": torch.zeros((*lead, d), dtype=dtype, device=device),
    }


def gelu_mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, in fp32, cast back
    to the activation dtype before the output product."""
    h = x @ p["wi"] + p["bi"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["wo"] + p["bo"]


# -- embeddings ---------------------------------------------------------------
def init_embedding(gen, vocab: int, d: int, dtype, device) -> Params:
    tok = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return {"tok": tok.mul_(d ** -0.5).to(dtype)}


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    return F.embedding(tokens.long(), p["tok"])


def init_unembed(gen, vocab: int, d: int, dtype, device) -> Params:
    return {"w": dense_init(gen, (d, vocab), d, dtype, device)}


def logits_from(h: torch.Tensor, unembed_p: Optional[Params], embed_p: Params) -> torch.Tensor:
    """fp32 logits; tied embeddings when no separate unembed is present. The
    product runs in the weight dtype and is cast to fp32 afterwards."""
    if unembed_p is not None:
        return (h @ unembed_p["w"]).float()
    return (h @ embed_p["tok"].t()).float()


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL of fp32 logits (B, S, V) at integer targets (B, S);
    with ``mask`` (B, S), 1.0 where counted, the masked sum over
    ``max(mask.sum(), 1)``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
