"""Plain PyTorch pieces the references share: norms, rotary positions,
causal attention, SwiGLU, and the products in the precision asked for.

Nothing here imports the program. Every product goes through ``Products``:
in float32 (TF32 off: the caller runs under ``exact_float32``) or, for the
control, with both operands rounded to float8 e4m3 with one scale a tensor,
as an fp8 deployment computes them.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # the largest finite float8 e4m3 value


@contextlib.contextmanager
def exact_float32():
    """float32 products in full float32 (no TF32) inside, the settings put back after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to 448), returned in float32."""
    scale = FP8_MAX / t.abs().amax().float().clamp_min(1e-30)
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


class Products:
    """``mm(x, w)``: x @ w in float32 ("float32"), or with both operands
    rounded to float8 e4m3 first ("fp8")."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got {precision!r}")
        self.precision = precision

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on (..., S, H, hd) over split halves (the first half
    of the head dim pairs with the second), angles in float32."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (..., S, H, hd), k and v (..., S, KV, hd) -> (..., S, H, hd): each
    query attends to the keys at or before its position; H / KV query heads
    share a key head."""
    S, H, hd = q.shape[-3:]
    rep = H // k.shape[-2]
    k = k.repeat_interleave(rep, dim=-2)
    v = v.repeat_interleave(rep, dim=-2)
    s = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(hd)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("...hqk,...khd->...qhd", torch.softmax(s, dim=-1), v)


def swiglu(x: torch.Tensor, wi, wg, wo, pr: Products) -> torch.Tensor:
    return pr.mm(pr.mm(x, wi) * F.silu(pr.mm(x, wg)), wo)
