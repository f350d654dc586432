"""Plain PyTorch fused residual add + RMSNorm: the kernel's reference.

Port of ``repro.kernels.rmsnorm.ref``. The sum is taken in float32 (float64
for float64 inputs, as ``gradcheck`` runs it) and the norm reads that
unrounded sum; both outputs come back in x's dtype. On the
CPU it is the execution path; on the card ``chip_smoke.py`` and the CUDA
tests hold ``kernel.fused_add_rmsnorm`` against it, and
``kernel.fused_add_rmsnorm_backward`` against ``fused_add_rmsnorm_backward_reference``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def fused_add_rmsnorm_reference(
    x: torch.Tensor,          # (..., D) residual stream
    delta: torch.Tensor,      # (..., D) block output to add
    scale: torch.Tensor,      # (D,)
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (new_residual = x + delta, rmsnorm(new_residual) * scale)."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    res = x.to(f32) + delta.to(f32)
    var = (res * res).mean(dim=-1, keepdim=True)
    normed = res * torch.rsqrt(var + eps) * scale.to(f32)
    return res.to(x.dtype), normed.to(x.dtype)


def fused_add_rmsnorm_backward_reference(
    x: torch.Tensor,          # (..., D)
    delta: torch.Tensor,      # (..., D)
    scale: torch.Tensor,      # (D,)
    g_res: torch.Tensor,      # (..., D) the gradient of new_residual
    g_out: torch.Tensor,      # (..., D) the gradient of the normed output
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``fused_add_rmsnorm_reference`` by its explicit formulas,
    with no autograd: (dx, ddelta, dscale). With h = x + delta in float32, r =
    rsqrt(mean(h^2) + eps), n = h r and u = g_out * scale: dh = g_res + r (u -
    n mean(u n)), dx = ddelta = dh in x's dtype (one tensor), dscale = the sum
    over rows of g_out * n in scale's dtype."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    h = x.to(f32) + delta.to(f32)
    r = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    n = h * r
    u = g_out.to(f32) * scale.to(f32)
    dh = (g_res.to(f32) + r * (u - n * (u * n).mean(dim=-1, keepdim=True))).to(x.dtype)
    dscale = (g_out.to(f32) * n).reshape(-1, x.shape[-1]).sum(0).to(scale.dtype)
    return dh, dh, dscale
