"""Plain PyTorch fused residual add + RMSNorm: the kernel's reference.

Port of ``repro.kernels.rmsnorm.ref``. The sum is taken in float32 and the
norm reads that unrounded sum; both outputs come back in x's dtype. On the
CPU it is the execution path; on the card ``chip_smoke.py`` and the CUDA
tests hold ``kernel.fused_add_rmsnorm`` against it.
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
    res = x.float() + delta.float()
    var = (res * res).mean(dim=-1, keepdim=True)
    normed = res * torch.rsqrt(var + eps) * scale.float()
    return res.to(x.dtype), normed.to(x.dtype)
