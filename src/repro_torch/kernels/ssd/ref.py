"""Plain PyTorch Mamba2 SSD (state-space duality) scan: the kernel's reference.

Port of ``repro.kernels.ssd.ref``: the chunked block decomposition of Mamba2
(arXiv:2405.21060 §6), a within-chunk quadratic term plus an inter-chunk
recurrence on the (H, P, N) state. All math is float32; y comes back in x's
dtype and the state in float32. G groups broadcast over heads: head h reads
group h // (H / G). On the CPU it is the execution path; on the card
``chip_smoke.py`` and the CUDA tests hold ``kernel.ssd`` against it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{k=j+1..i} x[..., k], lower
    triangle; -inf above the diagonal (exp gives 0 there)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_reference(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)      softplus-activated step sizes
    A: torch.Tensor,     # (H,)           negative decay rates (A = -exp(A_log))
    B_: torch.Tensor,    # (B, S, G, N)
    C_: torch.Tensor,    # (B, S, G, N)
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    return_final_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y[t] = C[t] · h[t],  h[t] = exp(dt[t]·A)·h[t-1] + dt[t]·B[t]⊗x[t]."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if S % chunk != 0:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nc = S // chunk
    rep = H // G

    f32 = torch.float32
    x_ = x.to(f32).reshape(Bb, nc, chunk, H, P)
    dt_ = dt.to(f32).reshape(Bb, nc, chunk, H)
    Bc = B_.to(f32).repeat_interleave(rep, dim=2).reshape(Bb, nc, chunk, H, N)
    Cc = C_.to(f32).repeat_interleave(rep, dim=2).reshape(Bb, nc, chunk, H, N)

    dA = (dt_ * A.to(f32)).movedim(-1, 2)                   # (B, nc, H, c)
    dA_cum = torch.cumsum(dA, dim=-1)                       # within-chunk cumsum

    # 1) within-chunk (quadratic) term: Y_diag = (C B^T ∘ L) · (dt·x)
    L = torch.exp(segsum(dA))                               # (B, nc, H, c, c)
    CB = torch.einsum("bnchj,bnshj->bnhcs", Cc, Bc)         # (B, nc, H, c, c)
    dtx = x_ * dt_[..., None]                               # (B, nc, c, H, P)
    y_diag = torch.einsum("bnhcs,bnshp->bnchp", CB * L, dtx)

    # 2) per-chunk final states: decay each position to the chunk's end
    decay_to_end = torch.exp(dA_cum[..., -1:] - dA_cum)     # (B, nc, H, c)
    states = torch.einsum("bnchm,bnchp->bnhpm",
                          Bc * decay_to_end.movedim(2, 3)[..., None], dtx)

    # 3) inter-chunk recurrence, sequential over the nc chunks
    chunk_decay = torch.exp(dA_cum[..., -1])                # (B, nc, H)
    h = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((Bb, H, P, N), dtype=f32, device=x.device))
    prior = []
    for n in range(nc):
        prior.append(h)                                     # state entering chunk n
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prior = torch.stack(prior, dim=1)                     # (B, nc, H, P, N)

    # 4) inter-chunk output: the prior state read out by C, decayed
    state_decay = torch.exp(dA_cum).movedim(2, 3)           # (B, nc, c, H)
    y_off = torch.einsum("bnchm,bnhpm->bnchp", Cc, h_prior) * state_decay[..., None]

    y = (y_diag + y_off).reshape(Bb, S, H, P).to(x.dtype)
    return (y, h) if return_final_state else (y, None)


def ssd_decode_reference(
    state: torch.Tensor,  # (B, H, P, N)
    x_t: torch.Tensor,    # (B, H, P)
    dt_t: torch.Tensor,   # (B, H)
    A: torch.Tensor,      # (H,)
    B_t: torch.Tensor,    # (B, G, N)
    C_t: torch.Tensor,    # (B, G, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence: O(1) in sequence length."""
    H = state.shape[1]
    rep = H // B_t.shape[1]
    f32 = torch.float32
    Bh = B_t.to(f32).repeat_interleave(rep, dim=1)          # (B, H, N)
    Ch = C_t.to(f32).repeat_interleave(rep, dim=1)
    dt32 = dt_t.to(f32)
    dA = torch.exp(dt32 * A.to(f32))                        # (B, H)
    dBx = torch.einsum("bhn,bhp->bhpn", Bh * dt32[..., None], x_t.to(f32))
    new_state = state.to(f32) * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state.to(state.dtype)
