"""Plain PyTorch Mamba2 SSD (state-space duality) scan: the kernel's reference.

Port of ``repro.kernels.ssd.ref``: the chunked block decomposition of Mamba2
(arXiv:2405.21060 §6), a within-chunk quadratic term plus an inter-chunk
recurrence on the (H, P, N) state. All math is float32 (float64 for float64
inputs, as ``gradcheck`` runs it); y comes back in x's dtype and the state in
float32. G groups broadcast over heads: head h reads
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

    f32 = torch.promote_types(x.dtype, torch.float32)
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


def ssd_backward_reference(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)
    A: torch.Tensor,     # (H,)
    B_: torch.Tensor,    # (B, S, G, N)
    C_: torch.Tensor,    # (B, S, G, N)
    dy: torch.Tensor,    # (B, S, H, P)  the gradient of y
    *,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    dfinal: Optional[torch.Tensor] = None,         # (B, H, P, N)  the final state's gradient
) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_reference`` by its explicit formulas, pass by pass
    as ``csrc/ssd_backward.cu``'s bf16 path runs them, with no autograd: (dx,
    ddt, dA, dB, dC, dinit). dx, dB and dC come back in x's dtype, ddt, dA and
    dinit in float32 (dinit None without an initial state), as autograd of
    ``ssd_reference`` gives them. Per chunk, with a = dt A, cum its inclusive
    cumulative sum in the chunk, cl its last entry, L_ij = exp(cum_i - cum_j)
    (i >= j), H_k the state entering chunk k and G_{k+1} the gradient of the
    state leaving it.

    The chunk-local gradients are regrouped so that nothing per head is summed
    over a group afterwards: C_i . B_j is formed once a group, and the heads'
    scores QL^h_ij = (dy^h_i . x^h_j) L^h_ij enter dB and dC only through
    their group sum W_ij = sum_h dt^h_j QL^h_ij (dB = W^T C, dC = W B, plus
    the state terms summed over the group's heads). Each head's share of the
    cum gradient comes from row and column sums of W^h o CB."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if S % chunk != 0:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nc, rep, f32 = S // chunk, H // G, torch.promote_types(x.dtype, torch.float32)
    x_ = x.to(f32).reshape(Bb, nc, chunk, H, P)
    dy_ = dy.to(f32).reshape(Bb, nc, chunk, H, P)
    dt_ = dt.to(f32).reshape(Bb, nc, chunk, H)
    Bg = B_.to(f32).reshape(Bb, nc, chunk, G, N)
    Cg = C_.to(f32).reshape(Bb, nc, chunk, G, N)
    Bh, Ch = (t.repeat_interleave(rep, dim=3) for t in (Bg, Cg))  # each head's group
    a = (dt_ * A.to(f32)).movedim(-1, 2)                    # (B, nc, H, c)
    cum = torch.cumsum(a, dim=-1)
    to_end = torch.exp(cum[..., -1:] - cum).movedim(2, 3)   # exp(cl - cum_j): (B, nc, c, H)
    from_start = torch.exp(cum).movedim(2, 3)               # exp(cum_i): (B, nc, c, H)
    decay = torch.exp(cum[..., -1])                         # (B, nc, H)

    # 1) each chunk's own state S_k and D_k = sum_i exp(cum_i) dy_i C_i^T
    own = torch.einsum("bnchp,bnchm->bnhpm", x_ * (dt_ * to_end)[..., None], Bh)
    d_own = torch.einsum("bnchp,bnchm->bnhpm", dy_ * from_start[..., None], Ch)

    # 2) the states entering each chunk, forward; their gradients, backward;
    # <G_{k+1}, H_k> for the cum gradient's last position
    h = (initial_state.to(f32) if initial_state is not None
         else torch.zeros((Bb, H, P, N), dtype=f32, device=x.device))
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = h * decay[:, k, :, None, None] + own[:, k]
    g = (dfinal.to(f32) if dfinal is not None
         else torch.zeros((Bb, H, P, N), dtype=f32, device=x.device))
    g_out = [None] * nc
    for k in reversed(range(nc)):
        g_out[k] = g                                        # G_{k+1}
        g = d_own[:, k] + decay[:, k, :, None, None] * g
    h_in, g_out = torch.stack(h_in, dim=1), torch.stack(g_out, dim=1)  # (B, nc, H, P, N)
    gh = (g_out * h_in).sum((-2, -1))                       # (B, nc, H)

    # 3) per head, over 64-row j tiles: dx, the direct term of ddt, and the cum
    # gradient's pieces from the group's C B^T; W summed over the group's heads
    L = torch.exp(segsum(a))                                # (B, nc, H, i, j)
    CB = torch.einsum("bnigm,bnjgm->bngij", Cg, Bg)         # C_i . B_j, once a group
    CBh = CB.repeat_interleave(rep, dim=2)                  # (B, nc, H, i, j)
    QL = torch.einsum("bnihp,bnjhp->bnhij", dy_, x_) * L    # (dy_i . x_j) L_ij
    gb = torch.einsum("bnhpm,bnjhm->bnjhp", g_out, Bh)      # G B_j
    dx = dt_[..., None] * (torch.einsum("bnhij,bnihp->bnjhp", CBh * L, dy_)
                           + to_end[..., None] * gb)
    V = to_end * (x_ * gb).sum(-1)                          # exp(cl - cum_j) x_j . G B_j
    # B_j . dB^h_j / dt_j: the column sums of QL o CB, and the state term
    ddt_direct = torch.einsum("bnhij,bnhij->bnjh", QL, CBh) + V   # (B, nc, c, H)
    Wh = QL * dt_.movedim(2, 3)[..., None, :]               # W^h_ij = dt_j QL_ij
    R = torch.einsum("bnhij,bnhij->bnih", Wh, CBh)          # row sums of W^h o CB: C_i . (W^h B)_i

    # 4) per group: dB = W^T C + sum_h dt_j exp(cl - cum_j) G^T x_j and
    # dC = W B + sum_h exp(cum_i) H^T dy_i; each head's exp(cum_i) C_i . H^T dy_i
    W = Wh.reshape(Bb, nc, G, rep, chunk, chunk).sum(3)     # (B, nc, G, i, j)
    gx = torch.einsum("bnhpm,bnjhp->bnjhm", g_out, x_)      # G^T x_j
    hy = torch.einsum("bnhpm,bnihp->bnihm", h_in, dy_)      # H_k^T dy_i
    Y = from_start * (Ch * hy).sum(-1)                      # (B, nc, c, H)
    dB = (torch.einsum("bngij,bnigm->bnjgm", W, Cg)
          + ((dt_ * to_end)[..., None] * gx).reshape(Bb, nc, chunk, G, rep, N).sum(4))
    dC = (torch.einsum("bngij,bnjgm->bnigm", W, Bg)
          + (from_start[..., None] * hy).reshape(Bb, nc, chunk, G, rep, N).sum(4))

    # 5) per head: the cum gradient dcum_t = C_t . dC^h_t - B_t . dB^h_t (the
    # last position also gains sum_j dt_j V_j + exp(cl) <G_{k+1}, H_k>), its
    # suffix sums da, ddt = the direct term + A da, and dA = sum dt da
    dcum = R - dt_ * ddt_direct + Y
    last = (dt_ * V).sum(2) + decay * gh                    # (B, nc, H)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]], dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))  # suffix sums
    ddt = ddt_direct + A.to(f32) * da
    dA = (dt_ * da).sum((0, 1, 2))
    return (dx.reshape(Bb, S, H, P).to(x.dtype), ddt.reshape(Bb, S, H), dA,
            dB.reshape(Bb, S, G, N).to(B_.dtype), dC.reshape(Bb, S, G, N).to(C_.dtype),
            g if initial_state is not None else None)


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
