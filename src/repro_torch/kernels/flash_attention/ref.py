"""Plain PyTorch GQA/causal attention: the kernels' reference.

Port of ``repro.kernels.flash_attention.ref``. On the CPU it is the execution
path; on the card ``chip_smoke.py`` and the CUDA tests hold the kernels in
``kernel.py`` against it. Nothing on the main path calls it for a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(
    q: torch.Tensor,            # (B, Sq, H, dqk)
    k: torch.Tensor,            # (B, Skv, KV, dqk)
    v: torch.Tensor,            # (B, Skv, KV, dv)
    *,
    causal: bool = True,
    q_offset=None,              # scalar: absolute pos of q[0]
    kv_len=None,                # scalar or (B,): #valid kv positions
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with optional causal masking and a kv validity
    length (decode: q_offset = cache position, kv_len = cache fill level).
    Heads are grouped by reshape: query head h reads KV head h // G.

    A query row whose mask leaves no valid key gives zeros, as both CUDA
    kernels do. Here the port departs from JAX: its ``mha_reference`` gives
    the mean of v over all Skv keys for such a row (every score is the finite
    NEG_INF), and its Pallas kernel the mean over the keys of its padded
    blocks (src/repro/kernels/flash_attention/kernel.py:57-72). Every row
    with at least one valid key is computed as JAX computes it."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    assert H % KV == 0, (H, KV)
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device

    qg = q.reshape(B, Sq, KV, G, hd)
    # scores: (B, KV, G, Sq, Skv) in fp32
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale

    kv_pos = torch.arange(Skv, device=dev)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        q_pos = torch.arange(Sq, device=dev) + (q_offset if q_offset is not None else 0)
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=dev)
        if kl.ndim == 0:
            mask = mask & (kv_pos[None, :] < kl)
        else:  # per-batch-row validity length (B,)
            mask = mask[None] & (kv_pos[None, None, :] < kl[:, None, None])
    # (B or 1, 1, 1, Sq, Skv): broadcast over (KV, G)
    mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
    s = torch.where(mask, s, NEG_INF)

    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)  # no valid key: zeros
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)  # dv may differ (MLA)


def decode_attention_reference(
    q: torch.Tensor,            # (B, 1, H, dqk) — single new token
    k_cache: torch.Tensor,      # (B, S, KV, dqk)
    v_cache: torch.Tensor,      # (B, S, KV, dv)
    pos,                        # scalar or (B,) int: write/attend position
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention against a cache whose entries <= pos are valid
    (the new token's own k/v are assumed already written at `pos`).
    Vector `pos` gives per-sequence positions (continuous batching)."""
    return mha_reference(
        q, k_cache, v_cache, causal=False,
        kv_len=torch.as_tensor(pos, device=q.device) + 1, scale=scale,
    )
