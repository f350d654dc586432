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


def decode_attention_partials_reference(
    q: torch.Tensor,            # (B, 1, H, dqk)
    k_cache: torch.Tensor,      # (B, S, KV, dqk): one sequence shard
    v_cache: torch.Tensor,      # (B, S, KV, dv)
    pos,                        # scalar or (B,) int: the global position attended to
    *,
    pos_offset: int = 0,        # global position of the shard's first entry
    scale: Optional[float] = None,
):
    """The decode over one sequence shard of a cache, unnormalised: entry s
    holds global position pos_offset + s and is valid where that is <= pos.
    Returns fp32 (m, l, acc): per (row, head) the max score m (B, 1, H), the
    sum l of exp(score - m) and the accumulator acc = sum exp(score - m) v
    (B, 1, H, dv). A row with no valid entry in the shard gives m = -inf,
    l = 0 and acc = 0. ``combine_partials`` of every shard's triple is
    ``decode_attention_reference`` on the whole cache."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) * scale       # (B, KV, G, S)
    p = torch.as_tensor(pos, device=dev).reshape(-1)                      # (1,) or (B,)
    valid = (torch.arange(S, device=dev) + pos_offset)[None, :] <= p[:, None]
    valid = valid[:, None, None, :]                                        # (B or 1, 1, 1, S)
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1)                                                     # -inf: no valid key
    w = torch.where(valid, torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None]), 0.0)
    acc = torch.einsum("bkgt,btkd->bkgd", w, v_cache.float())
    return (m.reshape(B, 1, H), w.sum(dim=-1).reshape(B, 1, H),
            acc.reshape(B, 1, H, v_cache.shape[-1]))


def _latent_kv(ckv: torch.Tensor, krope: torch.Tensor):
    """MLA's latent caches as one KV head: K = [ckv | krope] (B, S, 1, dl + dr)
    and V = ckv (B, S, 1, dl), the reference's ``k_full`` and ``v_lat``
    (src/repro/models/mla.py:131-132)."""
    return torch.cat([ckv, krope], dim=-1)[:, :, None, :], ckv[:, :, None, :]


def mla_decode_reference(
    q: torch.Tensor,            # (B, 1, H, dl + dr)
    ckv: torch.Tensor,          # (B, S, dl): the latent, K's first dl columns and V
    krope: torch.Tensor,        # (B, S, dr): K's last dr columns
    pos,                        # scalar or (B,) int: the position attended to
    *,
    scale: float,
) -> torch.Tensor:
    """MLA's absorbed decode attention, (B, 1, H, dl): the two caches
    concatenated into one KV head, then ``decode_attention_reference``, as
    the reference's models/mla.py computes it."""
    k, v = _latent_kv(ckv, krope)
    return decode_attention_reference(q, k, v, pos, scale=scale)


def mla_decode_partials_reference(q, ckv, krope, pos, *, pos_offset: int = 0, scale: float):
    """``decode_attention_partials_reference`` over one sequence shard of the
    two latent caches (entry s at global position pos_offset + s)."""
    k, v = _latent_kv(ckv, krope)
    return decode_attention_partials_reference(q, k, v, pos, pos_offset=pos_offset, scale=scale)


def combine_partials(parts, dtype) -> torch.Tensor:
    """The shards' (m, l, acc) triples merged by log-sum-exp into the output
    (B, 1, H, dv) in ``dtype``: zeros for a row with no valid entry in any
    shard (the kernels' rule)."""
    ms = torch.stack([m for m, _, _ in parts])
    m_g = ms.amax(dim=0)
    l_g = torch.zeros_like(m_g)
    acc_g = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = rescale(m, m_g)
        l_g = l_g + l * w
        acc_g = acc_g + acc * w[..., None]
    return normalise(acc_g, l_g, dtype)


def rescale(m: torch.Tensor, m_g: torch.Tensor) -> torch.Tensor:
    """exp(m - m_g), the weight of a shard's partials under the global max
    m_g; 0 where the shard has no valid entry (m = -inf, so m_g may be -inf
    too)."""
    return torch.where(torch.isinf(m), 0.0, torch.exp(m - m_g))


def normalise(acc: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    """acc / l in ``dtype``, zeros where l = 0 (no valid entry anywhere)."""
    return torch.where(l[..., None] > 0, acc / l.clamp_min(torch.finfo(l.dtype).tiny)[..., None],
                       0.0).to(dtype)
