"""Plain PyTorch GQA/causal attention: the kernels' reference.

Port of ``repro.kernels.flash_attention.ref``. On the CPU it is the execution
path; on the card ``chip_smoke.py`` and the CUDA tests hold the kernels in
``kernel.py`` against it. Nothing on the main path calls it for a CUDA tensor:
under autograd the card runs the backward kernel, whose plain version is
``mha_backward_reference`` (the explicit FlashAttention-2 formulas; the JAX
package differentiates its ``mha_reference`` with ``jax.grad`` instead).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _masked_scores(q, k, causal: bool, q_offset, kv_len, scale: float):
    """The scaled scores (B, KV, G, Sq, Skv), NEG_INF where masked, in fp32
    (fp64 for fp64 inputs, as gradcheck gives them), and the mask, (B or 1,
    1, 1, Sq, Skv). Query head h reads KV head h // G."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    assert H % KV == 0, (H, KV)
    G = H // KV
    dev = q.device
    acc = torch.promote_types(q.dtype, torch.float32)

    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.to(acc), k.to(acc)) * scale

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
    return torch.where(mask, s, NEG_INF), mask


def _softmax(q, k, causal: bool, q_offset, kv_len, scale: float):
    """(m, e, l, valid): each row's max m of its masked scores, e = exp(s - m),
    its sum l, and whether the row has a valid key, all (B, KV, G, Sq, ·)."""
    s, mask = _masked_scores(q, k, causal, q_offset, kv_len, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return m, e, e.sum(dim=-1, keepdim=True), mask.any(dim=-1, keepdim=True)


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
    return mha_forward_with_lse_reference(q, k, v, causal=causal, q_offset=q_offset,
                                          kv_len=kv_len, scale=scale)[0]


def mha_forward_with_lse_reference(q, k, v, *, causal: bool = True, q_offset=None,
                                   kv_len=None, scale: Optional[float] = None):
    """(o, lse): ``mha_reference``'s output and each row's natural-log
    log-sum-exp of its scaled, masked scores, (B, H, Sq) in fp32 (fp64 for
    fp64 inputs), -inf for a row with no valid key: the forward kernel's two
    outputs under autograd."""
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    m, e, l, valid = _softmax(q, k, causal, q_offset, kv_len, scale)
    w = torch.where(valid, e / l, 0.0)  # no valid key: zeros
    o = torch.einsum("bkgst,btkd->bskgd", w, v.to(w.dtype))
    o = o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)  # dv may differ (MLA)
    return o, torch.where(valid, m + torch.log(l), float("-inf")).reshape(B, H, Sq)


def mha_backward_reference(q, k, v, o, do, lse, *, causal: bool = True, q_offset=None,
                           kv_len=None, scale: Optional[float] = None):
    """The gradient of ``mha_reference`` for q, k and v, given its output o,
    the output's gradient do (B, Sq, H, dv) and lse (B, H, Sq) from
    ``mha_forward_with_lse_reference``: FlashAttention-2's formulas in fp32
    (fp64 for fp64 inputs), not autograd. P = exp(S - lse) where the mask
    lets a key through, Delta = rowsum(do * o), dS = P (dP - Delta) with
    dP = do V^T, dq = scale dS K, dk = scale dS^T q and dv = P^T do, each
    KV head's summed over its G query heads. A row with no valid key has
    P = 0 and so gives zero gradients. Returns (dq, dk, dv) in the inputs'
    dtypes. The backward kernel's plain version: the tests and
    ``chip_smoke.py`` hold the kernel against it."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, dv = v.shape
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    s, mask = _masked_scores(q, k, causal, q_offset, kv_len, scale)
    acc = s.dtype
    lse = lse.to(acc).reshape(B, KV, G, Sq, 1)
    p = torch.where(mask, torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)), 0.0)
    dog = do.to(acc).reshape(B, Sq, KV, G, dv)
    delta = (dog * o.to(acc).reshape(B, Sq, KV, G, dv)).sum(dim=-1)       # (B, Sq, KV, G)
    delta = delta.permute(0, 2, 3, 1)[..., None]                          # (B, KV, G, Sq, 1)
    d_v = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(acc))
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(acc)).reshape(B, Sq, H, hd)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.to(acc).reshape(B, Sq, KV, G, hd))
    return dq.to(q.dtype), dk.to(k.dtype), d_v.to(v.dtype)


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
