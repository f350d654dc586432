"""Plain reference of the Qwen1.5-MoE decoder (the "moe" family).

Each layer: RMSNorm, attention with biased Q/K/V projections, rotary
positions over split halves and causal softmax; the residual; RMSNorm, then
the routed experts plus a shared expert: a float32 router's softmax over the
experts, the top k weights kept as they are (``norm_topk_prob`` false), each
expert a SwiGLU, and the shared SwiGLU scaled by the sigmoid of a gate
product; the residual. A final RMSNorm and an untied unembedding give the
logits. Everything is float32 (the products through ``common.Products``).

Capacity: a batch of T tokens lets each expert take at most C(T) of them
(``capacity``, below), the first in token order; the rest of that token's
choice adds nothing. A served request's prompt is one such batch (its
prefill), so the reference drops among the prompt's tokens exactly so. Each
later token was decoded in a batch of the engine's slots, whose other tokens
the reference cannot see: it keeps all of that token's choices, which is what
a batch of one token gives. At a capacity factor of n_experts / top_k no
batch drops anything (C >= T), and the reference follows the program exactly.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F

from perfbench import weights as wts
from perfbench.reference.common import Products, causal_attention, rmsnorm, rope, swiglu


def weight_specs(m: dict) -> Dict[str, wts.Spec]:
    """The weights by the program's parameter names; layers stacked on axis 0."""
    D, L, H, KV, V = m["d_model"], m["n_layers"], m["n_heads"], m["n_kv_heads"], m["vocab"]
    hd = m.get("head_dim") or D // H
    e = m["moe"]
    E, Fe, Fs = e["n_experts"], e["d_ff_expert"], e["d_ff_shared"]
    bf, f32 = getattr(torch, m.get("dtype", "bfloat16")), torch.float32   # bf: the model dtype
    return {
        "embed.tok": ((V, D), bf, 0.0, D ** -0.5),
        "unembed.w": ((D, V), bf, 0.0, D ** -0.5),
        "final_norm.scale": ((D,), f32, 1.0, 0.1),
        "layers.attn.wq": ((L, D, H, hd), bf, 0.0, D ** -0.5),
        "layers.attn.wk": ((L, D, KV, hd), bf, 0.0, D ** -0.5),
        "layers.attn.wv": ((L, D, KV, hd), bf, 0.0, D ** -0.5),
        "layers.attn.wo": ((L, H, hd, D), bf, 0.0, (H * hd) ** -0.5),
        "layers.attn.bq": ((L, H, hd), bf, 0.0, 0.1),
        "layers.attn.bk": ((L, KV, hd), bf, 0.0, 0.1),
        "layers.attn.bv": ((L, KV, hd), bf, 0.0, 0.1),
        "layers.ffn.router": ((L, D, E), f32, 0.0, D ** -0.5),
        "layers.ffn.wi": ((L, E, D, Fe), bf, 0.0, D ** -0.5),
        "layers.ffn.wg": ((L, E, D, Fe), bf, 0.0, D ** -0.5),
        "layers.ffn.wo": ((L, E, Fe, D), bf, 0.0, Fe ** -0.5),
        "layers.ffn.shared.wi": ((L, D, Fs), bf, 0.0, D ** -0.5),
        "layers.ffn.shared.wg": ((L, D, Fs), bf, 0.0, D ** -0.5),
        "layers.ffn.shared.wo": ((L, Fs, D), bf, 0.0, Fs ** -0.5),
        "layers.ffn.shared_gate": ((L, D, 1), bf, 0.0, D ** -0.5),
        "layers.ln1.scale": ((L, D), f32, 1.0, 0.1),
        "layers.ln2.scale": ((L, D), f32, 1.0, 0.1),
    }


def capacity(n_tokens: int, e: dict) -> int:
    """Copied from ``src/repro_torch/models/moe.py`` ``_capacity`` at commit
    8d0f43b: int(factor x T x k / E), at least 4, rounded up to a multiple of 4."""
    c = int(e["capacity_factor"] * n_tokens * e["top_k"] / e["n_experts"])
    c = max(c, 4)
    return int(-(-c // 4) * 4)


def moe_ffn(x: torch.Tensor, lw: dict, e: dict, n_batch: int, pr: Products) -> torch.Tensor:
    """x (T, D) float32; the first ``n_batch`` tokens were one batch (they
    share the capacity), each later token a batch of its own."""
    T = x.shape[0]
    E, k = e["n_experts"], e["top_k"]
    probs = torch.softmax(x @ lw["ffn.router"].float(), dim=-1)     # the router stays float32
    topw, topi = torch.topk(probs, k, dim=-1)
    if e.get("norm_topk_prob", True):
        topw = topw / topw.sum(-1, keepdim=True)
    keep = torch.ones_like(topi, dtype=torch.bool)
    if n_batch:
        chosen = F.one_hot(topi[:n_batch], E).sum(1)              # (n, E) 0/1
        before = torch.cumsum(chosen, 0) - chosen                 # earlier tokens per expert
        keep[:n_batch] = before.gather(1, topi[:n_batch]) < capacity(n_batch, e)
    y = torch.zeros_like(x)
    for ex in range(E):
        tok, j = torch.nonzero((topi == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = swiglu(x[tok], lw["ffn.wi"][ex], lw["ffn.wg"][ex], lw["ffn.wo"][ex], pr)
        y.index_add_(0, tok, ye * topw[tok, j][:, None])
    if e.get("n_shared_experts"):
        gate = torch.sigmoid(pr.mm(x, lw["ffn.shared_gate"]))
        y = y + gate * swiglu(x, lw["ffn.shared.wi"], lw["ffn.shared.wg"],
                                  lw["ffn.shared.wo"], pr)
    return y


def attention(x: torch.Tensor, lw: dict, m: dict, pr: Products) -> torch.Tensor:
    T, D = x.shape
    H, KV = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or D // H
    pos = torch.arange(T, device=x.device)

    def proj(w, b, n):
        out = pr.mm(x, w.reshape(D, n * hd)).reshape(T, n, hd)
        return out + b.float() if b is not None else out

    q = proj(lw["attn.wq"], lw.get("attn.bq"), H)
    k = proj(lw["attn.wk"], lw.get("attn.bk"), KV)
    v = proj(lw["attn.wv"], lw.get("attn.bv"), KV)
    theta = m.get("rope_theta", 10000.0)
    o = causal_attention(rope(q, pos, theta), rope(k, pos, theta), v)
    return pr.mm(o.reshape(T, H * hd), lw["attn.wo"].reshape(H * hd, D))


def layer_weights(W: dict, i: int, prefix: str = "layers.") -> Dict[str, torch.Tensor]:
    """Layer i's slices of the stacked leaves, by their names after ``prefix``."""
    return {name[len(prefix):]: t[i] for name, t in W.items() if name.startswith(prefix)}


def logits(W: dict, m: dict, seqs: Sequence[torch.Tensor], batch_lens: Sequence[int],
           precision: str = "float32") -> Iterator[torch.Tensor]:
    """Float32 logits (T, V) at every position of each token sequence in
    ``seqs`` (int tensors on the card), one sequence at a time, layer by
    layer over all of them; ``batch_lens[r]``: how many leading tokens of
    sequence r were one batch (its prompt)."""
    pr = Products(precision)
    eps = m.get("norm_eps", 1e-5)
    e = m["moe"]
    hs: List[torch.Tensor] = [W["embed.tok"][s.long()].float() for s in seqs]
    for i in range(m["n_layers"]):
        lw = layer_weights(W, i)
        for r, h in enumerate(hs):
            h = h + attention(rmsnorm(h, lw["ln1.scale"], eps), lw, m, pr)
            hs[r] = h + moe_ffn(rmsnorm(h, lw["ln2.scale"], eps), lw, e,
                                batch_lens[r], pr)
    for r in range(len(hs)):
        h, hs[r] = hs[r], None
        yield pr.mm(rmsnorm(h, W["final_norm.scale"], eps), W["unembed.w"])
