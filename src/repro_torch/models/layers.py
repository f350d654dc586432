"""Shared model primitives: norms, RoPE, sinusoidal positions, MLPs, embeddings, logits.

Port of ``repro.models.layers``. Every ``init_*`` takes an explicit
``torch.Generator`` and device, and returns a dict of tensors; ``lead`` is a
shape prefix so a stack of layers is drawn in one call (layers on axis 0).
Compute follows the reference's mixed-precision recipe: bf16 weights and
activations, fp32 norms/softmax/rope. Each ``*_specs`` function gives the
logical axis names of its ``init_*``'s tree, the second value of the
reference's ``init_*`` (resolved against a mesh by ``sharding.partition``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.local import all_reduce, as_replicated, grad_placements
from ..sharding.partition import is_dtensor

Params = dict


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype, device) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(fan_in ** -0.5).to(dtype)


# -- norms ---------------------------------------------------------------
def init_rmsnorm(d: int, device, lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}


def rmsnorm_specs() -> dict:
    return {"scale": ("embed",)}


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def init_layernorm(d: int, device, lead: Tuple[int, ...] = ()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device),
            "bias": torch.zeros((*lead, d), dtype=torch.float32, device=device)}


def layernorm_specs() -> dict:
    return {"scale": ("embed",), "bias": ("embed",)}


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


def swiglu_specs() -> dict:
    return {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"), "wo": ("mlp", "embed")}


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


def gelu_mlp_specs() -> dict:
    return {"wi": ("embed", "mlp"), "bi": ("mlp",), "wo": ("mlp", "embed"), "bo": ("embed",)}


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


def embedding_specs() -> dict:
    return {"tok": ("vocab", "embed")}


def _split_on(t: torch.Tensor, dim: int) -> bool:
    """Whether DTensor ``t`` is sharded over its ``dim`` on some mesh dim."""
    if not is_dtensor(t):
        return False
    from torch.distributed.tensor import Shard

    return any(isinstance(p, Shard) and p.dim == dim % t.ndim for p in t.placements)


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    if _split_on(p["tok"], 0):
        return _vocab_parallel_embed(tokens, p["tok"])
    return F.embedding(tokens.long(), p["tok"])


def _vocab_parallel_embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The lookup on a mesh: each rank looks its tokens up in its rows of a
    vocab-sharded table (zeros for the rest) and the rows' owners' partial
    sums add up across the vocab split; the tokens keep their batch split,
    the table's embed dim is gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tokens = as_replicated(tokens, mesh)
    vocab_dims = [i for i, pl in enumerate(table.placements)
                  if isinstance(pl, Shard) and pl.dim == 0]
    tok_pl = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0 and i not in vocab_dims
                   else Replicate() for i, pl in enumerate(tokens.placements))
    tab_pl = tuple(Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim))
    out_pl = tuple(Partial() if i in vocab_dims else pl for i, pl in enumerate(tok_pl))
    coord = mesh.get_coordinate()
    part = 0
    for i in vocab_dims:
        part = part * mesh.size(i) + coord[i]

    def lookup(tok, tab):
        rows = tok.long() - part * tab.shape[0]
        inside = (rows >= 0) & (rows < tab.shape[0])
        out = F.embedding(rows.clamp(0, tab.shape[0] - 1), tab)
        return out * inside[..., None].to(out.dtype)

    tokens = tokens.redistribute(mesh, tok_pl) if tuple(tokens.placements) != tok_pl else tokens
    table = table.redistribute(mesh, tab_pl) if tuple(table.placements) != tab_pl else table
    return local_map(lookup, out_placements=list(out_pl), in_placements=(tok_pl, tab_pl),
                     in_grad_placements=grad_placements((tok_pl, tab_pl)),
                     device_mesh=mesh)(tokens, table)


def init_unembed(gen, vocab: int, d: int, dtype, device) -> Params:
    return {"w": dense_init(gen, (d, vocab), d, dtype, device)}


def unembed_specs() -> dict:
    return {"w": ("embed", "vocab")}


def logits_from(h: torch.Tensor, unembed_p: Optional[Params], embed_p: Params) -> torch.Tensor:
    """fp32 logits; tied embeddings when no separate unembed is present. The
    product runs in the weight dtype and is cast to fp32 afterwards."""
    if unembed_p is not None:
        return (h @ unembed_p["w"]).float()
    return (h @ embed_p["tok"].t()).float()


def _vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The NLL of vocab-sharded logits on a mesh without gathering them: each
    rank takes its rows' and its vocab slice's max, exp-sum and target logit,
    and the vocab split's ranks add the sums up (the max, a shift only, is
    reduced with no gradient)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if isinstance(p, Shard) and p.dim == logits.ndim - 1]
    row_pl = tuple(p if isinstance(p, Shard) and p.dim < logits.ndim - 1 else Replicate()
                   for p in logits.placements)
    lg_pl = tuple(Shard(logits.ndim - 1) if i in vocab_dims else p
                  for i, p in enumerate(row_pl))
    coord = mesh.get_coordinate()
    part = 0
    for i in vocab_dims:
        part = part * mesh.size(i) + coord[i]
    groups = [mesh.get_group(i) for i in vocab_dims]

    def nll(lg, tgt):
        import torch.distributed as dist
        m = lg.detach().amax(dim=-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        s = torch.exp(lg - m).sum(-1)
        rows = tgt.long() - part * lg.shape[-1]
        inside = (rows >= 0) & (rows < lg.shape[-1])
        t = lg.gather(-1, rows.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0] * inside
        for g in groups:
            s, t = all_reduce(s, "sum", g), all_reduce(t, "sum", g)
        return torch.log(s) + m[..., 0] - t

    logits = logits.redistribute(mesh, lg_pl) if tuple(logits.placements) != lg_pl else logits
    targets = as_replicated(targets, mesh)
    targets = targets.redistribute(mesh, row_pl) if tuple(targets.placements) != row_pl else targets
    return local_map(nll, out_placements=list(row_pl), in_placements=(lg_pl, row_pl),
                     device_mesh=mesh)(logits, targets)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL of fp32 logits (B, S, V) at integer targets (B, S);
    with ``mask`` (B, S), 1.0 where counted, the masked sum over
    ``max(mask.sum(), 1)``."""
    if _split_on(logits, -1):
        nll = _vocab_parallel_nll(logits, targets)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
