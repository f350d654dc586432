"""Mixture-of-Experts FFN with sort-based capacity dispatch (one device).

Port of the one-device ("global") path of ``repro.models.moe``: route each
token to its top-k experts, sort the assignments by expert and keep the first
C of each (the capacity drop), gather the kept tokens into an (E, C, D) table,
run the experts' SwiGLUs as batched products, and combine each token's
weighted outputs; plus the sigmoid-gated shared expert and the Switch
load-balance aux loss.

On a mesh there are two paths, as in the reference. The global path keeps its
shapes and constrains the (E, C, D) dispatch, the expert activations and the
output by logical names (``partition.shard_act``); the routing table, the
dispatch gather and the combine have no DTensor sharding rule, so they run
replicated (``sharding.local.replicated_call``), where XLA partitions them.
The expert-parallel path (``moe_impl == "local"``, ``_moe_ffn_shard_map``)
is the reference's ``shard_map``: each rank takes its `model` coordinate's
slice of experts and its data shard of tokens, routes them to its local
experts with no dispatch collective (``_local_expert_ffn``), and the partial
outputs meet in one all-reduce of (T_loc, D) over `model`; ``aux`` is the
mean over the batch axes of the per-shard aux losses.

Nothing here syncs with the host or has a shape that depends on the data:
the capacity C comes from the static token count, the ranks from
``searchsorted`` (not ``bincount``, which reads a maximum on the host), so the
engine's decode step captures as one CUDA graph.

The combines are deterministic. The reference's ``"scatter"`` combine is a
scatter-add into token rows; on CUDA an ``index_add_`` adds with atomics in an
order that varies from run to run. Here each token gathers its k slots and
adds their contributions (``ye * w``, each rounded to the activation dtype) in
increasing slot order: the order in which the reference's CPU scatter applies
its updates, so the sums round alike in bf16.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, MoEConfig
from ..sharding import partition
from ..sharding.local import all_reduce, replicated_call, scale_grad, shard_map
from . import layers


def init_moe(gen, cfg: ModelConfig, device, lead: Tuple[int, ...] = ()):
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
    dt = layers.dtype_of(cfg)
    p = {
        # the router stays float32 whatever the model dtype (repro/models/moe.py:32)
        "router": torch.randn((*lead, D, E), generator=gen, dtype=torch.float32,
                              device=device).mul_(D ** -0.5),
        "wi": layers.dense_init(gen, (*lead, E, D, Fe), D, dt, device),
        "wg": layers.dense_init(gen, (*lead, E, D, Fe), D, dt, device),
        "wo": layers.dense_init(gen, (*lead, E, Fe, D), Fe, dt, device),
    }
    if m.n_shared_experts:
        p["shared"] = layers.init_swiglu(gen, D, m.d_ff_shared, dt, device, lead)
        p["shared_gate"] = layers.dense_init(gen, (*lead, D, 1), D, dt, device)
    return p


def moe_specs(cfg: ModelConfig) -> dict:
    """Logical axes of ``init_moe``'s tree."""
    s = {"router": ("embed", None), "wi": ("experts", "embed", "mlp"),
         "wg": ("experts", "embed", "mlp"), "wo": ("experts", "mlp", "embed")}
    if cfg.moe.n_shared_experts:
        s["shared"] = layers.swiglu_specs()
        s["shared_gate"] = ("embed", None)
    return s


def _capacity(n_tokens: int, m: MoEConfig) -> int:
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    c = max(c, 4)
    return int(-(-c // 4) * 4)  # round up to a multiple of 4


@contextlib.contextmanager
def _full_fp32_products():
    """float32 products in full float32 (no TF32), whatever the caller set:
    TF32 rounding of the router product would flip routes. The setting is
    process-wide, so it is changed (and put back) only when the caller
    allowed TF32; the port makes its device calls from one thread at a time."""
    before = torch.get_float32_matmul_precision()
    if before == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def route(x2d: torch.Tensor, router_w: torch.Tensor, m: MoEConfig):
    """Returns (top-k weights (T, k) fp32, top-k expert ids (T, k) int64,
    router probs for the aux loss (T, E))."""
    with _full_fp32_products():
        logits = x2d.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, m.top_k, dim=-1)
    if m.norm_topk_prob:
        topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return topw, topi, probs


def build_dispatch(topi: torch.Tensor, topw: torch.Tensor, n_tokens: int, m: MoEConfig):
    """Sort assignments by expert; keep the first C per expert (capacity
    drop). Returns (gather_idx (E*C,) in [0, T] where T = empty, combine_w
    (E*C,) fp32, C, assign_slot (T, k) in [0, E*C]: the slot each (token,
    choice) landed in, E*C when dropped). Indices are int64."""
    E, k = m.n_experts, m.top_k
    C = _capacity(n_tokens, m)
    device = topi.device
    flat_e = topi.reshape(-1).long()                        # (T*k,)
    order = torch.argsort(flat_e, stable=True)              # groups by expert, as jnp.argsort
    sorted_e = flat_e[order]
    # rank of each assignment within its expert group
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(sorted_e.shape[0], device=device) - group_start
    slot = torch.where(ranks < C, sorted_e * C + ranks, E * C)  # overflow -> the sentinel slot
    token_of = order // k
    w_of = topw.reshape(-1)[order].float()
    # dropped assignments all write the sentinel entry E*C, which is sliced off
    gather_idx = torch.full((E * C + 1,), n_tokens, dtype=torch.long,
                            device=device).scatter_(0, slot, token_of)[: E * C]
    combine_w = torch.zeros((E * C + 1,), dtype=torch.float32,
                            device=device).scatter_(0, slot, w_of)[: E * C]
    # invert the permutation: the slot of each original (token, choice)
    assign_slot = torch.empty_like(slot).scatter_(0, order, slot).reshape(n_tokens, k)
    return gather_idx, combine_w, C, assign_slot


def load_balance_loss(probs: torch.Tensor, topi: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    """Switch-style aux loss: E * sum(mean router prob * fraction routed (top-1))."""
    T = topi.shape[0]
    me = probs.mean(dim=0)
    counts = torch.zeros(m.n_experts, dtype=torch.float32, device=probs.device)
    # integer counts: exact in any order of addition
    counts.scatter_add_(0, topi[:, 0].long(), torch.ones(T, dtype=torch.float32,
                                                         device=probs.device))
    return m.n_experts * torch.sum(me * (counts / T))


def _combine_in_slot_order(ye_flat: torch.Tensor, w_flat: torch.Tensor,
                           assign_slot: torch.Tensor) -> torch.Tensor:
    """y[t] = sum over t's kept slots s, in increasing s, of ye[s] * w[s],
    each product rounded to ye's dtype before its add. Dropped choices point
    at the zero row E*C and add nothing."""
    zero = ye_flat.new_zeros((1, ye_flat.shape[1]))
    ye_pad = torch.cat([ye_flat, zero])
    w_pad = torch.cat([w_flat.to(ye_flat.dtype), w_flat.new_zeros(1).to(ye_flat.dtype)])
    slots, _ = torch.sort(assign_slot, dim=1)
    contrib = ye_pad[slots] * w_pad[slots][..., None]       # (T, k, D)
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def _local_expert_ffn(x2d: torch.Tensor, p, m: MoEConfig, e_base: int, n_local: int):
    """Dispatch + compute + combine for the ``n_local`` experts from
    ``e_base``, on one rank's tokens x2d (T_loc, D), no collective: every
    other expert is the overflow group, dropped. The capacity is the local
    token count's. Returns (partial y (T_loc, D), this shard's aux loss)."""
    T, D = x2d.shape
    topw, topi, probs = route(x2d, p["router"], m)
    C = _capacity(T, m)
    local = topi.long() - e_base                             # (T, k); valid in [0, n_local)
    valid = (local >= 0) & (local < n_local)
    flat_e = torch.where(valid, local, n_local).reshape(-1)  # invalid -> overflow group
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(sorted_e.shape[0], device=x2d.device) - group_start
    keep = (ranks < C) & (sorted_e < n_local)
    slot = torch.where(keep, sorted_e * C + ranks, n_local * C)
    token_of = order // m.top_k
    w_of = topw.reshape(-1)[order].float()
    gather_idx = torch.full((n_local * C + 1,), T, dtype=torch.long,
                            device=x2d.device).scatter_(0, slot, token_of)[: n_local * C]
    combine_w = torch.zeros((n_local * C + 1,), dtype=torch.float32,
                            device=x2d.device).scatter_(0, slot, w_of)[: n_local * C]
    x_pad = torch.cat([x2d, x2d.new_zeros((1, D))])
    ye = _experts(x_pad[gather_idx].reshape(n_local, C, D), p).reshape(n_local * C, D)
    # the combine's scatter-add, deterministic: each token's kept slots added
    # in increasing slot order (_combine_in_slot_order), the rest point at zero
    inv = torch.full((T * m.top_k,), n_local * C, dtype=torch.long, device=x2d.device)
    inv.scatter_(0, order, slot)
    y = _combine_in_slot_order(ye, combine_w, inv.reshape(T, m.top_k))
    return y, load_balance_loss(probs, topi, m)


def _experts(xe: torch.Tensor, p) -> torch.Tensor:
    """The experts' SwiGLUs, batched over experts: (E, C, D) -> (E, C, D);
    silu in fp32, cast back."""
    h = torch.bmm(xe, p["wi"])
    g = torch.bmm(xe, p["wg"])
    h = h * F.silu(g.float()).to(h.dtype)
    h = partition.shard_act(h, "experts", "capacity", "mlp")
    return torch.bmm(h, p["wo"])


def _moe_ffn_shard_map(x: torch.Tensor, p, cfg: ModelConfig):
    """Expert parallelism, the reference's ``shard_map`` body: x is sharded
    over the batch axes and replicated over `model`, the experts over
    `model`. Each rank runs ``_local_expert_ffn`` for its experts on its
    tokens; one all-reduce of (T_loc, D) over `model` sums the partial
    outputs, and ``aux`` is averaged over the batch axes' groups."""
    mesh = partition.current().mesh
    axes = partition.mesh_axes(mesh)
    m = cfg.moe
    n_local = m.n_experts // axes["model"]
    batch_axes = [a for a in ("pod", "data") if a in axes]
    D = x.shape[-1]

    def body(xb, router, wi, wg, wo):
        rank = mesh.get_local_rank("model")
        pp = {"router": router, "wi": wi, "wg": wg, "wo": wo}
        y, aux = _local_expert_ffn(xb.reshape(-1, D), pp, m, rank * n_local, n_local)
        y = all_reduce(y, "sum", mesh.get_group("model"))
        # every model rank computes the same aux from the same tokens
        aux = scale_grad(aux, 1.0 / axes["model"])
        for a in batch_axes:
            aux = all_reduce(aux, "avg", mesh.get_group(a))
        return y.reshape(xb.shape), aux

    P = partition.PartitionSpec
    xs = P(tuple(batch_axes)) if batch_axes else P()
    return shard_map(body, mesh, in_specs=(xs, P(), P("model"), P("model"), P("model")),
                     out_specs=(xs, P()))(x, p["router"], p["wi"], p["wg"], p["wo"])


def _uses_shard_map(cfg: ModelConfig) -> bool:
    """The reference's condition (repro/models/moe.py:199-205)."""
    ctx = partition.current()
    if cfg.moe_impl != "local" or ctx is None or ctx.mesh is None:
        return False
    n_model = ctx.shape.get("model", 1)
    return n_model > 1 and cfg.moe.n_experts % n_model == 0


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux load-balance loss scalar fp32)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S

    if _uses_shard_map(cfg):
        y, aux = _moe_ffn_shard_map(x, p, cfg)
    else:
        x2d = x.reshape(T, D)
        topw, topi, probs = route(x2d, p["router"], m)
        gather_idx, combine_w, C, assign_slot = replicated_call(
            lambda i, w: build_dispatch(i, w, T, m), topi, topw)

        # dispatch: (E, C, D); the padded row T reads zeros
        xe = replicated_call(
            lambda a, idx: torch.cat([a, a.new_zeros((1, D))])[idx].reshape(m.n_experts, C, D),
            x2d, gather_idx)
        xe = partition.shard_act(xe, "experts", "capacity", "embed")
        ye = _experts(xe, p)                                  # (E, C, D)

        if cfg.moe_combine == "gather":
            # each token pulls its k expert outputs by slot id, weighted by topw
            def combine(ye, slots, w):
                ye_pad = torch.cat([ye.reshape(-1, D), ye.new_zeros((1, D))])
                picked = ye_pad[slots.reshape(-1)].reshape(T, m.top_k, D)
                return torch.einsum("tkd,tk->td", picked, w.to(picked.dtype))
            y = replicated_call(combine, ye, assign_slot, topw)
        else:
            y = replicated_call(lambda ye, w, s: _combine_in_slot_order(ye.reshape(-1, D), w, s),
                                ye, combine_w, assign_slot)
        y = partition.shard_act(y.reshape(B, S, D), "batch", "seq", None)
        aux = replicated_call(lambda pr, ti: load_balance_loss(pr, ti, m), probs, topi)

    if m.n_shared_experts:
        gate = torch.sigmoid((x @ p["shared_gate"]).float()).to(x.dtype)
        y = y + gate * layers.swiglu(x, p["shared"])
    return y, aux
