"""AdamW with fp32 master weights + moments, global-norm clip, warmup+cosine
schedule, and bf16 gradients ("compression"); an optional stochastic-rounding
cast guards the master update.

Port of ``repro.training.optimizer``. On a mesh the weights are DTensors and
the state follows them: the masters and moments take each weight's
placements (``state_specs`` gives their logical names, as the reference's
does). A tree is a nested dict of tensors, such as ``Model.params``; its leaves are
taken in the reference's flatten order (dict keys sorted at every level).
``apply_updates`` updates the state's tensors in place, a PyTorch optimizer's
way (the reference returns new buffers and donates the old ones to XLA), and
returns the new compute-dtype weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_dtype: str = "bfloat16"       # reduction precision ("compression")
    moments_dtype: str = "float32"     # bf16 moments halve optimizer-state memory
    stochastic_rounding: bool = False  # SR when casting update back to bf16


# ----------------------------------------------------------------- trees
def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in the reference's flatten order: dict keys sorted."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure, into a new tree."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return build(like)


# ------------------------------------------------------------- schedule
def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``;
    ``step`` an int or a tensor, the result an fp32 tensor on its device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    floor = cfg.min_lr_ratio
    return cfg.lr * warm * (floor + (1 - floor) * cos)


def init_state(params, cfg: Optional[OptimizerConfig] = None) -> Dict[str, Any]:
    """fp32 master copies of the weights (fresh buffers, also for fp32
    weights), zero moments in ``cfg.moments_dtype``, and an int32 step 0."""
    mdt = getattr(torch, cfg.moments_dtype) if cfg is not None else torch.float32
    device = tree_leaves(params)[0].device
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def state_specs(param_specs) -> Dict[str, Any]:
    """Optimizer-state logical specs mirror the params'."""
    return {"master": tree_map(tuple, param_specs), "mu": tree_map(tuple, param_specs),
            "nu": tree_map(tuple, param_specs), "step": ()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' fp32 squares, summed in flatten order."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def _sr_cast(x: torch.Tensor, dtype: torch.dtype, generator: torch.Generator) -> torch.Tensor:
    """Stochastic rounding of fp32 ``x`` to bfloat16: each element rounds to
    one of the two bf16 values around it, away from zero with probability
    its distance from the nearer-to-zero one over their spacing, so the
    expected result is x. Uniform draws come from ``generator``.

    A bf16 value is the top 16 bits of an fp32 one: clearing the low 16 bits
    rounds toward zero, adding 1 << 16 to that steps one bf16 value away from
    zero, and the low 16 bits over 2^16 are the fraction of the spacing (a
    binade is linear in its mantissa). The reference's ``_sr_cast`` rounds
    to nearest instead (its ``up`` rounds back to ``down``; ROADMAP F11)."""
    if x.dtype == dtype:
        return x
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic rounding casts to bfloat16, not {dtype}")
    bits = x.float().contiguous().view(torch.int32)
    frac = (bits & 0xFFFF).float() / 65536.0
    u = torch.rand(x.shape, generator=generator, device=x.device)
    rounded = (bits & ~0xFFFF) + ((u < frac).to(torch.int32) << 16)
    return (rounded >> 16).to(torch.int16).view(torch.bfloat16)


@torch.no_grad()
def apply_updates(
    grads,
    state: Dict[str, Any],
    cfg: OptimizerConfig,
    param_dtypes,
    sr_generator: Optional[torch.Generator] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step from ``grads`` (a tree like the params). Updates
    ``state`` in place (master, moments, step) and returns (new compute-dtype
    params, the state). ``param_dtypes`` is a tree of the params' dtypes;
    with ``cfg.stochastic_rounding`` and an ``sr_generator`` the cast back is
    stochastic."""
    step = state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    # fp32 cast + clip PER LEAF: a tree-wide cast would hold a full fp32
    # gradient copy at once
    for g, m, v, w in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"]), tree_leaves(state["master"])):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / b1c
        vhat = v32 / b2c
        w.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * w))
        m.copy_(m32)
        v.copy_(v32)
    state["step"] = step

    masters = tree_leaves(state["master"])
    dtypes = tree_leaves(param_dtypes)
    if cfg.stochastic_rounding and sr_generator is not None:
        new_params = [_sr_cast(w, dt, sr_generator) for w, dt in zip(masters, dtypes)]
    else:
        new_params = [w.to(dt, copy=True) for w, dt in zip(masters, dtypes)]
    return tree_unflatten(grads, new_params), state
