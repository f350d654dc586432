"""Step builders: the registered "functions" of serverless supercomputing.

Port of ``repro.training.steps`` on one device. ``build_train_step`` /
``build_prefill_step`` / ``build_decode_step`` return a ``BuiltStep``: the
callable, the in/out shardings (``None``: one device has nothing to shard),
the donated arguments, and the cell's stand-ins (``abstract_args``): meta
tensors, shapes and dtypes without storage, where the reference has
``jax.ShapeDtypeStruct`` avals. ``launch/dryrun.py`` traces the callable on
them; the FaaS endpoint registers it.

The model holds its weights, so ``params`` is ``model.params`` (a step refuses
another tree): the train step writes the new compute-dtype weights into the
model's parameters in place, and the decode step writes the cache in place
(``Model.decode_step``'s contract), which the reference's
``donate_argnums=(2,)`` records. A mesh raises: sharding is the next slice
(ROADMAP A5b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models import layers
from ..models.model import Model
from . import optimizer as opt

_NO_MESH = ("a mesh (sharded steps) is not ported yet: sharding over a DeviceMesh is "
            "the next slice (ROADMAP A5b)")


def batch_avals(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of this cell: empty tensors on
    ``device`` (meta: no allocation, the dry run's contract)."""
    B, S = shape.global_batch, shape.seq_len
    dt = layers.dtype_of(cfg)

    def f(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            return {"tokens": f((B, S - cfg.n_patches), torch.int32),
                    "patches": f((B, cfg.n_patches, cfg.d_model), dt)}
        if cfg.family == "encdec":
            return {"tokens": f((B, S), torch.int32),
                    "frames": f((B, cfg.enc_seq, cfg.d_model), dt)}
        return {"tokens": f((B, S), torch.int32)}
    if shape.kind == "decode":
        return {"token": f((B, 1), torch.int32)}
    raise ValueError(shape.kind)


def batch_logical_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, tuple]:
    if shape.kind in ("train", "prefill"):
        out = {"tokens": ("batch", "seq")}
        if cfg.family == "vlm":
            out["patches"] = ("batch", "seq", None)
        if cfg.family == "encdec":
            out["frames"] = ("batch", "seq", None)
        return out
    return {"token": ("batch", None)}


@dataclass
class BuiltStep:
    fn: Any                    # callable(params/state..., batch...) -> outputs
    in_shardings: Any          # None on one device
    out_shardings: Any         # None on one device
    donate_argnums: tuple      # the arguments the step updates in place
    abstract_args: tuple       # meta stand-ins of fn's arguments for a shape, else ()


def _on_meta(model: Model) -> Model:
    """The model itself when it lies on the meta device, else a meta twin."""
    if model.device.type == "meta":
        return model
    return Model(model.cfg, device="meta", kernel_impl="ref")


def _meta_params(model: Model) -> dict:
    """Stand-ins of the weights: a meta model's own (its steps take them)."""
    return _on_meta(model).params


def _check_params(model: Model, params) -> None:
    if params["embed"]["tok"] is not model.params["embed"]["tok"]:
        raise ValueError("the step computes with the weights the model holds: pass "
                         "model.params")


def build_train_step(model: Model, ocfg: opt.OptimizerConfig, mesh=None,
                     shape: Optional[ShapeSpec] = None) -> BuiltStep:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)`` for
    ``params = model.params`` (a tree of the model's parameters, which must
    require grad). The gradients of ``model.loss`` are cast to
    ``ocfg.grad_dtype``; with ``cfg.microbatches`` M > 1 the batch is split
    into M along axis 0 and the gradients and metrics averaged, as the
    reference does. Metrics: ``loss``, ``ce``, ``aux``, ``grad_norm``,
    ``lr``, each a 0-d tensor on the model's device."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    M = max(model.cfg.microbatches, 1)
    gdt = getattr(torch, ocfg.grad_dtype)

    def one(leaves, mb) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
        loss, metrics = model.loss(mb)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                [g.to(gdt) for g in grads])

    def _grads(params, batch):
        leaves = opt.tree_leaves(params)
        if M == 1:
            loss, metrics, g = one(leaves, batch)
            return loss, metrics, opt.tree_unflatten(params, g)
        split = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:]) for k, v in batch.items()}
        gacc = [torch.zeros(p.shape, dtype=gdt, device=p.device) for p in leaves]
        lsum = cesum = auxsum = 0.0
        for i in range(M):
            loss, metrics, g = one(leaves, {k: v[i] for k, v in split.items()})
            gacc = [a + b for a, b in zip(gacc, g)]
            lsum, cesum, auxsum = lsum + loss, cesum + metrics["ce"], auxsum + metrics["aux"]
        g = [(x / M).to(gdt) for x in gacc]
        metrics = {"loss": lsum / M, "ce": cesum / M, "aux": auxsum / M}
        return lsum / M, metrics, opt.tree_unflatten(params, g)

    def train_step(params, opt_state, batch):
        _check_params(model, params)
        _, metrics, grads = _grads(params, batch)
        param_dtypes = opt.tree_map(lambda p: p.dtype, params)
        new_params, opt_state = opt.apply_updates(grads, opt_state, ocfg, param_dtypes)
        with torch.no_grad():
            opt.tree_map(lambda p, w: p.copy_(w), params, new_params)
        metrics = dict(metrics, grad_norm=opt.global_norm(grads),
                       lr=opt.schedule(ocfg, opt_state["step"]))
        return params, opt_state, metrics

    args = ()
    if shape is not None:
        p_avals = _meta_params(model)
        args = (p_avals, opt.init_state(p_avals, ocfg), batch_avals(model.cfg, shape))
    return BuiltStep(train_step, None, None, (0, 1), args)


def build_prefill_step(model: Model, mesh=None, shape: Optional[ShapeSpec] = None) -> BuiltStep:
    """``fn(params, batch) -> (next_token (B,) int32, last logits (B, V), cache)``."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)

    @torch.no_grad()
    def prefill_step(params, batch):
        _check_params(model, params)
        logits, cache = model.prefill(batch)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    args = () if shape is None else (_meta_params(model), batch_avals(model.cfg, shape))
    return BuiltStep(prefill_step, None, None, (), args)


def build_decode_step(model: Model, mesh=None, shape: Optional[ShapeSpec] = None) -> BuiltStep:
    """``fn(params, token (B, 1), cache, pos) -> (next_token (B, 1) int32,
    cache)``; the cache is written in place."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)

    @torch.no_grad()
    def decode_step(params, token, cache, pos):
        _check_params(model, params)
        logits, cache = model.decode_step(token, cache, pos)
        next_token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return next_token, cache

    args = ()
    if shape is not None:
        cache = _on_meta(model).init_cache(shape.global_batch, shape.seq_len)
        args = (_meta_params(model), batch_avals(model.cfg, shape)["token"], cache,
                torch.empty((), dtype=torch.int32, device="meta"))
    return BuiltStep(decode_step, None, None, (2,), args)
