"""Step builders: the registered "functions" of serverless supercomputing.

Port of ``repro.training.steps.build_train_step`` on one device: the step is
a plain callable (no shardings to resolve, nothing to jit), and the model
holds its weights, so the step writes the new compute-dtype weights into the
model's parameters in place. ``build_prefill_step`` and ``build_decode_step``
are not ported yet: the serving engine calls ``Model.prefill`` and
``Model.decode_step`` directly.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models.model import Model
from . import optimizer as opt


def build_train_step(model: Model, ocfg: opt.OptimizerConfig, mesh=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
    for ``params = model.params`` (a tree of the model's parameters, which
    must require grad). The gradients of ``model.loss`` are cast to
    ``ocfg.grad_dtype``; with ``cfg.microbatches`` M > 1 the batch is split
    into M along axis 0 and the gradients and metrics averaged, as the
    reference does. Metrics: ``loss``, ``ce``, ``aux``, ``grad_norm``,
    ``lr``, each a 0-d tensor on the model's device."""
    if mesh is not None:
        raise NotImplementedError("a mesh (sharded training) is not ported yet (ROADMAP A5)")
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
        _, metrics, grads = _grads(params, batch)
        param_dtypes = opt.tree_map(lambda p: p.dtype, params)
        new_params, opt_state = opt.apply_updates(grads, opt_state, ocfg, param_dtypes)
        with torch.no_grad():
            opt.tree_map(lambda p, w: p.copy_(w), params, new_params)
        metrics = dict(metrics, grad_norm=opt.global_norm(grads),
                       lr=opt.schedule(ocfg, opt_state["step"]))
        return params, opt_state, metrics

    return train_step
