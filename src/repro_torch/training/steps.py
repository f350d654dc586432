"""Step builders: the registered "functions" of serverless supercomputing.

Port of ``repro.training.steps``. ``build_train_step`` /
``build_prefill_step`` / ``build_decode_step`` return a ``BuiltStep``: the
callable, the in/out shardings (``NamedSharding`` trees resolved from the
logical axis specs on a mesh; ``None`` on one device), the donated
arguments, and the cell's stand-ins (``abstract_args``): meta tensors (meta
DTensors on a mesh), shapes and dtypes without storage, where the reference
has ``jax.ShapeDtypeStruct`` avals. ``launch/dryrun.py`` traces the callable
on them; the FaaS endpoint registers it.

The model holds its weights, so ``params`` is ``model.params`` (a step refuses
another tree): the train step writes the new compute-dtype weights into the
model's parameters in place, and the decode step writes the cache in place
(``Model.decode_step``'s contract), which the reference's
``donate_argnums=(2,)`` records.

With ``mesh=`` (a ``DeviceMesh``) the builder distributes the model's weights
onto it (``Model.distribute``) if they are not there yet, and the step runs
inside ``partition.use_mesh``: plain batch, cache and state tensors (the same
value on every rank) are placed by their shardings, the gradients are
redistributed to the weights' placements right after the backward (the
reference's ``with_sharding_constraint`` on the gradients, with
microbatches too), the metrics come back replicated as plain tensors, and
the outputs are DTensors placed by ``out_shardings`` (``full_tensor()``
gathers one).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models import layers
from ..models.model import Model
from ..sharding import partition
from ..sharding.local import as_replicated
from . import optimizer as opt

METRICS = ("ce", "aux", "loss", "grad_norm", "lr")


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
    in_shardings: Any          # NamedSharding trees on a mesh, None on one device
    out_shardings: Any         # NamedSharding trees on a mesh, None on one device
    donate_argnums: tuple      # the arguments the step updates in place
    abstract_args: tuple       # meta stand-ins of fn's arguments for a shape, else ()


def _on_meta(model: Model, mesh=None) -> Model:
    """The model itself when it lies on the meta device, else a meta twin;
    on ``mesh`` (distributed there if it is not yet)."""
    if model.device.type != "meta":
        model = Model(model.cfg, device="meta", kernel_impl="ref")
    if mesh is not None and model.mesh is None:
        model.distribute(mesh)
    return model


def _meta_params(model: Model, mesh=None) -> dict:
    """Stand-ins of the weights: a meta model's own (its steps take them)."""
    return _on_meta(model, mesh).params


def _shardings(logical_tree, aval_tree, mesh, rules=None):
    return partition.named_shardings(logical_tree, aval_tree, mesh, rules=rules)


def _place(t, sh: "partition.NamedSharding"):
    """A tensor (the same full value on every rank) or a DTensor, placed by
    ``sh``: a plain tensor is sliced locally, a DTensor redistributed."""
    if t is None or sh is None:
        return t
    d = as_replicated(t, sh.mesh)
    pl = sh.placements
    return d if tuple(d.placements) == pl else d.redistribute(sh.mesh, pl)


def _place_tree(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    return _place(tree, shardings)


def _meta_tree(tree, shardings):
    """Meta DTensors of ``tree``'s shapes and dtypes placed by ``shardings``."""
    if isinstance(tree, dict):
        return {k: _meta_tree(v, shardings[k]) for k, v in tree.items()}
    meta = torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return _place(meta, shardings)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the vocab; on a mesh the vocab split is gathered first
    (each row's logits whole on its devices), the batch split kept."""
    logits = partition.shard_act(logits, "batch", None)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _full(t):
    return t.full_tensor() if partition.is_dtensor(t) else t


def _mesh_setup(model: Model, mesh):
    """(rules, the weights' shardings) of a model distributed onto ``mesh``."""
    rules = partition.rules_for(model.cfg)
    if model.mesh is None:
        model.distribute(mesh, rules)
    elif model.mesh is not mesh:
        raise ValueError("the model's weights are distributed on another mesh")
    return rules, _shardings(model.specs(), model.abstract_params(), mesh, rules)


def _batch_shardings(cfg: ModelConfig, batch, mesh, rules):
    """Shardings of a batch's tensors by ``batch_logical_specs``."""
    logical = {"tokens": ("batch", "seq"), "patches": ("batch", "seq", None),
               "frames": ("batch", "seq", None), "loss_mask": ("batch", "seq"),
               "token": ("batch", None)}
    return _shardings({k: logical[k] for k in batch}, batch, mesh, rules)


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
    ``lr``, each a 0-d tensor on the model's device. On ``mesh`` the state
    may be plain (``opt.init_state`` of the full weights) or placed."""
    cfg = model.cfg
    M = max(cfg.microbatches, 1)
    gdt = getattr(torch, ocfg.grad_dtype)
    rules = param_sh = None
    if mesh is not None:
        rules, param_sh = _mesh_setup(model, mesh)
        grad_pl = [s.placements for s in opt.tree_leaves(param_sh)]

    def constrain(grads: list) -> list:
        """The gradients on the weights' placements (the reference's
        constraint, steps.py:95-99), right after the backward."""
        if mesh is None:
            return grads
        return [g if tuple(g.placements) == pl else g.redistribute(mesh, pl)
                for g, pl in zip(grads, grad_pl)]

    def one(leaves, mb) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
        loss, metrics = model.loss(mb)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                constrain([g.to(gdt) for g in grads]))

    def _grads(params, batch):
        leaves = opt.tree_leaves(params)
        if M == 1:
            loss, metrics, g = one(leaves, batch)
            return loss, metrics, opt.tree_unflatten(params, g)
        split = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:]) for k, v in batch.items()}
        gacc = [torch.zeros_like(p, dtype=gdt) for p in leaves]
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
        if mesh is None:
            return _update(params, opt_state, batch)
        with partition.use_mesh(mesh, rules):
            batch = _place_tree(batch, _batch_shardings(cfg, batch, mesh, rules))
            opt_state = _place_tree(opt_state, state_sh)
            params, opt_state, metrics = _update(params, opt_state, batch)
            return params, opt_state, {k: _full(v) for k, v in metrics.items()}

    def _update(params, opt_state, batch):
        _, metrics, grads = _grads(params, batch)
        param_dtypes = opt.tree_map(lambda p: p.dtype, params)
        new_params, opt_state = opt.apply_updates(grads, opt_state, ocfg, param_dtypes)
        with torch.no_grad():
            opt.tree_map(lambda p, w: p.copy_(w), params, new_params)
        metrics = dict(metrics, grad_norm=opt.global_norm(grads),
                       lr=opt.schedule(ocfg, opt_state["step"]))
        return params, opt_state, metrics

    in_sh = out_sh = state_sh = None
    if mesh is not None:
        p_specs = model.specs()
        s_avals = opt.init_state(model.abstract_params(), ocfg)
        state_sh = _shardings(opt.state_specs(p_specs), s_avals, mesh, rules)
        b_sh = None
        if shape is not None:
            b_sh = _shardings(batch_logical_specs(cfg, shape), batch_avals(cfg, shape),
                              mesh, rules)
        in_sh = (param_sh, state_sh, b_sh)
        replicated = partition.NamedSharding(mesh, partition.P())
        out_sh = (param_sh, state_sh, {k: replicated for k in METRICS})
    args = ()
    if shape is not None:
        p_avals = _meta_params(model, mesh)
        s_avals = opt.init_state(p_avals, ocfg)
        b_avals = batch_avals(cfg, shape)
        if mesh is not None:
            s_avals, b_avals = _meta_tree(s_avals, state_sh), _meta_tree(b_avals, in_sh[2])
        args = (p_avals, s_avals, b_avals)
    return BuiltStep(train_step, in_sh, out_sh, (0, 1), args)


def _cache_shardings(model: Model, cache, mesh, rules=None):
    """Shardings of a cache tree (tensors or meta stand-ins) by the model's
    ``cache_specs`` under ``mesh``."""
    rules = rules or partition.rules_for(model.cfg)
    with partition.use_mesh(mesh, rules):
        specs = model.cache_specs(0, 0)
    return _shardings(specs, cache, mesh, rules)


def place_cache(model: Model, cache, mesh):
    """A full ``init_cache`` tree (the same on every rank) placed on ``mesh``
    by its shardings: the cache a sharded decode step writes in place."""
    return _place_tree(cache, _cache_shardings(model, cache, mesh))


def build_prefill_step(model: Model, mesh=None, shape: Optional[ShapeSpec] = None) -> BuiltStep:
    """``fn(params, batch) -> (next_token (B,) int32, last logits (B, V), cache)``."""
    cfg = model.cfg
    rules = None
    if mesh is not None:
        rules, param_sh = _mesh_setup(model, mesh)

    @torch.no_grad()
    def prefill_step(params, batch):
        _check_params(model, params)
        if mesh is None:
            return _prefill(batch)
        with partition.use_mesh(mesh, rules):
            batch = _place_tree(batch, _batch_shardings(cfg, batch, mesh, rules))
            return _prefill(batch)

    def _prefill(batch):
        logits, cache = model.prefill(batch)
        return _greedy(logits), logits, cache

    in_sh = out_sh = None
    if mesh is not None and shape is not None:
        B = shape.global_batch
        b_sh = _shardings(batch_logical_specs(cfg, shape), batch_avals(cfg, shape), mesh, rules)
        in_sh = (param_sh, b_sh)
        tok = _shardings({"t": ("batch",)}, {"t": torch.empty((B,), device="meta")},
                         mesh, rules)["t"]
        logits = _shardings({"l": ("batch", "vocab")},
                            {"l": torch.empty((B, cfg.vocab), device="meta")}, mesh, rules)["l"]
        cache = _on_meta(model).init_cache(B, shape.seq_len)
        out_sh = (tok, logits, _cache_shardings(model, cache, mesh, rules))
    args = ()
    if shape is not None:
        b_avals = batch_avals(cfg, shape)
        if mesh is not None:
            b_avals = _meta_tree(b_avals, in_sh[1])
        args = (_meta_params(model, mesh), b_avals)
    return BuiltStep(prefill_step, in_sh, out_sh, (), args)


def build_decode_step(model: Model, mesh=None, shape: Optional[ShapeSpec] = None) -> BuiltStep:
    """``fn(params, token (B, 1), cache, pos) -> (next_token (B, 1) int32,
    cache)``; the cache is written in place. On ``mesh`` pass the cache placed
    by ``place_cache`` (its ``cache_specs`` under the mesh), which the step
    writes in place."""
    cfg = model.cfg
    rules = None
    if mesh is not None:
        rules, param_sh = _mesh_setup(model, mesh)

    @torch.no_grad()
    def decode_step(params, token, cache, pos):
        _check_params(model, params)
        if mesh is None:
            return _decode(token, cache, pos)
        with partition.use_mesh(mesh, rules):
            token = _place(token, _batch_shardings(cfg, {"token": token}, mesh, rules)["token"])
            return _decode(token, cache, pos)

    def _decode(token, cache, pos):
        logits, cache = model.decode_step(token, cache, pos)
        return _greedy(logits)[:, None], cache

    in_sh = out_sh = None
    if mesh is not None and shape is not None:
        B = shape.global_batch
        tok = _shardings({"token": ("batch", None)}, batch_avals(cfg, shape), mesh, rules)["token"]
        cache_sh = _cache_shardings(model, _on_meta(model).init_cache(B, shape.seq_len),
                                    mesh, rules)
        # the reference resolves the decode step's weights by the default rules
        in_sh = (_shardings(model.specs(), model.abstract_params(), mesh), tok, cache_sh,
                 partition.NamedSharding(mesh, partition.P()))
        out_sh = (tok, cache_sh)
    args = ()
    if shape is not None:
        cache = _on_meta(model).init_cache(shape.global_batch, shape.seq_len)
        token = batch_avals(cfg, shape)["token"]
        if mesh is not None:
            cache, token = _meta_tree(cache, in_sh[2]), _meta_tree(token, in_sh[1])
        args = (_meta_params(model, mesh), token, cache,
                torch.empty((), dtype=torch.int32, device="meta"))
    return BuiltStep(decode_step, in_sh, out_sh, (2,), args)
