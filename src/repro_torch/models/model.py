"""Model assembly for the dense and SSM families: embedding + layer stack + head.

Port of ``repro.models.model.Model``. The model is an ``nn.Module`` whose
``state_dict`` keys are the JAX parameter pytree paths joined by ``.``, with
layers stacked on axis 0 (``layers.attn.wq`` is ``(L, D, H, hd)``), so the
JAX ``Model.init`` weights load through ``repro_torch.params`` unchanged. A
Python loop over the stacked layer axis replaces ``lax.scan``.

API (the JAX one without the ``params`` argument, which the module holds):
    init(generator)                      -> self (weights drawn in place)
    forward(batch)                       -> (hidden_states, aux_loss)
    prefill(batch)                       -> (last_logits (B, V), cache)
    decode_step(token, cache, pos)       -> (logits (B, V), cache updated in place)
    init_cache(batch, cache_len)         -> zero cache, stacked over layers:
        dense {"k", "v"}: (L, B, S, KV, hd) in the model dtype;
        ssm   {"conv": (L, B, K-1, Cd) in the model dtype, "ssm": (L, B, H, P, N) f32}
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import blocks, layers, mamba2

PORTED_FAMILIES = ("dense", "ssm")


def _as_module(tree: dict, module: nn.Module) -> nn.Module:
    for name, v in tree.items():
        if isinstance(v, dict):
            module.add_module(name, _as_module(v, nn.Module()))
        else:
            module.register_parameter(name, nn.Parameter(v, requires_grad=False))
    return module


def _as_tree(module: nn.Module) -> dict:
    tree = {name: p for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        tree[name] = _as_tree(child)
    return tree


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class Model(nn.Module):
    """``device`` defaults to the card; ``kernel_impl`` ("auto" | "kernel" |
    "ref") picks the implementation of every kernel the model reaches
    (attention or SSD scan; ``kernels.use_ref``)."""

    def __init__(self, cfg: ModelConfig, device="cuda", kernel_impl: str = "auto"):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet; ported: {PORTED_FAMILIES}"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        self.kernel_impl = kernel_impl
        shapes = self._draw(None, torch.device("meta"))
        empty = _map(shapes, lambda t: torch.empty_like(t, device=self.device))
        _as_module(empty, self)
        # per-layer views of the stacked weights, taken once: init() and
        # load_state_dict() write the parameters in place, so they stay valid
        self._layer_params: List[dict] = [
            _index(self.params["layers"], i) for i in range(cfg.n_layers)
        ]

    # ================================================================ init
    def _draw(self, gen, device) -> Dict:
        cfg = self.cfg
        dt = layers.dtype_of(cfg)
        tree: Dict = {"embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device)}
        if not cfg.tie_embeddings:
            tree["unembed"] = layers.init_unembed(gen, cfg.vocab, cfg.d_model, dt, device)
        tree["final_norm"] = layers.init_rmsnorm(cfg.d_model, device)
        init_layer = blocks.init_ssm_layer if cfg.family == "ssm" else blocks.init_decoder_layer
        tree["layers"] = init_layer(gen, cfg, device, lead=(cfg.n_layers,))
        return tree

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw random weights from `generator` (on the model's device)."""
        drawn = self._draw(generator, self.device)
        params = self.params
        _map2(params, drawn, lambda p, t: p.copy_(t))
        return self

    @property
    def params(self) -> dict:
        """The weights as the nested dict the compute functions take."""
        return _as_tree(self)

    # ============================================================ embedding
    def _embed_inputs(self, batch) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return layers.embed(tokens, self.params["embed"])

    # ============================================================== forward
    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (hidden_states, aux_loss)."""
        cfg = self.cfg
        h = self._embed_inputs(batch)
        positions = torch.arange(h.shape[1], device=self.device)
        for lp in self._layer_params:
            if cfg.family == "ssm":
                h, _ = blocks.ssm_layer(lp, h, cfg, impl=self.kernel_impl)
            else:
                h, _, _ = blocks.decoder_layer(lp, h, cfg, positions, self.kernel_impl)
        h = layers.rmsnorm(h, self.params["final_norm"], cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=self.device)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        p = self.params
        return layers.logits_from(h, p.get("unembed"), p["embed"])

    # ============================================================== prefill
    def prefill(self, batch) -> Tuple[torch.Tensor, dict]:
        """Run the full prompt, return (last-position logits (B, V), cache
        stacked over layers: {"k", "v"} (L, B, S, KV, hd) for dense, {"conv",
        "ssm"} for ssm)."""
        cfg = self.cfg
        h = self._embed_inputs(batch)
        positions = torch.arange(h.shape[1], device=self.device)
        per_layer = []
        for lp in self._layer_params:
            if cfg.family == "ssm":
                h, state = blocks.ssm_layer(lp, h, cfg, return_state=True, impl=self.kernel_impl)
            else:
                h, _, (k, v) = blocks.decoder_layer(lp, h, cfg, positions, self.kernel_impl)
                state = {"k": k, "v": v}
            per_layer.append(state)
        h = layers.rmsnorm(h, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(h[:, -1:])[:, 0]
        return logits, {name: torch.stack([s[name] for s in per_layer]) for name in per_layer[0]}

    # =============================================================== decode
    def decode_step(self, token, cache: dict, pos) -> Tuple[torch.Tensor, dict]:
        """token: (B, 1) int; pos: scalar or (B,) int write position (the ssm
        family ignores it, as in JAX). Updates `cache` in place and returns
        (logits (B, V), cache)."""
        cfg = self.cfg
        pos = torch.as_tensor(pos, device=self.device)
        h = layers.embed(torch.as_tensor(token, device=self.device), self.params["embed"])
        for i, lp in enumerate(self._layer_params):
            lc = {name: leaf[i] for name, leaf in cache.items()}
            if cfg.family == "ssm":
                h, _ = blocks.ssm_layer_decode(lp, h, lc, cfg)
            else:
                h, _ = blocks.decoder_layer_decode(lp, h, lc, pos, cfg, self.kernel_impl)
        h = layers.rmsnorm(h, self.params["final_norm"], cfg.norm_eps)
        return self._logits(h)[:, 0], cache

    # ================================================================ cache
    def init_cache(self, batch: int, cache_len: int) -> dict:
        """Zero decode cache stacked over layers (the JAX version also returns
        logical sharding specs, which one device does not need). The ssm
        state does not grow with the sequence: ``cache_len`` is not used."""
        lead = (self.cfg.n_layers,)
        if self.cfg.family == "ssm":
            return mamba2.init_decode_state(self.cfg, batch, self.device, lead=lead)
        return blocks.init_decoder_cache(self.cfg, batch, cache_len, self.device, lead=lead)


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _map2(a: dict, b: dict, fn) -> None:
    for k, v in a.items():
        if isinstance(v, dict):
            _map2(v, b[k], fn)
        else:
            fn(v, b[k])
