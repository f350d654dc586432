"""Model assembly for the dense, SSM and hybrid families: embedding + layer stack + head.

Port of ``repro.models.model.Model``. The model is an ``nn.Module`` whose
``state_dict`` keys are the JAX parameter pytree paths joined by ``.``, with
layers stacked on axis 0 (``layers.attn.wq`` is ``(L, D, H, hd)``), so the
JAX ``Model.init`` weights load through ``repro_torch.params`` unchanged. A
Python loop over the stacked layer axis replaces ``lax.scan``. The hybrid
family (zamba2) stacks its Mamba2 layers in G groups of PG
(``layers.mamba.wx`` is ``(G, PG, D, d_inner)``) and holds one unstacked
dense block, ``shared``, which runs before each group.

API (the JAX one without the ``params`` argument, which the module holds):
    init(generator)                      -> self (weights drawn in place)
    forward(batch)                       -> (hidden_states, aux_loss)
    prefill(batch)                       -> (last_logits (B, V), cache)
    decode_step(token, cache, pos)       -> (logits (B, V), cache updated in place)
    init_cache(batch, cache_len)         -> zero cache, stacked over layers:
        dense  {"k", "v"}: (L, B, S, KV, hd) in the model dtype;
        ssm    {"conv": (L, B, K-1, Cd) in the model dtype, "ssm": (L, B, H, P, N) f32};
        hybrid {"attn": {"k", "v"}: (G, B, S, KV, hd),
                "mamba": {"conv": (G, PG, B, K-1, Cd), "ssm": (G, PG, B, H, P, N)}}
    cache_batch_axes()                   -> the batch axis of each cache leaf
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import blocks, layers, mamba2

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


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


def _index(tree: dict, i) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _stack(per_layer: list) -> dict:
    """A list of same-shaped cache trees -> one tree stacked on a new axis 0."""
    return {name: _stack([t[name] for t in per_layer]) if isinstance(leaf, dict)
            else torch.stack([t[name] for t in per_layer])
            for name, leaf in per_layer[0].items()}


class Model(nn.Module):
    """``device`` defaults to the card; ``kernel_impl`` ("auto" | "kernel" |
    "ref") picks the implementation of every kernel the model reaches
    (attention, fused add + RMSNorm, SSD scan; ``kernels.use_ref``)."""

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
        # (the hybrid's: one list of PG per-layer views per group, and the shared block)
        stacked = self.params["layers"]
        if cfg.family == "hybrid":
            G, PG = self._hybrid_groups()
            self._layer_params: List = [[_index(stacked, (g, j)) for j in range(PG)]
                                        for g in range(G)]
            self._shared = self.params["shared"]
        else:
            self._layer_params = [_index(stacked, i) for i in range(cfg.n_layers)]

    def _hybrid_groups(self) -> Tuple[int, int]:
        cfg = self.cfg
        PG = cfg.shared_attn_every
        if PG <= 0 or cfg.n_layers % PG:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups of "
                             f"shared_attn_every={PG}")
        return cfg.n_layers // PG, PG

    # ================================================================ init
    def _draw(self, gen, device) -> Dict:
        cfg = self.cfg
        dt = layers.dtype_of(cfg)
        tree: Dict = {"embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device)}
        if not cfg.tie_embeddings:
            tree["unembed"] = layers.init_unembed(gen, cfg.vocab, cfg.d_model, dt, device)
        tree["final_norm"] = layers.init_rmsnorm(cfg.d_model, device)
        if cfg.family == "hybrid":
            tree["layers"] = blocks.init_ssm_layer(gen, cfg, device, lead=self._hybrid_groups())
            tree["shared"] = blocks.init_decoder_layer(gen, cfg, device)
            return tree
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
    def _layers(self, h: torch.Tensor, return_state: bool) -> Tuple[torch.Tensor, Optional[dict]]:
        """The layer stack over a full sequence; with ``return_state`` also
        the prefill cache, stacked as ``init_cache`` stacks it (batch and
        sequence from ``h``)."""
        cfg, impl = self.cfg, self.kernel_impl
        positions = torch.arange(h.shape[1], device=self.device)
        per_layer = []  # kept only with return_state
        if cfg.family == "hybrid":
            for group in self._layer_params:
                h, _, (k, v) = blocks.decoder_layer(self._shared, h, cfg, positions, impl)
                states = []
                for lp in group:
                    h, state = blocks.ssm_layer(lp, h, cfg, return_state=return_state, impl=impl)
                    states.append(state)
                if return_state:
                    per_layer.append({"attn": {"k": k, "v": v}, "mamba": _stack(states)})
        else:
            for lp in self._layer_params:
                if cfg.family == "ssm":
                    h, state = blocks.ssm_layer(lp, h, cfg, return_state=return_state, impl=impl)
                else:
                    h, _, (k, v) = blocks.decoder_layer(lp, h, cfg, positions, impl)
                    state = {"k": k, "v": v}
                if return_state:
                    per_layer.append(state)
        return h, (_stack(per_layer) if return_state else None)

    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (hidden_states, aux_loss)."""
        h, _ = self._layers(self._embed_inputs(batch), return_state=False)
        h = layers.rmsnorm(h, self.params["final_norm"], self.cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=self.device)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        p = self.params
        return layers.logits_from(h, p.get("unembed"), p["embed"])

    # ============================================================== prefill
    def prefill(self, batch) -> Tuple[torch.Tensor, dict]:
        """Run the full prompt, return (last-position logits (B, V), cache
        stacked as ``init_cache`` stacks it, at the prompt's length)."""
        h, cache = self._layers(self._embed_inputs(batch), return_state=True)
        h = layers.rmsnorm(h, self.params["final_norm"], self.cfg.norm_eps)
        logits = self._logits(h[:, -1:])[:, 0]
        return logits, cache

    # =============================================================== decode
    def decode_step(self, token, cache: dict, pos) -> Tuple[torch.Tensor, dict]:
        """token: (B, 1) int; pos: scalar or (B,) int write position (the ssm
        family ignores it, as in JAX). Updates `cache` in place and returns
        (logits (B, V), cache)."""
        cfg = self.cfg
        pos = torch.as_tensor(pos, device=self.device)
        h = layers.embed(torch.as_tensor(token, device=self.device), self.params["embed"])
        # each layer gets views of its slices of the stacked cache, updated in place
        if cfg.family == "hybrid":
            for g, group in enumerate(self._layer_params):
                ac = _index(cache["attn"], g)
                h, _ = blocks.decoder_layer_decode(self._shared, h, ac, pos, cfg,
                                                   self.kernel_impl)
                for j, lp in enumerate(group):
                    h, _ = blocks.ssm_layer_decode(lp, h, _index(cache["mamba"], (g, j)), cfg)
        else:
            for i, lp in enumerate(self._layer_params):
                lc = _index(cache, i)
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
        cfg = self.cfg
        if cfg.family == "hybrid":
            G, PG = self._hybrid_groups()
            return {"attn": blocks.init_decoder_cache(cfg, batch, cache_len, self.device,
                                                      lead=(G,)),
                    "mamba": mamba2.init_decode_state(cfg, batch, self.device, lead=(G, PG))}
        lead = (cfg.n_layers,)
        if cfg.family == "ssm":
            return mamba2.init_decode_state(cfg, batch, self.device, lead=lead)
        return blocks.init_decoder_cache(cfg, batch, cache_len, self.device, lead=lead)

    def cache_batch_axes(self) -> dict:
        """The batch axis of each leaf of ``init_cache``'s tree, for
        ``kv_cache.insert_sequence``: it follows the stacked layer axes, so it
        is 1 for every dense and ssm leaf and for the hybrid's ``attn`` leaves,
        and 2 for the hybrid's ``(G, PG, B, ...)`` ``mamba`` leaves."""
        if self.cfg.family == "hybrid":
            return {"attn": {"k": 1, "v": 1}, "mamba": {"conv": 2, "ssm": 2}}
        return {name: 1 for name in (("conv", "ssm") if self.cfg.family == "ssm" else ("k", "v"))}


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _map2(a: dict, b: dict, fn) -> None:
    for k, v in a.items():
        if isinstance(v, dict):
            _map2(v, b[k], fn)
        else:
            fn(v, b[k])
