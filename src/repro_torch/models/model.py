"""Model assembly for every ported family: embedding + layer stack + head.

Port of ``repro.models.model.Model``. The model is an ``nn.Module`` whose
``state_dict`` keys are the JAX parameter pytree paths joined by ``.``, with
layers stacked on axis 0 (``layers.attn.wq`` is ``(L, D, H, hd)``), so the
JAX ``Model.init`` weights load through ``repro_torch.params`` unchanged. A
Python loop over the stacked layer axis replaces ``lax.scan``. The hybrid
family (zamba2) stacks its Mamba2 layers in G groups of PG
(``layers.mamba.wx`` is ``(G, PG, D, d_inner)``) and holds one unstacked
dense block, ``shared``, which runs before each group. The encoder-decoder
family (whisper) stacks its encoder layers under ``enc_layers`` and its
decoder layers under ``layers``; ``enc_norm`` and ``final_norm`` are
LayerNorms. Its batches carry ``frames`` (B, enc_seq, d_model), the audio
front end's output, encoded once per prefill; sinusoidal positions are added
to the frames and to the decoder's tokens. The VLM family (internvl2) is the
dense decoder with ``patch_proj``, a (d_model, d_model) weight at the top of
the tree: its batches carry ``patches`` (B, n_patches, d_model), the stubbed
vision front end's output, projected and prepended to the token embeddings,
so its caches and positions count the patches before the prompt.

API (the JAX one without the ``params`` argument, which the module holds):
    init(generator)                      -> self (weights drawn in place)
    forward(batch)                       -> (hidden_states, aux_loss)
    prefill(batch)                       -> (last_logits (B, V), cache)
    decode_step(token, cache, pos)       -> (logits (B, V), cache updated in place)
    init_cache(batch, cache_len)         -> zero cache, stacked over layers:
        dense  {"k", "v"}: (L, B, S, KV, hd) in the model dtype; with MLA
               {"ckv": (L, B, S, kv_lora), "krope": (L, B, S, rope)};
        ssm    {"conv": (L, B, K-1, Cd) in the model dtype, "ssm": (L, B, H, P, N) f32};
        hybrid {"attn": {"k", "v"}: (G, B, S, KV, hd),
                "mamba": {"conv": (G, PG, B, K-1, Cd), "ssm": (G, PG, B, H, P, N)}};
        encdec {"k", "v"}: (L, B, S, KV, hd) and {"cross_k", "cross_v"}:
               (L, B, enc_seq, KV, hd), the encoder's keys and values;
        vlm    the dense tree, S counting the patches
    cache_batch_axes()                   -> the batch axis of each cache leaf
cache_len_of(cache) and build_model(cfg) are the reference's serving helpers.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import blocks, layers, mamba2

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


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
        shapes = {path[0]: part for path, part in self._parts(None, torch.device("meta"),
                                                              per_layer=False)}
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
        if cfg.family == "encdec":
            self._enc_layer_params = [_index(self.params["enc_layers"], i)
                                      for i in range(cfg.n_enc_layers)]
        # the decode step's sinusoidal tables, one per cache length (encdec)
        self._pos_tables: Dict[int, torch.Tensor] = {}

    def _hybrid_groups(self) -> Tuple[int, int]:
        cfg = self.cfg
        PG = cfg.shared_attn_every
        if PG <= 0 or cfg.n_layers % PG:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups of "
                             f"shared_attn_every={PG}")
        return cfg.n_layers // PG, PG

    # ================================================================ init
    def _stacks(self) -> List[Tuple[str, object, Tuple[int, ...]]]:
        """(name, per-layer init, stacked lead shape) of each layer stack."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return [("layers", blocks.init_ssm_layer, self._hybrid_groups())]
        if cfg.family == "ssm":
            return [("layers", blocks.init_ssm_layer, (cfg.n_layers,))]
        if cfg.family == "encdec":
            return [("enc_layers", blocks.init_encoder_layer, (cfg.n_enc_layers,)),
                    ("layers", blocks.init_cross_decoder_layer, (cfg.n_layers,))]
        return [("layers", blocks.init_decoder_layer, (cfg.n_layers,))]

    def _parts(self, gen, device, per_layer: bool) -> Iterator[Tuple[tuple, Dict]]:
        """Yield the weight tree's parts in draw order, each drawn when it is
        asked for: (("embed",), tree), the unembedding, the final norm, then
        each layer stack: one part stacked on its lead shape (``per_layer``
        False), or one ((name, index), tree) per layer; the hybrid's shared
        block, the encoder-decoder's encoder norm and the VLM's patch
        projection (a bare weight, drawn as the reference's ``dense_init``)
        last."""
        cfg = self.cfg
        dt = layers.dtype_of(cfg)
        yield ("embed",), layers.init_embedding(gen, cfg.vocab, cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            yield ("unembed",), layers.init_unembed(gen, cfg.vocab, cfg.d_model, dt, device)
        norm = layers.init_layernorm if cfg.family == "encdec" else layers.init_rmsnorm
        yield ("final_norm",), norm(cfg.d_model, device)
        for name, init_layer, lead in self._stacks():
            if per_layer:
                for index in itertools.product(*map(range, lead)):
                    yield (name, index), init_layer(gen, cfg, device)
            else:
                yield (name,), init_layer(gen, cfg, device, lead=lead)
        if cfg.family == "hybrid":
            yield ("shared",), blocks.init_decoder_layer(gen, cfg, device)
        if cfg.family == "encdec":
            yield ("enc_norm",), layers.init_layernorm(cfg.d_model, device)
        if cfg.family == "vlm":
            yield ("patch_proj",), layers.dense_init(gen, (cfg.d_model, cfg.d_model),
                                                     cfg.d_model, dt, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw random weights from `generator` (on the model's device) into
        the parameters in place, one part at a time: each part (the embedding,
        the unembedding, one layer) is drawn, its float32 draws scaled in
        place, copied into its slices of the parameters and freed before the
        next, so the peak is the weights plus one layer's draw."""
        params = self.params
        for path, part in self._parts(generator, self.device, per_layer=True):
            dst = params[path[0]]
            if len(path) == 2:
                dst = _index(dst, path[1])
            _map2(dst, part, lambda p, t: p.copy_(t))
            del part
        return self

    @property
    def params(self) -> dict:
        """The weights as the nested dict the compute functions take."""
        return _as_tree(self)

    # ============================================================ embedding
    def _embed_inputs(self, batch) -> torch.Tensor:
        """The token embeddings; a VLM's ``batch["patches"]`` (B, P, d_model)
        cast to the model dtype, projected by ``patch_proj`` and prepended."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        p = self.params
        h = layers.embed(tokens, p["embed"])
        if self.cfg.family == "vlm":
            patches = torch.as_tensor(batch["patches"], device=self.device).to(h.dtype)
            h = torch.cat([patches @ p["patch_proj"], h], dim=1)
        if self.cfg.family == "encdec":
            pos = layers.sinusoidal_positions(h.shape[1], self.cfg.d_model, self.device)
            h = h + pos.to(h.dtype)[None]
        return h

    def _encode(self, batch) -> torch.Tensor:
        """The encoder over ``batch["frames"]`` (B, enc_seq, d_model): the
        frames cast to the model dtype plus the sinusoidal table, the encoder
        layers, then ``enc_norm``."""
        cfg = self.cfg
        frames = torch.as_tensor(batch["frames"], device=self.device).to(layers.dtype_of(cfg))
        pos = layers.sinusoidal_positions(frames.shape[1], cfg.d_model, self.device)
        h = frames + pos.to(frames.dtype)[None]
        for lp in self._enc_layer_params:
            h = blocks.encoder_layer(lp, h, cfg, self.kernel_impl)
        return layers.layernorm(h, self.params["enc_norm"], cfg.norm_eps)

    def _final_norm(self, h: torch.Tensor) -> torch.Tensor:
        norm = layers.layernorm if self.cfg.family == "encdec" else layers.rmsnorm
        return norm(h, self.params["final_norm"], self.cfg.norm_eps)

    def _decode_positions(self, cache_len: int) -> torch.Tensor:
        """The sinusoidal table of a cache of ``cache_len`` positions in the
        model dtype (the reference's ``sinusoidal_positions(cache_len_of(cache),
        d)`` cast as its decode step casts it), built once per length by
        ``init_cache``, outside a captured step, and only indexed by it."""
        table = self._pos_tables.get(cache_len)
        if table is None:
            table = layers.sinusoidal_positions(cache_len, self.cfg.d_model, self.device)
            table = self._pos_tables[cache_len] = table.to(layers.dtype_of(self.cfg))
        return table

    # ============================================================== forward
    def _layers(self, h: torch.Tensor, return_state: bool, enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
        """The layer stack over a full sequence (``enc``: the encoder's output,
        for the encoder-decoder family). Returns (h, the sum of the layers' aux
        losses (an fp32 tensor for the moe family, else 0.0), and with
        ``return_state`` the prefill cache, stacked as ``init_cache`` stacks
        it (batch and sequence from ``h``), else None)."""
        cfg, impl = self.cfg, self.kernel_impl
        positions = torch.arange(h.shape[1], device=self.device)
        aux = 0.0
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
        elif cfg.family == "encdec":
            for lp in self._layer_params:
                h, ((k, v), (ck, cv)) = blocks.cross_decoder_layer(lp, h, enc, cfg, impl)
                if return_state:
                    per_layer.append({"k": k, "v": v, "cross_k": ck, "cross_v": cv})
        else:
            for lp in self._layer_params:
                if cfg.family == "ssm":
                    h, state = blocks.ssm_layer(lp, h, cfg, return_state=return_state, impl=impl)
                else:
                    h, a, kv = blocks.decoder_layer(lp, h, cfg, positions, impl)
                    if cfg.family == "moe":
                        aux = aux + a
                    state = self._pack_kv(kv)
                if return_state:
                    per_layer.append(state)
        return h, aux, (_stack(per_layer) if return_state else None)

    def _encoder_output(self, batch) -> Optional[torch.Tensor]:
        return self._encode(batch) if self.cfg.family == "encdec" else None

    def _pack_kv(self, kv: tuple) -> dict:
        """A dense layer's prefill cache as its decode-cache leaves."""
        names = ("ckv", "krope") if self.cfg.mla is not None else ("k", "v")
        return dict(zip(names, kv))

    def forward(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (hidden_states, aux_loss): the sum
        of the layers' load-balance losses for the moe family, else zero."""
        h, aux, _ = self._layers(self._embed_inputs(batch), return_state=False,
                                 enc=self._encoder_output(batch))
        h = self._final_norm(h)
        return h, torch.as_tensor(aux, dtype=torch.float32, device=self.device)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        p = self.params
        return layers.logits_from(h, p.get("unembed"), p["embed"])

    # ============================================================== prefill
    def prefill(self, batch) -> Tuple[torch.Tensor, dict]:
        """Run the full prompt, return (last-position logits (B, V), cache
        stacked as ``init_cache`` stacks it, at the prompt's length; the
        encoder-decoder's cross leaves at the frames' length)."""
        h, _, cache = self._layers(self._embed_inputs(batch), return_state=True,
                                   enc=self._encoder_output(batch))
        h = self._final_norm(h)
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
        if cfg.family == "encdec":
            # the sinusoidal row at pos, from the table of the cache's length
            rows = self._decode_positions(cache["k"].shape[2]).index_select(
                0, pos.reshape(-1).long())
            h = h + (rows[:, None] if pos.ndim == 1 else rows[None])
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
                elif cfg.family == "encdec":
                    h, _ = blocks.cross_decoder_layer_decode(lp, h, lc, pos, cfg,
                                                             self.kernel_impl)
                else:
                    h, _ = blocks.decoder_layer_decode(lp, h, lc, pos, cfg, self.kernel_impl)
        h = self._final_norm(h)
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
        cache = blocks.init_decoder_cache(cfg, batch, cache_len, self.device, lead=lead)
        if cfg.family == "encdec":
            shape = (*lead, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
            dt = layers.dtype_of(cfg)
            cache["cross_k"] = torch.zeros(shape, dtype=dt, device=self.device)
            cache["cross_v"] = torch.zeros(shape, dtype=dt, device=self.device)
            self._decode_positions(cache_len)
        return cache

    def cache_batch_axes(self) -> dict:
        """The batch axis of each leaf of ``init_cache``'s tree, for
        ``kv_cache.insert_sequence``: it follows the stacked layer axes, so it
        is 1 for every dense (MLA too), ssm and encoder-decoder leaf and for
        the hybrid's ``attn`` leaves, and 2 for the hybrid's ``(G, PG, B,
        ...)`` ``mamba`` leaves."""
        if self.cfg.family == "encdec":
            return {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1}
        if self.cfg.family == "hybrid":
            return {"attn": {"k": 1, "v": 1}, "mamba": {"conv": 2, "ssm": 2}}
        if self.cfg.family == "ssm":
            return {"conv": 1, "ssm": 1}
        return {name: 1 for name in (("ckv", "krope") if self.cfg.mla is not None else ("k", "v"))}


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _map2(a, b, fn) -> None:
    """fn(leaf of a, leaf of b) over two trees of one shape (a leaf alone
    is a tree: the VLM's ``patch_proj`` is a part with no dict around it)."""
    if not isinstance(a, dict):
        fn(a, b)
        return
    for k, v in a.items():
        _map2(v, b[k], fn)


def _first_leaf(tree: dict) -> torch.Tensor:
    """The first leaf in JAX's flatten order (dict keys sorted)."""
    leaf = tree[min(tree)]
    return _first_leaf(leaf) if isinstance(leaf, dict) else leaf


def cache_len_of(cache: dict) -> int:
    """Sequence capacity of a dense-style cache (``cache["k"]``'s axis 2,
    else the first leaf's, as the reference reads it)."""
    return (cache["k"] if "k" in cache else _first_leaf(cache)).shape[2]


@functools.lru_cache(maxsize=1)
def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of a frozen config, cached as the reference caches one per
    config. Unlike the reference's, the model holds its weights: callers
    asking for one config share one weight set (an ``init`` or
    ``load_state_dict`` by one is seen by all), and the cache keeps only the
    latest model alive so as not to pin several full-width weight sets; a
    caller that wants the plain path sets ``model.kernel_impl``."""
    return Model(cfg, device=device)
