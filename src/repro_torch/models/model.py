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
    loss(batch)                          -> (scalar, {"ce", "aux", "loss"})
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
    specs() / abstract_params()          -> the weights' logical axis names / meta stand-ins
    cache_specs(batch, cache_len)        -> the cache's logical axis names (the
                                            second value of the reference's init_cache)
    distribute(mesh)                     -> self, every weight a DTensor on the mesh
cache_len_of(cache) and build_model(cfg) are the reference's serving helpers.

On a mesh (``distribute``, then calls inside ``partition.use_mesh``) every
weight is a DTensor placed as its logical names resolve under
``rules_for(cfg)``; the activations take the reference's ``shard_act``
constraints (the embedding, each layer's input, the logits), and the kernel
wrappers run on each rank's shard (``sharding.local``). With no mesh the
constraints are no-ops and nothing on the one-device path changes.

Training: the weights are registered with ``requires_grad=False``, so serving
records no graph; ``model.requires_grad_(True)`` makes them trainable. A
forward that autograd records (grad mode on and a weight that requires grad)
takes its per-layer weights by ``torch.unbind`` of the stacked parameters on
each call, so their gradients reach the stacks (one stacking backward per
stack), and with ``cfg.remat`` runs each layer call under
``torch.utils.checkpoint`` (non-reentrant): the reference's ``jax.checkpoint``
around its scan body, with its three policies (``_remat``). The port
checkpoints each block call (the hybrid's shared block and each Mamba2 layer
apart, where the reference nests the group's). Other forwards use the per-layer views taken
once at construction, which the graphed decode step relies on.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..configs.base import ModelConfig
from ..sharding import partition
from ..sharding.local import as_replicated, local_shard
from . import blocks, layers, mamba2

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
AUX_COEF = 0.01   # the MoE load-balance loss's weight (repro/models/model.py:29)
_aten = torch.ops.aten
# the products each remat policy saves (the rest is recomputed), as JAX's
# checkpoint_dots and checkpoint_dots_with_no_batch_dims save every dot_general
# or those without batch dimensions (repro/models/model.py:32-40)
REMAT_SAVED_OPS = {
    "nothing": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


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


def _unbind(tree: dict) -> list:
    """A tree stacked on axis 0 -> one tree per index, views by ``torch.unbind``
    (whose backward stacks the indices' gradients once)."""
    parts = {k: _unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: part[i] for k, part in parts.items()} for i in range(n)]


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
        self.mesh = None
        shapes = {path[0]: part for path, part in self._parts(None, torch.device("meta"),
                                                              per_layer=False)}
        empty = _map(shapes, lambda t: torch.empty_like(t, device=self.device))
        _as_module(empty, self)
        self._take_views()
        # the decode step's sinusoidal tables, one per cache length (encdec)
        self._pos_tables: Dict[int, torch.Tensor] = {}

    def _take_views(self) -> None:
        """Per-layer views of the stacked weights, taken once: init() and
        load_state_dict() write the parameters in place, so they stay valid
        (the hybrid's: one list of PG per-layer views per group, and the
        shared block). ``distribute`` takes them again."""
        cfg = self.cfg
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

    def _hybrid_groups(self) -> Tuple[int, int]:
        cfg = self.cfg
        PG = cfg.shared_attn_every
        if PG <= 0 or cfg.n_layers % PG:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups of "
                             f"shared_attn_every={PG}")
        return cfg.n_layers // PG, PG

    # ============================================================ sharding
    def specs(self) -> dict:
        """The weights' logical axis names, a tree like ``params``: the spec
        trees of the reference's ``init_*`` functions, with one leading
        "layers" per stacked axis (the hybrid's Mamba2 stack has two)."""
        cfg = self.cfg
        s = {"embed": layers.embedding_specs()}
        if not cfg.tie_embeddings:
            s["unembed"] = layers.unembed_specs()
        s["final_norm"] = (layers.layernorm_specs() if cfg.family == "encdec"
                           else layers.rmsnorm_specs())
        layer_specs = {blocks.init_decoder_layer: blocks.decoder_layer_specs,
                       blocks.init_ssm_layer: blocks.ssm_layer_specs,
                       blocks.init_encoder_layer: blocks.encoder_layer_specs,
                       blocks.init_cross_decoder_layer: blocks.cross_decoder_layer_specs}
        for name, init_layer, lead in self._stacks():
            prefix = ("layers",) * len(lead)
            s[name] = _map(layer_specs[init_layer](cfg), lambda t: (*prefix, *t), is_leaf=tuple)
        if cfg.family == "hybrid":
            s["shared"] = blocks.decoder_layer_specs(cfg)
        if cfg.family == "encdec":
            s["enc_norm"] = layers.layernorm_specs()
        if cfg.family == "vlm":
            s["patch_proj"] = ("embed", "mlp")
        return s

    def abstract_params(self) -> dict:
        """Meta stand-ins of the weights at their global shapes and dtypes."""
        return _map(self.params, lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"))

    def cache_specs(self, batch: int, cache_len: int) -> dict:
        """The logical axis names of ``init_cache(batch, cache_len)``'s tree
        under the active mesh (the reference's ``init_cache`` returns them
        beside the cache): a sequence-sharded K/V cache where the KV heads do
        not divide the model axis."""
        cfg = self.cfg

        def stacked(specs, n_lead=1):
            return _map(specs, lambda t: ("layers",) * n_lead + tuple(t), is_leaf=tuple)

        if cfg.family == "hybrid":
            return {"attn": stacked(blocks.decoder_cache_specs(cfg)),
                    "mamba": stacked(mamba2.decode_state_specs(cfg), 2)}
        if cfg.family == "ssm":
            return stacked(mamba2.decode_state_specs(cfg))
        s = blocks.decoder_cache_specs(cfg)
        if cfg.family == "encdec":
            s["cross_k"] = s["cross_v"] = ("batch", None, "kv_heads", None)
        return stacked(s)

    @torch.no_grad()
    def distribute(self, mesh, rules: Optional[dict] = None) -> "Model":
        """Re-place every weight as a DTensor on ``mesh`` with the placements
        its logical names resolve to under ``rules`` (default
        ``rules_for(cfg)``), keeping its ``requires_grad``; then retake the
        per-layer views, so they view the distributed weights. Every rank
        holds the same full weights (drawn from one seed or loaded), so each
        keeps its own slice of them: no communication."""
        from torch.distributed.tensor import DTensor

        rules = rules or partition.rules_for(self.cfg)
        shardings = partition.named_shardings(self.specs(), self.params, mesh, rules)

        def place(module: nn.Module, sh: dict) -> None:
            for name, p in list(module.named_parameters(recurse=False)):
                pl = sh[name].placements
                local = as_replicated(p.detach(), mesh).redistribute(mesh, pl).to_local()
                d = DTensor.from_local(local.clone(), mesh, pl, run_check=False)
                module.register_parameter(name, nn.Parameter(d, requires_grad=p.requires_grad))
            for name, child in module.named_children():
                place(child, sh[name])

        place(self, shardings)
        self.mesh = mesh
        self._take_views()
        return self

    def _gather(self, tree):
        """A weight tree as its compute uses it: on a mesh each weight with
        its batch axes' (FSDP) shards gathered, as XLA gathers FSDP weights
        before their products (the gradient comes back reduce-scattered);
        with no mesh, the tree itself."""
        if self.mesh is None:
            return tree
        return _map(tree, partition.gather_fsdp)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict``; on a mesh each plain tensor is taken
        as the full value and written into its weight's local shard."""
        if self.mesh is None:
            return super().load_state_dict(state_dict, strict=strict, assign=assign)
        with partition.use_mesh(self.mesh, partition.rules_for(self.cfg)):
            return super().load_state_dict(state_dict, strict=strict, assign=assign)

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
            _map2(dst, part, _write)
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
            h = torch.cat([patches @ self._gather(p["patch_proj"]), h], dim=1)
        if self.cfg.family == "encdec":
            pos = layers.sinusoidal_positions(h.shape[1], self.cfg.d_model, self.device)
            h = h + pos.to(h.dtype)[None]
        return partition.shard_act(h, "batch", "seq", None)

    # ============================================================= training
    def _records_grad(self) -> bool:
        """Whether autograd records this forward: grad mode on and a weight
        that requires grad."""
        return torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())

    def _remat(self, fn):
        """``fn`` under ``torch.utils.checkpoint`` when this forward is
        recorded and ``cfg.remat`` is set, else ``fn``. Policy "nothing" keeps
        only the call's inputs and recomputes the rest in the backward;
        "dots" also keeps the output of every matrix product (``mm``,
        ``addmm``, ``bmm``, ``baddbmm``), "dots_no_batch" of those without a
        batch dimension (``mm``, ``addmm``), through
        ``create_selective_checkpoint_contexts``. The port's kernels launch
        through ctypes, not as aten ops, so every policy recomputes them."""
        cfg = self.cfg
        if not (cfg.remat and self._records_grad()):
            return fn
        if cfg.remat_policy not in REMAT_SAVED_OPS:
            raise ValueError(f"remat_policy {cfg.remat_policy!r} is not one of "
                             f"{tuple(REMAT_SAVED_OPS)}")
        saved = REMAT_SAVED_OPS[cfg.remat_policy]
        if not saved:
            return functools.partial(checkpoint, fn, use_reentrant=False)
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, list(saved)))

    def _per_layer(self, name: str = "layers") -> list:
        """The per-layer weight trees of stack ``name`` (the hybrid's: one list
        of PG per group): views taken now by ``torch.unbind`` when autograd
        records this forward, else the views taken at construction."""
        if not self._records_grad():
            return self._enc_layer_params if name == "enc_layers" else self._layer_params
        per_layer = _unbind(self.params[name])
        if self.cfg.family == "hybrid":
            return [_unbind(group) for group in per_layer]
        return per_layer

    def _encode(self, batch) -> torch.Tensor:
        """The encoder over ``batch["frames"]`` (B, enc_seq, d_model): the
        frames cast to the model dtype plus the sinusoidal table, the encoder
        layers, then ``enc_norm``."""
        cfg = self.cfg
        frames = torch.as_tensor(batch["frames"], device=self.device).to(layers.dtype_of(cfg))
        pos = layers.sinusoidal_positions(frames.shape[1], cfg.d_model, self.device)
        h = frames + pos.to(frames.dtype)[None]
        layer = self._remat(blocks.encoder_layer)
        for lp in self._per_layer("enc_layers"):
            h = layer(self._gather(lp), h, cfg, self.kernel_impl)
        return layers.layernorm(h, self._gather(self.params["enc_norm"]), cfg.norm_eps)

    def _final_norm(self, h: torch.Tensor) -> torch.Tensor:
        norm = layers.layernorm if self.cfg.family == "encdec" else layers.rmsnorm
        return norm(h, self._gather(self.params["final_norm"]), self.cfg.norm_eps)

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
        decoder_layer = self._remat(blocks.decoder_layer)
        ssm_layer = self._remat(functools.partial(blocks.ssm_layer, return_state=return_state,
                                                  impl=impl))
        if cfg.family == "hybrid":
            shared = self._gather(self._shared)
            for group in self._per_layer():
                h, _, (k, v) = decoder_layer(shared, h, cfg, positions, impl)
                states = []
                for lp in group:
                    h, state = ssm_layer(self._gather(lp), h, cfg)
                    states.append(state)
                if return_state:
                    per_layer.append({"attn": {"k": k, "v": v}, "mamba": _stack(states)})
        elif cfg.family == "encdec":
            cross_decoder_layer = self._remat(blocks.cross_decoder_layer)
            for lp in self._per_layer():
                h, ((k, v), (ck, cv)) = cross_decoder_layer(self._gather(lp), h, enc, cfg, impl)
                if return_state:
                    per_layer.append({"k": k, "v": v, "cross_k": ck, "cross_v": cv})
        else:
            for lp in map(self._gather, self._per_layer()):
                if cfg.family == "ssm":
                    h, state = ssm_layer(lp, h, cfg)
                else:
                    h, a, kv = decoder_layer(lp, h, cfg, positions, impl)
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
        if partition.is_dtensor(aux):
            return h, aux
        aux = torch.as_tensor(aux, dtype=torch.float32, device=self.device)
        if partition.is_dtensor(h):
            aux = as_replicated(aux, h.device_mesh)
        return h, aux

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        p = self._gather(self.params)
        # on a mesh the product would keep a sequence split of h that DTensor
        # may have chosen; the logits' constraint below wants the vocab split
        h = partition.shard_act(h, "batch", "seq", None)
        logits = layers.logits_from(h, p.get("unembed"), p["embed"])
        return partition.shard_act(logits, "batch", "seq", "vocab")

    # ================================================================= loss
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy plus ``AUX_COEF`` x the MoE aux loss.
        Returns (total, {"ce", "aux", "loss"}). The VLM scores rows P - 1 ..
        P - 1 + St (the last patch predicts the first token) against all St
        tokens, its ``loss_mask`` (B, St) unshifted; the other families score
        ``h[:, :-1]`` against ``tokens[:, 1:]`` and shift the mask alike."""
        cfg = self.cfg
        h, aux = self.forward(batch)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        if cfg.family == "vlm":
            P, St = cfg.n_patches, tokens.shape[1]
            h_lm, targets = h[:, P - 1:P - 1 + St], tokens
        else:
            h_lm, targets = h[:, :-1], tokens[:, 1:]
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
            if cfg.family != "vlm":
                mask = mask[:, 1:]
        ce = layers.cross_entropy_loss(self._logits(h_lm), targets, mask)
        total = ce + AUX_COEF * aux
        return total, {"ce": ce, "aux": aux, "loss": total}

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
        h = partition.shard_act(h, "batch", "seq", None)
        # each layer gets views of its slices of the stacked cache, updated in place
        if cfg.family == "hybrid":
            shared = self._gather(self._shared)
            for g, group in enumerate(self._layer_params):
                ac = _index(cache["attn"], g)
                h, _ = blocks.decoder_layer_decode(shared, h, ac, pos, cfg, self.kernel_impl)
                for j, lp in enumerate(group):
                    h, _ = blocks.ssm_layer_decode(self._gather(lp), h,
                                                   _index(cache["mamba"], (g, j)), cfg)
        else:
            for i, lp in enumerate(map(self._gather, self._layer_params)):
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
        """Zero decode cache stacked over layers, on the model's device (the
        JAX version also returns its logical specs: ``cache_specs``; on a mesh
        ``training.steps.place_cache`` places it). The ssm state does not grow
        with the sequence: ``cache_len`` is not used."""
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


def _map(tree, fn, is_leaf=None):
    """``fn`` over a tree's leaves (a bare leaf is a tree; ``is_leaf``: a
    type whose instances are leaves, for spec trees of tuples)."""
    if not isinstance(tree, dict) or (is_leaf is not None and isinstance(tree, is_leaf)):
        return fn(tree)
    return {k: _map(v, fn, is_leaf) for k, v in tree.items()}


def _write(p: torch.Tensor, t: torch.Tensor) -> None:
    """Copy the full value ``t`` into weight ``p`` in place: into its local
    shard when ``p`` is a DTensor."""
    if partition.is_dtensor(p):
        p.to_local().copy_(local_shard(t, p))
    else:
        p.copy_(t)


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
