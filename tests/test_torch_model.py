"""The port's dense (GQA and MLA), MoE, SSM, hybrid, encoder-decoder and VLM
models against the JAX package's, on carried weights.

JAX ``Model.init`` parameters go through ``repro_torch.params`` into the
port; both packages then run the same numpy batch (reduced configs, f32).
Tolerances are those of tests/test_decode_equivalence.py: 2e-4 for the
forward/prefill logits, 3e-4 for each decode step. The MoE archs run at
capacity factor 8.0, as that test does: the decode steps are held to the
full forward, and a forward over B*S tokens drops assignments where a
decode step over B does not (tests/test_torch_moe.py holds the published
capacity). The encoder-decoder batches carry ``make_batch``'s random frames,
the VLM's its random patches, which fill the first n_patches positions (so a
prefill of PREFILL positions holds PREFILL - n_patches tokens).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_batch  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.kv_cache import insert_sequence  # noqa: E402

ARCHS = ("qwen2-0.5b", "qwen1.5-0.5b", "deepseek-67b", "mamba2-2.7b", "zamba2-2.7b",
         "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "minicpm3-4b", "whisper-small",
         "internvl2-26b")


def _no_drop(cfg):
    """The MoE capacity factor of tests/test_decode_equivalence.py (8.0)."""
    if cfg.moe is None:
        return cfg
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
B, S, PREFILL = 2, 24, 16


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str = "float32"):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg = _no_drop(jax_reduced(arch).with_(dtype=dtype))
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(_no_drop(get_reduced(arch).with_(dtype=dtype)), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


@functools.lru_cache(maxsize=None)
def _reference_logits(arch: str):
    jmodel, jparams, _ = _pair(arch)
    batch = make_batch(jmodel.cfg, B, S)
    h, aux = jmodel.forward(jparams, batch)
    return batch, np.asarray(jmodel._logits(jparams, h)), float(aux)


def _inputs(batch, rows=slice(None), n=None) -> dict:
    """A numpy batch's rows as tensors, the tokens cut to `n` tokens (the
    encoder-decoder's frames and the VLM's patches whole)."""
    out = {"tokens": torch.from_numpy(batch["tokens"][rows, :n])}
    for side in ("frames", "patches"):
        if side in batch:
            out[side] = torch.from_numpy(batch[side][rows])
    return out


def _prefix(cfg) -> int:
    """Positions before the first token: the VLM's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    _, _, model = _pair(arch)
    batch, ref, ref_aux = _reference_logits(arch)
    with torch.inference_mode():
        h, aux = model(_inputs(batch))
        logits = model._logits(h)
    if model.cfg.family == "moe":  # the sum of the layers' load-balance losses
        assert ref_aux > 0.0
        np.testing.assert_allclose(float(aux), ref_aux, rtol=2e-4, atol=2e-4)
    else:
        assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, rtol=2e-4, atol=2e-4)


def _blit(cache: dict, seq_cache: dict) -> None:
    """Copy a prefill cache into the leading entries of a zero decode cache
    (the k/v sequence axis; the SSM leaves are the same shape; the hybrid's
    tree is walked)."""
    for name, dst in cache.items():
        src = seq_cache[name]
        if isinstance(dst, dict):
            _blit(dst, src)
        else:
            dst[tuple(slice(0, n) for n in src.shape)] = src


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_scalar_pos_decode_match_jax(arch):
    _, _, model = _pair(arch)
    batch, ref, _ = _reference_logits(arch)
    tokens = torch.from_numpy(batch["tokens"])
    off = _prefix(model.cfg)
    with torch.inference_mode():
        logits, seq_cache = model.prefill(_inputs(batch, n=PREFILL - off))
        np.testing.assert_allclose(logits.numpy(), ref[:, PREFILL - 1], rtol=2e-4, atol=2e-4)
        cache = model.init_cache(B, S)
        _blit(cache, seq_cache)
        for i in range(S - PREFILL - 1):
            pos = torch.tensor(PREFILL + i, dtype=torch.int32)
            t = PREFILL - off + i
            logits, cache = model.decode_step(tokens[:, t:t + 1], cache, pos)
            np.testing.assert_allclose(logits.numpy(), ref[:, PREFILL + i], rtol=3e-4,
                                       atol=3e-4, err_msg=f"{arch}: decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_vector_pos_decode_matches_jax(arch):
    """Rows at different positions (continuous batching): each row prefilled
    alone, inserted into its slot, then decoded together with vector pos."""
    _, _, model = _pair(arch)
    batch, ref, _ = _reference_logits(arch)
    tokens = torch.from_numpy(batch["tokens"])
    starts = [PREFILL, PREFILL - 5]
    off = _prefix(model.cfg)
    with torch.inference_mode():
        cache = model.init_cache(B, S)
        for row, n in enumerate(starts):
            logits, seq_cache = model.prefill(_inputs(batch, slice(row, row + 1), n - off))
            np.testing.assert_allclose(logits[0].numpy(), ref[row, n - 1], rtol=2e-4, atol=2e-4)
            insert_sequence(cache, seq_cache, row, model.cache_batch_axes())
        for i in range(S - PREFILL - 1):
            pos = torch.tensor([n + i for n in starts], dtype=torch.int32)
            tok = torch.stack([tokens[row, p - off] for row, p in enumerate(pos.tolist())])[:, None]
            logits, cache = model.decode_step(tok, cache, pos)
            for row, p in enumerate(pos.tolist()):
                np.testing.assert_allclose(logits[row].numpy(), ref[row, p], rtol=3e-4,
                                           atol=3e-4, err_msg=f"{arch}: row {row} pos {p}")


def test_qk_norm_forward_matches_jax():
    """The dense family's Qwen3-style per-head q/k RMSNorm (no ported arch
    turns it on yet)."""
    jcfg = jax_reduced("qwen2-0.5b").with_(dtype="float32", qk_norm=True)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    r = np.random.default_rng(5)
    jparams["layers"]["attn"]["q_norm"] = r.uniform(0.5, 1.5, (2, jcfg.hd)).astype(np.float32)
    jparams["layers"]["attn"]["k_norm"] = r.uniform(0.5, 1.5, (2, jcfg.hd)).astype(np.float32)
    model = Model(get_reduced("qwen2-0.5b").with_(dtype="float32", qk_norm=True), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    batch = make_batch(jcfg, B, S)
    h, _ = jmodel.forward(jparams, batch)
    with torch.inference_mode():
        ours = model._logits(model({"tokens": torch.from_numpy(batch["tokens"])})[0])
    np.testing.assert_allclose(ours.numpy(), np.asarray(jmodel._logits(jparams, h)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_keys_and_shapes_are_the_jax_pytree(arch):
    _, jparams, model = _pair(arch)
    flat = tparams.flatten(jax.tree.map(np.asarray, jparams))
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in flat.items()}
    cfg = model.cfg
    d_in = cfg.ssm.d_inner(cfg.d_model) if cfg.ssm else 0
    if cfg.family == "ssm":
        assert ours["layers.mamba.wx"] == (cfg.n_layers, cfg.d_model, d_in)
    elif cfg.family == "hybrid":
        G, PG = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
        assert ours["layers.mamba.wx"] == (G, PG, cfg.d_model, d_in)
        assert ours["layers.ln.scale"] == (G, PG, cfg.d_model)
        assert ours["shared.attn.wq"] == (cfg.d_model, cfg.n_heads, cfg.hd)
        assert ours["shared.ln2.scale"] == (cfg.d_model,)
    elif cfg.family == "encdec":
        L, D, H, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd
        assert ours["enc_layers.attn.wq"] == (cfg.n_enc_layers, D, H, hd)
        assert ours["enc_layers.mlp.bi"] == (cfg.n_enc_layers, cfg.d_ff)
        assert ours["layers.cross.wk"] == (L, D, cfg.n_kv_heads, hd)
        assert ours["layers.ln3.bias"] == (L, D)
        assert ours["enc_norm.bias"] == ours["final_norm.bias"] == (D,)
    elif cfg.family == "vlm":
        assert ours["patch_proj"] == (cfg.d_model, cfg.d_model)
        assert ours["layers.attn.wk"] == (cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd)
    elif cfg.mla is not None:
        m, L = cfg.mla, cfg.n_layers
        assert ours["layers.attn.wuq"] == (L, m.q_lora_rank, cfg.n_heads,
                                           m.qk_nope_dim + m.qk_rope_dim)
        assert ours["layers.attn.wuv"] == (L, m.kv_lora_rank, cfg.n_heads, m.v_head_dim)
        assert ours["layers.attn.kv_norm"] == (L, m.kv_lora_rank)
    else:
        assert ours["layers.attn.wq"] == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd)
    if cfg.family == "moe":
        L, D, m = cfg.n_layers, cfg.d_model, cfg.moe
        assert ours["layers.ffn.router"] == (L, D, m.n_experts)
        assert ours["layers.ffn.wi"] == (L, m.n_experts, D, m.d_ff_expert)
        assert ours["layers.ffn.wo"] == (L, m.n_experts, m.d_ff_expert, D)
        assert ("layers.ffn.shared_gate" in ours) == bool(m.n_shared_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_weight_carry_over_is_bit_exact(arch):
    _, jparams, model = _pair(arch, "bfloat16")
    flat = tparams.flatten(jax.tree.map(np.asarray, jparams))
    sd = model.state_dict()
    for name, a in flat.items():
        t = sd[name]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.view(torch.uint16).numpy(), a.view(np.uint16),
                                          err_msg=name)
        else:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)


def test_to_state_dict_casts_weights_but_keeps_norm_scales_fp32():
    _, jparams, _ = _pair("qwen2-0.5b")
    sd = tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu", dtype=torch.bfloat16)
    assert sd["layers.attn.wq"].dtype == torch.bfloat16
    assert sd["layers.attn.bq"].dtype == torch.bfloat16
    assert sd["layers.ln1.scale"].dtype == torch.float32
    assert sd["final_norm.scale"].dtype == torch.float32


def test_to_state_dict_keeps_the_ssm_fp32_leaves_fp32():
    _, jparams, _ = _pair("mamba2-2.7b")
    sd = tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu", dtype=torch.bfloat16)
    for name in ("wx", "conv_w", "conv_b", "out_proj"):
        assert sd[f"layers.mamba.{name}"].dtype == torch.bfloat16, name
    for name in ("A_log", "D", "dt_bias", "norm"):
        assert sd[f"layers.mamba.{name}"].dtype == torch.float32, name
    assert sd["layers.ln.scale"].dtype == torch.float32


def test_to_state_dict_keeps_the_hybrid_fp32_leaves_fp32():
    _, jparams, _ = _pair("zamba2-2.7b")
    sd = tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu", dtype=torch.bfloat16)
    for name in ("layers.mamba.wx", "layers.mamba.conv_w", "shared.attn.wq", "shared.ffn.wo"):
        assert sd[name].dtype == torch.bfloat16, name
    for name in ("layers.mamba.A_log", "layers.mamba.D", "layers.mamba.dt_bias",
                 "layers.mamba.norm", "layers.ln.scale", "shared.ln1.scale",
                 "shared.ln2.scale", "final_norm.scale"):
        assert sd[name].dtype == torch.float32, name


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_to_state_dict_keeps_the_router_fp32(arch):
    """The router stays float32 through a cast to bf16 (the JAX init keeps
    it so); the experts, the shared expert and its gate take the cast."""
    _, jparams, _ = _pair(arch)
    sd = tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu", dtype=torch.bfloat16)
    assert sd["layers.ffn.router"].dtype == torch.float32
    names = ["layers.ffn.wi", "layers.ffn.wg", "layers.ffn.wo", "layers.attn.wq"]
    if "layers.ffn.shared_gate" in sd:
        names += ["layers.ffn.shared_gate", "layers.ffn.shared.wi", "layers.ffn.shared.wo"]
    for name in names:
        assert sd[name].dtype == torch.bfloat16, name
    assert sd["layers.ln2.scale"].dtype == torch.float32


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("S", [3, 5, 16, 19])
def test_hybrid_prefill_cache_matches_jax_leaf_by_leaf(S):
    """The hybrid's nested prefill cache: the shared block's k/v per group
    and every mamba layer's conv tail and final state, (G, PG, 1, ...)."""
    jmodel, jparams, model = _pair("zamba2-2.7b")
    batch, _, _ = _reference_logits("zamba2-2.7b")
    tokens = batch["tokens"][:1, :S]
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        _, cache = model.prefill({"tokens": torch.from_numpy(tokens)})
    ours, theirs = dict(_leaves(cache)), dict(_leaves(jcache))
    assert set(ours) == set(theirs) == {"attn.k", "attn.v", "mamba.conv", "mamba.ssm"}
    for name, t in ours.items():
        assert t.shape == theirs[name].shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(theirs[name]), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b", "qwen2-0.5b", "qwen2-moe-a2.7b",
                                  "minicpm3-4b", "whisper-small", "internvl2-26b"])
def test_init_cache_tree_and_batch_axes_are_the_jax_ones(arch):
    jmodel, _, model = _pair(arch)
    jcache, _ = jmodel.init_cache(3, 10)
    cache = model.init_cache(3, 10)
    ours, theirs = dict(_leaves(cache)), dict(_leaves(jcache))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    axes = dict(_leaves(model.cache_batch_axes()))
    assert set(axes) == set(ours)
    for name, t in ours.items():
        assert t.shape[axes[name]] == 3, name
        assert str(t.dtype).split(".")[-1] == str(theirs[name].dtype), name


@pytest.mark.parametrize("S", [3, 5, 16, 19])
def test_ssm_prefill_states_match_jax(S):
    """The conv tail and the final SSD state of every layer (S >= K-1 = 3,
    where the reference's tail is right; S = 19 pads to two chunks of 16)."""
    jmodel, jparams, model = _pair("mamba2-2.7b")
    batch, _, _ = _reference_logits("mamba2-2.7b")
    tokens = batch["tokens"][:, :S]
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        _, cache = model.prefill({"tokens": torch.from_numpy(tokens)})
    assert set(cache) == set(jcache) == {"conv", "ssm"}
    for name in cache:
        assert cache[name].shape == jcache[name].shape, name
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


def test_ssm_init_draws_like_the_reference_recipe():
    cfg = get_reduced("mamba2-2.7b").with_(dtype="float32")
    p = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0)).params["layers"]["mamba"]
    L, H = cfg.n_layers, cfg.ssm.n_heads(cfg.d_model)
    d_in, K = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.conv_kernel
    torch.testing.assert_close(p["A_log"], torch.log(torch.linspace(1.0, 16.0, H)).expand(L, H))
    assert torch.equal(p["D"], torch.ones(L, H))
    torch.testing.assert_close(torch.nn.functional.softplus(p["dt_bias"]),
                               torch.full((L, H), 0.01))
    assert torch.equal(p["norm"], torch.ones(L, d_in))
    assert torch.equal(p["conv_b"], torch.zeros_like(p["conv_b"]))
    assert abs(p["conv_w"].std().item() * K ** 0.5 - 1.0) < 0.05
    for w, fan_in in ((p["wz"], cfg.d_model), (p["out_proj"], d_in)):
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05


def test_init_draws_like_the_reference_recipe():
    cfg = get_reduced("deepseek-67b").with_(dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    p = model.params
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert torch.equal(p["layers"]["ln1"]["scale"], torch.ones(cfg.n_layers, cfg.d_model))
    for w, fan_in in ((p["layers"]["attn"]["wq"], cfg.d_model),
                      (p["layers"]["ffn"]["wo"], cfg.d_ff),
                      (p["unembed"]["w"], cfg.d_model)):
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_moe_init_draws_like_the_reference_recipe():
    """Reduced qwen2-moe in bf16: the router f32 at scale D^-1/2, the experts,
    the shared expert and its gate at 1/sqrt(fan_in); the same seed draws the
    same weights (the model draws one layer at a time)."""
    cfg = get_reduced("qwen2-moe-a2.7b").with_(
        moe=dataclasses.replace(get_reduced("qwen2-moe-a2.7b").moe, n_experts=16))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ffn = model.params["layers"]["ffn"]
    D, Fe, Fs = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.d_ff_shared
    assert ffn["router"].dtype == torch.float32 and ffn["wi"].dtype == torch.bfloat16
    for w, fan_in in ((ffn["router"], D), (ffn["wi"], D), (ffn["wg"], D), (ffn["wo"], Fe),
                      (ffn["shared"]["wi"], D), (ffn["shared"]["wo"], Fs),
                      (model.params["embed"]["tok"], D), (model.params["unembed"]["w"], D)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.05
    gate = ffn["shared_gate"].float()
    assert gate.shape == (cfg.n_layers, D, 1)
    assert abs(gate.std().item() * D ** 0.5 - 1.0) < 0.2
    assert not torch.equal(ffn["wi"][0], ffn["wi"][1])   # each layer its own draw
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    other = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    assert not torch.equal(other.params["layers"]["ffn"]["wi"], ffn["wi"])


def test_unported_family_raises():
    cfg = get_reduced("qwen2-0.5b").with_(family="no-such-family")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Model(cfg, device="cpu")
