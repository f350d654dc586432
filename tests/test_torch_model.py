"""The port's dense model against the JAX package's, on weights carried across.

JAX ``Model.init`` parameters go through ``repro_torch.params`` into the
port; both packages then run the same numpy batch (reduced configs, f32).
Tolerances are those of tests/test_decode_equivalence.py: 2e-4 for the
forward/prefill logits, 3e-4 for each decode step.
"""
import functools

import jax
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

ARCHS = ("qwen2-0.5b", "qwen1.5-0.5b", "deepseek-67b")
B, S, PREFILL = 2, 24, 16


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str = "float32"):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg = jax_reduced(arch).with_(dtype=dtype)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(arch).with_(dtype=dtype), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


@functools.lru_cache(maxsize=None)
def _reference_logits(arch: str):
    jmodel, jparams, _ = _pair(arch)
    batch = make_batch(jmodel.cfg, B, S)
    h, _ = jmodel.forward(jparams, batch)
    return batch, np.asarray(jmodel._logits(jparams, h))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    _, _, model = _pair(arch)
    batch, ref = _reference_logits(arch)
    with torch.inference_mode():
        h, aux = model({"tokens": torch.from_numpy(batch["tokens"])})
        logits = model._logits(h)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_scalar_pos_decode_match_jax(arch):
    _, _, model = _pair(arch)
    batch, ref = _reference_logits(arch)
    tokens = torch.from_numpy(batch["tokens"])
    with torch.inference_mode():
        logits, seq_cache = model.prefill({"tokens": tokens[:, :PREFILL]})
        np.testing.assert_allclose(logits.numpy(), ref[:, PREFILL - 1], rtol=2e-4, atol=2e-4)
        cache = model.init_cache(B, S)
        for name in cache:
            cache[name][:, :, :PREFILL] = seq_cache[name]
        for i in range(S - PREFILL - 1):
            pos = torch.tensor(PREFILL + i, dtype=torch.int32)
            logits, cache = model.decode_step(tokens[:, PREFILL + i:PREFILL + i + 1], cache, pos)
            np.testing.assert_allclose(logits.numpy(), ref[:, PREFILL + i], rtol=3e-4,
                                       atol=3e-4, err_msg=f"{arch}: decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_vector_pos_decode_matches_jax(arch):
    """Rows at different positions (continuous batching): each row prefilled
    alone, inserted into its slot, then decoded together with vector pos."""
    _, _, model = _pair(arch)
    batch, ref = _reference_logits(arch)
    tokens = torch.from_numpy(batch["tokens"])
    starts = [PREFILL, PREFILL - 5]
    with torch.inference_mode():
        cache = model.init_cache(B, S)
        for row, n in enumerate(starts):
            logits, seq_cache = model.prefill({"tokens": tokens[row:row + 1, :n]})
            np.testing.assert_allclose(logits[0].numpy(), ref[row, n - 1], rtol=2e-4, atol=2e-4)
            insert_sequence(cache, seq_cache, row)
        for i in range(S - PREFILL - 1):
            pos = torch.tensor([n + i for n in starts], dtype=torch.int32)
            tok = torch.stack([tokens[row, p] for row, p in enumerate(pos.tolist())])[:, None]
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
    assert ours["layers.attn.wq"] == (model.cfg.n_layers, model.cfg.d_model,
                                      model.cfg.n_heads, model.cfg.hd)


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


def test_unported_family_raises():
    cfg = get_reduced("qwen2-0.5b").with_(family="moe")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Model(cfg, device="cpu")
