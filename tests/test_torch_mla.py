"""The port's MLA family (minicpm3-4b) against the JAX package's, on the CPU.

Reduced minicpm3-4b in f32, JAX ``Model.init`` weights carried over by
``repro_torch.params``, the same numpy inputs from a seed: the attention
block (expanded prefill, absorbed decode with scalar and vector positions,
the cache written in place), greedy streams against the JAX engine and the
``Model.forward`` oracle, the engine, a batched and an unbatched fabric
host, the serve driver, ``cache_bytes``, and the two attention ops at MLA's
head dims (dv != dqk, F3). The model's logits (prefill 2e-4, decode 3e-4 with
scalar and vector positions) are held in tests/test_torch_model.py, whose
parametrizations include minicpm3-4b.
"""
import contextlib
import io
import runpy
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.kernels.flash_attention import ref as jax_attn_ref  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv_cache  # noqa: E402
from repro.serving.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import FunctionService  # noqa: E402
from repro_torch.core.containers import ContainerSpec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.fabric import ModelHost, reset_serving, serve_model  # noqa: E402
from repro_torch.serving.kv_cache import cache_bytes  # noqa: E402

ARCH = "minicpm3-4b"
TOL = 2e-5   # one block in f32: the two packages sum in another order


@pytest.fixture(scope="module")
def carried():
    """(JAX model, JAX params, the port's model holding the same weights)."""
    jmodel = JaxModel(jax_reduced(ARCH).with_(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(ARCH).with_(dtype="float32"), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


def _layer0(jparams, model):
    """Layer 0's attention weights: the JAX leaves and the port's views."""
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    return jp, model._layer_params[0]["attn"]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@torch.inference_mode()
def _greedy_reference(model, prompt, n_new):
    """Sequential full-recompute greedy decoding (no cache): the oracle."""
    toks = list(np.asarray(prompt, np.int64))
    out = []
    for _ in range(n_new):
        h, _ = model({"tokens": torch.tensor([toks])})
        nxt = int(torch.argmax(model._logits(h)[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


# ------------------------------------------------------------ the block
def test_mla_attention_matches_jax(carried):
    jmodel, jparams, model = carried
    cfg = model.cfg
    jp, p = _layer0(jparams, model)
    x = _randn(np.random.default_rng(0), 2, 13, cfg.d_model)
    positions = np.arange(13)
    want, (want_ckv, want_krope) = jax_mla.mla_attention(
        jp, jnp.asarray(x), jmodel.cfg, positions=jnp.asarray(positions), return_cache=True)
    with torch.inference_mode():
        got, (ckv, krope) = mla.mla_attention(p, torch.from_numpy(x), cfg,
                                              positions=torch.from_numpy(positions))
    m = cfg.mla
    assert got.shape == (2, 13, cfg.d_model)
    assert ckv.shape == (2, 13, m.kv_lora_rank) and krope.shape == (2, 13, m.qk_rope_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ckv.numpy(), np.asarray(want_ckv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(krope.numpy(), np.asarray(want_krope), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar-pos", "vector-pos"])
def test_mla_attention_decode_matches_jax(carried, vector):
    """The absorbed decode on random caches: the output, and both cache
    leaves written at pos (in place here, returned anew by JAX)."""
    jmodel, jparams, model = carried
    cfg, m = model.cfg, model.cfg.mla
    jp, p = _layer0(jparams, model)
    rng = np.random.default_rng(1)
    B, S = 3, 20
    x = _randn(rng, B, 1, cfg.d_model)
    ckv, krope = _randn(rng, B, S, m.kv_lora_rank), _randn(rng, B, S, m.qk_rope_dim)
    pos = np.array([4, 11, 19], np.int32) if vector else np.int32(9)
    want, (want_ckv, want_krope) = jax_mla.mla_attention_decode(
        jp, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(krope), jnp.asarray(pos), jmodel.cfg)
    tckv, tkrope = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    with torch.inference_mode():
        got, (ckv_out, krope_out) = mla.mla_attention_decode(
            p, torch.from_numpy(x), tckv, tkrope, torch.from_numpy(np.asarray(pos)), cfg)
    assert ckv_out is tckv and krope_out is tkrope           # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tckv.numpy(), np.asarray(want_ckv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tkrope.numpy(), np.asarray(want_krope), rtol=TOL, atol=TOL)
    rows = np.arange(B) if vector else slice(None)
    changed = np.abs(tckv.numpy() - ckv).sum(-1) > 0
    assert changed[rows, pos].all() and changed.sum() == B   # one row a sequence, at pos


# --------------------------------------------------------------- F3 ops
def test_flash_attention_takes_dv_unlike_dqk():
    """ops.flash_attention with dqk 24 and dv 16 (reduced minicpm3's prefill)
    against JAX's mha_reference: causal, non-causal, and with a q offset."""
    rng = np.random.default_rng(2)
    q, k, v = _randn(rng, 2, 9, 4, 24), _randn(rng, 2, 9, 4, 24), _randn(rng, 2, 9, 4, 16)
    for kw in ({"causal": True}, {"causal": False}, {"causal": True, "q_offset": 0}):
        want = jax_attn_ref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          scale=24 ** -0.5, **kw)
        got = attn_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), scale=24 ** -0.5, **kw)
        assert got.shape == (2, 9, 4, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar-pos", "vector-pos"])
def test_decode_attention_takes_mla_head_dims(vector):
    """ops.decode_attention at full-width minicpm3's absorbed head dims (dqk
    256 + 32, dv 256; 40 query heads over one KV head) over a short cache,
    against JAX's decode_attention_reference. Every row has a valid key
    (JAX averages v over a row with none; the port gives zeros)."""
    rng = np.random.default_rng(3)
    B, S, H = 3, 12, 40
    q, k = _randn(rng, B, 1, H, 288), _randn(rng, B, S, 1, 288)
    v = k[..., :256]                              # the latent part, as mla.py hands it over
    pos = np.array([0, 6, S - 1] if vector else 7, np.int32)
    want = jax_attn_ref.decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                                   jnp.asarray(v), jnp.asarray(pos),
                                                   scale=96 ** -0.5)
    got = attn_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(k)[..., :256], torch.from_numpy(pos),
                                    scale=96 ** -0.5)
    assert got.shape == (B, 1, H, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- serving
def test_engine_streams_equal_jax_engine_and_oracle(carried):
    """Greedy streams of the port's engine equal the JAX engine's (same
    carried weights, same prompts, same slot schedule) and the full-recompute
    oracle's."""
    jmodel, jparams, model = carried
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (6, 11, 3, 8)]
    theirs = JaxServeEngine(jmodel, jparams, max_batch=2, max_len=40)
    ours = ServeEngine(model, max_batch=2, max_len=40)
    jreqs = [theirs.submit(p, max_new_tokens=6) for p in prompts]
    treqs = [ours.submit(p, max_new_tokens=6) for p in prompts]
    theirs.run_until_drained(timeout=120)
    ours.run_until_drained(timeout=120)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert ours.steps == theirs.steps
    for p, r in zip(prompts, treqs):
        assert r.tokens == _greedy_reference(model, p, 6)
    assert set(ours.cache) == {"ckv", "krope"}


@pytest.fixture
def fabric(carried):
    """A service of one endpoint with a ``torch`` pool serving the model."""
    _, _, model = carried
    svc = FunctionService()
    spec = ContainerSpec(name="torch", capabilities={"cpu", "torch"}, min_workers=0,
                         max_workers=8)
    svc.make_endpoint("site0", n_executors=1, containers=[spec])
    try:
        yield svc, serve_model(svc, model, name="minicpm3", max_len=48, max_sessions=4,
                               window_s=0.05)
    finally:
        svc.shutdown()
        reset_serving()


def test_batched_fabric_host_matches_oracle(carried, fabric):
    """Three concurrent sessions on a batched host (one stacked MLA cache,
    coalesced steps, admission by cache_bytes): each stream equals the
    oracle's, and the steps coalesce."""
    _, _, model = carried
    svc, client = fabric
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 9, 7)]
    results = {}

    def user(k):
        results[k] = client.generate(prompts[k], max_new_tokens=6)

    threads = [threading.Thread(target=user, args=(k,)) for k in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, p in enumerate(prompts):
        assert results[k] == _greedy_reference(model, p, 6)
    counters = svc.metrics.snapshot()["counters"]
    assert counters["serving.prefills"] == 3
    assert 0 < counters["serving.decode_batches"] < 15            # 15 decode tasks coalesced
    assert svc.metrics.snapshot()["gauges"]["serving.cache_bytes"] == \
        cache_bytes(model.cfg, 4, 48)


def test_unbatched_host_writes_the_latent_cache(carried):
    """The unbatched host gives each session a private MLA cache of max_len
    positions; its decode writes land inside it."""
    _, _, model = carried
    host = ModelHost(model, max_len=48, max_sessions=2, batching=False)
    prompt = np.random.default_rng(6).integers(0, model.cfg.vocab, 6)
    toks = [host.prefill("s1", prompt)]
    history = list(prompt) + toks
    for _ in range(7):
        nxt, migrated = host.decode("s1", history)
        assert not migrated
        toks.append(nxt)
        history.append(nxt)
    assert toks == _greedy_reference(model, prompt, 8)
    ckv = host.sessions["s1"].cache["ckv"]
    assert ckv.shape == (model.cfg.n_layers, 1, 48, model.cfg.mla.kv_lora_rank)
    assert ckv[:, :, 6:13].abs().sum() > 0 and ckv[:, :, 13:].abs().sum() == 0


def test_serve_driver_serves_minicpm3(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device", "cpu",
                                      "--requests", "3", "--max-new-tokens", "4"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_info:
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    assert exit_info.value.code == 0
    assert "minicpm3-4b-reduced on cpu: 3 requests / 12 tokens" in out.getvalue()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_equal_jax(dtype):
    """The latent cache's size, (kv_lora + rope) a token a layer, as the
    reference counts it, at reduced and full width; full-width minicpm3-4b in
    bf16 holds (256 + 32) x 2 B x 62 layers a token: 292 MB at 8 x 1024."""
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_reduced(ARCH), jax_reduced(ARCH))):
        ours, theirs = ours.with_(dtype=dtype), theirs.with_(dtype=dtype)
        for batch, seq in ((8, 1024), (3, 100)):
            assert cache_bytes(ours, batch, seq) == jax_kv_cache.cache_bytes(theirs, batch, seq)
    if dtype == "bfloat16":
        assert cache_bytes(get_config(ARCH).with_(dtype=dtype), 8, 1024) == \
            62 * 8 * 1024 * 288 * 2
