"""The port's encoder-decoder family (whisper-small) against the JAX package's, on the CPU.

Reduced whisper-small in f32, JAX ``Model.init`` weights carried over by
``repro_torch.params``, the same numpy inputs from a seed: the layers
(LayerNorm, sinusoidal positions, GELU MLP), the encoder and cross-decoder
blocks, the model's prefill with random frames (2e-4) and the decode that
follows (3e-4), greedy streams against the JAX engine at zero frames (the
only frames it sends, fault F9) and against the ``Model.forward`` oracle with
random frames, the unbatched fabric host through a failover, the serve
driver, ``cache_bytes`` and the bf16 carry-over of the LayerNorm bias.
"""
import contextlib
import io
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv_cache  # noqa: E402
from repro.serving.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import FunctionService, serializer  # noqa: E402
from repro_torch.core.containers import ContainerSpec  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.fabric import ModelHost, reset_serving, serve_model  # noqa: E402
from repro_torch.serving.kv_cache import cache_bytes, insert_sequence  # noqa: E402

ARCH = "whisper-small"
TOL = 2e-5   # one block in f32: the two packages sum in another order


@pytest.fixture(scope="module")
def carried():
    """(JAX model, JAX params, the port's model holding the same weights)."""
    jmodel = JaxModel(jax_reduced(ARCH).with_(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(ARCH).with_(dtype="float32"), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _layer(jparams, model, stack, i=0):
    """Layer i of a stack ("enc_layers" or "layers"): the JAX leaves and the
    port's views."""
    jp = jax.tree.map(lambda a: a[i], jparams[stack])
    views = model._enc_layer_params if stack == "enc_layers" else model._layer_params
    return jp, views[i]


def _frames(model, seed):
    cfg = model.cfg
    return _randn(np.random.default_rng(seed), cfg.enc_seq, cfg.d_model)


@torch.inference_mode()
def _greedy_reference(model, prompt, n_new, frames=None):
    """Sequential full-recompute greedy decoding (no cache) over `frames`
    (zeros when None): the oracle."""
    cfg = model.cfg
    frames = np.zeros((cfg.enc_seq, cfg.d_model), np.float32) if frames is None else frames
    toks = list(np.asarray(prompt, np.int64))
    out = []
    for _ in range(n_new):
        h, _ = model({"tokens": torch.tensor([toks]), "frames": torch.from_numpy(frames)[None]})
        nxt = int(torch.argmax(model._logits(h)[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = _randn(rng, 3, 5, 64) * 3 + 1
    p = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32), "bias": _randn(rng, 64)}
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 1e-5),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}[dtype]
    want = jax_layers.layernorm(jnp.asarray(x, jdt), jax.tree.map(jnp.asarray, p))
    got = layers.layernorm(torch.from_numpy(x).to(tdt), {k: torch.from_numpy(v)
                                                         for k, v in p.items()})
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d", [(24, 64), (448, 768), (1500, 768)])
def test_sinusoidal_positions_match_jax(n, d):
    """The [sin | cos] table against JAX's, to within the f32 rounding of the
    angle: XLA's exp and sin round differently from torch's by an ulp, and an
    ulp of the angle at position p is ~p * 6e-8."""
    want = np.asarray(jax_layers.sinusoidal_positions(n, d))
    got = layers.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=n * 1.2e-7 + 1e-6)
    # and exactly what the reference's recipe gives in float64, rounded once
    half = d // 2
    inv = np.exp(-np.log(10000.0) / max(half - 1, 1) * np.arange(half))
    scaled = np.arange(n)[:, None] * inv[None, :]
    exact = np.concatenate([np.sin(scaled), np.cos(scaled)], -1)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=n * 1.2e-7 + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_table_is_the_table_of_the_cache_length(carried, dtype):
    """The decode step's table, built once per cache length by init_cache, is
    bit for bit ``sinusoidal_positions(cache_len, d)`` cast to the model
    dtype; its rows do not depend on the table's length."""
    _, _, model = carried
    m = Model(model.cfg.with_(dtype=dtype), device="cpu")
    m.init_cache(2, 40)
    table = m._pos_tables[40]
    want = layers.sinusoidal_positions(40, m.cfg.d_model).to(getattr(torch, dtype))
    assert torch.equal(table, want)
    assert torch.equal(layers.sinusoidal_positions(1500, m.cfg.d_model)[:40],
                       layers.sinusoidal_positions(40, m.cfg.d_model))
    m.init_cache(1, 40)
    assert m._pos_tables[40] is table            # built once per length


def test_gelu_mlp_matches_jax(carried):
    _, jparams, model = carried
    jp, p = _layer(jparams, model, "layers")
    x = _randn(np.random.default_rng(1), 2, 7, model.cfg.d_model)
    want = jax_layers.gelu_mlp(jnp.asarray(x), jp["mlp"])
    with torch.inference_mode():
        got = layers.gelu_mlp(torch.from_numpy(x), p["mlp"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- blocks
def test_encoder_layer_matches_jax(carried):
    jmodel, jparams, model = carried
    jp, p = _layer(jparams, model, "enc_layers", 1)
    x = _randn(np.random.default_rng(2), 2, model.cfg.enc_seq, model.cfg.d_model)
    want = jax_blocks.encoder_layer(jp, jnp.asarray(x), jmodel.cfg)
    with torch.inference_mode():
        got = blocks.encoder_layer(p, torch.from_numpy(x), model.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_cross_decoder_layer_matches_jax(carried):
    jmodel, jparams, model = carried
    cfg = model.cfg
    jp, p = _layer(jparams, model, "layers", 1)
    rng = np.random.default_rng(3)
    x, enc = _randn(rng, 2, 9, cfg.d_model), _randn(rng, 2, cfg.enc_seq, cfg.d_model)
    want, (want_self, want_cross) = jax_blocks.cross_decoder_layer(
        jp, jnp.asarray(x), jnp.asarray(enc), jmodel.cfg)
    with torch.inference_mode():
        got, (self_kv, cross_kv) = blocks.cross_decoder_layer(
            p, torch.from_numpy(x), torch.from_numpy(enc), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for ours, theirs in zip((*self_kv, *cross_kv), (*want_self, *want_cross)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=TOL, atol=TOL)
    assert cross_kv[0].shape == (2, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar-pos", "vector-pos"])
def test_cross_decoder_layer_decode_matches_jax(carried, vector):
    """One token on random caches: the output, k and v written at pos (in
    place here, returned anew by JAX), the cross leaves only read."""
    jmodel, jparams, model = carried
    cfg = model.cfg
    jp, p = _layer(jparams, model, "layers")
    rng = np.random.default_rng(4)
    B, S, KV, hd = 3, 20, cfg.n_kv_heads, cfg.hd
    x = _randn(rng, B, 1, cfg.d_model)
    cache = {"k": _randn(rng, B, S, KV, hd), "v": _randn(rng, B, S, KV, hd),
             "cross_k": _randn(rng, B, cfg.enc_seq, KV, hd),
             "cross_v": _randn(rng, B, cfg.enc_seq, KV, hd)}
    pos = np.array([4, 11, 19], np.int32) if vector else np.int32(9)
    want, want_cache = jax_blocks.cross_decoder_layer_decode(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), jnp.asarray(pos), jmodel.cfg)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.inference_mode():
        got, out_cache = blocks.cross_decoder_layer_decode(
            p, torch.from_numpy(x), tcache, torch.from_numpy(np.asarray(pos)), cfg)
    assert out_cache is tcache and out_cache["k"] is tcache["k"]    # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(want_cache[name]),
                                   rtol=TOL, atol=TOL)
    for name in ("cross_k", "cross_v"):
        assert np.array_equal(tcache[name].numpy(), cache[name])
    changed = np.abs(tcache["k"].numpy() - cache["k"]).sum((-1, -2)) > 0
    rows = np.arange(B) if vector else slice(None)
    assert changed[rows, pos].all() and changed.sum() == B


# ---------------------------------------------------------------- model
def test_prefill_and_decode_with_random_frames_match_jax(carried):
    """Both packages' prefill over random frames (logits 2e-4, every cache
    leaf), then teacher-forced decode steps in lockstep with vector positions
    (3e-4), rows at different lengths."""
    jmodel, jparams, model = carried
    cfg = model.cfg
    rng = np.random.default_rng(5)
    B, S = 2, 24
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = _randn(rng, B, cfg.enc_seq, cfg.d_model)
    starts = [14, 9]
    jcache, _ = jmodel.init_cache(B, S)
    with torch.inference_mode():
        cache = model.init_cache(B, S)
        for row, n in enumerate(starts):
            jbatch = {"tokens": jnp.asarray(tokens[row:row + 1, :n]),
                      "frames": jnp.asarray(frames[row:row + 1])}
            jlogits, jseq = jmodel.prefill(jparams, jbatch)
            logits, seq = model.prefill({"tokens": torch.from_numpy(tokens[row:row + 1, :n]),
                                         "frames": torch.from_numpy(frames[row:row + 1])})
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
            assert set(seq) == set(jseq) == {"k", "v", "cross_k", "cross_v"}
            for name, t in seq.items():
                assert t.shape == jseq[name].shape, name
                np.testing.assert_allclose(t.numpy(), np.asarray(jseq[name]), rtol=2e-4,
                                           atol=2e-4, err_msg=name)
            jcache = jax_kv_cache.insert_sequence(jcache, jseq, row)
            insert_sequence(cache, seq, row, model.cache_batch_axes())
        for i in range(S - max(starts) - 1):
            pos = np.array([n + i for n in starts], np.int32)
            tok = tokens[np.arange(B), pos][:, None]
            jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                                 jnp.asarray(pos))
            logits, cache = model.decode_step(torch.from_numpy(tok), cache, torch.from_numpy(pos))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=3e-4,
                                       atol=3e-4, err_msg=f"decode step {i}")


def test_frames_change_the_stream(carried):
    """The frames reach the logits: the same prompt over random frames and
    over zeros gives other tokens (what the F9 checks below rely on)."""
    _, _, model = carried
    prompt = np.random.default_rng(6).integers(0, model.cfg.vocab, 5)
    assert _greedy_reference(model, prompt, 6, _frames(model, 7)) != \
        _greedy_reference(model, prompt, 6)


# -------------------------------------------------------------- serving
def test_engine_streams_equal_jax_engine_at_zero_frames(carried):
    """Greedy streams of the port's engine equal the JAX engine's (which
    prefills every encdec request on zero frames) and the oracle's."""
    jmodel, jparams, model = carried
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (6, 11, 3, 8)]
    theirs = JaxServeEngine(jmodel, jparams, max_batch=2, max_len=32)
    ours = ServeEngine(model, max_batch=2, max_len=32)
    jreqs = [theirs.submit(p, max_new_tokens=6) for p in prompts]
    treqs = [ours.submit(p, max_new_tokens=6) for p in prompts]
    theirs.run_until_drained(timeout=120)
    ours.run_until_drained(timeout=120)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert ours.steps == theirs.steps
    for p, r in zip(prompts, treqs):
        assert r.tokens == _greedy_reference(model, p, 6)
    assert set(ours.cache) == {"k", "v", "cross_k", "cross_v"}


def test_engine_streams_equal_oracle_with_random_frames(carried):
    """F9 repaired: each request carries its own frames (numpy or a tensor)
    through admission into its slot's cross leaves."""
    _, _, model = carried
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 9, 4)]
    frames = [_frames(model, 10 + i) for i in range(3)]
    engine = ServeEngine(model, max_batch=2, max_len=32)
    reqs = [engine.submit(p, max_new_tokens=6, frames=f if i != 1 else torch.from_numpy(f))
            for i, (p, f) in enumerate(zip(prompts, frames))]
    engine.run_until_drained(timeout=120)
    for p, f, r in zip(prompts, frames, reqs):
        assert r.tokens == _greedy_reference(model, p, 6, f)


def test_engine_rejects_misplaced_frames(carried):
    _, _, model = carried
    engine = ServeEngine(model, max_batch=1, max_len=16)
    with pytest.raises(ValueError, match="frames must be"):
        engine.submit([1, 2], frames=np.zeros((3, model.cfg.d_model), np.float32))
    dense = Model(get_reduced("qwen2-0.5b").with_(dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="takes no frames"):
        ServeEngine(dense, max_batch=1, max_len=16).submit(
            [1, 2], frames=np.zeros((4, 4), np.float32))


@pytest.fixture
def fabric(carried):
    """A service of two endpoints, each a ``torch`` pool, serving the model."""
    _, _, model = carried
    svc = FunctionService()
    spec = ContainerSpec(name="torch", capabilities={"cpu", "torch"}, min_workers=0,
                         max_workers=8)
    eps = [svc.make_endpoint(f"site{i}", n_executors=1, containers=[spec]) for i in range(2)]
    try:
        yield svc, eps, serve_model(svc, model, name="whisper", max_len=32, max_sessions=4)
    finally:
        svc.shutdown()
        reset_serving()


def test_fabric_session_failover_reprefills_with_its_own_frames(carried, fabric):
    """The unbatched host (encdec is not batched, as in the reference): a
    session with random frames, its endpoint killed after two steps,
    re-prefills on the survivor with its own frames; its stream equals the
    oracle's over those frames. The frames travel once, by content key: each
    task carries the key and the store's id as plain strings."""
    _, _, model = carried
    svc, eps, client = fabric
    by_id = {e.endpoint_id: e for e in eps}
    prompt = np.random.default_rng(11).integers(0, model.cfg.vocab, 6)
    frames = _frames(model, 12)
    sent = []
    call = client._call

    def recording(which, doc, **kw):
        sent.append((which, doc))
        return call(which, doc, **kw)

    client._call = recording
    s = client.session(prompt, frames=frames)
    s.step()
    s.step()
    home = s.endpoints[-1]
    by_id[home].kill()
    assert home in svc.forwarder.check_endpoints()
    for _ in range(3):
        s.step()
    assert s.migrations == 1 and s.endpoints[-1] != home
    assert s.tokens == _greedy_reference(model, prompt, 6, frames)
    counters = svc.metrics.snapshot()["counters"]
    assert counters["serving.cache_migrations"] == 1
    key = s.side_ref["frames"]
    for which, doc in sent:
        assert doc["frames"] == key and isinstance(doc["frames_store"], str), which
        assert len(serializer.packb(doc)) < 1024, which    # no frame bytes in a task
    assert [w for w, _ in sent] == ["prefill"] + ["decode"] * 5
    s.close()
    assert key not in client._side_store                # dropped with its last session


def test_fabric_streams_with_and_without_frames(carried, fabric):
    """Through the fabric, a session without frames prefills on zeros (the
    reference's stream), one with frames on its own."""
    _, _, model = carried
    _, _, client = fabric
    prompt = np.random.default_rng(13).integers(0, model.cfg.vocab, 7)
    frames = _frames(model, 14)
    assert client.generate(prompt, max_new_tokens=5) == _greedy_reference(model, prompt, 5)
    assert client.generate(prompt, max_new_tokens=5, frames=frames) == \
        _greedy_reference(model, prompt, 5, frames)


def test_unbatched_host_cache_holds_max_len_and_the_cross_leaves(carried):
    _, _, model = carried
    cfg = model.cfg
    host = ModelHost(model, max_len=32, max_sessions=2)
    assert not host.batching                                 # encdec serves unbatched
    prompt = np.random.default_rng(15).integers(0, cfg.vocab, 6)
    frames = _frames(model, 16)
    toks = [host.prefill("s1", prompt, {"frames": frames})]
    history = list(prompt) + toks
    for _ in range(4):
        nxt, migrated = host.decode("s1", history)
        assert not migrated
        toks.append(nxt)
        history.append(nxt)
    assert toks == _greedy_reference(model, prompt, 5, frames)
    cache = host.sessions["s1"].cache
    assert cache["k"].shape == (cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.hd)
    assert cache["cross_k"].shape == (cfg.n_layers, 1, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    assert cache["k"][:, :, 6:10].abs().sum() > 0 and cache["k"][:, :, 10:].abs().sum() == 0


def test_serve_driver_serves_whisper(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device", "cpu",
                                      "--requests", "3", "--max-new-tokens", "4"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_info:
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    assert exit_info.value.code == 0
    assert "whisper-small-reduced on cpu: 3 requests / 12 tokens" in out.getvalue()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_equal_jax(dtype):
    """Self k/v over seq_len positions and cross k/v over enc_seq frames, as
    the reference's live branch counts them; full-width whisper-small at
    B = 1, S = 448 holds 71,811,072 bytes in bf16."""
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_reduced(ARCH), jax_reduced(ARCH))):
        ours, theirs = ours.with_(dtype=dtype), theirs.with_(dtype=dtype)
        for batch, seq in ((8, 448), (1, 448), (3, 100)):
            assert cache_bytes(ours, batch, seq) == jax_kv_cache.cache_bytes(theirs, batch, seq)
    if dtype == "bfloat16":
        assert cache_bytes(get_config(ARCH).with_(dtype=dtype), 1, 448) == 71_811_072


def test_to_state_dict_keeps_the_layernorm_bias_fp32(carried):
    _, jparams, _ = carried
    sd = tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu", dtype=torch.bfloat16)
    for name in ("final_norm.bias", "enc_norm.bias", "layers.ln1.bias", "layers.ln3.bias",
                 "enc_layers.ln2.bias", "final_norm.scale", "layers.ln2.scale"):
        assert sd[name].dtype == torch.float32, name
    for name in ("layers.self.wq", "layers.cross.wk", "layers.mlp.bi", "layers.mlp.bo",
                 "enc_layers.mlp.wi", "embed.tok", "unembed.w"):
        assert sd[name].dtype == torch.bfloat16, name
