"""The port's VLM family (internvl2-26b) against the JAX package's, on the CPU.

Reduced internvl2-26b (2 layers, d_model 64, 8 patches), JAX ``Model.init``
weights carried over by ``repro_torch.params``, the same numpy inputs from a
seed, each request's patches drawn ``standard_normal`` as
``repro.data.pipeline`` draws them: the weight tree with ``patch_proj``,
prefill logits and caches (2e-4 in f32) and the decode steps that follow at
positions n_patches + S + i (3e-4 in f32; 2e-2 in bf16, the reference's bf16
kernel tolerance), engine streams against the JAX ``Model.forward`` greedy
oracle with random patches (the JAX engine cannot serve this family, fault
F7), misplaced side inputs and prompts that do not fit, the unbatched fabric
host through a failover, the serve driver, ``cache_bytes``, ``cache_len_of``
and ``build_model``.
"""
import contextlib
import functools
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
from repro.models import model as jax_model_mod  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv_cache  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core import FunctionService, serializer  # noqa: E402
from repro_torch.core.containers import ContainerSpec  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import Model, build_model, cache_len_of  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.fabric import ModelHost, reset_serving, serve_model  # noqa: E402
from repro_torch.serving.kv_cache import cache_bytes, insert_sequence  # noqa: E402

ARCH = "internvl2-26b"
TOL = {"float32": (2e-4, 3e-4), "bfloat16": (2e-2, 2e-2)}   # (prefill, decode)


@functools.lru_cache(maxsize=None)
def _carried(dtype: str = "float32"):
    """(JAX model, JAX params, the port's model holding the same weights)."""
    jmodel = JaxModel(jax_reduced(ARCH).with_(dtype=dtype))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(ARCH).with_(dtype=dtype), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


def _patches(cfg, seed, n=None):
    """Standard normal patch embeddings, (n, P, d_model) (or (P, d_model)
    with n None), as ``repro.data.pipeline`` draws them."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_patches, cfg.d_model) if n is None else (n, cfg.n_patches, cfg.d_model)
    return rng.standard_normal(shape).astype(np.float32)


ORACLE_LEN = 40   # tokens the oracle's one compiled forward takes


@functools.lru_cache(maxsize=None)
def _jax_logits():
    """JAX ``Model.forward`` and the logits, compiled once over
    ORACLE_LEN tokens after the patches."""
    jmodel, jparams, _ = _carried()
    return jax.jit(lambda tokens, patches: jmodel._logits(
        jparams, jmodel.forward(jparams, {"tokens": tokens, "patches": patches})[0]))


@functools.lru_cache(maxsize=None)
def _oracle(prompt: tuple, seed, n_new: int) -> tuple:
    """The JAX ``Model.forward`` greedy oracle: full recompute over the
    patches (zeros for seed None) and the tokens so far, no cache. The
    model is causal, so a position's logits do not depend on the tokens
    after it: each step reads them from one forward over the tokens padded
    to ORACLE_LEN."""
    cfg = _carried()[0].cfg
    patches = (np.zeros((cfg.n_patches, cfg.d_model), np.float32) if seed is None
               else _patches(cfg, seed))
    toks, out = list(prompt), []
    for _ in range(n_new):
        padded = np.zeros((1, ORACLE_LEN), np.int32)
        padded[0, :len(toks)] = toks
        logits = _jax_logits()(jnp.asarray(padded), jnp.asarray(patches[None]))
        nxt = int(jnp.argmax(logits[0, cfg.n_patches + len(toks) - 1]))
        out.append(nxt)
        toks.append(nxt)
    return tuple(out)


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, cfg.vocab, n)) for n in lengths]


# ---------------------------------------------------------------- weights
def test_patch_proj_and_the_whole_tree_carry_across():
    """``params.to_state_dict`` flattens the bare top-level ``patch_proj``
    to the key ``patch_proj`` (the JAX pytree path): every leaf lands with
    its shape, dtype and values."""
    _, jparams, model = _carried()
    flat = tparams.flatten(jax.tree.map(np.asarray, jparams))
    sd = model.state_dict()
    assert set(sd) == set(flat) and "patch_proj" in sd
    for name, a in flat.items():
        assert tuple(sd[name].shape) == a.shape, name
        np.testing.assert_array_equal(sd[name].numpy(), a, err_msg=name)
    assert model.params["patch_proj"].shape == (model.cfg.d_model, model.cfg.d_model)


def test_init_draws_patch_proj_like_the_reference_recipe():
    """The bare top-level leaf is drawn in place like the rest (the
    reference's ``dense_init``: normal at 1/sqrt(d_model), model dtype), and
    the same seed draws the same weights."""
    cfg = get_reduced(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    w = model.params["patch_proj"]
    assert w.dtype == torch.bfloat16 and w.shape == (cfg.d_model, cfg.d_model)
    assert abs(w.float().std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_with_random_patches_match_jax(dtype):
    """Both packages' prefill of two requests, each with its own patches
    (logits and every cache leaf over n_patches + S positions), then
    teacher-forced decode steps in lockstep at positions P + S + i."""
    jmodel, jparams, model = _carried(dtype)
    cfg = model.cfg
    tol_p, tol_d = TOL[dtype]
    P, B, S, steps = cfg.n_patches, 2, 7, 6
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S + steps)).astype(np.int32)
    patches = _patches(cfg, 2, B)
    jlogits, jseq = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S]),
                                             "patches": jnp.asarray(patches)})
    with torch.inference_mode():
        logits, seq = model.prefill({"tokens": torch.from_numpy(tokens[:, :S]),
                                     "patches": torch.from_numpy(patches)})
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    np.testing.assert_allclose(logits.float().numpy(), f32(jlogits), rtol=tol_p, atol=tol_p)
    assert set(seq) == set(jseq) == {"k", "v"}
    for name, t in seq.items():
        assert t.shape == jseq[name].shape == (cfg.n_layers, B, P + S, cfg.n_kv_heads, cfg.hd)
        np.testing.assert_allclose(t.float().numpy(), f32(jseq[name]), rtol=tol_p, atol=tol_p,
                                   err_msg=name)
    total = P + S + steps
    jcache, _ = jmodel.init_cache(B, total)
    jcache = jax.tree.map(lambda z, c: z.at[:, :, :c.shape[2]].set(c), jcache, jseq)
    with torch.inference_mode():
        cache = model.init_cache(B, total)
        for b in range(B):
            insert_sequence(cache, {k: v[:, b:b + 1] for k, v in seq.items()}, b,
                            model.cache_batch_axes())
        for i in range(steps - 1):
            pos = P + S + i
            tok = tokens[:, S + i:S + i + 1]
            jlogits, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                                 jnp.int32(pos))
            logits, cache = model.decode_step(torch.from_numpy(tok), cache,
                                              torch.tensor(pos, dtype=torch.int32))
            np.testing.assert_allclose(logits.float().numpy(), f32(jlogits), rtol=tol_d,
                                       atol=tol_d, err_msg=f"decode step {i} at {pos}")


# -------------------------------------------------------------- serving
def test_engine_streams_equal_the_jax_forward_oracle():
    """Each request carries its own patches (numpy or a tensor) through
    admission; every slot decodes at n_patches + its prompt's length on."""
    _, _, model = _carried()
    cfg = model.cfg
    prompts = _prompts(cfg, 3, (6, 11, 3, 8))
    seeds = (10, 11, 12, 13)
    engine = ServeEngine(model, max_batch=2, max_len=cfg.n_patches + 24)
    reqs = [engine.submit(np.array(p), max_new_tokens=6,
                          patches=_patches(cfg, s) if i != 1 else
                          torch.from_numpy(_patches(cfg, s)))
            for i, (p, s) in enumerate(zip(prompts, seeds))]
    engine._admit()
    assert list(engine.slot_pos) == [cfg.n_patches + 6, cfg.n_patches + 11]
    engine.run_until_drained(timeout=120)
    for p, s, r in zip(prompts, seeds, reqs):
        assert tuple(r.tokens) == _oracle(p, s, 6)


def test_a_request_without_patches_is_one_with_zero_patches():
    """No patches prefills on zeros (what the serve driver serves); random
    patches reach the logits and give another stream."""
    _, _, model = _carried()
    cfg = model.cfg
    prompt = _prompts(cfg, 4, (5,))[0]
    engine = ServeEngine(model, max_batch=2, max_len=cfg.n_patches + 16)
    none = engine.generate(np.array(prompt), max_new_tokens=6)
    zeros = engine.generate(np.array(prompt), max_new_tokens=6,
                            patches=np.zeros((cfg.n_patches, cfg.d_model), np.float32))
    rand = engine.generate(np.array(prompt), max_new_tokens=6, patches=_patches(cfg, 14))
    assert tuple(none) == tuple(zeros) == _oracle(prompt, None, 6)
    assert tuple(rand) == _oracle(prompt, 14, 6) and rand != none


def test_misplaced_side_inputs_and_prompts_that_do_not_fit_raise():
    _, _, model = _carried()
    cfg = model.cfg
    engine = ServeEngine(model, max_batch=1, max_len=cfg.n_patches + 8)
    with pytest.raises(ValueError, match="patches must be"):
        engine.submit([1, 2], patches=np.zeros((3, cfg.d_model), np.float32))
    with pytest.raises(ValueError, match="takes no frames"):
        engine.submit([1, 2], frames=np.zeros((4, cfg.d_model), np.float32))
    dense = Model(get_reduced("qwen2-0.5b").with_(dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="takes no patches"):
        ServeEngine(dense, max_batch=1, max_len=16).submit(
            [1, 2], patches=np.zeros((cfg.n_patches, cfg.d_model), np.float32))
    # P + len(prompt) must leave a position of max_len free
    with pytest.raises(ValueError, match="do not fit in max_len"):
        engine.submit(np.arange(8))
    engine.submit(np.arange(7))
    host = ModelHost(model, max_len=cfg.n_patches + 8, max_sessions=1)
    with pytest.raises(ValueError, match="do not fit in max_len"):
        host.prefill("s", np.arange(8))
    assert not host.sessions and host._free == {0}


@pytest.fixture
def fabric():
    """A service of two endpoints, each a ``torch`` pool, serving the model."""
    _, _, model = _carried()
    svc = FunctionService()
    spec = ContainerSpec(name="torch", capabilities={"cpu", "torch"}, min_workers=0,
                         max_workers=8)
    eps = [svc.make_endpoint(f"site{i}", n_executors=1, containers=[spec]) for i in range(2)]
    try:
        yield svc, eps, serve_model(svc, model, name="internvl2",
                                    max_len=model.cfg.n_patches + 32, max_sessions=4)
    finally:
        svc.shutdown()
        reset_serving()


def test_fabric_session_failover_reprefills_with_its_own_patches(fabric):
    """The unbatched host (the reference batches only dense and moe): a
    session with random patches, its endpoint killed after two steps,
    re-prefills on the survivor with its own patches; its stream equals the
    oracle's over those patches. The patches travel once, by content key."""
    _, _, model = _carried()
    svc, eps, client = fabric
    by_id = {e.endpoint_id: e for e in eps}
    prompt = _prompts(model.cfg, 5, (6,))[0]
    sent = []
    call = client._call

    def recording(which, doc, **kw):
        sent.append((which, doc))
        return call(which, doc, **kw)

    client._call = recording
    s = client.session(np.array(prompt), patches=_patches(model.cfg, 15))
    s.step()
    s.step()
    home = s.endpoints[-1]
    host = by_id[home].site.get_or_create(("serving-host", "internvl2"), None)
    assert not host.batching and host.sessions[s.session_id].pos == model.cfg.n_patches + 8
    by_id[home].kill()
    assert home in svc.forwarder.check_endpoints()
    for _ in range(3):
        s.step()
    assert s.migrations == 1 and s.endpoints[-1] != home
    assert tuple(s.tokens) == _oracle(prompt, 15, 6)
    key = s.side_ref["patches"]
    for which, doc in sent:
        assert doc["patches"] == key and isinstance(doc["patches_store"], str), which
        assert "frames" not in doc and len(serializer.packb(doc)) < 1024, which
    s.close()
    assert key not in client._side_store                 # dropped with its last session


def test_fabric_stream_stops_at_max_len_counting_the_patches(fabric):
    """A session's stream ends where its cache does: n_patches + history
    reaches max_len - 1; the tokens equal the oracle's (zero patches)."""
    _, _, model = _carried()
    _, _, client = fabric
    prompt = _prompts(model.cfg, 6, (20,))[0]
    toks = client.generate(np.array(prompt), max_new_tokens=50)
    assert len(prompt) + len(toks) == 32 - 1
    assert tuple(toks) == _oracle(prompt, None, len(toks))


def test_serve_driver_serves_internvl2(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device", "cpu",
                                      "--requests", "3", "--max-new-tokens", "4"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_info:
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    assert exit_info.value.code == 0
    assert "internvl2-26b-reduced on cpu: 3 requests / 12 tokens" in out.getvalue()


# --------------------------------------------------------------- helpers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_equal_jax(dtype):
    """The dense branch over seq_len positions, the patches among them:
    full-width internvl2-26b at 8 x 1024 holds 1,610,612,736 bytes in bf16."""
    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_reduced(ARCH), jax_reduced(ARCH))):
        ours, theirs = ours.with_(dtype=dtype), theirs.with_(dtype=dtype)
        for batch, seq in ((8, 1024), (1, 768), (3, 100)):
            assert cache_bytes(ours, batch, seq) == jax_kv_cache.cache_bytes(theirs, batch, seq)
    if dtype == "bfloat16":
        assert cache_bytes(get_config(ARCH), 8, 1024) == 1_610_612_736


@pytest.mark.parametrize("arch", ["internvl2-26b", "qwen2-0.5b", "minicpm3-4b",
                                  "mamba2-2.7b", "zamba2-2.7b", "whisper-small"])
def test_cache_len_of_equals_jax(arch):
    """The reference reads ``cache["k"]``'s axis 2, else its first leaf's in
    JAX's flatten order (the ssm's conv tail, the MLA latent, the hybrid's
    attention keys)."""
    jcache, _ = JaxModel(jax_reduced(arch)).init_cache(2, 12)
    cache = Model(get_reduced(arch), device="cpu").init_cache(2, 12)
    assert cache_len_of(cache) == jax_model_mod.cache_len_of(jcache)


def test_build_model_caches_one_model_per_config():
    """One model per frozen config (and device), as the reference's
    ``build_model`` caches one per config; its weight tree is the JAX
    model's."""
    cfg = get_reduced(ARCH)
    try:
        m = build_model(cfg, device="cpu")
        assert build_model(cfg, device="cpu") is m
        assert build_model(cfg.with_(n_layers=1), device="cpu") is not m
        assert jax_model_mod.build_model(jax_reduced(ARCH)) is \
            jax_model_mod.build_model(jax_reduced(ARCH))
        shapes = jax.tree.map(lambda a: a.shape,
                              jax_model_mod.build_model(jax_reduced(ARCH)).abstract_params())
        assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == \
            tparams.flatten(shapes)
    finally:
        model_mod.build_model.cache_clear()
