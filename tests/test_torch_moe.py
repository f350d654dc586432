"""The port's MoE family (``repro_torch.models.moe``) against the JAX package's.

Reduced qwen2-moe-a2.7b (60 experts top-4 cut to 6 top-2, with shared experts
and their sigmoid gate) and reduced qwen3-moe-235b-a22b (8 experts top-2,
``qk_norm``, no shared experts), f32, the JAX weights carried over, the same
numpy inputs through both packages:

- ``_capacity`` and ``build_dispatch`` equal exactly (``gather_idx``,
  ``combine_w``, ``assign_slot``, C), from the same top-k ids and weights;
  ``route``'s top-k ids equal exactly, its weights and probabilities within
  1e-6 (the router product and the softmax's exp come from other libraries,
  so their last bits differ);
- ``moe_ffn``'s output and aux at 2e-5, for both ``moe_combine`` values, at
  the published capacity with assignments dropped;
- prefill logits at 2e-4, decode logits at 3e-4 and the forward's aux, at
  capacity factor 8.0 and at the published one;
- the engine's greedy streams equal the JAX engine's exactly at both;
- a batched fabric host gives every session its tokens, and the serve
  driver serves the MoE through ``FunctionService``.
"""
import contextlib
import dataclasses
import functools
import io
import runpy
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.fabric import ModelHost  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
CAPACITIES = ("published", 8.0)
B, S, PREFILL = 2, 24, 16


def _with_capacity(cfg, capacity):
    if capacity == "published":
        return cfg
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))


@functools.lru_cache(maxsize=None)
def _pair(arch: str, capacity="published"):
    """(JAX model, JAX params, the port's model with the same weights), f32."""
    jmodel = JaxModel(_with_capacity(jax_reduced(arch).with_(dtype="float32"), capacity))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(_with_capacity(get_reduced(arch).with_(dtype="float32"), capacity),
                  device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


def _layer0_ffn(jparams):
    """Layer 0's ffn weights: the JAX tree (numpy leaves) and the port's tensors."""
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jparams["layers"]["ffn"])
    tp = jax.tree.map(torch.from_numpy, jax.tree.map(np.array, jp))
    return jp, tp


def _x(cfg, T, seed=0):
    return np.random.default_rng(seed).standard_normal((T, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_tokens", [1, 2, 7, 8, 48, 100, 1000])
def test_capacity_equals_reference(arch, n_tokens):
    for capacity in CAPACITIES:
        m = _with_capacity(get_reduced(arch), capacity).moe
        assert moe._capacity(n_tokens, m) == jax_moe._capacity(n_tokens, m)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_reference(arch):
    jmodel, jparams, _ = _pair(arch)
    m = jmodel.cfg.moe
    jp, tp = _layer0_ffn(jparams)
    x = _x(jmodel.cfg, 96)
    jw, ji, jprobs = jax_moe.route(jnp.asarray(x), jnp.asarray(jp["router"]), m)
    tw, ti, tprobs = moe.route(torch.from_numpy(x), tp["router"], m)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)


def test_route_takes_full_fp32_products_whatever_the_caller_set(monkeypatch):
    """With TF32 allowed by the caller, the router product still runs at
    "highest" precision, and the caller's setting is back afterwards."""
    jmodel, jparams, _ = _pair("qwen2-moe-a2.7b")
    _, tp = _layer0_ffn(jparams)
    seen = []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        moe.route(torch.from_numpy(_x(jmodel.cfg, 8)), tp["router"], jmodel.cfg.moe)
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_tokens", [3, 40, 200])
def test_build_dispatch_equals_reference(arch, n_tokens):
    """The same top-k ids and weights in: every output equal exactly; the
    200-token case skews the routing towards expert 1, so assignments drop."""
    m = get_reduced(arch).moe
    rng = np.random.default_rng(n_tokens)
    logits = rng.standard_normal((n_tokens, m.n_experts)).astype(np.float32)
    if n_tokens == 200:
        logits[:, 1] += 2.0
    topw, topi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), m.top_k)
    theirs = jax_moe.build_dispatch(topi, topw, n_tokens, m)
    ours = moe.build_dispatch(torch.from_numpy(np.array(topi)),
                              torch.from_numpy(np.array(topw)), n_tokens, m)
    gather_idx, combine_w, C, assign_slot = ours
    assert C == theirs[2]
    np.testing.assert_array_equal(gather_idx.numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(combine_w.numpy(), np.asarray(theirs[1]))
    np.testing.assert_array_equal(assign_slot.numpy(), np.asarray(theirs[3]))
    if n_tokens == 200:
        assert int((assign_slot == m.n_experts * C).sum()) > 0


# ------------------------------------------------------------ moe_ffn
@pytest.mark.parametrize("combine", ["scatter", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, combine):
    """At the published reduced capacity over 2 x 60 tokens, every token
    leaning towards expert 0 (its router column added to the input): expert
    0 overflows, so assignments drop and the drop path runs."""
    jmodel, jparams, _ = _pair(arch)
    cfg = jmodel.cfg.with_(moe_combine=combine)
    jp, tp = _layer0_ffn(jparams)
    lean = jp["router"][:, 0] / np.linalg.norm(jp["router"][:, 0])
    x = (_x(cfg, 120, seed=1) + 3.0 * lean).astype(np.float32).reshape(2, 60, cfg.d_model)
    jy, jaux = jax_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, jp), cfg)
    y, aux = moe.moe_ffn(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-5, atol=2e-5)
    _, topi, _ = moe.route(torch.from_numpy(x.reshape(120, -1)), tp["router"], cfg.moe)
    _, _, C, assign_slot = moe.build_dispatch(topi, torch.ones(topi.shape), 120, cfg.moe)
    assert int((assign_slot == cfg.moe.n_experts * C).sum()) > 0, "nothing dropped"


def test_combine_adds_in_slot_order_in_bf16():
    """bf16: each token's contributions, rounded to bf16, added in increasing
    slot order, as the reference's scatter-add applies them on the CPU."""
    rng = np.random.default_rng(3)
    E, C, T, k, D = 4, 8, 10, 3, 16
    ye = torch.from_numpy(rng.standard_normal((E * C, D)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.uniform(0.1, 0.9, E * C).astype(np.float32))
    assign = torch.from_numpy(np.stack([rng.permutation(E * C + 1)[:k] for _ in range(T)]))
    y = moe._combine_in_slot_order(ye, w, assign)
    for t in range(T):
        want = torch.zeros(D, dtype=torch.bfloat16)
        for s in sorted(assign[t].tolist()):
            if s < E * C:
                want = want + ye[s] * w[s].bfloat16()
        assert torch.equal(y[t], want), t


# ------------------------------------------------------------- the model
def _blit(cache, seq_cache):
    for name, dst in cache.items():
        src = seq_cache[name]
        dst[tuple(slice(0, n) for n in src.shape)] = src


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_matches_reference(arch, capacity):
    jmodel, jparams, model = _pair(arch, capacity)
    tokens = np.random.default_rng(0).integers(0, jmodel.cfg.vocab, (B, S)).astype(np.int32)
    h, aux = jmodel.forward(jparams, {"tokens": tokens})
    with torch.inference_mode():
        th, taux = model({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(model._logits(th).numpy(), np.asarray(jmodel._logits(jparams, h)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(taux), float(aux), rtol=2e-4, atol=2e-4)
    assert float(aux) > 0.0


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, capacity):
    """The JAX ``prefill`` and ``decode_step`` against the port's on the same
    tokens (so both drop the same assignments): the prefill logits at 2e-4,
    each vector-position decode step at 3e-4."""
    jmodel, jparams, model = _pair(arch, capacity)
    tokens = np.random.default_rng(1).integers(0, jmodel.cfg.vocab, (B, S)).astype(np.int32)
    jlogits, jseq = jax.jit(jmodel.prefill)(jparams, {"tokens": tokens[:, :PREFILL]})
    jcache, _ = jmodel.init_cache(B, S)
    jcache = jax.tree.map(lambda full, part: full.at[tuple(slice(0, n) for n in part.shape)]
                          .set(part), jcache, jseq)
    jdecode = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        logits, seq = model.prefill({"tokens": torch.from_numpy(tokens[:, :PREFILL])})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
        cache = model.init_cache(B, S)
        _blit(cache, seq)
        for i in range(S - PREFILL):
            tok = tokens[:, PREFILL + i:PREFILL + i + 1]
            pos = np.full((B,), PREFILL + i, np.int32)
            jlogits, jcache = jdecode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos))
            logits, cache = model.decode_step(torch.from_numpy(tok), cache,
                                              torch.from_numpy(pos))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=3e-4,
                                       atol=3e-4, err_msg=f"decode step {i}")


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_jax_engine(arch, capacity):
    """Five prompts over two slots (slots idle, decoding token 0 at their last
    position, and are reused): the same greedy tokens, steps and counters."""
    jmodel, jparams, model = _pair(arch, capacity)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (6, 11, 3, 8, 5)]
    n_new = [6, 3, 7, 4, 5]
    theirs = JaxServeEngine(jmodel, jparams, max_batch=2, max_len=40)
    ours = ServeEngine(model, max_batch=2, max_len=40)
    jreqs = [theirs.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    treqs = [ours.submit(p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    theirs.run_until_drained(timeout=300)
    ours.run_until_drained(timeout=300)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert ours.steps == theirs.steps
    assert ours.metrics.snapshot()["counters"] == theirs.metrics.snapshot()["counters"]


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_batched_fabric_host_serves_every_session(capacity):
    """Four sessions on one batched host, decoding from four threads so that
    their steps coalesce: every session gets its tokens. At capacity factor
    8.0 nothing drops, and each stream equals the engine's for that prompt
    alone (the oracle); at the published one the drops depend on which slots
    share a step, so only the token counts are held."""
    _, _, model = _pair("qwen2-moe-a2.7b", capacity)
    host = ModelHost(model, max_len=48, max_sessions=4, window_s=0.05)
    assert host.batching
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 9, 7, 12)]
    n_new = 8
    streams = {}

    def user(i):
        session = f"s{i}"
        toks = [host.prefill(session, prompts[i])]
        for _ in range(n_new - 1):
            toks.append(host.decode(session, None)[0])
        host.release(session)
        streams[i] = toks

    threads = [threading.Thread(target=user, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(streams) == list(range(len(prompts)))
    assert all(len(s) == n_new and all(0 <= t < model.cfg.vocab for t in s)
               for s in streams.values())
    assert host.coalescer.batches < len(prompts) * (n_new - 1)
    if capacity != "published":
        for i, p in enumerate(prompts):
            alone = ServeEngine(model, max_batch=1, max_len=48)
            assert streams[i] == alone.generate(p, max_new_tokens=n_new), i


def test_serve_driver_serves_the_moe(monkeypatch):
    """``launch/serve.py --arch qwen2-moe-a2.7b`` (reduced, on the CPU) through
    ``FunctionService``: no branch of the driver is the MoE's own."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-moe-a2.7b", "--device", "cpu",
                                      "--requests", "4", "--max-new-tokens", "5"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_info:
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    assert exit_info.value.code == 0
    assert "qwen2-moe-a2.7b-reduced on cpu: 4 requests / 20 tokens" in out.getvalue()
