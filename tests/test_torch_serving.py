"""The port's serve engine: twins of tests/test_serving_and_training.py's engine
tests, plus cross-package tests (the port's engine and the JAX engine give
the same greedy tokens on the same carried weights), for the dense and the
SSM family. The JAX engine cannot serve the hybrid family (its
``insert_sequence`` takes batch axis 1 for the (G, PG, B, ...) mamba leaves),
so the hybrid engine is held against the JAX ``Model.prefill`` /
``decode_step`` stream driven by hand."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import kv_cache as jax_kv_cache  # noqa: E402
from repro.serving.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.engine import DecodeGraph, ServeEngine  # noqa: E402
from repro_torch.serving.kv_cache import cache_bytes, insert_sequence, summarize  # noqa: E402


@pytest.fixture(scope="module")
def small_model():
    """qwen1.5-0.5b reduced, f32: JAX weights and the port holding the same."""
    jcfg = jax_reduced("qwen1.5-0.5b").with_(dtype="float32")
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced("qwen1.5-0.5b").with_(dtype="float32"), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def ssm_model():
    """mamba2-2.7b reduced, f32: JAX weights and the port holding the same."""
    jcfg = jax_reduced("mamba2-2.7b").with_(dtype="float32")
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced("mamba2-2.7b").with_(dtype="float32"), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def hybrid_model():
    """zamba2-2.7b reduced, f32: JAX weights and the port holding the same."""
    jcfg = jax_reduced("zamba2-2.7b").with_(dtype="float32")
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced("zamba2-2.7b").with_(dtype="float32"), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


@torch.inference_mode()
def _greedy_reference(model, prompt, n_new):
    """Sequential full-recompute greedy decoding (no cache): the oracle for
    the engine's continuous batching."""
    toks = list(np.asarray(prompt, np.int64))
    out = []
    for _ in range(n_new):
        h, _ = model({"tokens": torch.tensor([toks])})
        nxt = int(torch.argmax(model._logits(h)[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


def test_engine_matches_sequential_greedy(small_model):
    _, _, model = small_model
    engine = ServeEngine(model, max_batch=2, max_len=48)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 9, 7)]
    reqs = [engine.submit(p, max_new_tokens=4) for p in prompts]
    engine.run_until_drained(timeout=120)
    for p, r in zip(prompts, reqs):
        assert r.done.is_set()
        expected = _greedy_reference(model, p, 4)
        assert r.tokens == expected, (r.tokens, expected)


def test_engine_continuous_batching_slots_reused(small_model):
    _, _, model = small_model
    engine = ServeEngine(model, max_batch=2, max_len=32)
    rng = np.random.default_rng(1)
    reqs = [engine.submit(rng.integers(0, model.cfg.vocab, 4), max_new_tokens=3)
            for _ in range(5)]  # 5 requests > 2 slots
    engine.run_until_drained(timeout=120)
    assert all(r.done.is_set() and len(r.tokens) == 3 for r in reqs)
    assert engine.stats()["pending"] == 0


def test_engine_serve_forever_handles_trickling_requests(small_model):
    _, _, model = small_model
    engine = ServeEngine(model, max_batch=2, max_len=48)
    stop = threading.Event()
    t = threading.Thread(target=engine.serve_forever, args=(stop,), daemon=True)
    t.start()
    rng = np.random.default_rng(2)
    reqs = []
    for _ in range(4):  # trickle: would defeat run_until_drained's exit check
        reqs.append(engine.submit(rng.integers(0, model.cfg.vocab, 5), max_new_tokens=3))
        time.sleep(0.05)
    for r in reqs:
        assert r.done.wait(120), "request never completed under serve_forever"
        assert len(r.tokens) == 3
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()


def test_engine_tokens_equal_jax_engine(small_model):
    """Cross-package: same carried weights, same prompts -> same greedy tokens."""
    jmodel, jparams, model = small_model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (6, 11, 3, 8)]
    theirs = JaxServeEngine(jmodel, jparams, max_batch=2, max_len=40)
    ours = ServeEngine(model, max_batch=2, max_len=40)
    jreqs = [theirs.submit(p, max_new_tokens=6) for p in prompts]
    treqs = [ours.submit(p, max_new_tokens=6) for p in prompts]
    theirs.run_until_drained(timeout=120)
    ours.run_until_drained(timeout=120)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert ours.steps == theirs.steps
    ts, js = ours.metrics.snapshot(), theirs.metrics.snapshot()
    assert ts["counters"] == js["counters"]
    assert ts["gauges"] == js["gauges"]
    assert ts["histograms"].keys() == js["histograms"].keys()


def test_ssm_engine_matches_sequential_greedy(ssm_model):
    """Prompts of 1 and 2 tokens included: shorter than the conv's K-1 = 3,
    where the reference engine pads the conv tail on the wrong side."""
    _, _, model = ssm_model
    engine = ServeEngine(model, max_batch=2, max_len=48)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (1, 2, 3, 9, 20)]
    reqs = [engine.submit(p, max_new_tokens=4) for p in prompts]
    engine.run_until_drained(timeout=120)
    for p, r in zip(prompts, reqs):
        assert r.done.is_set()
        expected = _greedy_reference(model, p, 4)
        assert r.tokens == expected, (len(p), r.tokens, expected)


def test_ssm_short_prompt_conv_tail_is_left_padded(ssm_model):
    _, _, model = ssm_model
    K = model.cfg.ssm.conv_kernel
    with torch.inference_mode():
        _, short = model.prefill({"tokens": torch.tensor([[7, 11]])})
        _, longer = model.prefill({"tokens": torch.tensor([[3, 7, 11]])})
    assert short["conv"].shape == longer["conv"].shape
    assert short["conv"].shape[2] == K - 1
    assert (short["conv"][:, :, 0] == 0).all()
    # the two real rows sit last, in time order: in the first layer each row is
    # the projection of its own token's embedding
    torch.testing.assert_close(short["conv"][0, :, 1:], longer["conv"][0, :, 1:])


def test_ssm_engine_tokens_equal_jax_engine(ssm_model):
    """Cross-package on prompts of >= 3 tokens (the reference engine is right
    there): same carried weights, same prompts -> same greedy tokens."""
    jmodel, jparams, model = ssm_model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (6, 17, 3, 8)]
    theirs = JaxServeEngine(jmodel, jparams, max_batch=2, max_len=40)
    ours = ServeEngine(model, max_batch=2, max_len=40)
    jreqs = [theirs.submit(p, max_new_tokens=6) for p in prompts]
    treqs = [ours.submit(p, max_new_tokens=6) for p in prompts]
    theirs.run_until_drained(timeout=120)
    ours.run_until_drained(timeout=120)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert ours.steps == theirs.steps
    assert ours.metrics.snapshot()["counters"] == theirs.metrics.snapshot()["counters"]


def test_ssm_engine_slots_reused(ssm_model):
    _, _, model = ssm_model
    engine = ServeEngine(model, max_batch=2, max_len=32)
    rng = np.random.default_rng(7)
    reqs = [engine.submit(rng.integers(0, model.cfg.vocab, 4), max_new_tokens=3)
            for _ in range(5)]  # 5 requests > 2 slots
    engine.run_until_drained(timeout=120)
    assert all(r.done.is_set() and len(r.tokens) == 3 for r in reqs)
    assert engine.stats()["pending"] == 0


def test_hybrid_engine_matches_sequential_greedy(hybrid_model):
    """Prompts of 1 and 2 tokens included (shorter than the conv's K-1 = 3),
    more requests than slots, so slots are refilled mid-run."""
    _, _, model = hybrid_model
    engine = ServeEngine(model, max_batch=2, max_len=48)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (1, 2, 3, 9, 20)]
    reqs = [engine.submit(p, max_new_tokens=4) for p in prompts]
    engine.run_until_drained(timeout=120)
    for p, r in zip(prompts, reqs):
        assert r.done.is_set()
        expected = _greedy_reference(model, p, 4)
        assert r.tokens == expected, (len(p), r.tokens, expected)


def _jax_greedy_stream(jmodel, jparams, prompt, n_new, max_len):
    """JAX Model.prefill then decode_step by hand at B = 1 (scalar positions):
    the prefill cache zero-padded to max_len along the attention leaves'
    sequence axis, the mamba leaves taken as they are."""
    logits, seq = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt[None], jnp.int32)})
    cache, _ = jmodel.init_cache(1, max_len)
    cache = {"attn": jax_kv_cache.insert_sequence(cache["attn"], seq["attn"], 0),
             "mamba": seq["mamba"]}
    out = [int(jnp.argmax(logits[0]))]
    for i in range(n_new - 1):
        tok = jnp.asarray([[out[-1]]], jnp.int32)
        logits, cache = jmodel.decode_step(jparams, tok, cache, jnp.int32(len(prompt) + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_hybrid_engine_tokens_equal_jax_stream(hybrid_model):
    """Cross-package on prompts of >= 3 tokens (where the reference's conv
    tail is right): same carried weights, same prompts -> same greedy tokens."""
    jmodel, jparams, model = hybrid_model
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (6, 17, 3, 8)]
    ours = ServeEngine(model, max_batch=2, max_len=40)
    treqs = [ours.submit(p, max_new_tokens=6) for p in prompts]
    ours.run_until_drained(timeout=120)
    for p, r in zip(prompts, treqs):
        assert r.tokens == _jax_greedy_stream(jmodel, jparams, np.asarray(p), 6, 40), len(p)


def test_hybrid_engine_slots_reused(hybrid_model):
    _, _, model = hybrid_model
    engine = ServeEngine(model, max_batch=2, max_len=32)
    rng = np.random.default_rng(10)
    reqs = [engine.submit(rng.integers(0, model.cfg.vocab, 4), max_new_tokens=3)
            for _ in range(5)]  # 5 requests > 2 slots
    engine.run_until_drained(timeout=120)
    assert all(r.done.is_set() and len(r.tokens) == 3 for r in reqs)
    assert engine.stats()["pending"] == 0
    assert engine.stats()["cache"] == summarize(model.cfg, 2, 32)


def test_insert_sequence_puts_each_leaf_at_its_own_batch_axis(hybrid_model):
    """The hybrid's nested cache: attention leaves (G, B, S, KV, hd) take the
    slot on axis 1, mamba leaves (G, PG, B, ...) on axis 2; other slots keep
    their contents."""
    _, _, model = hybrid_model
    G, PG = 2, 2
    cache = model.init_cache(3, 12)
    for _, leaf in _tree_leaves(cache):
        leaf.fill_(7.0)
    with torch.inference_mode():
        _, seq = model.prefill({"tokens": torch.tensor([[5, 9, 11, 4, 2]])})
    insert_sequence(cache, seq, 1, model.cache_batch_axes())
    for layer in ("k", "v"):
        dst, src = cache["attn"][layer], seq["attn"][layer]
        assert dst.shape[:2] == (G, 3)
        torch.testing.assert_close(dst[:, 1:2, :5], src, rtol=0, atol=0)
        assert (dst[:, 1, 5:] == 0).all()
        assert (dst[:, 0] == 7).all() and (dst[:, 2] == 7).all()
    for name in ("conv", "ssm"):
        dst, src = cache["mamba"][name], seq["mamba"][name]
        assert dst.shape[:3] == (G, PG, 3)
        torch.testing.assert_close(dst[:, :, 1:2], src, rtol=0, atol=0)
        assert (dst[:, :, 0] == 7).all() and (dst[:, :, 2] == 7).all()


def test_insert_sequence_one_axis_for_the_hybrid_is_the_reference_fault(hybrid_model):
    """One batch axis for every leaf (the reference's rule) cannot place the
    mamba leaves: their axis 1 is the layer-in-group axis."""
    _, _, model = hybrid_model
    cache = model.init_cache(3, 12)
    with torch.inference_mode():
        _, seq = model.prefill({"tokens": torch.tensor([[5, 9, 11]])})
    with pytest.raises(RuntimeError):
        insert_sequence(cache, seq, 1)


def _tree_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_cache_bytes_analytical():
    cfg = get_reduced("qwen1.5-0.5b")
    b = cache_bytes(cfg, batch=2, seq_len=64)
    expected = cfg.n_layers * 2 * 64 * 2 * cfg.n_kv_heads * cfg.hd * 2
    assert b == expected
    assert summarize(cfg, 2, 64)["bytes_per_seq"] == expected // 2


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen1.5-0.5b", "deepseek-67b", "mamba2-2.7b",
                                  "zamba2-2.7b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_equals_reference(arch, dtype):
    from repro_torch.configs import get_config
    from repro.configs import get_config as jax_config
    for ours, theirs in ((get_config(arch), jax_config(arch)),
                         (get_reduced(arch), jax_reduced(arch))):
        ours, theirs = ours.with_(dtype=dtype), theirs.with_(dtype=dtype)
        assert cache_bytes(ours, 8, 1024) == jax_kv_cache.cache_bytes(theirs, 8, 1024)
        assert summarize(ours, 3, 100) == jax_kv_cache.summarize(theirs, 3, 100)


def test_insert_sequence_pads_like_the_reference():
    rng = np.random.default_rng(4)
    L, Bc, S, KV, hd, n = 2, 3, 10, 2, 4, 6
    dst = rng.standard_normal((L, Bc, S, KV, hd)).astype(np.float32)
    src = rng.standard_normal((L, 1, n, KV, hd)).astype(np.float32)
    theirs = jax_kv_cache.insert_sequence({"k": jnp.asarray(dst)}, {"k": jnp.asarray(src)}, 1)
    ours = insert_sequence({"k": torch.from_numpy(dst.copy())}, {"k": torch.from_numpy(src)}, 1)
    np.testing.assert_array_equal(ours["k"].numpy(), np.asarray(theirs["k"]))
    assert (ours["k"][:, 1, n:] == 0).all()  # stale entries past the prompt are zeroed


def test_hybrid_cache_bytes_counts_the_allocated_cache(hybrid_model):
    """cache_bytes of the hybrid is what init_cache allocates, leaf by leaf."""
    _, _, model = hybrid_model
    cache = model.init_cache(4, 20)
    allocated = sum(t.numel() * t.element_size() for _, t in _tree_leaves(cache))
    assert cache_bytes(model.cfg, 4, 20) == allocated


# -- the decode step as the card's graph replays it (static buffers, on-device
# argmax), run eagerly on the CPU ----------------------------------------------
def test_cuda_graph_on_a_cpu_model_raises(small_model):
    _, _, model = small_model
    with pytest.raises(ValueError, match="cuda_graph=True"):
        ServeEngine(model, max_batch=2, max_len=16, cuda_graph=True)


@pytest.mark.parametrize("cuda_graph", [None, False])
def test_cpu_engine_steps_eagerly(small_model, cuda_graph):
    _, _, model = small_model
    engine = ServeEngine(model, max_batch=2, max_len=16, cuda_graph=cuda_graph)
    assert engine._graph is None
    assert engine.generate(np.arange(4), max_new_tokens=3) == _greedy_reference(
        model, np.arange(4), 3)


FAMILY_MODELS = {"dense": "small_model", "ssm": "ssm_model", "hybrid": "hybrid_model"}


def _serve_with_an_idle_slot(engine, prompts):
    """A (slot 0, 8 tokens) and B (slot 1, 2 tokens) start together; B ends
    after one step, slot 1 then idles for three steps (decoding token 0 at its
    last position) and C is admitted into it. Returns the three requests."""
    a = engine.submit(prompts[0], max_new_tokens=8)
    b = engine.submit(prompts[1], max_new_tokens=2)
    engine._admit()
    for _ in range(4):
        engine._step()
    assert engine.slot_req[0] is a and engine.slot_req[1] is None and b.done.is_set()
    c = engine.submit(prompts[2], max_new_tokens=5)
    engine._admit()
    assert engine.slot_req[1] is c
    engine.run_until_drained(timeout=120)
    return [a, b, c]


def _addresses(engine):
    return ([t.data_ptr() for _, t in _tree_leaves(engine.cache)]
            + [engine._inputs.data_ptr(), engine._sampled.data_ptr()])


@pytest.mark.parametrize("family", list(FAMILY_MODELS))
def test_engine_slot_idle_then_reused(family, request):
    """The step over static buffers, for every family: a slot that goes idle
    and is reused gives the oracle's tokens and the reference's (the JAX
    engine driven the same way; for the hybrid, which it cannot serve, the
    hand-driven JAX stream); the positions are int32 and every buffer and
    cache leaf keeps its address, as a captured graph needs."""
    jmodel, jparams, model = request.getfixturevalue(FAMILY_MODELS[family])
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (6, 9, 4)]
    ours = ServeEngine(model, max_batch=2, max_len=40)
    assert ours._positions.dtype == torch.int32 and ours._tokens.shape == (2, 1)
    addresses = _addresses(ours)
    reqs = _serve_with_an_idle_slot(ours, prompts)
    assert _addresses(ours) == addresses
    for p, r in zip(prompts, reqs):
        assert r.tokens == _greedy_reference(model, p, len(r.tokens)), len(p)
    if family == "hybrid":
        for p, r in zip(prompts, reqs):
            assert r.tokens == _jax_greedy_stream(jmodel, jparams, np.asarray(p),
                                                  len(r.tokens), 40)
    else:
        theirs = _serve_with_an_idle_slot(JaxServeEngine(jmodel, jparams, max_batch=2,
                                                         max_len=40), prompts)
        assert [r.tokens for r in reqs] == [r.tokens for r in theirs]


class _StandInGraph:
    """Counts replays, as a captured CUDA graph would run them."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fresh_launches(monkeypatch):
    """Every kernel wrapper's LAUNCHES replaced by a copy for one test."""
    for mod in tengine._KERNEL_MODULES:
        monkeypatch.setattr(mod, "LAUNCHES", dict(mod.LAUNCHES))


def test_launch_counts_merges_every_kernel_wrapper(fresh_launches):
    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    for mod in (attn_kernel, rms_kernel, ssd_kernel):
        mod.reset_launches()
    attn_kernel.LAUNCHES["decode_attention"] += 3
    rms_kernel.LAUNCHES["fused_add_rmsnorm"] += 5
    assert tengine.launch_counts() == {"flash_attention": 0, "decode_attention": 3,
                                       "mla_decode_attention": 0,
                                       "flash_attention_backward": 0,
                                       "decode_attention_partials": 0,
                                       "mla_decode_attention_partials": 0,
                                       "fused_add_rmsnorm": 5,
                                       "fused_add_rmsnorm_backward": 0, "ssd": 0,
                                       "ssd_backward": 0}


def test_decode_graph_replay_adds_the_captured_launches(fresh_launches):
    """Each replay adds the calls counted during capture to LAUNCHES (a replay
    makes no host call); a replay under another kernel_impl raises before it
    replays or counts anything."""
    captured = {"flash_attention": 0, "decode_attention": 24, "mla_decode_attention": 0,
                "flash_attention_backward": 0, "decode_attention_partials": 0,
                "mla_decode_attention_partials": 0, "fused_add_rmsnorm": 24,
                "fused_add_rmsnorm_backward": 0, "ssd": 0, "ssd_backward": 0}
    graph = DecodeGraph(_StandInGraph(), captured, "auto")
    before = tengine.launch_counts()
    for _ in range(3):
        graph.replay("auto")
    after = tengine.launch_counts()
    assert graph.graph.replays == 3
    assert {k: after[k] - before[k] for k in after} == {k: 3 * n for k, n in captured.items()}
    with pytest.raises(RuntimeError, match="kernel_impl"):
        graph.replay("ref")
    assert graph.graph.replays == 3 and tengine.launch_counts() == after


def test_engine_step_replays_its_graph(small_model, fresh_launches):
    """With a graph in place, a step copies its inputs into the static
    buffers, replays once and reads the sampled tokens back; the replay's
    captured counts reach LAUNCHES once per step."""
    _, _, model = small_model
    engine = ServeEngine(model, max_batch=2, max_len=16)

    class Eager(_StandInGraph):           # a replay that runs the step it stands for
        def replay(self):
            super().replay()
            engine._decode()

    engine._graph = DecodeGraph(Eager(), {"decode_attention": 2}, model.kernel_impl)
    before = tengine.launch_counts()["decode_attention"]
    tokens = engine.generate(np.arange(5), max_new_tokens=4)
    assert tokens == _greedy_reference(model, np.arange(5), 4)
    assert engine._graph.graph.replays == engine.steps == 3
    assert tengine.launch_counts()["decode_attention"] == before + 2 * 3
