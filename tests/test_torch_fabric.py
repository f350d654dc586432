"""The port's fabric-served inference (``repro_torch.serving.fabric``): twins of
tests/test_serving_fabric.py on reduced qwen1.5-0.5b in f32 with the JAX
weights carried over, held to the JAX fabric's greedy streams and to the
port's ``Model.forward`` oracle; F2 repaired (the unbatched host's cache holds
``max_len`` positions); the SSM and hybrid families through the unbatched
host; the ``torch`` capability gate; and the serve driver through
``FunctionService``."""
import contextlib
import io
import runpy
import sys
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.core import FunctionService as JaxFunctionService  # noqa: E402
from repro.core.containers import ContainerSpec as JaxContainerSpec  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serving import fabric as jax_fabric  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import FunctionService, MetricsRegistry  # noqa: E402
from repro_torch.core.containers import CapabilityError, ContainerSpec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.fabric import (  # noqa: E402
    CacheAdmissionError,
    DecodeCoalescer,
    ModelHost,
    reset_serving,
    serve_model,
)
from repro_torch.serving.kv_cache import cache_bytes  # noqa: E402


def _carried(arch):
    """A reduced f32 config: the JAX model and params, and the port's model
    holding the same weights."""
    jmodel = JaxModel(jax_reduced(arch).with_(dtype="float32"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(get_reduced(arch).with_(dtype="float32"), device="cpu")
    model.load_state_dict(tparams.to_state_dict(jax.tree.map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def small_model():
    return _carried("qwen1.5-0.5b")


@pytest.fixture(autouse=True)
def _clean_specs():
    yield
    reset_serving()
    jax_fabric.reset_serving()


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


def _fabric(model, n_endpoints=2, **serve_kw):
    svc = FunctionService()
    spec = ContainerSpec(name="torch", capabilities={"cpu", "torch"}, min_workers=0,
                         max_workers=8)
    endpoints = [svc.make_endpoint(f"site{i}", n_executors=1, containers=[spec])
                 for i in range(n_endpoints)]
    serve_kw.setdefault("max_len", 48)
    serve_kw.setdefault("max_sessions", 6)
    client = serve_model(svc, model, name="qwen", **serve_kw)
    return svc, endpoints, client


def _jax_generate(jmodel, jparams, prompt, n_new, **serve_kw):
    """The reference fabric's stream: one endpoint with a jit-capable pool."""
    svc = JaxFunctionService()
    spec = JaxContainerSpec(name="jit", capabilities={"cpu", "jit"}, min_workers=0,
                            max_workers=8)
    svc.make_endpoint("site0", n_executors=1, containers=[spec])
    try:
        client = jax_fabric.serve_model(svc, jmodel, jparams, name="ref", max_len=48,
                                        max_sessions=6, **serve_kw)
        return client.generate(prompt, max_new_tokens=n_new)
    finally:
        svc.shutdown()


# ---------------------------------------------------------------- tentpole
def test_fabric_generation_matches_reference(small_model):
    jmodel, jparams, model = small_model
    svc, _, client = _fabric(model, n_endpoints=1)
    try:
        prompt = np.random.default_rng(0).integers(0, model.cfg.vocab, 6)
        toks = client.generate(prompt, max_new_tokens=5)
        assert toks == _greedy_reference(model, prompt, 5)
        assert toks == _jax_generate(jmodel, jparams, prompt, 5)
        snap = svc.metrics.snapshot()
        # 4 decode steps, all served from the resident cache slot
        assert snap["counters"]["serving.affinity_hits"] == 4
        assert snap["counters"]["serving.prefills"] == 1
        assert snap["histograms"]["serving.ttft_s"]["count"] == 1
    finally:
        svc.shutdown()


def test_concurrent_sessions_coalesce(small_model):
    _, _, model = small_model
    svc, _, client = _fabric(model, n_endpoints=1, window_s=0.05)
    try:
        results = {}

        def user(k, prompt):
            results[k] = client.generate(prompt, max_new_tokens=4)

        rng = np.random.default_rng(1)
        prompts = {k: rng.integers(0, model.cfg.vocab, 5) for k in range(4)}
        threads = [threading.Thread(target=user, args=(k, p)) for k, p in prompts.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for k, p in prompts.items():
            assert results[k] == _greedy_reference(model, p, 4)
        snap = svc.metrics.snapshot()["counters"]
        decodes = snap["serving.affinity_hits"]  # 3 per session
        # continuous batching: fewer batched steps than decode tasks
        assert snap["serving.decode_batches"] < decodes
        assert svc.metrics.histogram("serving.merged_per_step").percentile(100) > 1
    finally:
        svc.shutdown()


def test_session_failover_reprefills_on_survivor(small_model):
    _, _, model = small_model
    svc, endpoints, client = _fabric(model, n_endpoints=2)
    by_id = {e.endpoint_id: e for e in endpoints}
    try:
        prompt = np.random.default_rng(3).integers(0, model.cfg.vocab, 6)
        s = client.session(prompt)
        s.step()
        home = s.endpoints[-1]
        by_id[home].kill()
        assert home in svc.forwarder.check_endpoints()
        s.step()
        s.step()
        assert s.migrations == 1
        assert set(s.endpoints[-2:]) != {home}  # moved to the survivor
        assert s.tokens == _greedy_reference(model, prompt, 4)
        snap = svc.metrics.snapshot()["counters"]
        assert snap["serving.cache_migrations"] == 1
        assert snap["forwarder.session_evictions"] == 1
    finally:
        svc.shutdown()


def test_cache_bytes_admission_control(small_model):
    _, _, model = small_model
    per_seq = cache_bytes(model.cfg, 1, 48)
    metrics = MetricsRegistry()
    host = ModelHost(model, max_len=48, max_sessions=8, cache_bytes_budget=2 * per_seq,
                     metrics=metrics)
    assert host.n_slots == 2  # budget, not max_sessions, is the binding cap
    prompt = np.arange(4, dtype=np.int32)
    host.prefill("a", prompt)
    host.prefill("b", prompt)
    with pytest.raises(CacheAdmissionError):
        host.prefill("c", prompt)
    assert metrics.counter("serving.admission_rejects").value == 1
    assert host.release("a")
    host.prefill("c", prompt)  # freed slot admits the new session
    assert metrics.gauge("serving.cache_bytes").value == 2 * per_seq


# ------------------------------------------------------------- coalescer
def test_decode_coalescer_merges_concurrent_submits():
    calls = []
    barrier = threading.Barrier(4)

    def step(slots):
        calls.append(list(slots))
        time.sleep(0.01)
        return {s: 100 + s for s in slots}

    co = DecodeCoalescer(step, window_s=0.2, target_fn=lambda: 4)
    out = {}

    def submit(slot):
        barrier.wait()
        out[slot] = co.submit(slot)

    threads = [threading.Thread(target=submit, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == {0: 100, 1: 101, 2: 102, 3: 103}
    assert co.batches < 4  # at least one merged step
    assert co.merged == 4
    assert max(len(c) for c in calls) > 1


def test_decode_coalescer_propagates_step_errors():
    def step(slots):
        raise RuntimeError("kernel exploded")

    co = DecodeCoalescer(step, window_s=0.01)
    with pytest.raises(RuntimeError, match="kernel exploded"):
        co.submit(0)
    # leadership must be released for the next caller
    co2 = DecodeCoalescer(lambda slots: {s: 7 for s in slots}, window_s=0.01)
    assert co2.submit(1) == 7


# --------------------------------------------------- the unbatched host
def _host_stream(host, prompt, n_new, session="s1"):
    toks = [host.prefill(session, prompt)]
    history = list(prompt) + toks
    for _ in range(n_new - 1):
        nxt, migrated = host.decode(session, history)
        assert not migrated
        toks.append(nxt)
        history.append(nxt)
    return toks


def test_unbatched_dense_host_matches_oracle(small_model):
    """F2, repaired: each session's private cache holds max_len positions, so
    decode writes land inside it. Held to the oracle: the reference's
    unbatched host keeps the cache at the prompt's length and drops them."""
    _, _, model = small_model
    host = ModelHost(model, max_len=48, max_sessions=2, batching=False)
    prompt = np.random.default_rng(4).integers(0, model.cfg.vocab, 6)
    assert _host_stream(host, prompt, 8) == _greedy_reference(model, prompt, 8)
    k = host.sessions["s1"].cache["k"]
    assert k.shape[2] == 48                        # (L, B, S, KV, hd) at max_len
    assert k[:, :, 6:13].abs().sum() > 0            # the decode steps' k rows are written


def test_ssm_fabric_matches_reference():
    """mamba2-2.7b reduced: both fabrics serve it through the unbatched host;
    an SSM cache has no sequence axis, so F2 does not reach it."""
    jmodel, jparams, model = _carried("mamba2-2.7b")
    svc, _, client = _fabric(model, n_endpoints=1)
    try:
        prompt = np.random.default_rng(5).integers(0, model.cfg.vocab, 7)
        toks = client.generate(prompt, max_new_tokens=6)
        assert toks == _jax_generate(jmodel, jparams, prompt, 6)
        assert toks == _greedy_reference(model, prompt, 6)
        assert svc.metrics.snapshot()["counters"].get("serving.decode_batches", 0) == 0
    finally:
        svc.shutdown()


def test_hybrid_fabric_matches_oracle_and_engine():
    """zamba2-2.7b reduced through the unbatched host: its shared block's
    attention cache is the one F2 leaves short in the reference."""
    _, _, model = _carried("zamba2-2.7b")
    svc, _, client = _fabric(model, n_endpoints=1)
    try:
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 9)]
        results = {}

        def user(k):
            results[k] = client.generate(prompts[k], max_new_tokens=6)

        threads = [threading.Thread(target=user, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        engine = ServeEngine(model, max_batch=2, max_len=48)
        reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_drained(timeout=120)
        for k, p in enumerate(prompts):
            assert results[k] == _greedy_reference(model, p, 6)
            assert results[k] == reqs[k].tokens
    finally:
        svc.shutdown()


# ------------------------------------------------------- capability gate
def test_torch_functions_never_route_to_a_cpu_pool(small_model):
    _, _, model = small_model
    svc = FunctionService()
    spec = ContainerSpec(name="torch", capabilities={"cpu", "torch"}, min_workers=0,
                         max_workers=8)
    plain = svc.make_endpoint("plain", n_executors=1, workers_per_executor=2)
    capable = svc.make_endpoint("capable", n_executors=1, containers=[spec])
    try:
        client = serve_model(svc, model, name="qwen", max_len=48, max_sessions=6)
        rng = np.random.default_rng(7)
        for _ in range(4):
            s = client.session(rng.integers(0, model.cfg.vocab, 5))
            s.step()
            s.close()
            assert set(s.endpoints) == {capable.endpoint_id}
        assert svc.forwarder.stats()["endpoints"][plain.endpoint_id]["routed"] == 0
    finally:
        svc.shutdown()
    only_cpu = FunctionService()
    only_cpu.make_endpoint("plain", n_executors=1, workers_per_executor=2)
    try:
        client = serve_model(only_cpu, model, name="qwen", max_len=48)
        with pytest.raises(CapabilityError):
            client.session(np.arange(4))
    finally:
        only_cpu.shutdown()


# ------------------------------------------------------------ serve driver
def test_serve_driver_runs_through_function_service(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu", "--requests", "4",
                                      "--max-new-tokens", "5"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_info:
        runpy.run_module("repro_torch.launch.serve", run_name="__main__")
    assert exit_info.value.code == 0
    assert "4 requests / 20 tokens" in out.getvalue()
    assert "through FunctionService" in out.getvalue()
