"""Fabric-served inference on the card (``repro_torch.serving.fabric``).

Every test here is marked ``cuda`` and skips without a CUDA card of compute
capability 9.0 (the kernels have no CPU mode). The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fabric_cuda.py

A batched host on the card replays its decode step as a CUDA graph; one built
with ``cuda_graph=False`` steps eagerly through the same kernels in the same
order, so the two are held equal bit for bit.
"""
import gc
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import FunctionService  # noqa: E402
from repro_torch.core.containers import ContainerSpec  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.fabric import ModelHost, reset_serving, serve_model  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    reset_serving()


def _model(arch: str, dtype: str, device) -> Model:
    cfg = get_reduced(arch).with_(dtype=dtype)
    return Model(cfg, device=device).init(torch.Generator(device).manual_seed(0))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _drive(host, prompts, n_new, release_first=False):
    """Prefill every session, then decode them round by round from one
    thread (each step serves one session; the others rewrite their slot's
    current position); with ``release_first`` the first session is released
    midway, so that its slot idles. Returns each session's tokens."""
    toks = {k: [host.prefill(f"s{k}", p)] for k, p in enumerate(prompts)}
    hist = {k: list(p) + toks[k] for k, p in enumerate(prompts)}
    for r in range(n_new - 1):
        for k in toks:
            if release_first and k == 0 and r >= n_new // 2:
                continue
            nxt, migrated = host.decode(f"s{k}", hist[k])
            assert not migrated
            toks[k].append(nxt)
            hist[k].append(nxt)
        if release_first and r == n_new // 2:
            host.release("s0")
    return [toks[k] for k in range(len(prompts))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_host_equals_eager_host(dtype, cuda_device):
    model = _model("qwen2-0.5b", dtype, cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n) for n in (5, 17, 3)]
    graphed = ModelHost(model, max_len=64, max_sessions=4, window_s=0.0005)
    eager = ModelHost(model, max_len=64, max_sessions=4, window_s=0.0005, cuda_graph=False)
    assert graphed._graph is not None and eager._graph is None
    before = tengine.launch_counts()["decode_attention"]
    got = _drive(graphed, prompts, 8, release_first=True)
    replayed = tengine.launch_counts()["decode_attention"] - before
    assert graphed.coalescer.batches > 0
    # every replay adds the decode-attention calls its capture counted
    assert replayed == graphed.coalescer.batches * graphed._graph.launches["decode_attention"]
    assert got == _drive(eager, prompts, 8, release_first=True)
    assert graphed.coalescer.batches == eager.coalescer.batches
    for (name, g), (_, e) in zip(_leaves(graphed.cache), _leaves(eager.cache)):
        assert torch.equal(g, e), name


def test_endpoints_whose_first_tasks_arrive_together_all_serve(cuda_device):
    """Three endpoints build their hosts (each a graph capture) at the same
    moment, from their own worker threads, and each then serves its session."""
    model = _model("qwen2-0.5b", "bfloat16", cuda_device)
    svc = FunctionService()
    spec = ContainerSpec(name="torch", capabilities={"cpu", "torch"}, min_workers=0,
                         max_workers=8)
    eps = [svc.make_endpoint(f"card{i}", n_executors=1, containers=[spec]) for i in range(3)]
    try:
        client = serve_model(svc, model, name="qwen2", max_len=64, max_sessions=4)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, model.cfg.vocab, n) for n in (7, 11, 4)]
        start = threading.Barrier(len(eps))
        out, errors = {}, []

        def user(k):
            try:
                start.wait()
                s = client.session(prompts[k], endpoint_id=eps[k].endpoint_id)
                out[k] = (list(s.stream(6)), s.endpoints)
                s.close()
            except BaseException as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        threads = [threading.Thread(target=user, args=(k,)) for k in range(len(eps))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        engine = ServeEngine(model, max_batch=4, max_len=64)
        reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
        engine.run_until_drained(timeout=300)
        for k, ep in enumerate(eps):
            tokens, endpoints = out[k]
            assert set(endpoints) == {ep.endpoint_id}
            assert tokens == reqs[k].tokens
            assert ep.site.get_or_create(("serving-host", "qwen2"), None)._graph is not None
    finally:
        svc.shutdown()


def test_hybrid_unbatched_host_decodes_to_max_len(cuda_device):
    """F2, repaired, on the card: the hybrid's attention cache holds max_len
    positions, so decoding from a prompt up to the context limit writes past
    the prompt without an index error and matches the engine (B = 1, the
    same cache length)."""
    model = _model("zamba2-2.7b", "float32", cuda_device)
    max_len = 32
    prompt = np.random.default_rng(2).integers(0, model.cfg.vocab, 20)
    host = ModelHost(model, max_len=max_len, max_sessions=1)
    assert not host.batching
    n_new = max_len - 1 - len(prompt)
    toks = _drive(host, [prompt], n_new + 1)[0]
    engine = ServeEngine(model, max_batch=1, max_len=max_len, cuda_graph=False)
    req = engine.submit(prompt, max_new_tokens=n_new + 1)
    engine.run_until_drained(timeout=300)
    assert toks[:len(req.tokens)] == req.tokens
    k = host.sessions["s0"].cache["attn"]["k"]
    assert k.shape[2] == max_len
    assert k[:, :, max_len - 2].abs().sum() > 0     # written at the last decode position


def test_capture_runs_with_the_collector_off(cuda_device):
    """A fabric host is a reference cycle (host -> coalescer -> its bound
    step); collected while another graph is captured, its graph's release
    invalidates that capture. The warm-up steps run with the collector on,
    the capture with it off, and it is on again after."""
    x = torch.zeros(4, device=cuda_device)
    seen = []

    def step():
        seen.append(gc.isenabled())
        x.add_(1)

    assert gc.isenabled()
    graph = tengine.DecodeGraph.capture(step, "auto", cuda_device)
    assert seen == [True] * tengine.WARMUP_STEPS + [False]
    assert gc.isenabled()
    graph.replay("auto")
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full((4,), float(tengine.WARMUP_STEPS + 1), device=cuda_device))
