"""The port's compiled-function path (``torch_compile=True``) through the fabric.

The twin of ``tests/test_system.py::test_jax_jit_function_warm_faster_than_cold``:
a function registered with ``torch_compile=True`` is built by the worker as a
``torch.compile`` executable on the first task's payload, so that task pays the
compile (the warm pool's cold start) and the next one reuses it. Its results
equal the eager call's, and the cold task runs the function once. A function
that fails to compile fails its task and is never run uncompiled in its place.
A compile or a task that holds the GIL longer than the heartbeat's
threshold (as Triton's code generation does on the card) keeps its executor:
the endpoint runs on its default liveness. Inductor's cache points at the test's own
directory, so no earlier run's cache passes for a cold start (a cold compile
takes tens of seconds on a CPU).
"""
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import FunctionService  # noqa: E402


@pytest.fixture
def service(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor"))
    torch._dynamo.reset()
    svc = FunctionService()
    svc.make_endpoint("compiled", n_executors=1, workers_per_executor=1)
    yield svc
    svc.shutdown()
    torch._dynamo.reset()


def _mm(doc):
    return {"z": (doc["a"] @ doc["a"].T).sum()}


def test_torch_compile_function_warm_faster_than_cold(service):
    fid = service.register_function(_mm, name="mm", torch_compile=True)
    p = {"a": torch.ones((128, 128))}
    t0 = time.monotonic()
    cold_out = service.run(fid, p).result(600)
    cold = time.monotonic() - t0
    t0 = time.monotonic()
    warm_out = service.run(fid, p).result(60)
    warm = time.monotonic() - t0
    assert warm < cold, (warm, cold)
    # every partial sum of ones is exact: the compiled sum equals the eager one
    want = _mm(p)["z"]
    assert torch.equal(cold_out["z"], want) and torch.equal(warm_out["z"], want)
    assert service.metrics.counter("warming.cold_starts").value == 1
    assert service.metrics.counter("warming.warm_hits").value == 1
    assert service.metrics.counter("endpoint.executors_lost").value == 0
    # other values, the same compiled graph: equal up to the order of the fp32 sum
    r = {"a": torch.from_numpy(np.random.default_rng(0).standard_normal((128, 128))
                               .astype(np.float32))}
    got = service.run(fid, r).result(60)["z"]
    assert torch.allclose(got, _mm(r)["z"], rtol=1e-5, atol=0), (got, _mm(r)["z"])
    assert service.metrics.counter("warming.cold_starts").value == 1


def test_function_that_fails_to_compile_fails_its_task(service):
    calls = []

    def breaks(doc):
        calls.append(1)
        torch._dynamo.graph_break()  # no single graph: fullgraph=True refuses it
        return {"y": doc["x"] * 2}

    fid = service.register_function(breaks, name="breaks", torch_compile=True,
                                    compile_kwargs={"fullgraph": True})
    with pytest.raises(Exception, match="graph_break|graph break|Unsupported"):
        service.run(fid, {"x": torch.ones(4)}).result(120)
    assert calls == [], "the function ran uncompiled"
    # the eager function itself runs: only its compile failed
    assert torch.equal(breaks({"x": torch.ones(4)})["y"], torch.full((4,), 2.0))


CALLS = []


def _counted(doc):
    CALLS.append(1)  # a side effect: Dynamo replays it after each compiled call
    return {"y": doc["x"] + 1}


def test_cold_task_runs_the_function_once(service):
    CALLS.clear()
    fid = service.register_function(_counted, name="counted", torch_compile=True)
    out = service.run(fid, {"x": torch.zeros(8)}).result(600)
    assert torch.equal(out["y"], torch.ones(8))
    assert len(CALLS) == 1, "the cold task ran the function more than once"
    service.run(fid, {"x": torch.zeros(8)}).result(60)
    assert len(CALLS) == 2
    assert service.metrics.counter("warming.cold_starts").value == 1


def _hold_gil(seconds: float) -> None:
    """Hold the GIL for about ``seconds`` in one C call: ``sum`` over a C
    iterator lets no other thread run until it returns."""
    n = 1_000_000
    t0 = time.perf_counter()
    sum(itertools.repeat(1, n))
    sum(itertools.repeat(1, int(n * seconds / (time.perf_counter() - t0))))


def _gil_holding_backend(gm, example_inputs):
    for _ in range(4):  # four stalls, each past the endpoint's 0.5 s liveness
        _hold_gil(1.0)
    return gm.forward


def _gil_holding_task(doc):
    for _ in range(4):
        _hold_gil(1.0)
    return _mm(doc)


@pytest.mark.parametrize("where", ["compile", "task"])
def test_gil_stall_keeps_its_executor(service, where):
    """A compile (a ``torch.compile`` backend) or a plain task that holds the
    GIL 4 x 1 s, on the endpoints' default liveness of 2 beats of 0.25 s:
    neither the executor that runs it nor a second endpoint's idle one is
    written off, and the next task is dispatched."""
    service.make_endpoint("idle", n_executors=1, workers_per_executor=1)
    if where == "compile":
        fid = service.register_function(_mm, name="stalls", torch_compile=True,
                                         compile_kwargs={"backend": _gil_holding_backend})
    else:
        fid = service.register_function(_gil_holding_task, name="stalls")
    p = {"a": torch.ones((16, 16))}
    assert torch.equal(service.run(fid, p).result(120)["z"], _mm(p)["z"])
    # the next task is dispatched to the same executor, which still lives
    q = {"a": torch.full((16, 16), 2.0)}
    assert torch.equal(service.run(fid, q).result(60)["z"], _mm(q)["z"])
    assert service.metrics.counter("endpoint.executors_lost").value == 0


def test_launcher_runs_its_launch_as_it_is_eager_and_compiled():
    """A ``kernels.launcher`` (each kernel's launch on CUDA tensors) is the
    launch itself when eager, and under ``torch.compile`` runs between the
    compiled graphs at every call, its counter never guarded on."""
    from repro_torch.kernels import launcher

    counts = {"n": 0}

    def launch(x, out):
        assert x.data_ptr() % 16 == 0       # a wrapper's pointer check
        counts["n"] += 1                    # its launch counter
        out.copy_(x * 3)                    # stands in for the ctypes call
        return out

    wrapped = launcher(launch)
    x = torch.randn(64)
    assert torch.equal(wrapped(x, torch.empty(64)), x * 3) and counts["n"] == 1

    def model(x):
        return wrapped(torch.sin(x) + 1, torch.empty(64)).sum() * 2

    torch._dynamo.reset()
    from torch._dynamo.utils import counters
    counters.clear()
    compiled = torch.compile(model)
    for _ in range(4):
        assert torch.allclose(compiled(x), model(x))
    assert counts["n"] == 1 + 2 * 4
    assert counters["stats"]["unique_graphs"] <= 2   # no recompile per call
    torch._dynamo.reset()


def test_launch_host_time_runs_and_the_kernels_import_no_dynamo(tmp_path):
    """``tools/launch_host_time.py`` on the CPU at the reduced config: the
    kernel modules import no ``torch._dynamo``, and every timing is there."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "tools" / "launch_host_time.py"),
                          "--device", "cpu", "--reduced", "--calls", "20", "--rounds", "2",
                          "--admissions", "1"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["imports_dynamo"] is False
    for key in ("import_s", "rmsnorm_us", "decode_us", "prefill_host_ms", "admit_ms"):
        assert line[key] > 0, (key, line)
