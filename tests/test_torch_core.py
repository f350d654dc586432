"""The port's fabric core (``repro_torch.core``): its msgpack codec against
``msgpack``, its serializer against the reference's (F1 repaired: torch
tensors travel), the worker without JAX, the copied modules against the
reference's text, its exports against the reference's, flows of the workflow
engine and the client helpers on both packages, and a twin of the quickstart
over two endpoints with an endpoint kill."""
import importlib
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - exercised on clean environments
    from _hypothesis_stub import given, settings, st

from repro.core import serializer as ref_serializer  # noqa: E402
from repro.core.datastore import DataRef as RefDataRef  # noqa: E402
from repro_torch.core import FunctionService, serializer, wire  # noqa: E402
from repro_torch.core.datastore import DataRef  # noqa: E402
from repro_torch.core.worker import build_executable  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# ------------------------------------------------------------------ codec
# every int width msgpack encodes: fixint, u8..u64, negative fixint, i8..i64
_INTS = st.one_of(
    st.integers(-32, 127), st.integers(128, 2**8 - 1), st.integers(2**8, 2**16 - 1),
    st.integers(2**16, 2**32 - 1), st.integers(2**32, 2**64 - 1),
    st.integers(-2**7, -33), st.integers(-2**15, -2**7 - 1),
    st.integers(-2**31, -2**15 - 1), st.integers(-2**63, -2**31 - 1),
)
_EXTS = st.builds(wire.ExtType, st.integers(0, 127),
                  st.one_of(st.binary(max_size=20), st.sampled_from([1, 2, 4, 8, 16, 300, 70000])
                            .map(lambda n: bytes(range(256)) * (n // 256) + bytes(n % 256))))
_LEAVES = st.one_of(
    st.none(), st.booleans(), _INTS, st.floats(allow_nan=False), st.text(max_size=40),
    st.text(min_size=32, max_size=300), st.binary(max_size=300), _EXTS,
)
_TREES = st.recursive(
    _LEAVES,
    lambda kids: st.one_of(
        st.lists(kids, max_size=20), st.lists(kids, max_size=5).map(tuple),
        st.dictionaries(st.one_of(st.text(max_size=10), _INTS), kids, max_size=18),
    ),
    max_leaves=40,
)


def _as_msgpack(obj, msgpack):
    """The same tree with msgpack's own ExtType at each ext."""
    if isinstance(obj, wire.ExtType):
        return msgpack.ExtType(obj.code, obj.data)
    if isinstance(obj, dict):
        return {k: _as_msgpack(v, msgpack) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_as_msgpack(v, msgpack) for v in obj)
    return obj


def _as_unpacked(obj):
    """What unpacking gives back: arrays as lists."""
    if isinstance(obj, wire.ExtType):
        return obj
    if isinstance(obj, dict):
        return {k: _as_unpacked(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_as_unpacked(v) for v in obj]
    return obj


@settings(max_examples=150, deadline=None)
@given(_TREES)
def test_wire_packs_what_msgpack_packs(obj):
    msgpack = pytest.importorskip("msgpack")
    want = msgpack.packb(_as_msgpack(obj, msgpack), use_bin_type=True)
    assert wire.packb(obj) == want


@settings(max_examples=150, deadline=None)
@given(_TREES)
def test_wire_unpacks_what_msgpack_packs(obj):
    msgpack = pytest.importorskip("msgpack")
    data = msgpack.packb(_as_msgpack(obj, msgpack), use_bin_type=True)
    got = wire.unpackb(data, raw=False, strict_map_key=False)
    assert got == msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert got == _as_unpacked(obj)


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_wire_container_lengths_match_msgpack(n):
    msgpack = pytest.importorskip("msgpack")
    for obj in (list(range(n)), {i: i for i in range(n)}, "s" * n, b"b" * n):
        data = wire.packb(obj)
        assert data == msgpack.packb(obj, use_bin_type=True)
        assert wire.unpackb(data) == (obj if not isinstance(obj, tuple) else list(obj))


def test_wire_default_and_errors():
    msgpack = pytest.importorskip("msgpack")
    for obj in (np.float32(1.5), np.int64(7), {1, 2}):
        def conv(o):
            return float(o) if isinstance(o, np.floating) else (
                int(o) if isinstance(o, np.integer) else sorted(o))
        assert wire.packb([obj], default=conv) == msgpack.packb([obj], default=conv,
                                                               use_bin_type=True)
    with pytest.raises(TypeError):
        wire.packb(object())
    with pytest.raises(OverflowError):
        wire.packb(2**64)
    with pytest.raises(wire.ExtraData):
        wire.unpackb(wire.packb(1) + wire.packb(2))
    with pytest.raises(ValueError):
        wire.unpackb(wire.packb("abc")[:-1])


def test_wire_unpacker_tells_the_header_end():
    header = wire.packb(("<f4", (2, 3)))
    unpacker = wire.Unpacker(raw=False)
    unpacker.feed(header + b"\x00" * 24)
    assert unpacker.unpack() == ["<f4", [2, 3]]
    assert unpacker.tell() == len(header)


# ------------------------------------------------------------- serializer
def _payloads(dataref):
    rng = np.random.default_rng(0)
    return [
        {"x": rng.standard_normal((3, 4)).astype(np.float32), "n": 3, "s": "name"},
        np.asfortranarray(rng.standard_normal((4, 5))),
        np.array(3.5),
        np.arange(7, dtype=np.int16),
        [np.zeros(0, np.uint8), np.ones((2, 2), bool)],
        (1, 2.5, "t", None, b"raw"),
        {"set": {3, 1, 2}, "c": 1 + 2j, "scalars": [np.float32(1.5), np.int64(-9), np.bool_(True)]},
        {"ref": dataref(key="k" * 64, size=1024, locations=("store-a", "store-b"))},
        {"tokens": list(range(576)), "session": "s-0123456789ab", "model": "qwen"},
        {b"k": {"nested": [{"z": 1, "a": 2}]}, 7: -(2**40)},
    ]


@pytest.mark.parametrize("i", range(10))
def test_numpy_payloads_pack_as_the_reference_does(i):
    ours, theirs = _payloads(DataRef)[i], _payloads(RefDataRef)[i]
    assert serializer.packb(ours) == ref_serializer.packb(theirs)
    assert serializer.payload_hash(ours) == ref_serializer.payload_hash(theirs)
    # and each package reads the other's bytes
    back = serializer.unpackb(ref_serializer.packb(theirs))
    assert serializer.packb(back) == serializer.packb(ours)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.bfloat16, torch.float16,
                                   torch.bool])
def test_torch_tensors_round_trip(dtype):
    """F1, repaired: the reference's serializer turns a tensor into numpy and
    so rejects bf16; the port's carries the tensor with its dtype."""
    gen = torch.Generator().manual_seed(0)
    t = (torch.randn((3, 5), generator=gen) * 100).to(dtype)
    out = serializer.unpackb(serializer.packb({"t": t, "view": t.t(), "empty": t[:0]}))
    for key, want in (("t", t), ("view", t.t()), ("empty", t[:0])):
        got = out[key]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert serializer.unpackb(serializer.packb(torch.tensor(2.5, dtype=dtype))).shape == ()


def test_reference_serializer_rejects_bf16():
    with pytest.raises(TypeError):
        ref_serializer.packb({"x": torch.ones(3, dtype=torch.bfloat16)})


# ------------------------------------------------------------------ worker
def test_jax_jit_function_raises_at_build():
    svc = FunctionService()
    try:
        fid = svc.register_function(lambda x: x, name="jitted", jax_jit=True)
        with pytest.raises(ValueError, match="jitted"):
            build_executable(svc.registry.get(fid))
        fid2 = svc.register_function(lambda x: x + 1, name="plain")
        assert build_executable(svc.registry.get(fid2))(1) == 2
    finally:
        svc.shutdown()


# ------------------------------------------- a stall is not an executor's death
def test_heartbeat_monitor_does_not_count_a_stall_of_the_process():
    import itertools

    from repro_torch.core.heartbeat import HeartbeatMonitor

    mon = HeartbeatMonitor(interval_s=0.1, threshold=2.0)
    time.sleep(0.05)                          # the stall clock runs
    mon.register("a")
    t0 = time.perf_counter()
    sum(itertools.repeat(1, 1_000_000))
    n = int(1_000_000 / (time.perf_counter() - t0))
    sum(itertools.repeat(1, n))               # one C call: the GIL held ~1 s, no thread beats
    assert mon.dead() == []                   # ~1 s late, all of it a stall
    time.sleep(0.4)                           # the process runs and "a" does not beat
    assert mon.dead() == ["a"]
    # explicit times outside any stall count in full
    mon.register("b", now=0.0)
    assert "b" in mon.dead(now=0.3) and "b" not in mon.dead(now=0.15)


# ----------------------------------------------------- copies stay copies
# copied verbatim from repro/core: only import lines may differ. worker.py
# (no JAX executable), serializer.py (the wire codec, the tensor ext) and
# metrics.py (a docstring naming the copy) diverge, and are not listed; so
# does heartbeat.py, whose watchdog does not count a stall of the process
# (a thread holding the GIL, such as ``torch.compile`` in a worker) against
# an executor (F15).
COPIED = ["futures", "memoization", "scheduler", "provider", "predictor",
          "fairness", "interchange", "batching", "auth", "warming", "datastore", "journal",
          "containers", "registry", "executor", "autoscaler", "endpoint", "forwarder",
          "service", "automation", "client"]
_IMPORT = re.compile(r"^\s*(import\s|from\s+\S+\s+import\s)")


def _code_lines(path):
    return [line for line in path.read_text().splitlines() if not _IMPORT.match(line)]


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_has_the_reference_text(module):
    ours = ROOT / "src" / "repro_torch" / "core" / f"{module}.py"
    theirs = ROOT / "src" / "repro" / "core" / f"{module}.py"
    assert _code_lines(ours) == _code_lines(theirs)


# ------------------------------------------------------- quickstart twin
def _preview_stats(doc):
    data = np.asarray(doc["data"])
    return {"name": doc["name"], "mean": float(data.mean()),
            "hot_pixels": int((data > doc["threshold"]).sum())}


def _sleepy(doc):
    time.sleep(doc.get("t", 0.03))
    return {"i": doc.get("i", -1)}


def test_quickstart_twin_register_run_map_over_two_endpoints():
    svc = FunctionService()
    eps = [svc.make_endpoint(f"qs{i}", n_executors=1, workers_per_executor=2) for i in range(2)]
    try:
        fid = svc.register_function(_preview_stats, name="preview_stats")
        rng = np.random.default_rng(0)
        payload = {"name": "frame_000", "data": rng.random((64, 64)), "threshold": 0.99}
        out = svc.run(fid, payload).result(10)
        assert out["name"] == "frame_000"
        assert out["hot_pixels"] == int((payload["data"] > 0.99).sum())
        memo = svc.run(fid, payload, memoize=True)
        memo.result(10)
        again = svc.run(fid, payload, memoize=True)
        assert again.result(10) == out and again.state.value == "memoized"
        frames = [{"name": f"f{i}", "data": rng.random((8, 8)), "threshold": 0.5}
                  for i in range(12)]
        outs = svc.map(fid, frames)
        assert [o["name"] for o in outs] == [f["name"] for f in frames]
        routed = svc.forwarder.stats()["endpoints"]
        assert all(routed[e.endpoint_id]["routed"] > 0 for e in eps)
        # a torch tensor payload travels the wire (F1)
        tfid = svc.register_function(lambda d: d["t"].float().sum().item(), name="tsum")
        t = torch.arange(6, dtype=torch.bfloat16)
        assert svc.run(tfid, {"t": t}).result(10) == 15.0
    finally:
        svc.shutdown()


def test_quickstart_twin_endpoint_kill_fails_over():
    svc = FunctionService(policy="least_outstanding")
    svc.forwarder.liveness_threshold_s = 0.2
    svc.forwarder.watchdog_interval_s = 0.02
    ep_a = svc.make_endpoint("fo-a", n_executors=1, workers_per_executor=2)
    svc.make_endpoint("fo-b", n_executors=1, workers_per_executor=2)
    try:
        fid = svc.register_function(_sleepy)
        futs = [svc.run(fid, {"i": i, "t": 0.08}) for i in range(10)]
        time.sleep(0.05)
        ep_a.kill()
        results = [f.result(timeout=30) for f in futs]
        assert sorted(r["i"] for r in results) == list(range(10))
        assert svc.forwarder.failovers > 0
        assert svc.forwarder.stats()["endpoints"][ep_a.endpoint_id]["dead"]
    finally:
        svc.shutdown()


# ------------------------------------------- automation and client (A2b)
PACKAGES = ["repro.core", "repro_torch.core"]


def test_core_exports_what_the_reference_exports():
    ours, theirs = importlib.import_module("repro_torch.core"), importlib.import_module("repro.core")
    public = {name for name in dir(theirs) if not name.startswith("_")}
    assert public <= set(dir(ours))
    for name in ("Flow", "Workflow", "WorkflowNode", "EventBus", "Trigger", "wait",
                 "get_result"):
        assert getattr(ours, name).__module__.startswith("repro_torch.core."), name
    for name in ("ALL_COMPLETED", "ANY_COMPLETED", "ALWAYS"):
        assert getattr(ours, name) == getattr(theirs, name), name


def _flow_diamond(core, svc):
    """A diamond DAG: the two siblings ride one TaskBatch frame."""
    wf = core.Workflow([
        core.WorkflowNode("src", svc.register_function(lambda d: {"v": d["v"]})),
        core.WorkflowNode("left", svc.register_function(lambda x: {"v": x["v"] * 2}),
                          deps=["src"]),
        core.WorkflowNode("right", svc.register_function(lambda x: {"v": x["v"] + 1}),
                          deps=["src"]),
        core.WorkflowNode("join", svc.register_function(
            lambda up: {"sum": up["left"]["v"] + up["right"]["v"]}), deps=["left", "right"]),
    ], name="diamond")
    run = wf.start(svc, {"v": 10})
    out = run.wait(30)
    stats = svc.forwarder.stats()
    return {"out": out, "states": sorted(run.node_states.values()),
            "batches": stats["batches_delivered"], "tasks": stats["tasks_delivered"]}


def _flow_fanout_retry_skip(core, svc):
    """Per-branch sinks, a node that fails once and is run again (by the
    fabric's task retry or the node's max_attempts), and a failing node
    skipped with its fallback."""
    calls = {"n": 0}
    lock = threading.Lock()

    def flaky(x):
        with lock:
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")
        return x * 3

    def broken(x):
        raise ValueError("always")

    wf = core.Workflow([
        core.WorkflowNode("src", svc.register_function(lambda d: d["base"])),
        core.WorkflowNode("x2", svc.register_function(lambda x: x * 2), deps=["src"]),
        core.WorkflowNode("x3", svc.register_function(flaky), deps=["src"], max_attempts=2),
        core.WorkflowNode("bad", svc.register_function(broken), deps=["src"],
                          on_error="skip", fallback=-1),
    ])
    run = wf.start(svc, {"base": 7})
    return {"out": run.wait(30), "state": run.state, "flaky_calls": calls["n"]}


def _flow_linear_shim(core, svc):
    """The linear Flow surface, a merge, then a failing flow."""
    f1 = svc.register_function(lambda d: {"values": [v * 1.0 for v in d["raw"]]})
    f2 = svc.register_function(lambda d: {"mean": sum(d["values"]) / len(d["values"])})
    flow = core.Flow([core.ActionStep(f1, name="extract"),
                      core.ActionStep(f2, name="reduce",
                                      merge=lambda doc, result: dict(doc, **result))])
    run = flow.start(svc, {"raw": list(range(10))})
    result = core.Flow.wait(run, timeout=30)

    def boom(doc):
        raise ValueError("bad document")

    bad = core.Flow([core.ActionStep(svc.register_function(boom), name="boom")])
    bad_run = bad.start(svc, {"v": 1})
    try:
        core.Flow.wait(bad_run, timeout=30)
        failed = None
    except RuntimeError as exc:
        failed = "flow failed" in str(exc)
    return {"mean": result["mean"], "steps": [h["step"] for h in run.history],
            "status": core.Flow.status(run)["state"], "failed": failed,
            "bad_state": bad_run.state}


def _flow_trigger(core, svc):
    """An EventBus trigger starts one run per matching data-arrival event."""
    fid = svc.register_function(lambda d: {"source": d["source"], "n": len(d["item"])})
    bus = core.EventBus()
    trig = bus.attach(core.Trigger(core.Workflow([core.WorkflowNode("analyze", fid)]), svc,
                                   name="on-data", predicate=lambda e: e.source == "detector"))
    bus.publish(core.DataArrivalEvent("other-site", item=[1]))
    bus.publish(core.DataArrivalEvent("detector", item=[1, 2, 3]))
    bus.publish(core.DataArrivalEvent("detector", item=[4, 5]))
    outs = [r.wait(30) for r in trig.runs]
    return {"outs": outs,
            "fired": svc.metrics.snapshot()["counters"]["trigger.fired{trigger=on-data}"]}


def _flow_client_wait(core, svc):
    """wait / get_result over fabric futures from batch_run."""
    fid = svc.register_function(lambda x: x + 1)
    futs = svc.batch_run(fid, list(range(8)))
    done, not_done = core.wait(futs, return_when=core.ALL_COMPLETED, timeout=30)
    slow = svc.register_function(lambda d: (time.sleep(d["t"]), d["i"])[1])
    racing = [svc.run(slow, {"t": 0.3, "i": 0}), svc.run(slow, {"t": 0.0, "i": 1})]
    first, rest = core.wait(racing, return_when=core.ANY_COMPLETED, timeout=30)
    return {"values": core.get_result(futs), "done": len(done), "not_done": len(not_done),
            "any_completed": len(first) >= 1 and all(f.done() for f in first)
            and len(first) + len(rest) == 2, "all": core.get_result(racing)}


FLOWS = {
    "diamond": (_flow_diamond, {"out": {"sum": 31}, "states": ["SUCCEEDED"] * 4,
                                "batches": 3, "tasks": 4}),
    "fanout-retry-skip": (_flow_fanout_retry_skip,
                          {"out": {"x2": 14, "x3": 21, "bad": -1}, "state": "SUCCEEDED",
                           "flaky_calls": 2}),
    "linear-shim": (_flow_linear_shim, {"mean": 4.5, "steps": ["extract", "reduce"],
                                        "status": "SUCCEEDED", "failed": True,
                                        "bad_state": "FAILED"}),
    "trigger": (_flow_trigger, {"outs": [{"source": "detector", "n": 3},
                                         {"source": "detector", "n": 2}], "fired": 2}),
    "client-wait": (_flow_client_wait, {"values": list(range(1, 9)), "done": 8, "not_done": 0,
                                        "any_completed": True, "all": [0, 1]}),
}


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("flow", list(FLOWS))
def test_shared_flow_gives_the_same_result_on_both_packages(flow, package):
    """Flows of tests/test_workflows.py and tests/test_client_api.py on the
    reference's core and on the port's: each package's run gives the same
    result."""
    core = importlib.import_module(package)
    svc = core.FunctionService()
    svc.make_endpoint("wf-ep", n_executors=1, workers_per_executor=4)
    try:
        fn, want = FLOWS[flow]
        assert fn(core, svc) == want
    finally:
        svc.shutdown()
