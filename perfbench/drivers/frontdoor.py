"""Front-door serving: each request one ``generate`` task through the
program's ``FunctionService`` (forwarder, endpoint, worker) into a graphed
``ServeEngine``, the way a model-serving user of the fabric calls it.

A closed loop of ``clients`` client threads, each sending its next request
(``mixes.client_requests``) when its last one has answered. The endpoint has
one worker a client: the registered function holds its worker until its
request is done. Set-up builds the model with the run's weights, the engine
(its decode step captured as a CUDA graph), the service and the endpoint,
sends one request at the mix's longest prompt, and lets the loop run
``warm_s`` seconds so that the window opens on a full engine.

The window lasts ``seconds``. Tokens: the engine's ``serving.tokens_generated``
counter at its open and close. The loop keeps every slot busy, so the tails
(time to first token from the client's ``service.run``, time per output
token from the engine's stamps) are read by per-layer readers from the
window's records. At the close the clients stop sending, the engine admits
what it has queued (so every request sent has its first token) and stops,
and each request still decoding goes back to its client as it stands, cut
at the close: it counts neither as attempted nor as failed. Then a sample of
the requests the window finished is checked against the plain reference
(``check``).
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import mixes, program, stats
from perfbench import weights as wts
from perfbench.devicetrace import Profiler

REQUEST_TIMEOUT_S = 300.0


@dataclass(eq=False)
class Record:
    client: int
    prompt: np.ndarray
    n_new: int
    submit: float
    request: object = None            # the engine's Request once answered
    future: object = None             # the service's TaskFuture, until the window closes
    stamps: object = None             # its Timestamps, kept when the future is let go
    error: Optional[str] = None

    @property
    def answered(self) -> bool:
        return (self.request is not None and self.request.finished_at is not None
                and len(self.request.tokens) == self.n_new)

    @property
    def cut(self) -> bool:
        """Still being served when the engine stopped at the window's close."""
        return self.request is not None and self.request.finished_at is None


class FrontDoor:
    """The system under test, built from the cell, with the run's weights."""

    def __init__(self, cell, seed: int, device: str = "cuda"):
        from repro_torch.core import FunctionService
        from repro_torch.models.model import Model
        from repro_torch.serving.engine import ServeEngine

        mix, m = cell.mix, cell.model
        self.cell, self.device = cell, torch.device(device)
        self.specs = cell.reference().weight_specs(m)
        self.model = Model(program.model_config(m), device=self.device)
        program.log("model built")
        wts.fill(self.model.named_parameters(), self.specs, seed)
        program.log("weights drawn")
        self.engine = ServeEngine(self.model, max_batch=mix["max_batch"], max_len=mix["max_len"])
        program.log("engine built, its decode step captured")
        self.service = FunctionService()
        self.service.make_endpoint("frontdoor", n_executors=1,
                                   workers_per_executor=mix["clients"])
        engine = self.engine

        def generate(doc):
            req = engine.submit(doc["prompt"], max_new_tokens=doc["max_new_tokens"])
            if not req.done.wait(timeout=REQUEST_TIMEOUT_S):
                raise TimeoutError(req.request_id)
            return req

        self.fid = self.service.register_function(
            generate, name=f"generate/{m['name']}", pass_through=True,
            serialize_result=False, deterministic=False)
        self.serve()

    def serve(self) -> None:
        """Start the engine's loop (again, after ``halt``)."""
        self._stop = threading.Event()
        self._loop = threading.Thread(target=self.engine.serve_forever, args=(self._stop,),
                                      daemon=True)
        self._loop.start()

    def halt(self, loop: "Loop") -> None:
        """At the window's close, once ``loop`` sends no more: let the engine
        admit what it has queued, stop its loop, then hand every request it
        still holds back to its worker as it stands, until the clients end."""
        eng = self.engine
        time.sleep(0.1)                  # a request sent at the close reaches the queue
        end = time.monotonic() + REQUEST_TIMEOUT_S
        while eng.pending and time.monotonic() < end:
            time.sleep(0.01)
        self._stop.set()
        self._loop.join(timeout=30)
        while not loop.join(0.05):
            with eng._lock:
                held = eng.pending + [r for r in eng.slot_req if r is not None]
                eng.pending, eng.slot_req = [], [None] * eng.max_batch
            for req in held:
                req.done.set()

    def refill(self, seed: int) -> None:
        """Draw another seed's weights into the same parameters (the captured
        step reads them in place)."""
        wts.fill(self.model.named_parameters(), self.specs, seed)

    def call(self, prompt: np.ndarray, n_new: int, client: int = -1) -> Record:
        rec = Record(client, prompt, n_new, time.monotonic())
        try:
            rec.future = self.service.run(self.fid, {"prompt": prompt, "max_new_tokens": n_new})
            rec.request = rec.future.result(REQUEST_TIMEOUT_S)
        except Exception as exc:  # noqa: BLE001 - a failed request is counted, not raised
            rec.error = repr(exc)
        return rec

    def counter(self, name: str) -> int:
        return self.engine.metrics.counter(name).value

    def close(self) -> None:
        self._stop.set()
        self._loop.join(timeout=30)
        self.service.shutdown()


class Loop:
    """The closed loop of clients; ``stop()`` ends submission, ``join()``
    waits for the requests in flight."""

    def __init__(self, fd: FrontDoor, seed: int):
        self.fd, self.records, self._lock = fd, [], threading.Lock()
        self._stop = threading.Event()
        vocab = fd.cell.model["vocab"]
        self.threads = [threading.Thread(target=self._client, args=(c, seed, vocab), daemon=True)
                        for c in range(fd.cell.mix["clients"])]

    def _client(self, c: int, seed: int, vocab: int) -> None:
        for prompt, n_new in mixes.client_requests(self.fd.cell.mix, seed, c, vocab):
            if self._stop.is_set():
                return
            rec = self.fd.call(prompt, n_new, c)
            with self._lock:
                self.records.append(rec)

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float) -> bool:
        end = time.monotonic() + timeout
        for t in self.threads:
            t.join(max(0.0, end - time.monotonic()))
        return not any(t.is_alive() for t in self.threads)


class ReplayTimer:
    """CUDA events around every ``DecodeGraph.replay`` (the class's method
    wrapped while active), each with the keys every row of the step attends
    to (its position + 1), read from ``engine`` as the replay is issued (none
    without an engine)."""

    def __init__(self, engine):
        from repro_torch.serving import engine as engine_mod

        self._cls, self._engine = engine_mod.DecodeGraph, engine
        self._orig = self._cls.replay
        self.replays: List[tuple] = []      # (host start, start event, end event, keys)

    def __enter__(self):
        timer, orig = self, self._orig

        def replay(graph, kernel_impl):
            keys = [] if timer._engine is None else [int(p) + 1 for p in timer._engine.slot_pos]
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.monotonic()
            e0.record()
            orig(graph, kernel_impl)
            e1.record()
            timer.replays.append((t, e0, e1, keys))

        self._cls.replay = replay
        return self

    def __exit__(self, *exc):
        self._cls.replay = self._orig

    def read(self, t0: float, t1: float) -> List[tuple]:
        """(device ms, keys) of the replays issued in [t0, t1)."""
        torch.cuda.synchronize()
        return [(e0.elapsed_time(e1), keys) for t, e0, e1, keys in self.replays if t0 <= t < t1]


class EngineProfiler:
    """The profiler started and stopped on the engine's own thread, between
    two of its steps (``ServeEngine._step`` wrapped while active): the engine
    is the only thread that launches work on the card, so no replay runs
    while the trace starts or stops."""

    def __init__(self):
        from repro_torch.serving.engine import ServeEngine

        self._cls, self.prof = ServeEngine, Profiler()
        self._orig, self._cmd = ServeEngine._step, None
        self._done = threading.Event()

    def __enter__(self):
        orig = self._orig

        def step(engine):
            if self._cmd is not None:
                self._cmd()
                self._cmd = None
                self._done.set()
            return orig(engine)

        self._cls._step = step
        return self

    def __exit__(self, *exc):
        self._cls._step = self._orig

    def run(self, cmd) -> None:
        """Have the engine's thread run ``cmd`` before its next step, and wait."""
        self._done.clear()
        self._cmd = cmd
        if not self._done.wait(REQUEST_TIMEOUT_S):
            raise TimeoutError("the engine's loop did not reach its next step")


def window(fd: FrontDoor, seed: int, seconds: float, trace: bool = False) -> dict:
    """Warm the loop, measure ``seconds``, close, and halt the engine.
    Returns the window's raw readings (and with ``trace`` the device's)."""
    mix = fd.cell.mix
    if not fd._loop.is_alive():
        fd.serve()
    loop = Loop(fd, seed)
    timer, ep = (ReplayTimer(fd.engine), EngineProfiler()) if trace else (None, None)
    if trace:
        timer.__enter__()
        ep.__enter__()
    try:
        loop.start()
        time.sleep(mix["warm_s"])
        t0 = time.monotonic()
        c0 = (fd.counter("serving.tokens_generated"), fd.counter("serving.decode_batches"))
        if trace:   # the slice is the window's last trace_s seconds
            time.sleep(max(0.0, t0 + seconds - mix["trace_s"] - time.monotonic()))
            ep.run(ep.prof.start)
            ts = time.monotonic()
        time.sleep(max(0.0, t0 + seconds - time.monotonic()))
        t1 = time.monotonic()
        c1 = (fd.counter("serving.tokens_generated"), fd.counter("serving.decode_batches"))
        loop.stop()
        if trace:
            # stopped only once no client sends: reducing the trace holds the
            # process for seconds, past the forwarder's liveness limit, and a
            # request sent meanwhile is refused
            ep.run(ep.prof.stop)
            piece_span = (ts, time.monotonic())
        fd.halt(loop)
        settled = loop.join(REQUEST_TIMEOUT_S)
    finally:
        if trace:
            ep.__exit__()
            timer.__exit__()
    for rec in loop.records:
        # a future holds the service (its callbacks), and through it the engine
        if rec.future is not None:
            rec.stamps, rec.future = rec.future.timestamps, None
    out = dict(t0=t0, t1=t1, tokens=c1[0] - c0[0], decode_batches=c1[1] - c0[1],
               records=list(loop.records), settled=settled)
    if trace:
        out.update(replays=timer.read(t0, t1), slice=ep.prof.slice(),
                   slice_replays=[k for t, _, _, k in timer.replays
                                  if piece_span[0] <= t < piece_span[1]])
    return out


def end_to_end(win: dict) -> Dict[str, float]:
    """The cell's end-to-end metric from a window's raw readings: every token
    the engine generated in the window, over its length."""
    return {"serve_tokens_per_s": stats.rate(win["tokens"], win["t1"] - win["t0"])}


def sample(records: List[Record], seed: int, n: int) -> List[Record]:
    """``n`` answered requests drawn from the seed, and the longest of all."""
    done = [r for r in records if r.answered]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.prompt) + r.n_new)
    rng = np.random.default_rng([seed, 2])
    picked = [done[i] for i in rng.choice(len(done), size=min(n, len(done)), replace=False)]
    return ([longest] if longest not in picked else []) + picked


def gap_stats(rows: List[torch.Tensor], chosen: List[torch.Tensor], prefix: str = ""
              ) -> Dict[str, float]:
    """Over every position: the gap (nats) by which the chosen token's
    reference logit lies below the reference's best there. Returns the widest
    gap, the mean gap, and the share of positions whose chosen token is not
    the reference's first (``top1_miss``); the first position of each
    request (its prefill's token) apart as ``first_gap``."""
    gaps = [lg.max(-1).values - lg.gather(1, c[:, None])[:, 0] for lg, c in zip(rows, chosen)]
    allg = torch.cat(gaps)
    return {f"{prefix}logit_gap": float(allg.max()), f"{prefix}mean_gap": float(allg.mean()),
            f"{prefix}top1_miss": float((allg > 0).float().mean()),
            f"{prefix}first_gap": float(torch.stack([g[0] for g in gaps]).max())}


@torch.no_grad()
def check(cell, seed: int, picked: List[Record], device: str = "cuda",
          control: bool = False) -> Dict[str, float]:
    """The picked requests' served tokens against the plain reference, run
    over each prompt with its served tokens (``gap_stats``); with
    ``control``, the same statistics (prefixed ``control_``) of the tokens
    that the reference computed with fp8 products puts first. The reference
    draws its own weights."""
    from perfbench.reference.common import exact_float32

    ref, m = cell.reference(), cell.model
    specs = ref.weight_specs(m)
    W = {name: wts.draw(seed, name, spec, device) for name, spec in specs.items()}
    seqs = [torch.as_tensor(np.concatenate([r.prompt, np.asarray(r.request.tokens[:-1],
                                                                 np.int32)]), device=device)
            for r in picked]
    lens = [len(r.prompt) for r in picked]
    served = [torch.as_tensor(r.request.tokens, device=device).long() for r in picked]
    out = {"served_tokens": float(sum(len(t) for t in served))}
    with exact_float32():
        rows = [lg[n - 1:].clone() for lg, n in zip(ref.logits(W, m, seqs, lens), lens)]
        out.update(gap_stats(rows, served))
        if control:
            tops = [ctl[n - 1:].argmax(-1)
                    for ctl, n in zip(ref.logits(W, m, seqs, lens, precision="fp8"), lens)]
            out.update(gap_stats(rows, tops, "control_"))
    del W
    return out


def build(cell, seed: int, device: str = "cuda") -> FrontDoor:
    """The system with the run's weights, warmed by one request at the mix's
    longest prompt."""
    fd = FrontDoor(cell, seed, device)
    warm = fd.call(*mixes.warmup_request(cell.mix, seed, cell.model["vocab"]))
    if warm.error:
        raise RuntimeError(f"the warm-up request failed: {warm.error}")
    program.log("warm-up request answered")
    return fd


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> dict:
    mix = cell.mix
    if trace and device != "cpu":
        Profiler.warm()
    fd = build(cell, seed, device)
    win = window(fd, seed, seconds, trace)
    setup_s = win["t0"] - t_start
    if device != "cpu":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    ctx = dict(cell=cell, win=win, specs=fd.specs)
    fd.close()
    del fd
    program.release()
    program.log(f"window closed; program freed: {program.allocated_gib():.3f} GiB allocated")
    inside = [r for r in win["records"] if win["t0"] <= r.submit < win["t1"] and not r.cut]
    failed = sum(1 for r in inside if not r.answered)
    why = Counter((r.error or f"{len(r.request.tokens) if r.request else 0} of {r.n_new} "
                   "tokens")[:200] for r in inside if not r.answered)
    for text, n in why.most_common(3):
        program.log(f"{n} failed request(s): {text}")
    readings = check(cell, seed, sample(win["records"], seed, mix["check_requests"]), device)
    program.log("reference checked")
    metrics = end_to_end(win)
    metrics["setup_s"] = setup_s
    return dict(attempted=len(inside), failed=failed, e2e=metrics, ctx=ctx, peak=peak,
                readings=readings, sampled_ok=win["settled"])
