"""Fabric-served inference: the serving tier meets the FaaS tiers.

Port of ``repro.serving.fabric``. The paper's DLHub case study (§7) serves ML
models through the fabric; this module makes the port's models first-class
fabric workloads. Model steps are *registered functions* carrying
``ResourceSpec(capabilities={"torch"})`` so routing only lands them on
torch-capable container pools, and three pieces make serving fast through the
task path:

- **Session-sticky KV-cache affinity** — every task of a generation session
  carries a ``session_id``; the Forwarder's :class:`SessionRouter` pins the
  session to the endpoint holding its KV-cache slot. On endpoint death the
  binding is evicted, the next decode step lands on a survivor, and the
  :class:`ModelHost` there rebuilds the cache from the token history carried
  in the request (`serving.cache_migrations`).
- **Endpoint-level continuous batching** — concurrent decode-step tasks for
  the same model meet in a :class:`DecodeCoalescer` (the interchange tier's
  ``BatchCoalescer`` generalized from task frames to kernel batches): the
  first arrival leads, waits a bounded window for peers, and runs ONE
  batched ``decode_step`` over the shared stacked cache; followers just
  collect their token.
- **cache_bytes admission control** — a host's slot count derives from
  :func:`repro_torch.serving.kv_cache.cache_bytes`; prefill beyond it raises
  :class:`CacheAdmissionError` instead of silently growing decode state.

Hosts are *site state*: the serving functions are registered once and
``site_aware`` metadata hands them the executing endpoint's
:class:`~repro_torch.core.worker.SiteRuntime`, where each endpoint lazily
builds its own :class:`ModelHost` (the model, which holds its weights, is
shared in-process; a real deployment loads per site).

What differs from the reference:

- The reference compiles the batched step with ``jax.jit`` (the cache
  donated). On the card a batched host captures ``Model.decode_step`` and the
  greedy ``argmax`` once, at construction, as a CUDA graph
  (:class:`~repro_torch.serving.engine.DecodeGraph`) over static token and
  int32 position buffers and its stacked cache, and each batched step replays
  it. On the CPU, and with ``cuda_graph=False``, it steps eagerly. Prefill is
  eager; its cache goes into a slot through ``kv_cache.insert_sequence``.
- An unbatched host gives each session a private cache of ``max_len``
  positions with the prefill cache inserted into it. The reference keeps the
  prefill cache at the prompt's length, so its decode writes fall outside it.
  Unbatched steps are eager.
- A session carries its family's side input: an encoder-decoder's audio
  frames (fault F9: the reference prefills every such session on zero
  frames) or a VLM's patch embeddings (fault F7: the reference cannot
  prefill a VLM session). The client packs it once into an object store
  (the service's ``datastore`` when it has one, else the client's own
  ``InMemoryStore``) and every prefill and decode task carries only its
  content key and the store's id, as plain strings (``frames`` and
  ``frames_store``, or ``patches`` and ``patches_store``): a decode task
  does not carry the array's bytes, and the worker resolves no ``DataRef`` a
  step. A host fetches it only when it prefills, so a session that migrates
  re-prefills with its own frames or patches. A VLM session's positions
  count its patches before the prompt. Encoder-decoder and VLM hosts are
  unbatched, as in the reference.
- Hosts are built lazily by whichever worker runs a model's first task, so
  two endpoints may capture, prefill and step at once. A graph capture fails
  if another thread launches work on the card meanwhile, so one process-wide
  lock (``_DEVICE_LOCK``) is held around every device call of every host. The
  card runs one program at a time anyway.
"""
from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import serializer
from ..core.containers import ResourceSpec
from ..core.datastore import InMemoryStore, get_store
from ..models.model import Model
from . import kv_cache
from .engine import (SIDE_INPUTS, DecodeGraph, check_fits, check_side_input, prefill_batch,
                     prefix_len, zero_cache)

# Families whose decode state is positionally idempotent: re-running a step
# for a slot at an unchanged position rewrites the same K/V rows with the
# same values, so slots *absent* from a merged kernel invocation are
# unharmed. Recurrent state (ssm/hybrid) accumulates per step and would be
# corrupted, so those families serve unbatched (per-session caches).
_BATCHABLE_FAMILIES = ("dense", "moe")

# held around every device call of every host in the process: graph capture,
# prefill, cache insertion and decode steps (see the module docstring). It is
# taken before a host's own lock, never while holding it: a thread that held
# its host's lock while it waited here would keep that host's admissions
# waiting behind every other host's prefills.
_DEVICE_LOCK = threading.Lock()


class CacheAdmissionError(RuntimeError):
    """No free KV-cache slot under the host's ``cache_bytes`` budget."""


# ---------------------------------------------------------------------------
# decode coalescer
# ---------------------------------------------------------------------------
class _PendingDecode:
    __slots__ = ("token", "error", "event")

    def __init__(self):
        self.token: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()


class DecodeCoalescer:
    """Merge concurrent decode-step calls into one batched kernel invocation.

    The interchange tier's ``BatchCoalescer`` generalized to kernel batches:
    instead of a pump thread flushing task frames on size/deadline, the
    *callers themselves* combine — the first arrival becomes the leader,
    waits up to ``window_s`` for more slots to join (stopping early once
    every currently-active session has arrived), then runs ``step_fn`` over
    the merged slot set while followers block on their own result. Exactly
    one kernel invocation serves the whole batch.
    """

    def __init__(
        self,
        step_fn: Callable[[List[int]], Dict[int, int]],
        window_s: float = 0.003,
        target_fn: Optional[Callable[[], int]] = None,
    ):
        self._step = step_fn
        self.window_s = window_s
        self._target = target_fn or (lambda: 1)
        self._cond = threading.Condition()
        self._waiting: Dict[int, _PendingDecode] = {}
        self._leading = False
        self.batches = 0
        self.merged = 0

    def submit(self, slot: int) -> int:
        mine = _PendingDecode()
        with self._cond:
            self._waiting[slot] = mine
            self._cond.notify_all()
            # follower path: somebody is already leading — wait for them to
            # take (and serve) our slot, or for leadership to free up
            while self._leading and not mine.event.is_set():
                self._cond.wait(timeout=self.window_s)
            if mine.event.is_set():
                return self._collect(mine)
            self._leading = True
        try:
            deadline = time.monotonic() + self.window_s
            with self._cond:
                while (
                    len(self._waiting) < max(1, self._target())
                    and (remaining := deadline - time.monotonic()) > 0
                ):
                    self._cond.wait(timeout=remaining)
                batch = dict(self._waiting)
                self._waiting.clear()
            try:
                tokens = self._step(sorted(batch))
            except BaseException as exc:  # noqa: BLE001 — fan out, don't hang peers
                with self._cond:
                    for pending in batch.values():
                        pending.error = exc
                        pending.event.set()
                    self._cond.notify_all()
                raise
            with self._cond:
                self.batches += 1
                self.merged += len(batch)
                for s, pending in batch.items():
                    pending.token = tokens[s]
                    pending.event.set()
                self._cond.notify_all()
        finally:
            with self._cond:
                self._leading = False
                self._cond.notify_all()
        return self._collect(mine)

    @staticmethod
    def _collect(pending: _PendingDecode) -> int:
        if pending.error is not None:
            raise pending.error
        assert pending.token is not None
        return pending.token


# ---------------------------------------------------------------------------
# per-endpoint model host
# ---------------------------------------------------------------------------
@dataclass
class _SessionState:
    slot: int
    pos: int                      # next cache write position
    last: int                     # last accepted token (decode input)
    cache: Any = None             # unbatched mode: private batch-1 cache
    touched: float = field(default_factory=time.monotonic)


class ModelHost:
    """One endpoint's serving state for one model: slotted KV cache, session
    table, and the decode coalescer.

    ``batching=True`` (attention families) keeps ONE stacked cache of
    ``n_slots`` sequences — prefills insert into free slots, concurrent
    decode steps coalesce into one batched step, replayed as a CUDA graph on
    the card. Other families (or ``batching=False``, the per-request
    baseline) give each session a private batch-1 cache of ``max_len``
    positions and run one eager step per request, serialized like
    independent device programs.

    ``cuda_graph``: None replays a captured batched step on a CUDA model and
    steps eagerly on a CPU one; False steps eagerly on the card too (the
    yardstick a graphed host is compared with); True on a CPU model raises.
    """

    def __init__(
        self,
        model: Model,
        max_len: int = 96,
        max_sessions: int = 8,
        cache_bytes_budget: Optional[int] = None,
        batching: bool = True,
        window_s: float = 0.003,
        metrics=None,
        cuda_graph: Optional[bool] = None,
    ):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.max_len = max_len
        self.prefix = prefix_len(self.cfg)
        if batching and self.cfg.family not in _BATCHABLE_FAMILIES:
            batching = False
        self.batching = batching
        # admission control: slots the cache_bytes budget affords
        per_seq = kv_cache.cache_bytes(self.cfg, 1, max_len)
        if cache_bytes_budget is not None:
            max_sessions = max(1, min(max_sessions, cache_bytes_budget // per_seq))
        self.n_slots = int(max_sessions)
        self.metrics = metrics
        if metrics is not None:
            metrics.gauge("serving.cache_bytes").set(
                kv_cache.cache_bytes(self.cfg, self.n_slots, max_len)
            )
        self.batch_axes = model.cache_batch_axes()

        self._lock = threading.Lock()
        self.sessions: Dict[str, _SessionState] = {}
        self._free = set(range(self.n_slots))
        self._graph: Optional[DecodeGraph] = None
        if batching:
            self.slot_pos = np.zeros(self.n_slots, np.int32)
            self.slot_last = np.zeros(self.n_slots, np.int32)
            self.coalescer = DecodeCoalescer(
                self._batched_step,
                window_s=window_s,
                target_fn=lambda: len(self.sessions),
            )
            on_card = self.device.type == "cuda"
            use_graph = on_card if cuda_graph is None else cuda_graph
            if use_graph and not on_card:
                raise ValueError(
                    f"cuda_graph=True needs a CUDA model; this one is on {self.device}"
                )
            with _DEVICE_LOCK, torch.inference_mode():
                self.cache = model.init_cache(self.n_slots, max_len)
                # the step's static buffers: last tokens and int32 positions
                # (one host-to-device copy a step), and the greedy tokens
                self._inputs = torch.zeros(
                    (2, self.n_slots), dtype=torch.int32, device=self.device
                )
                self._sampled = torch.zeros(self.n_slots, dtype=torch.int64, device=self.device)
                if use_graph:
                    # the warm-up steps write k/v at every slot's position,
                    # so the cache is zeroed after the capture
                    self._graph = DecodeGraph.capture(
                        self._decode, model.kernel_impl, self.device
                    )
                    zero_cache(self.cache)
        else:
            self.coalescer = None

    # -- metrics helpers ---------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)

    # -- session lifecycle -------------------------------------------------
    def prefill(self, session: str, tokens, side: Optional[Dict[str, object]] = None) -> int:
        """Open (or rebuild) `session` from its full token history; returns
        the next predicted token. Raises CacheAdmissionError when every slot
        under the cache_bytes budget is taken, ValueError when the history
        (after a VLM's patches) leaves no position of max_len free.
        ``side``: the session's side inputs by name (``SIDE_INPUTS``: an
        encoder-decoder's frames, a VLM's patches), each an array or a
        callable that fetches it; none given prefills on zeros."""
        tokens = np.asarray(tokens, np.int32)
        side = check_side_input(self.cfg, {name: a() if callable(a) else a
                                           for name, a in (side or {}).items()})
        check_fits(self.cfg, len(tokens), self.max_len)
        pos = self.prefix + len(tokens)
        with self._lock:
            old = self.sessions.pop(session, None)
            if old is not None:
                self._free.add(old.slot)
            if not self._free:
                self._count("serving.admission_rejects")
                raise CacheAdmissionError(
                    f"model host full: {self.n_slots} KV slots "
                    f"({kv_cache.cache_bytes(self.cfg, self.n_slots, self.max_len)} "
                    f"bytes) all serving sessions"
                )
            slot = self._free.pop()
        # lock order: _DEVICE_LOCK, then the host's lock (see _DEVICE_LOCK)
        with _DEVICE_LOCK, torch.inference_mode():
            logits, seq_cache = self.model.prefill(prefill_batch(self.model, tokens, side))
            first = int(torch.argmax(logits[0]))
            if not self.batching:
                # a private cache of max_len positions: the decode steps
                # write past the prompt
                cache = self.model.init_cache(1, self.max_len)
                kv_cache.insert_sequence(cache, seq_cache, 0, self.batch_axes)
                seq_cache = cache
            with self._lock:
                if self.batching:
                    kv_cache.insert_sequence(self.cache, seq_cache, slot, self.batch_axes)
                    self.slot_pos[slot] = pos
                    self.slot_last[slot] = first
                    seq_cache = None
                self.sessions[session] = _SessionState(
                    slot=slot, pos=pos, last=first, cache=seq_cache
                )
                n_active = len(self.sessions)
        self._count("serving.prefills")
        self._count("serving.tokens_generated")
        if self.metrics is not None:
            self.metrics.gauge("serving.sessions_active").set(n_active)
        return first

    def decode(self, session: str, tokens,
               side: Optional[Dict[str, object]] = None) -> Tuple[int, bool]:
        """One decode step for `session`; returns ``(next_token, migrated)``.

        A hit (`serving.affinity_hits`) runs against the resident cache slot;
        a miss means the session's home died and sticky routing moved it here
        — the cache is rebuilt from the full token history (`tokens`) and
        the session's `side` inputs (as ``prefill`` takes them; a callable
        is called only here), which is the explicit re-prefill
        migration path.
        """
        with self._lock:
            st = self.sessions.get(session)
        if st is None:
            self._count("serving.cache_migrations")
            return self.prefill(session, tokens, side), True
        self._count("serving.affinity_hits")
        if self.batching:
            nxt = self.coalescer.submit(st.slot)
        else:
            # per-request baseline: one step per request
            with _DEVICE_LOCK, self._lock, torch.inference_mode():
                tok = torch.tensor([[st.last]], dtype=torch.int32, device=self.device)
                pos = torch.tensor([st.pos], dtype=torch.int32, device=self.device)
                logits, st.cache = self.model.decode_step(tok, st.cache, pos)
                nxt = int(torch.argmax(logits[0]))
                st.pos += 1
        with self._lock:
            st.last = nxt
            st.touched = time.monotonic()
        self._count("serving.tokens_generated")
        return nxt, False

    def release(self, session: str) -> bool:
        with self._lock:
            st = self.sessions.pop(session, None)
            if st is not None:
                self._free.add(st.slot)
            n_active = len(self.sessions)
        if self.metrics is not None:
            self.metrics.gauge("serving.sessions_active").set(n_active)
        return st is not None

    # -- batched decode step -----------------------------------------------
    def _decode(self) -> None:
        """The step the graph captures: decode the static tokens at the static
        positions (the cache in place) and sample greedily into ``_sampled``."""
        logits, _ = self.model.decode_step(self._inputs[0].unsqueeze(1), self.cache,
                                           self._inputs[1])
        torch.argmax(logits, dim=-1, out=self._sampled)

    def _batched_step(self, slots: List[int]) -> Dict[int, int]:
        """One decode step over the shared stacked cache serving `slots`.

        Every slot's row advances at its own position (vector pos); slots
        not in `slots` rewrite their current position with their last token
        — byte-identical values their own next step overwrites again, which
        is why batching is gated to attention families.
        """
        with _DEVICE_LOCK, self._lock, torch.inference_mode():
            inputs = np.stack([self.slot_last, self.slot_pos])
            self._inputs.copy_(torch.from_numpy(inputs))
            if self._graph is None:
                self._decode()
            else:
                self._graph.replay(self.model.kernel_impl)
            nt = self._sampled.cpu().numpy()  # greedy tokens: one copy to the host
            out = {}
            for s in slots:
                self.slot_last[s] = int(nt[s])
                self.slot_pos[s] += 1
                out[s] = int(nt[s])
        self._count("serving.decode_batches")
        if self.metrics is not None:
            self.metrics.gauge("serving.batch_occupancy").set(len(slots))
            self.metrics.histogram("serving.merged_per_step").observe(len(slots))
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "batching": self.batching,
                "slots": self.n_slots,
                "active": len(self.sessions),
                "free": len(self._free),
                "decode_batches": self.coalescer.batches if self.coalescer else 0,
                "merged": self.coalescer.merged if self.coalescer else 0,
                "cache": kv_cache.summarize(self.cfg, self.n_slots, self.max_len),
            }


# ---------------------------------------------------------------------------
# registration: model specs + per-site hosts
# ---------------------------------------------------------------------------
@dataclass
class ModelServeSpec:
    """Blueprint a site builds its ModelHost from (in-process the model and
    its weights are shared; a real deployment loads them per endpoint)."""

    name: str
    model: Model
    max_len: int
    max_sessions: int
    cache_bytes_budget: Optional[int]
    batching: bool
    window_s: float


_SPECS: Dict[str, ModelServeSpec] = {}
_SPECS_LOCK = threading.Lock()


def _host_for(site, name: str) -> ModelHost:
    with _SPECS_LOCK:
        spec = _SPECS.get(name)
    if spec is None:
        raise KeyError(f"model {name!r} not served (serve_model first)")

    def build() -> ModelHost:
        return ModelHost(
            spec.model,
            max_len=spec.max_len,
            max_sessions=spec.max_sessions,
            cache_bytes_budget=spec.cache_bytes_budget,
            batching=spec.batching,
            window_s=spec.window_s,
            metrics=site.metrics,
        )

    return site.get_or_create(("serving-host", name), build)


def reset_serving() -> None:
    """Drop every served-model spec (tests/benchmarks hygiene; hosts live in
    their endpoints' SiteRuntimes and die with them)."""
    with _SPECS_LOCK:
        _SPECS.clear()


# the side inputs a task may name (an encoder-decoder's frames, a VLM's patches)
_SIDE_NAMES = tuple(name for name, _ in SIDE_INPUTS.values())


def _fetch(key: str, store_id: str) -> Callable[[], np.ndarray]:
    return lambda: serializer.unpackb(get_store(store_id).get(key))


def _side_loaders(doc) -> Dict[str, Callable[[], np.ndarray]]:
    """A task's side input as a fetch the host calls only when it prefills,
    by name: the packed array under ``doc[name]`` (a content key) in the
    object store ``doc[name + "_store"]``; empty when the task names none."""
    return {name: _fetch(doc[name], doc[f"{name}_store"])
            for name in _SIDE_NAMES if doc.get(name) is not None}


# the three serving functions: module-level so registration is idempotent
# (same content hash) no matter how many models/services register them
def _serve_prefill(doc, site):
    host = _host_for(site, doc["model"])
    token = host.prefill(doc["session"], doc["tokens"], _side_loaders(doc))
    return {"token": token, "endpoint": site.endpoint_id, "migrated": False}


def _serve_decode(doc, site):
    host = _host_for(site, doc["model"])
    token, migrated = host.decode(doc["session"], doc["tokens"], _side_loaders(doc))
    return {"token": token, "endpoint": site.endpoint_id, "migrated": migrated}


def _serve_release(doc, site):
    host = _host_for(site, doc["model"])
    return host.release(doc["session"])


def serve_model(
    service,
    model: Model,
    name: str,
    max_len: int = 96,
    max_sessions: int = 8,
    cache_bytes_budget: Optional[int] = None,
    batching: bool = True,
    window_s: float = 0.003,
    token=None,
) -> "ServingClient":
    """Register `model` as a fabric-served inference workload.

    Registers prefill/decode/release as public fabric functions requiring
    the ``torch`` capability and records the host blueprint every
    torch-capable endpoint builds lazily on first task. Returns a
    :class:`ServingClient` bound to this service.
    """
    spec = ModelServeSpec(
        name=name,
        model=model,
        max_len=max_len,
        max_sessions=max_sessions,
        cache_bytes_budget=cache_bytes_budget,
        batching=batching,
        window_s=window_s,
    )
    with _SPECS_LOCK:
        _SPECS[name] = spec
    requirements = ResourceSpec(capabilities=frozenset({"torch"}))
    common = dict(
        public=True, requirements=requirements, token=token,
        site_aware=True, serialize_result=False,
    )
    fids = {
        "prefill": service.register_function(
            _serve_prefill, name="serving/prefill",
            description="prefill-into-slot for served models",
            **common,
        ),
        "decode": service.register_function(
            _serve_decode, name="serving/decode_step",
            description="coalesced decode step for served models", **common,
        ),
        "release": service.register_function(
            _serve_release, name="serving/release",
            description="free a session's KV-cache slot", **common,
        ),
    }
    return ServingClient(service, name, fids, max_len=max_len, token=token,
                         prefix=prefix_len(model.cfg))


# ---------------------------------------------------------------------------
# client surface
# ---------------------------------------------------------------------------
class ServeSession:
    """One sticky generation session: every step routes with the same
    ``session_id`` so the Forwarder pins it to the endpoint holding its
    KV-cache slot."""

    def __init__(self, client: "ServingClient", session_id: str,
                 history: List[int], first_token: int, endpoint: str,
                 ttft_s: float, side_ref: Optional[Dict[str, str]] = None):
        self._client = client
        self.session_id = session_id
        self.side_ref = side_ref or {}   # e.g. {"patches": key, "patches_store": id}
        self.history = history          # prompt + every generated token
        self.tokens = [first_token]     # generated tokens only
        self.endpoints = [endpoint]     # serving endpoint per step
        self.migrations = 0
        self.ttft_s = ttft_s
        self.closed = False

    def step(self, timeout: float = 60.0) -> int:
        """One decode step (one fabric task). The full token history and the
        side input's key ride along so a failed-over session can re-prefill
        on its new endpoint."""
        out = self._client._call(
            "decode",
            {"session": self.session_id, "tokens": list(self.history), **self.side_ref},
            session_id=self.session_id,
            timeout=timeout,
        )
        self.history.append(out["token"])
        self.tokens.append(out["token"])
        self.endpoints.append(out["endpoint"])
        self.migrations += bool(out["migrated"])
        return out["token"]

    def stream(self, max_new_tokens: int, eos_id: int = -1,
               timeout: float = 60.0) -> Iterator[int]:
        """Yield generated tokens (including the prefill's first token)
        until `max_new_tokens`, EOS, or the host's context limit."""
        yield self.tokens[0]
        while (
            len(self.tokens) < max_new_tokens
            and self.tokens[-1] != eos_id
            and self._client.prefix + len(self.history) < self._client.max_len - 1
        ):
            yield self.step(timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self._client._call(
                "release", {"session": self.session_id},
                session_id=self.session_id, timeout=timeout,
            )
        finally:
            sessions = getattr(self._client.service.forwarder, "sessions", None)
            if sessions is not None:
                sessions.forget(self.session_id)
            self._client._drop_side(self.side_ref)

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServingClient:
    """Client surface over a served model: open sticky sessions, stream
    tokens, observe TTFT through the fabric metrics."""

    def __init__(self, service, model_name: str, fids: Dict[str, str],
                 max_len: int, token=None, prefix: int = 0):
        self.service = service
        self.model_name = model_name
        self.fids = fids
        self.max_len = max_len
        self.prefix = prefix          # cache positions before a prompt: a VLM's patches
        self.token = token
        # side inputs of open sessions, when the service has no datastore:
        # the client's own store, and how many open sessions use each key
        self._side_store: Optional[InMemoryStore] = None
        self._side_users: Dict[str, int] = {}
        self._side_lock = threading.Lock()

    def _put_side(self, side: Dict[str, object]) -> Dict[str, str]:
        """Pack each side input given (by name; None skipped) into an object
        store once; returns the keys and the store's id that the session's
        tasks carry."""
        ref = {}
        for name, a in side.items():
            if a is None:
                continue
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            blob = serializer.packb(np.asarray(a))
            with self._side_lock:
                store = self.service.datastore
                if store is None:
                    if self._side_store is None:
                        self._side_store = InMemoryStore()
                    store = self._side_store
                key = store.put(blob)
                if store is self._side_store:
                    self._side_users[key] = self._side_users.get(key, 0) + 1
            ref.update({name: key, f"{name}_store": store.store_id})
        return ref

    def _drop_side(self, ref: Dict[str, str]) -> None:
        """A session closed: drop its side inputs from the client's own store
        once no open session uses them (the service's datastore keeps them)."""
        with self._side_lock:
            for key in (ref.get(name) for name in _SIDE_NAMES):
                if key is None or key not in self._side_users:
                    continue
                self._side_users[key] -= 1
                if not self._side_users[key]:
                    del self._side_users[key]
                    self._side_store.delete(key)

    def _call(self, which: str, doc: dict, session_id: Optional[str] = None,
              endpoint_id: Optional[str] = None, timeout: float = 60.0):
        doc = {"model": self.model_name, **doc}
        future = self.service.run(
            self.fids[which], doc,
            endpoint_id=endpoint_id, session_id=session_id,
            token=self.token,
        )
        return future.result(timeout)

    def session(self, prompt, session_id: Optional[str] = None,
                endpoint_id: Optional[str] = None, timeout: float = 60.0,
                admission_retries: int = 2, frames=None, patches=None) -> ServeSession:
        """Prefill `prompt` into a slot somewhere and return the sticky
        session. A CacheAdmissionError (endpoint full under its cache_bytes
        budget) forgets the binding and retries, letting the policy place
        the session on an endpoint with free slots. ``frames`` (encoder-
        decoder models): (enc_seq, d_model); ``patches`` (VLM models):
        (n_patches, d_model); numpy or a tensor, put once into an object
        store; None prefills on zeros."""
        session_id = session_id or f"s-{uuid.uuid4().hex[:12]}"
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        side_ref = self._put_side({"frames": frames, "patches": patches})
        t0 = time.monotonic()
        attempt = 0
        try:
            while True:
                try:
                    out = self._call(
                        "prefill", {"session": session_id, "tokens": prompt, **side_ref},
                        session_id=session_id, endpoint_id=endpoint_id,
                        timeout=timeout,
                    )
                    break
                except CacheAdmissionError:
                    attempt += 1
                    sessions = getattr(self.service.forwarder, "sessions", None)
                    if sessions is not None:
                        sessions.forget(session_id)
                    if attempt > admission_retries:
                        raise
        except BaseException:
            self._drop_side(side_ref)
            raise
        ttft = time.monotonic() - t0
        self.service.metrics.histogram("serving.ttft_s").observe(ttft)
        return ServeSession(
            self, session_id, history=prompt + [out["token"]],
            first_token=out["token"], endpoint=out["endpoint"], ttft_s=ttft,
            side_ref=side_ref,
        )

    def generate(self, prompt, max_new_tokens: int = 16, eos_id: int = -1,
                 timeout: float = 60.0, frames=None, patches=None) -> List[int]:
        with self.session(prompt, timeout=timeout, frames=frames, patches=patches) as s:
            return list(s.stream(max_new_tokens, eos_id=eos_id, timeout=timeout))
