"""Data fabric tier: content-addressed object stores + ``DataRef`` indirection.

The paper's pitch is that "computation is mobile, so that ... it can occur
near data", and the funcX journal follow-up (arXiv:2209.11631) lands this as
a first-class tier: pluggable object stores plus data-aware placement. Here
large payload/result leaves stop travelling inline through the Forwarder:

- An :class:`ObjectStore` holds content-hashed blobs (sha256 of the packed
  bytes is the key, so identical data dedupes to one blob). The surface is
  lithops-storage shaped: ``put_object``/``get_object``/``head_object``/
  ``delete_object``/``list_keys`` alias the native ``put``/``get``/... API.
- A :class:`DataRef` (key, size, locations) is a frozen leaf that may appear
  anywhere in a task payload pytree. The serializer packs/unpacks refs as an
  ext type, so a ref-bearing payload is a few hundred bytes on the wire no
  matter how large the data behind it is.
- :func:`spill_payload` replaces big array/bytes leaves with refs (the
  ``FunctionService.spill_threshold`` knob); :func:`resolve_payload`
  materializes them back, preferring a per-endpoint locality cache so a
  dataset shared by many tasks is fetched from the backing store once.

Stores self-register in a process-global registry keyed by ``store_id``
(``mem://...`` / ``fs://<abspath>``) so a ref's ``locations`` tuple is enough
to find bytes from any tier — including a *restarted* fabric: ``get_store``
auto-attaches ``fs://`` stores from their path, which is what keeps journaled
ref-bearing payloads resolvable across a crash (see docs/data.md).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import serializer
from .metrics import MetricsRegistry

#: default FunctionService spill threshold (bytes of packed leaf data)
DEFAULT_SPILL_THRESHOLD = 64 * 1024


@dataclass(frozen=True)
class DataRef:
    """A by-reference leaf in a task payload: content key + size + where the
    bytes live. ``locations`` is advisory placement metadata (store ids, best
    first); two refs to the same content with different location lists are
    the *same* data — ``payload_hash`` excludes locations so memoization keys
    don't change when data moves."""

    key: str
    size: int
    locations: Tuple[str, ...] = ()

    def __repr__(self) -> str:  # keep large fan-out logs readable
        return f"DataRef({self.key[:12]}…, {self.size}B, {len(self.locations)} loc)"


class ObjectStore:
    """Content-addressed blob store base: ``put(data) -> key`` where the key
    is the sha256 hex digest of the bytes (idempotent — re-putting identical
    content is a no-op). Subclasses implement the four raw-blob primitives."""

    def __init__(self, store_id: str, register: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.store_id = store_id
        self.metrics: Optional[MetricsRegistry] = metrics
        self._lock = threading.Lock()
        if register:
            register_store(self)

    # -- primitives (override) --------------------------------------------
    def _write(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def _read(self, key: str) -> bytes:
        raise NotImplementedError

    def _has(self, key: str) -> bool:
        raise NotImplementedError

    def _delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> List[str]:
        raise NotImplementedError

    # -- shared surface ----------------------------------------------------
    @staticmethod
    def content_key(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()

    def put(self, data: bytes, key: Optional[str] = None) -> str:
        data = bytes(data)
        if key is None:
            key = self.content_key(data)
        with self._lock:
            if not self._has(key):
                self._write(key, data)
                self._account()
        return key

    def get(self, key: str) -> bytes:
        with self._lock:
            if not self._has(key):
                raise KeyError(f"{self.store_id}: no blob {key[:12]}…")
            return self._read(key)

    def delete(self, key: str) -> bool:
        with self._lock:
            if not self._has(key):
                return False
            self._delete(key)
            self._account()
        return True

    def __contains__(self, key: object) -> bool:
        with self._lock:
            return isinstance(key, str) and self._has(key)

    def __len__(self) -> int:
        return len(self.keys())

    def total_bytes(self) -> int:
        raise NotImplementedError

    def bind_metrics(self, metrics: MetricsRegistry) -> None:
        """Adopt a fabric registry: resident-object/byte gauges (labeled by
        store) land in the shared telemetry snapshot."""
        self.metrics = metrics
        with self._lock:
            self._account()

    def _account(self) -> None:
        # called with the lock held, after any mutation
        if self.metrics is None:
            return
        labels = {"store": self.store_id}
        self.metrics.gauge("data.objects", labels).set(len(self.keys()))
        self.metrics.gauge("data.store_bytes", labels).set(self.total_bytes())

    def close(self) -> None:
        """Deregister from the process-global registry (blobs stay put for
        filesystem stores; in-memory blobs die with the object)."""
        deregister_store(self.store_id)

    # -- lithops-storage-shaped aliases ------------------------------------
    def put_object(self, key: str, body: bytes) -> str:
        return self.put(body, key=key)

    def get_object(self, key: str) -> bytes:
        return self.get(key)

    def head_object(self, key: str) -> dict:
        if key not in self:
            raise KeyError(f"{self.store_id}: no blob {key[:12]}…")
        return {"key": key, "size": len(self.get(key))}

    def delete_object(self, key: str) -> bool:
        return self.delete(key)

    def list_keys(self) -> List[str]:
        return self.keys()

    def stats(self) -> dict:
        return {
            "store_id": self.store_id,
            "objects": len(self.keys()),
            "bytes": self.total_bytes(),
        }


class InMemoryStore(ObjectStore):
    """Dict-backed store: the per-endpoint locality cache and the test/bench
    default. Blobs do not survive the process."""

    def __init__(self, store_id: Optional[str] = None, register: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self._blobs: Dict[str, bytes] = {}
        super().__init__(
            store_id or f"mem://{uuid.uuid4().hex[:8]}",
            register=register, metrics=metrics,
        )

    def _write(self, key: str, data: bytes) -> None:
        self._blobs[key] = data

    def _read(self, key: str) -> bytes:
        return self._blobs[key]

    def _has(self, key: str) -> bool:
        return key in self._blobs

    def _delete(self, key: str) -> None:
        self._blobs.pop(key, None)

    def keys(self) -> List[str]:
        return list(self._blobs)

    def total_bytes(self) -> int:
        return sum(len(b) for b in self._blobs.values())


class FileSystemStore(ObjectStore):
    """Blob-per-file store rooted at a directory. The ``store_id`` is derived
    from the absolute path (``fs://<abspath>``), so any process — including a
    restarted fabric resuming from a journal — can re-attach the same store
    from a ref's location string alone. Writes are atomic (tmp + rename): a
    crash mid-put never leaves a torn blob behind."""

    def __init__(self, directory: str, register: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        super().__init__(
            f"fs://{self.directory}", register=register, metrics=metrics,
        )

    def _path(self, key: str) -> str:
        if os.sep in key or key in (".", ".."):
            raise ValueError(f"invalid blob key {key!r}")
        return os.path.join(self.directory, f"{key}.blob")

    def _write(self, key: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
            os.replace(tmp, self._path(key))  # atomic on POSIX
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _read(self, key: str) -> bytes:
        with open(self._path(key), "rb") as fh:
            return fh.read()

    def _has(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def _delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self) -> List[str]:
        return [
            name[: -len(".blob")]
            for name in os.listdir(self.directory)
            if name.endswith(".blob")
        ]

    def total_bytes(self) -> int:
        total = 0
        for name in os.listdir(self.directory):
            if name.endswith(".blob"):
                try:
                    total += os.path.getsize(os.path.join(self.directory, name))
                except OSError:
                    pass
        return total


# -- process-global store registry -----------------------------------------
# A ref's `locations` are store ids; any tier (endpoint dispatch, worker
# safety net, a restarted service resuming from its journal) resolves them
# here. `fs://` stores auto-attach from their path — the durable half of the
# fabric needs no in-memory survivor to find its bytes again.
_STORES: Dict[str, ObjectStore] = {}
_STORES_LOCK = threading.Lock()


def register_store(store: ObjectStore) -> None:
    with _STORES_LOCK:
        _STORES[store.store_id] = store


def deregister_store(store_id: str) -> None:
    with _STORES_LOCK:
        _STORES.pop(store_id, None)


def get_store(store_id: str) -> ObjectStore:
    """Look a store up by id, auto-attaching ``fs://`` stores whose directory
    exists (restart path). Raises KeyError for anything unreachable."""
    with _STORES_LOCK:
        store = _STORES.get(store_id)
    if store is not None:
        return store
    if store_id.startswith("fs://"):
        path = store_id[len("fs://"):]
        if os.path.isdir(path):
            return FileSystemStore(path)
    raise KeyError(f"no reachable object store {store_id!r}")


def reset_store_registry() -> None:
    """Forget every registered store (tests simulating a process restart)."""
    with _STORES_LOCK:
        _STORES.clear()


# -- spill / resolve over payload pytrees -----------------------------------
def _leaf_nbytes(leaf: Any) -> int:
    if isinstance(leaf, np.ndarray):
        return int(leaf.nbytes)
    if isinstance(leaf, (bytes, bytearray)):
        return len(leaf)
    if hasattr(leaf, "__array__") and not isinstance(leaf, (bool, int, float, complex, str)):
        try:
            return int(np.asarray(leaf).nbytes)
        except Exception:
            return 0
    return 0


def spill_payload(
    payload: Any,
    store: ObjectStore,
    threshold: int,
    metrics: Optional[MetricsRegistry] = None,
) -> Tuple[Any, List[DataRef]]:
    """Replace every array/bytes leaf of at least `threshold` bytes with a
    :class:`DataRef` into `store` (blob = the serializer-packed leaf, so a
    resolve is a plain ``unpackb``). Returns the new payload and the full
    ref list it carries — spilled ones plus any refs already present — which
    the Forwarder's transfer estimator consumes. Content-hash keys mean N
    tasks sharing one dataset store one blob."""
    if metrics is None:
        metrics = store.metrics
    refs: List[DataRef] = []

    def walk(obj: Any) -> Any:
        if isinstance(obj, DataRef):
            refs.append(obj)
            return obj
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            out = [walk(v) for v in obj]
            return tuple(out) if isinstance(obj, tuple) else out
        if 0 < threshold <= _leaf_nbytes(obj):
            blob = serializer.packb(obj)
            key = store.put(blob)
            ref = DataRef(key=key, size=len(blob), locations=(store.store_id,))
            refs.append(ref)
            if metrics is not None:
                metrics.counter("data.spilled_leaves").inc()
                metrics.counter("data.bytes_spilled").inc(len(blob))
            return ref
        return obj

    return walk(payload), refs


def scan_refs(payload: Any) -> List[DataRef]:
    """Collect DataRef leaves nested anywhere in a payload pytree."""
    found: List[DataRef] = []

    def walk(obj: Any) -> None:
        if isinstance(obj, DataRef):
            found.append(obj)
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(payload)
    return found


def _fetch_blob(
    ref: DataRef,
    cache: Optional[ObjectStore],
    metrics: Optional[MetricsRegistry],
) -> bytes:
    if cache is not None and ref.key in cache:
        if metrics is not None:
            metrics.counter("data.cache_hits").inc()
        return cache.get(ref.key)
    last_err: Optional[Exception] = None
    for loc in ref.locations:
        try:
            store = get_store(loc)
            blob = store.get(ref.key)
        except KeyError as exc:
            last_err = exc
            continue
        if metrics is not None:
            metrics.counter("data.cache_misses").inc()
            metrics.counter("data.bytes_fetched").inc(len(blob))
        if cache is not None:
            cache.put(blob, key=ref.key)  # locality: next task hits locally
        return blob
    raise KeyError(
        f"DataRef {ref.key[:12]}… unresolvable from locations "
        f"{list(ref.locations)}: {last_err}"
    )


def _fresh_copy(obj: Any) -> Any:
    """Deep-copy the mutable parts of a decoded value so a cached decode can
    be handed to a task without mutations leaking into later tasks. Arrays
    cost one memcpy (which releases the GIL) — far cheaper than re-running
    the msgpack decode path per task."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return {k: _fresh_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_fresh_copy(v) for v in obj]
        return tuple(out) if isinstance(obj, tuple) else out
    if isinstance(obj, bytearray):
        return bytearray(obj)
    return obj


def resolve_payload(
    payload: Any,
    cache: Optional[ObjectStore] = None,
    metrics: Optional[MetricsRegistry] = None,
    decoded: Optional[Dict[str, Any]] = None,
) -> Any:
    """Materialize every :class:`DataRef` leaf back into its value,
    preferring `cache` (the per-endpoint locality store) over the ref's
    backing locations. Raises ``KeyError`` when a ref points nowhere
    reachable.

    `decoded` is an optional per-endpoint decoded-value cache (plain dict,
    keyed by blob key): when many tasks at one site reference the same blob,
    the msgpack decode runs once and every resolve hands out a fresh deep
    copy of the cached value — mutation-safe, and the per-task cost drops to
    a memcpy. Concurrent workers may race to populate a key; the duplicate
    decode is harmless and last-write-wins."""

    def walk(obj: Any) -> Any:
        if isinstance(obj, DataRef):
            if metrics is not None:
                metrics.counter("data.resolved_refs").inc()
            if decoded is not None and obj.key in decoded:
                if metrics is not None:
                    metrics.counter("data.decoded_hits").inc()
                return _fresh_copy(decoded[obj.key])
            blob = _fetch_blob(obj, cache, metrics)
            if decoded is not None:
                # cache-bound decode: zero-copy read-only views over the blob
                # bytes — every hand-out below goes through _fresh_copy, whose
                # ndarray.copy() yields a writable array, so the upfront
                # unpack copy was pure waste
                value = serializer.unpackb(blob, writable=False)
                decoded[obj.key] = value
                return _fresh_copy(value)
            return serializer.unpackb(blob)
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            out = [walk(v) for v in obj]
            return tuple(out) if isinstance(obj, tuple) else out
        return obj

    return walk(payload)


def prefetch_refs(
    refs: Iterable[DataRef],
    cache: ObjectStore,
    metrics: Optional[MetricsRegistry] = None,
) -> int:
    """Warm a locality cache with every blob the refs point at (the endpoint
    dispatch path). Only raw blob bytes move — no unpack/repack — and a key
    already resident costs a membership probe, not a read, so the serial
    dispatch loop pays one store read per *new* key and the workers
    materialize values in parallel from the warmed cache."""
    n = 0
    for ref in refs:
        if ref.key in cache:
            if metrics is not None:
                metrics.counter("data.cache_hits").inc()
        else:
            _fetch_blob(ref, cache, metrics)
        n += 1
    return n


def resolve_packed(
    packed: bytes,
    cache: Optional[ObjectStore] = None,
    metrics: Optional[MetricsRegistry] = None,
) -> bytes:
    """Resolve a *packed* ref-bearing payload back to inline packed bytes
    (the endpoint dispatch path: refs materialize at the endpoint, workers
    see plain payloads). The intermediate tree is repacked immediately, never
    handed to user code, so the unpack side rides the zero-copy fast path."""
    return serializer.packb(
        resolve_payload(
            serializer.unpackb(packed, writable=False), cache=cache, metrics=metrics
        )
    )
