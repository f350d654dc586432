"""Write-ahead journal: durable workflow/task lifecycle state.

Everything else in the fabric is in-memory — a restart loses every run. The
funcX journal follow-up makes durable task state and exactly-once result
delivery the production story; this module is that tier:

- :class:`Journal` — an append-only write-ahead log of lifecycle records
  (task ``submitted → routed → completed/failed``, workflow-run
  ``started → node_completed → finished``). Records are crc32-framed so a
  crash mid-append leaves a truncated tail that replay detects and skips;
  compaction reuses the atomic tmp-write-then-rename + GC idiom of
  :mod:`repro.checkpoint.checkpointer` (a snapshot segment replaces the
  history it folds).
- :class:`JournalState` — the fold of a journal's records: per-task and
  per-run progress, used by ``FunctionService.resume`` / ``Workflow.resume``
  to re-execute only unfinished work after a fabric restart.
- :class:`ResultStore` — the Forwarder's task-id-keyed idempotent result
  record. A completion lands here exactly once; replayed or speculated
  duplicates are counted in ``journal.duplicate_results`` and dropped.

Exactly-once semantics (see docs/durability.md): a task's *committed result*
— the journal terminal record and the future resolution — happens exactly
once. Execution of work whose completion was never journaled is re-driven on
resume (standard WAL at-least-once execution, exactly-once commitment).
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import serializer
from .metrics import BYTES_BUCKETS, MetricsRegistry

# Frame layout: MAGIC (2B) | payload length (uint32 LE) | crc32 (uint32 LE)
# | msgpack payload. A torn write anywhere in the frame fails either the
# length read or the crc check and terminates replay of that segment.
_MAGIC = b"WJ"
_HEADER = struct.Struct("<II")
_SEG_PREFIX = "seg_"
_SEG_SUFFIX = ".wal"

# Record kinds / task terminal states, shared with the fold below.
KIND_TASK = "task"
KIND_RUN = "run"
TASK_TERMINAL = ("completed", "failed")


def _segment_name(index: int) -> str:
    return f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}"


def _segment_index(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


@dataclass
class TaskJournalEntry:
    """Folded journal view of one task's lifecycle."""

    task_id: str
    function_id: Optional[str] = None
    payload: Optional[bytes] = None     # serialized input (None: not resumable)
    container: str = "default"
    requirements: Tuple[str, ...] = ()
    max_retries: int = 2
    owner: Optional[str] = None         # e.g. a workflow run_id; owned tasks
    endpoint_id: Optional[str] = None   # are resumed by their owner, not
    status: str = "submitted"           # submitted | routed | completed | failed
    value: Optional[bytes] = None       # packed result (completed only)
    error: Optional[str] = None

    @property
    def terminal(self) -> bool:
        return self.status in TASK_TERMINAL

    @property
    def resumable(self) -> bool:
        """Re-submittable from the journal alone: incomplete, with a wire
        payload (pass-through payloads never serialize) and no owner."""
        return (
            not self.terminal
            and self.payload is not None
            and self.function_id is not None
            and self.owner is None
        )

    def result(self) -> Any:
        """Unpack the committed result (completed tasks only)."""
        if self.status != "completed" or self.value is None:
            raise ValueError(f"task {self.task_id} has no committed result")
        return serializer.unpackb(self.value)


@dataclass
class RunJournalEntry:
    """Folded journal view of one workflow run."""

    run_id: str
    workflow: str
    document: Optional[bytes] = None    # packed initial document
    nodes: List[str] = field(default_factory=list)
    node_results: Dict[str, Optional[bytes]] = field(default_factory=dict)
    node_skipped: Dict[str, bool] = field(default_factory=dict)
    state: str = "ACTIVE"               # ACTIVE | SUCCEEDED | FAILED | CANCELLED
    resumed: int = 0

    @property
    def terminal(self) -> bool:
        return self.state != "ACTIVE"

    def done_nodes(self) -> List[str]:
        """Nodes with a committed downstream-visible result."""
        return [
            n for n in self.node_results
            if self.node_results[n] is not None or self.node_skipped.get(n)
        ]


class JournalState:
    """The fold of a journal's records. ``duplicate_completions`` counts
    terminal records for already-terminal tasks/nodes — the journal-level
    exactly-once check (a healthy fabric keeps it at zero)."""

    def __init__(self) -> None:
        self.tasks: Dict[str, TaskJournalEntry] = {}
        self.runs: Dict[str, RunJournalEntry] = {}
        self.duplicate_completions = 0
        self.truncated_records = 0

    # -- fold ----------------------------------------------------------------
    def apply(self, rec: dict) -> None:
        kind, event = rec.get("kind"), rec.get("event")
        if kind == KIND_TASK:
            self._apply_task(event, rec)
        elif kind == KIND_RUN:
            self._apply_run(event, rec)

    def _apply_task(self, event: str, rec: dict) -> None:
        tid = rec["task_id"]
        entry = self.tasks.get(tid)
        if entry is None:
            entry = self.tasks[tid] = TaskJournalEntry(task_id=tid)
        if event == "submitted":
            # resubmission after resume re-appends `submitted`: idempotent
            entry.function_id = rec.get("function_id", entry.function_id)
            if rec.get("payload") is not None:
                entry.payload = rec["payload"]
            entry.container = rec.get("container", entry.container)
            entry.requirements = tuple(rec.get("requirements") or ())
            entry.max_retries = rec.get("max_retries", entry.max_retries)
            entry.owner = rec.get("owner", entry.owner)
            if not entry.terminal:
                entry.status = "submitted"
        elif event == "routed":
            entry.endpoint_id = rec.get("endpoint_id")
            if not entry.terminal:
                entry.status = "routed"
        elif event in TASK_TERMINAL:
            if entry.terminal:
                self.duplicate_completions += 1  # first commitment wins
                return
            entry.status = event
            entry.value = rec.get("value")
            entry.error = rec.get("error")

    def _apply_run(self, event: str, rec: dict) -> None:
        rid = rec["run_id"]
        run = self.runs.get(rid)
        if run is None:
            run = self.runs[rid] = RunJournalEntry(
                run_id=rid, workflow=rec.get("workflow", "")
            )
        if event == "started":
            run.workflow = rec.get("workflow", run.workflow)
            run.document = rec.get("document")
            run.nodes = list(rec.get("nodes") or ())
        elif event == "resumed":
            run.resumed += 1
        elif event == "node_completed":
            node = rec["node"]
            if node in run.node_results:
                self.duplicate_completions += 1  # first commitment wins
                return
            run.node_results[node] = rec.get("result")
        elif event == "node_skipped":
            node = rec["node"]
            if node in run.node_results:
                self.duplicate_completions += 1
                return
            run.node_results[node] = None
            run.node_skipped[node] = True
        elif event == "finished":
            if not run.terminal:
                run.state = rec.get("state", "SUCCEEDED")

    # -- queries -------------------------------------------------------------
    def incomplete_tasks(self) -> List[TaskJournalEntry]:
        return [e for e in self.tasks.values() if not e.terminal]

    def incomplete_runs(self) -> List[RunJournalEntry]:
        return [r for r in self.runs.values() if not r.terminal]


class Journal:
    """Append-only write-ahead log over a directory of segment files.

    Every :class:`Journal` instance opens a *fresh* segment — an old
    segment's truncated tail (the record a crash tore mid-write) stays
    quarantined in its file and replay simply stops reading that segment at
    the tear. ``append`` is thread-safe and flushes per record; ``sync=True``
    additionally fsyncs (durable against power loss, ~10x slower).
    """

    def __init__(
        self,
        directory: str,
        sync: bool = False,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.directory = directory
        self.sync = sync
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._closed = False
        existing = self._segment_indices()
        self._seg_index = (existing[-1] + 1) if existing else 1
        self._fh = open(self._segment_path(self._seg_index), "ab")
        self.metrics.gauge("journal.segments").set(len(self._segment_indices()))

    # -- segment bookkeeping -------------------------------------------------
    def _segment_path(self, index: int) -> str:
        return os.path.join(self.directory, _segment_name(index))

    def _segment_indices(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            idx = _segment_index(name)
            if idx is not None:
                out.append(idx)
        return sorted(out)

    def segments(self) -> List[str]:
        """Segment file paths, oldest first."""
        return [self._segment_path(i) for i in self._segment_indices()]

    # -- append --------------------------------------------------------------
    def append(self, kind: str, event: str, **fields: Any) -> Optional[dict]:
        """Append one record. Returns the record dict, or None when the
        journal is closed — a closed journal drops writes silently, which is
        exactly what a crashed fabric does (the chaos tier's kill-the-fabric
        simulation is ``journal.close()``)."""
        rec = {"kind": kind, "event": event, **fields}
        payload = serializer.packb(rec)
        frame = _MAGIC + _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._closed:
                return None
            self._fh.write(frame)
            self._fh.flush()
            if self.sync:
                os.fsync(self._fh.fileno())
        self.metrics.counter("journal.records_appended").inc()
        self.metrics.counter("journal.bytes_appended").inc(len(frame))
        self.metrics.histogram(
            "journal.record_bytes", buckets=BYTES_BUCKETS
        ).observe(len(frame))
        return rec

    # -- replay --------------------------------------------------------------
    def _read_segment(self, path: str) -> Iterator[dict]:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        off, n = 0, len(data)
        while off < n:
            head_end = off + len(_MAGIC) + _HEADER.size
            if data[off:off + len(_MAGIC)] != _MAGIC or head_end > n:
                break  # torn/garbage tail: skip the rest of this segment
            length, crc = _HEADER.unpack(data[off + len(_MAGIC):head_end])
            body_end = head_end + length
            if body_end > n:
                break  # crash mid-payload
            payload = data[head_end:body_end]
            if zlib.crc32(payload) != crc:
                break  # crash mid-frame overwritten / bit rot
            try:
                yield serializer.unpackb(payload)
            except Exception:
                break
            off = body_end
        if off < n:
            self.metrics.counter("journal.truncated_records").inc()

    def records(self) -> Iterator[dict]:
        """Every readable record across all segments, oldest first. A
        truncated tail record (crash during append) is skipped, never
        surfaced."""
        with self._lock:
            if not self._closed:
                self._fh.flush()
        for path in self.segments():
            yield from self._read_segment(path)

    def state(self) -> JournalState:
        st = JournalState()
        for rec in self.records():
            st.apply(rec)
        return st

    # -- compaction (checkpointer idiom: tmp write, rename, GC) --------------
    def compact(self) -> JournalState:
        """Fold the full history into a snapshot segment and GC the segments
        it replaces. The snapshot is written to ``<seg>.tmp`` and renamed
        into place — a crash mid-compaction leaves the old segments intact
        and an orphan ``.tmp`` that is ignored (and removed next compact)."""
        st = self.state()
        with self._lock:
            if self._closed:
                return st
            old = self._segment_indices()
            self._fh.close()
            snap_index = (old[-1] + 1) if old else 1
            snap_path = self._segment_path(snap_index)
            tmp = snap_path + ".tmp"
            with open(tmp, "wb") as f:
                for rec in self._snapshot_records(st):
                    payload = serializer.packb(rec)
                    f.write(
                        _MAGIC
                        + _HEADER.pack(len(payload), zlib.crc32(payload))
                        + payload
                    )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, snap_path)
            for idx in old:  # GC the history the snapshot folded
                try:
                    os.remove(self._segment_path(idx))
                except FileNotFoundError:
                    pass
            for name in os.listdir(self.directory):  # orphan tmps from crashes
                if name.endswith(".tmp"):
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except FileNotFoundError:
                        pass
            self._seg_index = snap_index + 1
            self._fh = open(self._segment_path(self._seg_index), "ab")
        self.metrics.counter("journal.compactions").inc()
        self.metrics.gauge("journal.segments").set(len(self._segment_indices()))
        return st

    @staticmethod
    def _snapshot_records(st: JournalState) -> Iterator[dict]:
        """Minimal record stream reproducing `st` when folded."""
        for e in st.tasks.values():
            yield {
                "kind": KIND_TASK, "event": "submitted", "task_id": e.task_id,
                "function_id": e.function_id, "payload": e.payload,
                "container": e.container, "requirements": list(e.requirements),
                "max_retries": e.max_retries, "owner": e.owner,
            }
            if e.endpoint_id is not None:
                yield {
                    "kind": KIND_TASK, "event": "routed",
                    "task_id": e.task_id, "endpoint_id": e.endpoint_id,
                }
            if e.terminal:
                yield {
                    "kind": KIND_TASK, "event": e.status, "task_id": e.task_id,
                    "value": e.value, "error": e.error,
                }
        for r in st.runs.values():
            yield {
                "kind": KIND_RUN, "event": "started", "run_id": r.run_id,
                "workflow": r.workflow, "document": r.document,
                "nodes": list(r.nodes),
            }
            for node, result in r.node_results.items():
                if r.node_skipped.get(node):
                    yield {
                        "kind": KIND_RUN, "event": "node_skipped",
                        "run_id": r.run_id, "node": node,
                    }
                else:
                    yield {
                        "kind": KIND_RUN, "event": "node_completed",
                        "run_id": r.run_id, "node": node, "result": result,
                    }
            if r.terminal:
                yield {
                    "kind": KIND_RUN, "event": "finished",
                    "run_id": r.run_id, "state": r.state,
                }

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop accepting writes (subsequent appends drop silently — the
        crashed-fabric simulation) and release the file handle."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._fh.flush()
            finally:
                self._fh.close()


class ResultStore:
    """Task-id-keyed idempotent result record (the Forwarder's exactly-once
    authority). ``record`` accepts the first terminal outcome for a task and
    rejects every later one, counting it in ``journal.duplicate_results``;
    ``prime`` seeds completed ids from a journal replay without counting.
    Bounded FIFO so a long-lived fabric cannot grow it without limit."""

    def __init__(
        self,
        max_entries: int = 65536,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.max_entries = max_entries
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[Any, Optional[BaseException]]]" = (
            OrderedDict()
        )

    def record(
        self,
        task_id: str,
        value: Any = None,
        error: Optional[BaseException] = None,
    ) -> bool:
        """Record a terminal outcome. Returns False (and bumps the duplicate
        counter) when `task_id` already has one — the caller must not apply
        the outcome again."""
        with self._lock:
            if task_id in self._entries:
                dup = True
            else:
                dup = False
                self._entries[task_id] = (value, error)
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
        if dup:
            self.metrics.counter("journal.duplicate_results").inc()
        return not dup

    def prime(self, task_id: str) -> None:
        """Seed a completed task id (journal replay at resume) so replayed
        late deliveries dedupe — never counted as a duplicate itself."""
        with self._lock:
            if task_id not in self._entries:
                self._entries[task_id] = (None, None)
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)

    def get(self, task_id: str) -> Optional[Tuple[Any, Optional[BaseException]]]:
        with self._lock:
            return self._entries.get(task_id)

    def __contains__(self, task_id: str) -> bool:
        with self._lock:
            return task_id in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


@dataclass
class ResumeReport:
    """What :meth:`FunctionService.resume` rehydrated from the journal.

    ``futures`` — fresh TaskFutures for re-submitted standalone tasks, keyed
    by their original task_id (ids are stable across restarts so terminal
    journal records keep matching). ``runs`` — resumed WorkflowRuns by
    run_id. ``skipped`` — (id, reason) pairs for work the journal knows about
    but this fabric cannot resume (unregistered function, no workflow
    definition supplied, unserializable payload)."""

    futures: Dict[str, Any] = field(default_factory=dict)
    runs: Dict[str, Any] = field(default_factory=dict)
    skipped: List[Tuple[str, str]] = field(default_factory=list)
    state: Optional[JournalState] = None
