"""The fabric of the port: a copy of ``repro.core`` (funcX as a runtime).

It exports what the reference's ``repro.core`` exports, its workflow engine
(``automation``) and its lithops-style client helpers (``client``) included.
Two modules differ from the reference: the serializer packs with the port's
own msgpack codec (``wire``) and carries torch tensors, and the worker builds
no JAX executable.

Public API:
    FunctionService, Forwarder, Endpoint, TaskFuture, TokenAuthority, Flow,
    TaskBatch, ResultBatch, BatchCoalescer, MetricsRegistry, Autoscaler,
    Journal, ResultStore, wait, get_result, DataRef, FileSystemStore,
    InMemoryStore, TaskPredictor, ShardedForwarder, FairnessPolicy,
    AdmissionError, TenantLedger, SessionRouter
"""
from .auth import (  # noqa: F401
    SCOPE_ADMIN,
    SCOPE_INVOKE,
    SCOPE_REGISTER_ENDPOINT,
    SCOPE_REGISTER_FUNCTION,
    AuthError,
    TenantProfile,
    Token,
    TokenAuthority,
)
from .automation import (  # noqa: F401
    ActionStep,
    DataArrivalEvent,
    Event,
    EventBus,
    Flow,
    FlowRun,
    TimerEvent,
    TimerSource,
    Trigger,
    Workflow,
    WorkflowNode,
    WorkflowRun,
)
from .autoscaler import (  # noqa: F401
    Autoscaler,
    LatencySLOPolicy,
    ScalingDecision,
    ScalingObservation,
    ScalingPolicy,
    TargetQueueDepthPolicy,
    make_policy,
)
from .batching import MicroBatcher, stack_payloads, unstack_results  # noqa: F401
from .client import (  # noqa: F401
    ALL_COMPLETED,
    ALWAYS,
    ANY_COMPLETED,
    get_result,
    wait,
)
from .containers import (  # noqa: F401
    CapabilityError,
    ContainerPool,
    ContainerSpec,
    ResourceSpec,
    default_container_spec,
)
from .datastore import (  # noqa: F401
    DEFAULT_SPILL_THRESHOLD,
    DataRef,
    FileSystemStore,
    InMemoryStore,
    ObjectStore,
    get_store,
    prefetch_refs,
    register_store,
    reset_store_registry,
    resolve_packed,
    resolve_payload,
    scan_refs,
    spill_payload,
)
from .endpoint import Endpoint  # noqa: F401
from .executor import Executor  # noqa: F401
from .fairness import (  # noqa: F401
    ANONYMOUS,
    AdmissionError,
    DeficitRoundRobin,
    FairnessPolicy,
    TenantLedger,
)
from .forwarder import (  # noqa: F401
    ENDPOINT_POLICIES,
    EndpointRecord,
    Forwarder,
    SessionRouter,
    ShardedForwarder,
    shard_of,
)
from .futures import TaskEnvelope, TaskFuture, TaskState  # noqa: F401
from .heartbeat import HeartbeatMonitor, LatencyTracker  # noqa: F401
from .interchange import (  # noqa: F401
    BatchCoalescer,
    ResultBatch,
    TaskBatch,
    iter_frames,
    new_batch_id,
)
from .journal import (  # noqa: F401
    Journal,
    JournalState,
    ResultStore,
    ResumeReport,
    RunJournalEntry,
    TaskJournalEntry,
)
from .memoization import MemoCache  # noqa: F401
from .metrics import (  # noqa: F401
    BYTES_BUCKETS,
    LATENCY_BUCKETS_S,
    SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merged_snapshot,
)
from .predictor import (  # noqa: F401
    RuntimePredictor,
    TaskPredictor,
    TransferPredictor,
)
from .provider import (  # noqa: F401
    LocalThreadProvider,
    Provider,
    ProviderSpec,
    SlurmProvider,
    TPUPodProvider,
)
from .registry import FunctionRegistry, RegisteredFunction, hash_function  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
from .serializer import packb, payload_hash, unpackb  # noqa: F401
from .service import FunctionService, Invocation  # noqa: F401
from .warming import WarmPool  # noqa: F401
from .worker import Worker  # noqa: F401
