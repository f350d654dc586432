"""Function registry.

funcX requires functions to be *registered* before invocation; the registry
assigns each function a content-derived id so that (a) memoization can key on
the function body (paper §5.5: "hashing the function body and input document")
and (b) re-registering identical code is idempotent.
"""
from __future__ import annotations

import hashlib
import inspect
import textwrap
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional, Union

from .containers import ResourceSpec


def hash_function(fn: Callable, static: Any = None) -> str:
    """Content hash of a function body (+ optional static configuration).

    Uses the dedented source when available (matches funcX's body-hash
    semantics); falls back to the compiled code object for builtins/lambdas
    defined in exotic places. Closure cell values are folded in so two
    closures over different constants hash differently.
    """
    h = hashlib.sha256()
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        h.update(src.encode())
    except (OSError, TypeError):
        code = getattr(fn, "__code__", None)
        if code is not None:
            h.update(code.co_code)
            h.update(repr(code.co_consts).encode())
        else:
            h.update(repr(fn).encode())
    closure = getattr(fn, "__closure__", None)
    if closure:
        for cell in closure:
            try:
                h.update(repr(cell.cell_contents).encode())
            except ValueError:  # empty cell
                pass
    if static is not None:
        h.update(repr(static).encode())
    return h.hexdigest()


@dataclass
class RegisteredFunction:
    function_id: str
    fn: Callable
    name: str
    description: str = ""
    owner: str = "anonymous"
    public: bool = False
    # what this function requires from the fabric: capabilities the executing
    # container pool must provide + the container variant it prefers
    requirements: ResourceSpec = field(default_factory=ResourceSpec)
    # serving hints
    batchable: bool = False       # payloads may be stacked on a leading axis
    deterministic: bool = True    # eligible for memoization
    metadata: dict = field(default_factory=dict)


class FunctionRegistry:
    """Thread-safe registry mapping function_id -> RegisteredFunction."""

    def __init__(self):
        self._lock = threading.Lock()
        self._functions: dict[str, RegisteredFunction] = {}

    def register(
        self,
        fn: Callable,
        name: Optional[str] = None,
        description: str = "",
        owner: str = "anonymous",
        public: bool = False,
        static: Any = None,
        requirements: Union[ResourceSpec, Iterable[str], None] = None,
        batchable: bool = False,
        deterministic: bool = True,
        **metadata: Any,
    ) -> str:
        if requirements is None:
            requirements = ResourceSpec()
        elif not isinstance(requirements, ResourceSpec):
            # a bare capability iterable is the common shorthand
            requirements = ResourceSpec(capabilities=frozenset(requirements))
        fid = hash_function(fn, static=static)
        with self._lock:
            if fid not in self._functions:
                self._functions[fid] = RegisteredFunction(
                    function_id=fid,
                    fn=fn,
                    name=name or getattr(fn, "__name__", "anonymous"),
                    description=description,
                    owner=owner,
                    public=public,
                    requirements=requirements,
                    batchable=batchable,
                    deterministic=deterministic,
                    metadata=dict(metadata),
                )
        return fid

    def get(self, function_id: str) -> RegisteredFunction:
        with self._lock:
            try:
                return self._functions[function_id]
            except KeyError:
                raise KeyError(f"unknown function_id {function_id!r}") from None

    def __contains__(self, function_id: str) -> bool:
        with self._lock:
            return function_id in self._functions

    def list(self) -> list[RegisteredFunction]:
        with self._lock:
            return list(self._functions.values())

    def authorized(self, function_id: str, identity: str) -> bool:
        """Invocation permission: the owner themselves, or anyone when the
        owner explicitly opted in with ``public=True``. Ownership is a strict
        identity comparison — an anonymous-owned function is only open to the
        anonymous identity (the no-authority deployment), never a wildcard
        that makes every unowned function world-executable."""
        rf = self.get(function_id)
        return rf.public or rf.owner == identity
