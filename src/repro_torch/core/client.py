"""Unified client surface: ``wait`` / ``get_result`` over task futures.

The lithops ``wait.py`` shape, aligned with ``concurrent.futures``
semantics so fabric futures compose with stdlib patterns:

    futs = svc.batch_run(fid, payloads)
    done, pending = wait(futs, return_when=ANY_COMPLETED, timeout=5)
    values = get_result(futs, throw_except=False)

``wait`` blocks via done-callbacks (no polling) until the ``return_when``
condition holds — ``ALL_COMPLETED`` (default), ``ANY_COMPLETED`` (at least
one), or ``ALWAYS`` (return immediately with whatever is done) — and returns
the ``(done, not_done)`` partition in input order, like
:func:`concurrent.futures.wait`. A timeout expiry returns the partial
partition rather than raising; ``get_result`` is the strict variant that
raises :class:`TimeoutError`.

Anything future-shaped works: the functions only use ``done()`` /
``exception()`` / ``result()`` / ``add_done_callback()`` (plus
``remove_done_callback`` when available), so stdlib futures mix freely with
:class:`~repro.core.futures.TaskFuture`\\ s in one call.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Tuple

ALL_COMPLETED = "ALL_COMPLETED"
ANY_COMPLETED = "ANY_COMPLETED"
ALWAYS = "ALWAYS"

RETURN_WHEN = (ALL_COMPLETED, ANY_COMPLETED, ALWAYS)


def _as_list(fs: Any) -> Tuple[List[Any], bool]:
    """Normalize a single future or an iterable of futures to a list.
    Returns (futures, was_single)."""
    if hasattr(fs, "add_done_callback"):
        return [fs], True
    return list(fs), False


def _exception_of(f: Any) -> Optional[BaseException]:
    """Terminal exception of a *done* future. TaskFuture returns it; a
    stdlib Future raises CancelledError for cancelled — normalize to return."""
    try:
        return f.exception(0)
    except BaseException as exc:  # noqa: BLE001 - done futures only raise cancellation
        return exc


def _raise_first(done: Sequence[Any]) -> None:
    for f in done:
        exc = _exception_of(f)
        if exc is not None:
            raise exc


def wait(
    fs: Any,
    return_when: str = ALL_COMPLETED,
    timeout: Optional[float] = None,
    throw_except: bool = True,
) -> Tuple[List[Any], List[Any]]:
    """Block until the futures in `fs` satisfy `return_when`, then return the
    ``(done, not_done)`` partition (input order preserved).

    With ``throw_except`` (default) the first exception among the done
    futures is re-raised — including :class:`CancelledError` for cancelled
    tasks; pass ``throw_except=False`` to inspect failures yourself. On
    timeout the partial partition is returned (stdlib ``wait`` contract);
    use :func:`get_result` when a timeout should raise instead."""
    if return_when not in RETURN_WHEN:
        raise ValueError(
            f"unknown return_when {return_when!r}; choose from {RETURN_WHEN}"
        )
    futures, _ = _as_list(fs)
    if return_when != ALWAYS and futures:
        target = 1 if return_when == ANY_COMPLETED else len(futures)
        event = threading.Event()
        lock = threading.Lock()
        ndone = [0]

        def _on_done(_f: Any) -> None:
            with lock:
                ndone[0] += 1
                if ndone[0] >= target:
                    event.set()

        for f in futures:
            f.add_done_callback(_on_done)  # already-done futures fire inline
        event.wait(timeout)
        for f in futures:  # detach from the stragglers — no callback leak
            remove = getattr(f, "remove_done_callback", None)
            if remove is not None and not f.done():
                remove(_on_done)
    done = [f for f in futures if f.done()]
    not_done = [f for f in futures if not f.done()]
    if throw_except:
        _raise_first(done)
    return done, not_done


def get_result(
    fs: Any,
    throw_except: bool = True,
    timeout: Optional[float] = None,
) -> Any:
    """Gather results: a single future yields its bare result, an iterable
    yields the ordered result list. Raises :class:`TimeoutError` when not
    everything completes within `timeout`. With ``throw_except=False`` a
    failed (or cancelled) future contributes ``None`` instead of raising."""
    futures, single = _as_list(fs)
    _, not_done = wait(
        futures, return_when=ALL_COMPLETED, timeout=timeout, throw_except=False
    )
    if not_done:
        raise TimeoutError(
            f"{len(not_done)} of {len(futures)} tasks incomplete after {timeout}s"
        )
    results: List[Any] = []
    for f in futures:
        exc = _exception_of(f)
        if exc is not None:
            if throw_except:
                raise exc
            results.append(None)
        else:
            results.append(f.result(0))
    return results[0] if single else results
