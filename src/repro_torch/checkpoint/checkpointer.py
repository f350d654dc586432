"""Checkpoint/restart: per-leaf save + async write + restore by key.

Port of ``repro.checkpoint.checkpointer`` with the same files: the training
loop periodically calls ``save`` so a lost controller restarts from the
newest manifest (``latest_step``); the FaaS layer re-executes lost steps.

Layout:  <dir>/step_<N:08d>/manifest.msgpack  (+ leaf_<i:05d>.npy per leaf)

The manifest (packed by ``core.serializer``) lists each leaf's ``key`` (its
path joined by ``/``, e.g. ``params/layers/attn/wq``), file, shape and dtype,
in the reference's flatten order (dict keys sorted at every level). Each
``.npy`` file is byte for byte the reference's: a bfloat16 leaf, which numpy
has no type for, is written as its raw 2-byte values with the header the
reference's ``np.save`` of an ``ml_dtypes`` array writes (descr ``<V2``).

``restore`` maps leaves by the manifest's ``key`` (not by position) and
gives each the manifest's dtype, so a bf16 leaf comes back as bf16 (the
reference's gives it back as raw ``|V2`` bytes; ROADMAP F8), the reference's
bf16 checkpoints included. A key missing on either side, or a shape that
differs from the template's, raises ``ValueError``.

On a mesh the files are the same: leaves are stored unsharded. ``save`` of a
tree holding DTensors gathers each (``full_tensor()``, a collective every
rank joins), writes from rank 0 alone, and returns once the files are there
on every rank. ``restore(..., shardings=)`` places each leaf with
``distribute_tensor`` on its target mesh and placements, so a checkpoint
saved on one mesh restores onto another (the reference's elastic-rescale
path) or onto one device (no ``shardings``).
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import serializer
from ..sharding.partition import is_dtensor

_BF16_DESCR = "<V2"   # np.save's header descr of an ml_dtypes bfloat16 array


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) in the reference's order: dict keys sorted, joined by '/'."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    """The dtype as numpy (and the reference's manifest) names it."""
    return str(t.dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 bit patterns."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _save_leaf(path: str, a: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, a)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": a.shape})
        f.write(a.tobytes())


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == "bfloat16":     # '|V2' (or an ml_dtypes array): the raw bf16 values
        return torch.from_numpy(np.asarray(a, order="C").view(np.uint16).view(np.int16)
                                ).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise ValueError(f"{path} holds {a.dtype}, the manifest says {dtype}")
    return torch.from_numpy(np.asarray(a, order="C"))


def _unflatten(like, values: dict, prefix: str = ""):
    if not isinstance(like, dict):
        return values[prefix]
    return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> str:
        """Snapshot `tree` (a nested dict of tensors) at `step`. Device tensors
        are copied to the host first (cheap vs. the async write); the write
        itself runs on a thread. A tree with DTensors is gathered on every rank,
        written by rank 0 alone and synchronously, then all ranks meet."""
        pairs = _flatten_with_paths(tree)
        sharded = any(is_dtensor(t) for _, t in pairs)
        pairs = [(key, t.full_tensor() if is_dtensor(t) else t) for key, t in pairs]
        path = os.path.join(self.directory, f"step_{step:08d}")
        if sharded and dist.is_initialized():
            if dist.get_rank() == 0:
                self._write(step, path, pairs, blocking=True)
            dist.barrier()
            return path
        return self._write(step, path, pairs, blocking)

    def _write(self, step: int, path: str, pairs, blocking: bool) -> str:
        leaves = [(key, _host(t), _dtype_name(t)) for key, t in pairs]

        def write():
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": [], "time": time.time()}
            for i, (key, a, dtype) in enumerate(leaves):
                fname = f"leaf_{i:05d}.npy"
                _save_leaf(os.path.join(tmp, fname), a, dtype == "bfloat16")
                manifest["leaves"].append(
                    {"key": key, "file": fname, "shape": list(a.shape), "dtype": dtype}
                )
            with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
                f.write(serializer.packb(manifest))
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        self.wait()  # at most one in-flight save
        if self.async_save and not blocking:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Tuple[int, Any]:
        """Restore into the structure of `like` (a nested dict whose leaves
        have ``.shape``): returns (step, a tree of CPU tensors in the
        manifest's dtypes). With ``shardings`` (a tree of
        ``partition.NamedSharding`` matching `like`), each leaf is placed on
        its mesh as a DTensor (``distribute_tensor``, every rank joining)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
            manifest = serializer.unpackb(f.read())
        saved = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        want = {key: tuple(t.shape) for key, t in _flatten_with_paths(like)}
        if saved.keys() != want.keys():
            raise ValueError(
                f"checkpoint keys differ from the template's: only in the checkpoint "
                f"{sorted(saved.keys() - want.keys())}, only in the template "
                f"{sorted(want.keys() - saved.keys())}")
        values = {}
        for key, shape in want.items():
            leaf = saved[key]
            if tuple(leaf["shape"]) != shape:
                raise ValueError(f"{key}: the checkpoint's shape {tuple(leaf['shape'])} is "
                                 f"not the template's {shape}")
            values[key] = _load_leaf(os.path.join(path, leaf["file"]), leaf["dtype"])
        tree = _unflatten(like, values)
        if shardings is not None:
            tree = _distribute(tree, shardings)
        return step, tree


def _distribute(tree, shardings):
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _distribute(v, shardings[k]) for k, v in tree.items()}
    mesh = shardings.mesh
    return distribute_tensor(tree.to(mesh.device_type), mesh, shardings.placements)
