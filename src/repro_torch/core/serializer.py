"""Payload serialization: pytree <-> bytes.

funcX exchanges JSON documents; our functions exchange array pytrees, so the
wire format is msgpack with a numpy extension type. The serializer is also the
basis for memoization keys (``payload_hash``): packing is canonical (dict keys
sorted) so equal payloads hash equally.

Port of ``repro.core.serializer`` with two changes. It packs with the port's
own msgpack codec (``wire``), which writes the same bytes, so a payload with
no tensor leaf packs, hashes and memoizes as it does in the reference. And a
``torch.Tensor`` leaf travels as an ext of its own (code 6): a header of the
torch dtype's name and the shape, then the tensor's bytes. A bf16 tensor, which
numpy cannot hold, goes as its raw 2-byte words; a CUDA tensor is copied to the
host first. The leaf decodes to a CPU tensor of the same dtype and values (the
reference turns every array-like into numpy and so rejects both).
"""
from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

from . import wire

_EXT_NDARRAY = 1
_EXT_TUPLE = 2
_EXT_SET = 3
_EXT_COMPLEX = 4
_EXT_DATAREF = 5
_EXT_TENSOR = 6

# Lazily bound: datastore imports this module at load time, so the reverse
# edge resolves on first use instead of at import.
_DataRef = None


def _dataref_type():
    global _DataRef
    if _DataRef is None:
        from .datastore import DataRef

        _DataRef = DataRef
    return _DataRef


def _default(obj: Any):
    DataRef = _dataref_type()
    if isinstance(obj, DataRef):
        # refs travel the wire as (key, size, locations); payload_hash uses a
        # location-free view so moving data never changes a memo key
        return wire.ExtType(
            _EXT_DATAREF, packb([obj.key, obj.size, list(obj.locations)])
        )
    if isinstance(obj, torch.Tensor):
        return wire.ExtType(_EXT_TENSOR, _tensor_bytes(obj))
    # anything else array-like -> ndarray ext
    if hasattr(obj, "__array__") or isinstance(obj, np.ndarray):
        arr = np.asarray(obj)
        header = wire.packb((arr.dtype.str, arr.shape))
        if arr.dtype == object:
            raise TypeError("object arrays are not serializable")
        body = arr.tobytes(order="C")
        return wire.ExtType(_EXT_NDARRAY, header + body)
    if isinstance(obj, tuple):
        return wire.ExtType(_EXT_TUPLE, packb(list(obj)))
    if isinstance(obj, (set, frozenset)):
        return wire.ExtType(_EXT_SET, packb(sorted(obj, key=repr)))
    if isinstance(obj, complex):
        return wire.ExtType(_EXT_COMPLEX, packb([obj.real, obj.imag]))
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """Header (dtype name, shape), then the tensor's bytes in C order, read
    through a byte view so that dtypes numpy lacks (bfloat16) travel too."""
    t = t.detach().cpu().contiguous()
    header = wire.packb((str(t.dtype).removeprefix("torch."), list(t.shape)))
    if t.numel() == 0:
        return header
    return header + t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _tensor_from(data: bytes) -> torch.Tensor:
    unpacker = wire.Unpacker(raw=False)
    unpacker.feed(data)
    dtype_name, shape = unpacker.unpack()
    dtype = getattr(torch, dtype_name)
    offset = unpacker.tell()
    if offset == len(data):
        return torch.empty(shape, dtype=dtype)
    body = torch.frombuffer(bytearray(data[offset:]), dtype=torch.uint8)
    return body.view(dtype).reshape(shape)


def _ext_hook(code: int, data: bytes, writable: bool = True):
    if code == _EXT_NDARRAY:
        unpacker = wire.Unpacker(raw=False)
        unpacker.feed(data)
        dtype_str, shape = unpacker.unpack()
        offset = unpacker.tell()
        arr = np.frombuffer(data, dtype=np.dtype(dtype_str), offset=offset)
        arr = arr.reshape(shape)
        if not writable:
            # zero-copy fast path: a read-only view straight over the wire
            # bytes. Callers that never hand the array to user code (decoded
            # object caches, ref scans, unpack-to-repack hops) skip the copy
            # entirely — at million-task scale the unpack copy dominated the
            # decode hot path.
            return arr
        # copy out of the wire bytes: a frombuffer view would be read-only,
        # and functions mutate their inputs freely (one copy, not a
        # slice-then-bytearray double copy)
        return arr.copy()
    if code == _EXT_TENSOR:
        return _tensor_from(data)
    if code == _EXT_TUPLE:
        return tuple(unpackb(data, writable=writable))
    if code == _EXT_SET:
        return set(unpackb(data, writable=writable))
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == _EXT_DATAREF:
        key, size, locations = unpackb(data)
        return _dataref_type()(key=key, size=size, locations=tuple(locations))
    return wire.ExtType(code, data)


def _canonicalize(obj: Any) -> Any:
    """Sort dict keys recursively so packing is deterministic."""
    if isinstance(obj, dict):
        return {k: _canonicalize(obj[k]) for k in sorted(obj, key=repr)}
    if isinstance(obj, (list, tuple)):
        typ = type(obj)
        out = [_canonicalize(v) for v in obj]
        return typ(out) if typ is tuple else out
    return obj


def packb(obj: Any) -> bytes:
    return wire.packb(_canonicalize(obj), default=_default)


def unpackb(data: bytes, writable: bool = True) -> Any:
    """Decode wire bytes back to a pytree.

    ``writable=True`` (the default API) copies array leaves out of the wire
    buffer so callers can mutate them. ``writable=False`` is the zero-copy
    fast path: array leaves are read-only ``frombuffer`` views over ``data``
    — use it only where the decoded value is never handed to user code (the
    endpoint decoded-value cache hands out fresh copies per task; journal
    replay only scans for refs).
    """
    if writable:
        return wire.unpackb(
            data, ext_hook=_ext_hook, raw=False, strict_map_key=False
        )
    return wire.unpackb(
        data,
        ext_hook=lambda code, payload: _ext_hook(code, payload, writable=False),
        raw=False,
        strict_map_key=False,
    )


def _hash_view(obj: Any) -> Any:
    """Pre-hash transform: DataRef leaves hash by (key, size) only. Locations
    are placement metadata — two refs to the same content must produce the
    same memo key even when the data has moved or been replicated."""
    DataRef = _dataref_type()
    if isinstance(obj, DataRef):
        return wire.ExtType(_EXT_DATAREF, packb([obj.key, obj.size]))
    if isinstance(obj, dict):
        return {k: _hash_view(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_hash_view(v) for v in obj]
        return tuple(out) if isinstance(obj, tuple) else out
    return obj


def payload_hash(obj: Any) -> str:
    """Canonical content hash of a payload (memoization key component)."""
    return hashlib.sha256(packb(_hash_view(obj))).hexdigest()

