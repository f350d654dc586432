"""Wrappers of the Hopper attention kernels (``csrc/*.cu``), bound with ctypes.

- ``flash_attention``: prefill, replaces ``flash_attention_pallas``
  (src/repro/kernels/flash_attention/kernel.py:107).
- ``decode_attention``: one token against the cache, replaces
  ``decode_attention_pallas`` (same file, :173). One call is two device
  launches (split-KV, then the combine); ``LAUNCHES`` counts calls.

A wrapper given CPU tensors computes the plain version in ``ref.py``, and only
then. Given CUDA tensors it checks them, allocates the output with
``torch.empty``, launches on the current stream, raises if the launch failed,
and adds one to ``LAUNCHES[name]``. It never falls back to the plain version
on the card. The libraries are built by ``nvcc`` at first use (``build()``).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build
from . import ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {
    "flash_attention": CSRC / "flash_attention.cu",
    "decode_attention": CSRC / "decode_attention.cu",
}
# launches per kernel since the last reset_launches(): the proof that a run
# went through the kernels
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh kFloat32/kBFloat16
# the widest (dqk, dv) each kernel takes: flash_attention.cu kMaxHd (the f32
# kernel's registers, the bf16 kernel's two 64-column slabs);
# decode_attention.cu kMaxDqk / kMaxDv (its shared memory, sized for MLA)
MAX_HEAD_DIMS = {"flash_attention": (128, 128), "decode_attention": (288, 256)}
# cache positions per split of the decode kernel's first pass
# (csrc/decode_attention.cu kSplit, checked when the library loads)
DECODE_SPLIT = 128
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64P = ctypes.POINTER(ctypes.c_int64)
_ARGTYPES = {
    # q, k, v, o, kv_len, dtype, B, Sq, Skv, H, KV, dqk, dv, q/k/v strides, scale,
    # causal, q_offset, stream
    "flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I64P, _I64P, _I64P, _F, _I, _I, _P],
    # q, k_cache, v_cache, o, pos, pos is int64, pos stride, scratch, dtype, B, S, H,
    # KV, dqk, dv, q/k/v strides, scale, stream
    "decode_attention": [_P, _P, _P, _P, _P, _I, ctypes.c_int64, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I64P, _I64P, _I64P, _F, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Dict[str, dict]:
    """Compile both kernels (in parallel) and load them; returns, per kernel,
    the library path, build seconds and the ptxas report."""
    with _lock:
        results = _build.build(list(SOURCES.values()))
        for name, src in SOURCES.items():
            if name not in _libs:
                lib = ctypes.CDLL(str(results[src]["path"]))
                fn = getattr(lib, f"{name}_launch")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                if name == "decode_attention" and lib.decode_attention_split() != DECODE_SPLIT:
                    raise RuntimeError(f"decode_attention.cu splits by "
                                       f"{lib.decode_attention_split()}, kernel.py by "
                                       f"{DECODE_SPLIT}")
                _libs[name] = lib
    return {name: results[src] for name, src in SOURCES.items()}


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name]
    return lib


def _strides(t: torch.Tensor, dims) -> ctypes.Array:
    return (ctypes.c_int64 * len(dims))(*(t.stride(d) for d in dims))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: str) -> None:
    """q (B, Sq, H, dqk), k (B, Skv, KV, dqk), v (B, Skv, KV, dv): dv may
    differ from dqk (MLA), each within ``MAX_HEAD_DIMS[kernel]``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-D with a unit stride on head_dim: "
                             f"shape {tuple(t.shape)}, strides {t.stride()}")
        # the kernels read rows as 16-byte vectors, cp.async copies and TMA boxes
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides in multiples "
                             f"of 8 elements: strides {t.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the attention kernels take float32 or bfloat16, got {q.dtype}")
    B, _, H, dqk = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[-1] != dqk:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}: k and v need the same (B, S, KV), q and k "
                         "the same head dim")
    KV = k.shape[2]
    if H % KV != 0:
        raise ValueError(f"query heads {H} are not a multiple of KV heads {KV}")
    dv = v.shape[-1]
    max_qk, max_v = MAX_HEAD_DIMS[kernel]
    if dqk % 8 or dv % 8 or dqk > max_qk or dv > max_v:
        raise ValueError(f"{kernel}: head dims dqk {dqk} and dv {dv} must each be a multiple "
                         f"of 8, with dqk at most {max_qk} and dv at most {max_v}")


def _lengths(x, batch: int, device) -> torch.Tensor:
    """Scalar or (B,) lengths -> contiguous (B,) int32 on the device, no host sync."""
    t = torch.as_tensor(x, device=device).to(torch.int32)
    if t.ndim == 0:
        t = t.expand(batch)
    if t.shape != (batch,):
        raise ValueError(f"lengths must be a scalar or ({batch},), got {tuple(t.shape)}")
    return t.contiguous()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _libs[name].repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def flash_attention(q, k, v, *, causal: bool = True, q_offset=None, kv_len=None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention. q (B,Sq,H,dqk); k (B,Skv,KV,dqk), v (B,Skv,KV,dv) ->
    (B,Sq,H,dv). ``q_offset`` is a scalar; ``kv_len`` a scalar or one length
    per row."""
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len, scale=scale)
    _check(q, k, v, "flash_attention")
    B, Sq, H, dqk = q.shape
    Skv, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else dqk ** -0.5
    o = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lens = None if kv_len is None else _lengths(kv_len, B, q.device)
    lib = _lib("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lens is None else lens.data_ptr(), _DTYPE_CODES[q.dtype],
        B, Sq, Skv, H, KV, dqk, dv,
        _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)), _strides(v, (0, 1, 2)),
        float(scale), int(causal), int(q_offset) if q_offset is not None else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def decode_attention(q, k_cache, v_cache, pos, *, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention: q (B,1,H,dqk) against caches (B,S,KV,dqk) and
    (B,S,KV,dv) whose entries <= pos are valid -> (B,1,H,dv); ``pos`` is a
    scalar or (B,) (continuous batching)."""
    if q.device.type == "cpu":
        return ref.decode_attention_reference(q, k_cache, v_cache, pos, scale=scale)
    _check(q, k_cache, v_cache, "decode_attention")
    B, Sq, H, dqk = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention takes one query token per row, got {Sq}")
    S, KV, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    scale = scale if scale is not None else dqk ** -0.5
    o = torch.empty((B, 1, H, dv), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    # the kernels read pos (int32 or int64) themselves: no host sync, no extra launch
    pos = torch.as_tensor(pos, device=q.device)
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int64)
    if pos.shape not in ((), (B,)):
        raise ValueError(f"pos must be a scalar or ({B},), got {tuple(pos.shape)}")
    # per (row, split, head): the split's accumulator (dv), max and sum, fp32
    n_split = -(-S // DECODE_SPLIT)
    scratch = torch.empty(B * n_split * H * (dv + 2), dtype=torch.float32, device=q.device)
    lib = _lib("decode_attention")
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(), pos.data_ptr(),
        int(pos.dtype == torch.int64), pos.stride(0) if pos.ndim else 0,
        scratch.data_ptr(), _DTYPE_CODES[q.dtype], B, S, H, KV, dqk, dv,
        _strides(q, (0, 2)), _strides(k_cache, (0, 1, 2)), _strides(v_cache, (0, 1, 2)),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return o
