"""Wrapper of the Hopper fused add + RMSNorm kernel (``csrc/fused_add_rmsnorm.cu``), via ctypes.

``fused_add_rmsnorm`` replaces ``fused_add_rmsnorm_pallas``
(src/repro/kernels/rmsnorm/kernel.py:30). It takes any number of rows and no
``block_rows``: one thread block per row needs no padding. ``empty_launch``
times the path's floor.

A wrapper given CPU or meta tensors (meta: a trace with no data) computes the
plain version in ``ref.py``, and only then. Given CUDA tensors it checks them,
allocates both outputs with ``torch.empty``, launches on the current stream,
raises if the launch failed, and adds one to
``LAUNCHES["fused_add_rmsnorm"]``. The library is built by ``nvcc`` at first
use (``build()``). Under autograd (an input that requires grad, grad mode on)
it launches through ``KernelWithPlainGrad``: the kernel forward, the gradient
of ``ref.fused_add_rmsnorm_reference`` for x, delta and the fp32 scale
backward.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from .. import KernelWithPlainGrad, _build, launcher, on_host, records_grad
from . import ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"fused_add_rmsnorm": CSRC / "fused_add_rmsnorm.cu"}
# launches since the last reset_launches(): the proof that a run went through
# the kernel
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc kFloat32/kBFloat16
MAX_D = 16384                                          # csrc kBlockThreads * 8 * kBlockMaxChunks
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_ENTRIES = {  # C entry: (argument types, result type)
    # x, delta, scale, res, out, dtype, rows, D, x/delta row strides, eps, stream
    "fused_add_rmsnorm_launch": ([_P, _P, _P, _P, _P, _I, _I64, _I, _I64, _I64, _F, _P], _I),
    "rmsnorm_empty_launch": ([_P], _I),
    "rmsnorm_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Dict[str, dict]:
    """Compile the kernel and load it; returns the library path, build seconds
    and the ptxas report."""
    with _lock:
        results = _build.build(list(SOURCES.values()))
        if "fused_add_rmsnorm" not in _libs:
            _libs["fused_add_rmsnorm"] = load(results[SOURCES["fused_add_rmsnorm"]]["path"])
    return {name: results[src] for name, src in SOURCES.items()}


def load(path) -> ctypes.CDLL:
    """Load a library built from a source with this C interface and declare
    the entries it has (a build of an earlier design has no empty kernel)."""
    lib = ctypes.CDLL(str(path))
    for name, (args, result) in _ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, result
    return lib


def _lib() -> ctypes.CDLL:
    lib = _libs.get("fused_add_rmsnorm")
    if lib is None:
        build()
        lib = _libs["fused_add_rmsnorm"]
    return lib


def _rows(name: str, t: torch.Tensor, D: int) -> torch.Tensor:
    """``t`` as a (T, D) view with a unit stride on D and 16-byte aligned rows;
    raises where the kernel's vector loads cannot read it as it lies."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a unit stride on its last axis: {t.stride()}")
    try:
        rows = t.view(-1, D)
    except RuntimeError:
        raise ValueError(f"{name}'s leading axes {tuple(t.shape[:-1])} with strides "
                         f"{t.stride()[:-1]} do not flatten into rows without a copy") from None
    if rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{name} has {rows.shape[0]} rows, more than one launch takes")
    if rows.shape[0] > 1 and rows.stride(0) % 8 != 0:
        raise ValueError(f"{name}'s row stride {rows.stride(0)} is not a multiple of 8")
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} is not 16-byte aligned")
    return rows


def _check(x, delta, scale) -> None:
    for name, t in (("x", x), ("delta", delta), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the fused add + RMSNorm kernel takes float32 or bfloat16 x, "
                         f"got {x.dtype}")
    if delta.dtype != x.dtype or delta.shape != x.shape:
        raise ValueError(f"delta {delta.dtype} {tuple(delta.shape)} must match x "
                         f"{x.dtype} {tuple(x.shape)}")
    D = x.shape[-1]
    if D % 8 != 0 or not 0 < D <= MAX_D:
        raise ValueError(f"the last axis {D} must be a multiple of 8 in 8..{MAX_D}")
    if (tuple(scale.shape) != (D,) or scale.dtype != torch.float32
            or not scale.is_contiguous() or scale.data_ptr() % 16 != 0):
        raise ValueError(f"scale must be contiguous float32 ({D},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def fused_add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + delta, rmsnorm(x + delta) * scale) for x, delta (..., D) and scale
    (D,) fp32; both outputs contiguous in x's dtype."""
    if on_host(x):
        return ref.fused_add_rmsnorm_reference(x, delta, scale, eps)
    if records_grad(x, delta, scale):
        return KernelWithPlainGrad.apply(
            functools.partial(_launch, eps=eps),
            functools.partial(ref.fused_add_rmsnorm_reference, eps=eps), x, delta, scale)
    return _launch(x, delta, scale, eps=eps)


@launcher
def _launch(x, delta, scale, *, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, delta, scale)
    D = x.shape[-1]
    res = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return res, out
    x2, d2 = _rows("x", x, D), _rows("delta", delta, D)
    lib = _lib()
    err = lib.fused_add_rmsnorm_launch(
        x2.data_ptr(), d2.data_ptr(), scale.data_ptr(), res.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], x2.shape[0], D, x2.stride(0), d2.stride(0), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"fused_add_rmsnorm kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["fused_add_rmsnorm"] += 1
    return res, out


def empty_launch() -> None:
    """Launch an empty kernel of the same library, as ``fused_add_rmsnorm``
    launches its kernel, on the current stream: the least time a call can take."""
    lib = _lib()
    err = lib.rmsnorm_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err} "
                           f"({lib.rmsnorm_error_string(err).decode()})")
