"""Wrappers of the Hopper fused add + RMSNorm kernels (``csrc/*.cu``), via ctypes.

- ``fused_add_rmsnorm`` replaces ``fused_add_rmsnorm_pallas``
  (src/repro/kernels/rmsnorm/kernel.py:30). It takes any number of rows and no
  ``block_rows``: one thread block per row needs no padding. ``empty_launch``
  times the path's floor.
- ``fused_add_rmsnorm_backward`` is its gradient for x, delta and the fp32
  scale (``csrc/fused_add_rmsnorm_backward.cu``, two device launches a call:
  the rows, then the sum of dscale's per-block partials). The JAX package has
  no backward kernel: it differentiates its plain
  ``fused_add_rmsnorm_reference`` with ``jax.grad``
  (src/repro/kernels/rmsnorm/ref.py:10; the Pallas kernel has no VJP).

A wrapper given CPU or meta tensors (meta: a trace with no data) computes the
plain version in ``ref.py``, and only then. Given CUDA tensors it checks them,
allocates its outputs with ``torch.empty``, launches on the current stream,
raises if the launch failed, and adds one to ``LAUNCHES[name]``. The libraries
are built by ``nvcc`` at first use (``build()``). Under autograd (an input
that requires grad, grad mode on) ``fused_add_rmsnorm`` launches through
``AddRMSNormGrad``: the kernel forward, and ``fused_add_rmsnorm_backward``'s
kernel backward.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from .. import _build, launcher, on_host, records_grad
from . import ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"fused_add_rmsnorm": CSRC / "fused_add_rmsnorm.cu",
           "fused_add_rmsnorm_backward": CSRC / "fused_add_rmsnorm_backward.cu"}
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
    # x, delta, scale, g_res, g_out, dh, dscale, scratch, dtype, rows, D, x/delta
    # row strides, eps, stream
    "fused_add_rmsnorm_backward_launch": ([_P] * 8 + [_I, _I64, _I, _I64, _I64, _F, _P], _I),
    "fused_add_rmsnorm_backward_scratch": ([_I64, _I], _I64),   # rows, D -> fp32 floats
    "rmsnorm_backward_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Dict[str, dict]:
    """Compile the kernels and load them; returns each library's path, build
    seconds and the ptxas report."""
    with _lock:
        results = _build.build(list(SOURCES.values()))
        for name, src in SOURCES.items():
            if name not in _libs:
                _libs[name] = load(results[src]["path"])
    return {name: results[src] for name, src in SOURCES.items()}


def load(path) -> ctypes.CDLL:
    """Load a library built from a source with one of these C interfaces and
    declare the entries it has (a build of an earlier design has no empty
    kernel)."""
    lib = ctypes.CDLL(str(path))
    for name, (args, result) in _ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, result
    return lib


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name]
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
        return AddRMSNormGrad.apply(functools.partial(_launch, eps=eps),
                                    functools.partial(_backward_launch, eps=eps), x, delta, scale)
    return _launch(x, delta, scale, eps=eps)


class AddRMSNormGrad(torch.autograd.Function):
    """``apply(forward_fn, backward_fn, x, delta, scale)``: the forward is
    ``forward_fn(x, delta, scale) -> (res, out)`` and returns both, saving x,
    delta and scale; the backward is ``backward_fn(x, delta, scale, g_res,
    g_out) -> (dx, ddelta, dscale)`` and returns the gradients of the inputs
    that need one (dx and ddelta may be one tensor: autograd copies a
    gradient before it adds into one that is used elsewhere). On the card the
    pair is the two kernels; the CPU tests pass the plain pair
    (``ref.fused_add_rmsnorm_reference``,
    ``ref.fused_add_rmsnorm_backward_reference``)."""

    @staticmethod
    def forward(ctx, forward_fn, backward_fn, x, delta, scale):
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(x, delta, scale)
        return forward_fn(x, delta, scale)

    @staticmethod
    def backward(ctx, g_res, g_out):
        grads = ctx.backward_fn(*ctx.saved_tensors, g_res, g_out)
        return (None, None, *(g if n else None for g, n in zip(grads, ctx.needs_input_grad[2:])))


@launcher
def _launch(x, delta, scale, *, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, delta, scale)
    D = x.shape[-1]
    res = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return res, out
    x2, d2 = _rows("x", x, D), _rows("delta", delta, D)
    lib = _lib("fused_add_rmsnorm")
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
    lib = _lib("fused_add_rmsnorm")
    err = lib.rmsnorm_empty_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err} "
                           f"({lib.rmsnorm_error_string(err).decode()})")


def fused_add_rmsnorm_backward(x, delta, scale, g_res, g_out, eps: float = 1e-5):
    """The gradient of ``fused_add_rmsnorm`` for x, delta and scale: (dx,
    ddelta, dscale) from its outputs' gradients g_res and g_out (..., D) in
    x's dtype. dx and ddelta are one tensor (both are the gradient of x +
    delta), in x's dtype; dscale is fp32 (D,)."""
    if on_host(x):
        return ref.fused_add_rmsnorm_backward_reference(x, delta, scale, g_res, g_out, eps)
    return _backward_launch(x, delta, scale, g_res, g_out, eps=eps)


@launcher
def _backward_launch(x, delta, scale, g_res, g_out, *, eps: float):
    _check(x, delta, scale)
    D = x.shape[-1]
    grads = []
    for name, g in (("g_res", g_res), ("g_out", g_out)):
        g = g.contiguous()   # autograd may hand it over strided or expanded
        if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
            raise ValueError(f"{name} must be {tuple(x.shape)} {x.dtype} on {x.device}, got "
                             f"{tuple(g.shape)} {g.dtype} on {g.device}")
        grads.append(_rows(name, g, D))
    dh = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.empty((D,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dh, dh, dscale.zero_()
    x2, d2 = _rows("x", x, D), _rows("delta", delta, D)
    lib = _lib("fused_add_rmsnorm_backward")
    # one fp32 partial of dscale a block of rows
    scratch = torch.empty(lib.fused_add_rmsnorm_backward_scratch(x2.shape[0], D),
                          dtype=torch.float32, device=x.device)
    err = lib.fused_add_rmsnorm_backward_launch(
        x2.data_ptr(), d2.data_ptr(), scale.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(),
        dh.data_ptr(), dscale.data_ptr(), scratch.data_ptr(), _DTYPE_CODES[x.dtype],
        x2.shape[0], D, x2.stride(0), d2.stride(0), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.rmsnorm_backward_error_string(err).decode()
        raise RuntimeError(f"fused_add_rmsnorm_backward kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["fused_add_rmsnorm_backward"] += 1
    return dh, dh, dscale
