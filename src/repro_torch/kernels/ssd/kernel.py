"""Wrapper of the Hopper SSD chunked-scan kernel (``csrc/ssd.cu``), bound with ctypes.

``ssd`` replaces ``ssd_pallas`` (src/repro/kernels/ssd/kernel.py:93). Unlike
the TPU kernel it takes a nonzero ``initial_state``: on the card nothing falls
back to the plain version, so the kernel has to take everything ``ops.ssd``
accepts.

A wrapper given CPU or meta tensors (meta: a trace with no data) computes the
plain version in ``ref.py``, and only then. Given CUDA tensors it checks them,
allocates ``y``, the final state and the bf16 passes' scratch with
``torch.empty``, launches on the current stream, raises if the launch failed,
and adds one to ``LAUNCHES["ssd"]``. In bf16 one call is up to three device
launches (chunk state, state passing, output; the launch decision lives in
``csrc/ssd.cu``); ``LAUNCHES`` counts calls. The library is built by ``nvcc``
at first use (``build()``). Under autograd (an input that requires grad, grad
mode on) it launches through ``KernelWithPlainGrad``: the kernel forward, the
gradient of ``ref.ssd_reference`` for x, dt, A, B, C and the initial state
backward (the ssm and hybrid families' training; remat runs the forward twice
a layer).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import KernelWithPlainGrad, _build, launcher, on_host, records_grad
from . import ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"ssd": CSRC / "ssd.cu"}
# launches since the last reset_launches(): the proof that a run went through
# the kernel
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/ssd.cu kFloat32/kBFloat16
MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128                # csrc/ssd.cu kMaxChunk/kMaxP/kMaxN
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int
_I64P = ctypes.POINTER(ctypes.c_int64)
# x, dt, A, B, C, initial_state, y, final_state, states, chunk_decay, h_in, dtype,
# B, S, H, P, G, N, chunk, x/dt/B/C strides, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _I64P, _I64P, _I64P, _I64P, _P]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Dict[str, dict]:
    """Compile the kernel and load it; returns the library path, build seconds
    and the ptxas report."""
    with _lock:
        results = _build.build(list(SOURCES.values()))
        if "ssd" not in _libs:
            lib = ctypes.CDLL(str(results[SOURCES["ssd"]]["path"]))
            lib.ssd_launch.argtypes = _ARGTYPES
            lib.ssd_launch.restype = ctypes.c_int
            lib.ssd_error_string.argtypes = [ctypes.c_int]
            lib.ssd_error_string.restype = ctypes.c_char_p
            _libs["ssd"] = lib
    return {name: results[src] for name, src in SOURCES.items()}


def _lib() -> ctypes.CDLL:
    lib = _libs.get("ssd")
    if lib is None:
        build()
        lib = _libs["ssd"]
    return lib


def _strides(t: torch.Tensor) -> ctypes.Array:
    return (ctypes.c_int64 * 3)(*t.stride()[:3])


def _check(x, dt, A, B_, C_, chunk: int, initial_state) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B_), ("C", C_))
    if initial_state is not None:
        named += (("initial_state", initial_state),)
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the SSD kernel takes float32 or bfloat16 x, got {x.dtype}")
    if x.ndim != 4 or B_.ndim != 4 or C_.ndim != 4 or dt.ndim != 3 or A.ndim != 1:
        raise ValueError(f"expected x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B_.shape)}, {tuple(C_.shape)}")
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    for name, t in (("B", B_), ("C", C_)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, x has {x.dtype}")
        if tuple(t.shape) != (Bb, S, G, N):
            raise ValueError(f"B {tuple(B_.shape)} and C {tuple(C_.shape)} must match")
    for name, t in (("x", x), ("B", B_), ("C", C_)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on its last axis: {t.stride()}")
    if tuple(dt.shape) != (Bb, S, H) or dt.dtype != torch.float32:
        raise ValueError(f"dt must be float32 {(Bb, S, H)}, got {dt.dtype} {tuple(dt.shape)}")
    if tuple(A.shape) != (H,) or A.dtype != torch.float32 or not A.is_contiguous():
        raise ValueError(f"A must be contiguous float32 ({H},), got {A.dtype} "
                         f"{tuple(A.shape)}")
    if H % G != 0:
        raise ValueError(f"heads {H} are not a multiple of groups {G}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"head_dim {P} / state {N} above the kernel's {MAX_P} / {MAX_N}")
    if not 1 <= chunk <= MAX_CHUNK or S == 0 or S % chunk != 0:
        raise ValueError(f"chunk {chunk} must be in 1..{MAX_CHUNK} and divide the "
                         f"sequence {S} (> 0)")
    if initial_state is not None and (
            tuple(initial_state.shape) != (Bb, H, P, N)
            or initial_state.dtype != torch.float32 or not initial_state.is_contiguous()):
        raise ValueError(f"initial_state must be contiguous float32 {(Bb, H, P, N)}, got "
                         f"{initial_state.dtype} {tuple(initial_state.shape)}")


def ssd(x, dt, A, B_, C_, *, chunk: int = 256, initial_state: Optional[torch.Tensor] = None,
        return_final_state: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Mamba2 SSD scan. x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B_/C_ (B,S,G,N)
    -> (y like x, final state (B,H,P,N) f32 or None)."""
    kw = dict(chunk=chunk, return_final_state=return_final_state)
    if on_host(x):
        return ref.ssd_reference(x, dt, A, B_, C_, initial_state=initial_state, **kw)
    inputs = (x, dt, A, B_, C_) + (() if initial_state is None else (initial_state,))
    if records_grad(*inputs):
        # the Function's two callables return the same tensors: y alone when
        # no final state is asked for; chunk and the flag travel in the closure
        out = KernelWithPlainGrad.apply(_outputs(_launch, **kw),
                                        _outputs(ref.ssd_reference, **kw), *inputs)
        return out if return_final_state else (out, None)
    return _launch(x, dt, A, B_, C_, initial_state=initial_state, **kw)


def _outputs(fn, *, chunk: int, return_final_state: bool):
    """``fn`` over (x, dt, A, B, C[, initial_state]) returning (y, state), or y
    alone without the final state."""
    def call(x, dt, A, B_, C_, initial_state=None):
        y, state = fn(x, dt, A, B_, C_, chunk=chunk, initial_state=initial_state,
                      return_final_state=return_final_state)
        return (y, state) if return_final_state else y
    return call


@launcher
def _launch(x, dt, A, B_, C_, *, chunk: int, initial_state: Optional[torch.Tensor],
            return_final_state: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _check(x, dt, A, B_, C_, chunk, initial_state)
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    state = (torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
             if return_final_state else None)
    if y.numel() == 0:
        return y, state
    nc = S // chunk
    # the bf16 passes' scratch past one chunk: each chunk's own state and decay
    # (fp32), and the state entering each chunk as two bf16 planes, hi and lo,
    # the form the output pass reads
    states = decay = h_in = None
    if x.dtype == torch.bfloat16 and nc > 1:
        states = torch.empty((Bb, nc, H, P, N), dtype=torch.float32, device=x.device)
        decay = torch.empty((Bb, nc, H), dtype=torch.float32, device=x.device)
        h_in = torch.empty((Bb, nc, H, 2, P, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.ssd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(), y.data_ptr(),
        None if state is None else state.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (states, decay, h_in)),
        _DTYPE_CODES[x.dtype],
        Bb, S, H, P, G, N, chunk, _strides(x), _strides(dt), _strides(B_), _strides(C_),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.ssd_error_string(err).decode()
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["ssd"] += 1
    return y, state
