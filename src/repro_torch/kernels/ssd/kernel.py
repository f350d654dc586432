"""Wrappers of the Hopper SSD chunked-scan kernels (``csrc/*.cu``), bound with ctypes.

- ``ssd`` replaces ``ssd_pallas`` (src/repro/kernels/ssd/kernel.py:93). Unlike
  the TPU kernel it takes a nonzero ``initial_state``: on the card nothing
  falls back to the plain version, so the kernel has to take everything
  ``ops.ssd`` accepts. In bf16 one call is up to three device launches (chunk
  state, state passing, output; the launch decision lives in ``csrc/ssd.cu``).
- ``ssd_backward`` is its gradient for x, dt, A, B, C and the initial state
  (``csrc/ssd_backward.cu``, five device launches a call: chunk states, state
  passing, the chunk-local gradients, the group sums of dB and dC, dA's sum).
  The JAX package has no backward kernel: it differentiates its plain
  ``ssd_reference`` with ``jax.grad`` (src/repro/kernels/ssd/ref.py:25; the
  Pallas kernel has no VJP).

A wrapper given CPU or meta tensors (meta: a trace with no data) computes the
plain version in ``ref.py``, and only then. Given CUDA tensors it checks them,
allocates its outputs and scratch with ``torch.empty``, launches on the current
stream, raises if the launch failed, and adds one to ``LAUNCHES[name]``
(calls, not device launches). The libraries are built by ``nvcc`` at first use
(``build()``). Under autograd (an input that requires grad, grad mode on)
``ssd`` launches through ``SSDGrad``: the kernel forward, and
``ssd_backward``'s kernel backward (the ssm and hybrid families' training;
remat runs the forward twice a layer and the backward once).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import _build, launcher, on_host, records_grad
from . import ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"ssd": CSRC / "ssd.cu", "ssd_backward": CSRC / "ssd_backward.cu"}
# launches since the last reset_launches(): the proof that a run went through
# the kernel
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/ssd.cu kFloat32/kBFloat16
MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128                # csrc/ssd.cu kMaxChunk/kMaxP/kMaxN
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int
_I64P = ctypes.POINTER(ctypes.c_int64)
_ENTRIES = {  # library: {C entry: (argument types, result type)}
    "ssd": {
        # x, dt, A, B, C, initial_state, y, final_state, states, chunk_decay, h_in,
        # dtype, B, S, H, P, G, N, chunk, x/dt/B/C strides, stream
        "ssd_launch": ([_P] * 11 + [_I] * 8 + [_I64P] * 4 + [_P], _I),
        "ssd_error_string": ([_I], ctypes.c_char_p),
    },
    "ssd_backward": {
        # x, dt, A, B, C, dy, initial_state, dfinal, dx, ddt, dA, dB, dC, dinit,
        # scratch, dtype, B, S, H, P, G, N, chunk, x/dt/B/C strides, stream
        "ssd_backward_launch": ([_P] * 15 + [_I] * 8 + [_I64P] * 4 + [_P], _I),
        # B, S, H, P, G, N, chunk -> fp32 scratch floats
        "ssd_backward_scratch": ([_I] * 7, ctypes.c_int64),
        "ssd_backward_error_string": ([_I], ctypes.c_char_p),
    },
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
                lib = ctypes.CDLL(str(results[src]["path"]))
                for entry, (args, result) in _ENTRIES[name].items():
                    fn = getattr(lib, entry)
                    fn.argtypes, fn.restype = args, result
                _libs[name] = lib
    return {name: results[src] for name, src in SOURCES.items()}


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name]
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
    if records_grad(x, dt, A, B_, C_, initial_state):
        return SSDGrad.apply(functools.partial(_launch, **kw),
                             functools.partial(_backward_launch, chunk=chunk),
                             x, dt, A, B_, C_, initial_state)
    return _launch(x, dt, A, B_, C_, initial_state=initial_state, **kw)


class SSDGrad(torch.autograd.Function):
    """``apply(forward_fn, backward_fn, x, dt, A, B, C, initial_state)``: the
    forward is ``forward_fn(x, dt, A, B, C, initial_state=...) -> (y, final
    state or None)`` and returns both, saving the inputs; the backward is
    ``backward_fn(x, dt, A, B, C, dy, initial_state=..., dfinal=...) -> (dx,
    ddt, dA, dB, dC, dinit)`` and returns the gradients of the inputs that
    need one (``dfinal`` is None where the final state was not asked for or
    not used). On the card the pair is the two kernels; the CPU tests pass the
    plain pair (``ref.ssd_reference``, ``ref.ssd_backward_reference``). Under
    ``torch.utils.checkpoint`` the recompute runs ``forward_fn`` again."""

    @staticmethod
    def forward(ctx, forward_fn, backward_fn, x, dt, A, B_, C_, initial_state):
        y, state = forward_fn(x, dt, A, B_, C_, initial_state=initial_state)
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(x, dt, A, B_, C_, initial_state)
        return y, state

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B_, C_, initial_state = ctx.saved_tensors
        grads = ctx.backward_fn(x, dt, A, B_, C_, dy, initial_state=initial_state,
                                dfinal=dfinal)
        return (None, None, *(g if n else None for g, n in zip(grads, ctx.needs_input_grad[2:])))


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
    lib = _lib("ssd")
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


def ssd_backward(x, dt, A, B_, C_, dy, *, chunk: int = 256,
                 initial_state: Optional[torch.Tensor] = None,
                 dfinal: Optional[torch.Tensor] = None) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradient of ``ssd`` for x, dt, A, B, C and the initial state: (dx,
    ddt, dA, dB, dC, dinit), dx, dB and dC in x's dtype, ddt, dA and dinit
    fp32 (dinit None without an initial state), from the output's gradient
    dy (B,S,H,P) and, where the caller asked for the final state, its
    gradient dfinal (B,H,P,N)."""
    if on_host(x):
        return ref.ssd_backward_reference(x, dt, A, B_, C_, dy, chunk=chunk,
                                          initial_state=initial_state, dfinal=dfinal)
    return _backward_launch(x, dt, A, B_, C_, dy, chunk=chunk, initial_state=initial_state,
                            dfinal=dfinal)


@launcher
def _backward_launch(x, dt, A, B_, C_, dy, *, chunk: int, initial_state: Optional[torch.Tensor],
                     dfinal: Optional[torch.Tensor]):
    _check(x, dt, A, B_, C_, chunk, initial_state)
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    # autograd may hand the gradients over strided or expanded
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if dfinal is not None:
        dfinal = dfinal.contiguous()
        if dfinal.shape != (Bb, H, P, N) or dfinal.dtype != torch.float32 \
                or dfinal.device != x.device:
            raise ValueError(f"dfinal must be {(Bb, H, P, N)} float32 on {x.device}, got "
                             f"{tuple(dfinal.shape)} {dfinal.dtype} on {dfinal.device}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    ddt, dA = torch.empty((Bb, S, H), **f32), torch.empty((H,), **f32)
    dB, dC = (torch.empty((Bb, S, G, N), dtype=x.dtype, device=x.device) for _ in range(2))
    dinit = None if initial_state is None else torch.empty((Bb, H, P, N), **f32)
    if x.numel() == 0 or N == 0:   # nothing to launch: every gradient is 0
        return tuple(None if t is None else t.zero_() for t in (dx, ddt, dA, dB, dC, dinit))
    lib = _lib("ssd_backward")
    # the chunk states, then the states entering each chunk; their gradients;
    # the decays; the per-head partials of dB and dC; dA's partials (fp32)
    scratch = torch.empty(lib.ssd_backward_scratch(Bb, S, H, P, G, N, chunk), **f32)
    err = lib.ssd_backward_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(), dy.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (initial_state, dfinal)),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        None if dinit is None else dinit.data_ptr(), scratch.data_ptr(), _DTYPE_CODES[x.dtype],
        Bb, S, H, P, G, N, chunk, _strides(x), _strides(dt), _strides(B_), _strides(C_),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        msg = lib.ssd_backward_error_string(err).decode()
        raise RuntimeError(f"ssd_backward kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES["ssd_backward"] += 1
    return dx, ddt, dA, dB, dC, dinit
