"""Wrappers of the Hopper attention kernels (``csrc/*.cu``), bound with ctypes.

- ``flash_attention``: prefill, replaces ``flash_attention_pallas``
  (src/repro/kernels/flash_attention/kernel.py:107). Under autograd it also
  writes each row's log-sum-exp for the backward.
- ``flash_attention_backward``: its gradient (dq, dk, dv) from q, k, v, the
  output, the output's gradient and the log-sum-exp; two device launches a
  call (the dQ pass, then the dK/dV pass), three under GQA (the sum of each
  KV head's query heads). The JAX package has no backward
  kernel: it differentiates its plain ``mha_reference`` with ``jax.grad``
  (src/repro/kernels/flash_attention/ref.py:16; the Pallas kernel has no VJP).
- ``decode_attention``: one token against the cache, replaces
  ``decode_attention_pallas`` (same file, :173). One call is two device
  launches (split-KV, then the combine); ``LAUNCHES`` counts calls.
- ``decode_attention_partials``: the same two passes over one sequence shard
  of a cache (a mesh whose cache is split over ranks by position), returning
  the shard's max, sum and unnormalised accumulator per (row, head) for a
  combine across ranks (``ops.decode_attention``). Counted in ``LAUNCHES``
  under its own name.
- ``mla_decode_attention``: MLA's absorbed decode (``models/mla.py``), the
  same TPU kernel at that call: H query heads against one latent KV head
  whose K row is [ckv | krope] and whose V is ckv, read from the two cache
  tensors as they lie (no concatenated copy). One device launch a call: a
  thread-block cluster per (row, group of heads) that merges its blocks in
  distributed shared memory (``mla_grid``).
- ``mla_decode_attention_partials``: the same over one sequence shard of the
  two caches, returning the shard's max, sum and accumulator per (row, head)
  (``ops.mla_decode_attention`` on a mesh).

A wrapper given CPU or meta tensors (meta: a trace with no data) computes the
plain version in ``ref.py``, and only then. Given CUDA tensors it checks them,
allocates the output with ``torch.empty``, launches on the current stream,
raises if the launch failed, and adds one to ``LAUNCHES[name]``. It never
falls back to the plain version on the card. The libraries are built by
``nvcc`` at first use (``build()``).

Under autograd (an input that requires grad, grad mode on) ``flash_attention``
launches through ``FlashAttentionGrad``: the kernel forward, which also
writes the log-sum-exp, and ``flash_attention_backward``'s kernel backward
(training with remat runs the forward twice a layer, forward and recompute,
and the backward once). The decode kernels are on no training path and raise.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import _build, launcher, on_host, records_grad, refuse_grad
from . import ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {
    "flash_attention": CSRC / "flash_attention.cu",
    "decode_attention": CSRC / "decode_attention.cu",
    "mla_decode_attention": CSRC / "mla_decode.cu",
    "flash_attention_backward": CSRC / "flash_attention_backward.cu",
}
# entry points of each library beyond the one named after it
EXTRA_ENTRY_POINTS = {"decode_attention": ("decode_attention_partials",),
                      "mla_decode_attention": ("mla_decode_attention_partials",)}
# launches per kernel since the last reset_launches(): the proof that a run
# went through the kernels
LAUNCHES: Dict[str, int] = {name: 0 for name in
                            (*SOURCES, *(e for es in EXTRA_ENTRY_POINTS.values() for e in es))}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh kFloat32/kBFloat16
# the widest (dqk, dv) each kernel takes: flash_attention.cu kMaxHd (the f32
# kernel's registers, the bf16 kernel's two 64-column slabs);
# decode_attention.cu kMaxDqk / kMaxDv (its shared memory, sized for MLA)
MAX_HEAD_DIMS = {"flash_attention": (128, 128), "decode_attention": (288, 256)}
# the widest latent (dl, a multiple of 16) and rope (dr, a multiple of 8)
# parts mla_decode.cu takes (mla_decode_plan.cuh kMaxLatent / kMaxRope)
MLA_MAX_DIMS = (256, 64)
# cache positions per split of the decode kernel's first pass
# (csrc/decode_attention.cu kSplit, checked when the library loads)
DECODE_SPLIT = 128
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_I64P = ctypes.POINTER(ctypes.c_int64)
_ARGTYPES = {
    # q, k, v, o, lse, kv_len, dtype, B, Sq, Skv, H, KV, dqk, dv, q/k/v strides,
    # scale, causal, q_offset, stream
    "flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I64P, _I64P, _I64P, _F, _I, _I, _P],
    # q, k, v, o, dout, lse, kv_len, dq, dk, dv, scratch, dtype, B, Sq, Skv, H, KV,
    # dqk, dv, q/k/v strides, scale, causal, q_offset, stream
    "flash_attention_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I64P, _I64P, _I64P, _F, _I, _I, _P],
    # q, k_cache, v_cache, o, pos, pos is int64, pos stride, scratch, dtype, B, S, H,
    # KV, dqk, dv, q/k/v strides, scale, stream
    "decode_attention": [_P, _P, _P, _P, _P, _I, ctypes.c_int64, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I64P, _I64P, _I64P, _F, _P],
    # q, k_cache, v_cache, m, l, acc, pos, pos is int64, pos stride, pos offset,
    # scratch, dtype, B, S, H, KV, dqk, dv, q/k/v strides, scale, stream
    "decode_attention_partials": [_P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_int64,
                                  ctypes.c_int64, _P, _I, _I, _I, _I, _I, _I, _I, _I64P,
                                  _I64P, _I64P, _F, _P],
    # q, ckv, krope, o, pos, pos is int64, pos stride, dtype, B, S, H, dl, dr,
    # q/ckv/krope strides, scale, stream
    "mla_decode_attention": [_P, _P, _P, _P, _P, _I, ctypes.c_int64, _I, _I, _I, _I, _I, _I,
                             _I64P, _I64P, _I64P, _F, _P],
    # q, ckv, krope, m, l, acc, pos, pos is int64, pos stride, pos offset, dtype, B,
    # S, H, dl, dr, q/ckv/krope strides, scale, stream
    "mla_decode_attention_partials": [_P, _P, _P, _P, _P, _P, _P, _I, ctypes.c_int64,
                                      ctypes.c_int64, _I, _I, _I, _I, _I, _I, _I64P, _I64P,
                                      _I64P, _F, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build() -> Dict[str, dict]:
    """Compile the attention kernels (in parallel) and load them; returns, per kernel,
    the library path, build seconds and the ptxas report."""
    with _lock:
        results = _build.build(list(SOURCES.values()))
        for name, src in SOURCES.items():
            if name not in _libs:
                _libs[name] = load(name, results[src]["path"])
    return {name: results[src] for name, src in SOURCES.items()}


def load(name: str, path) -> ctypes.CDLL:
    """The library of kernel ``name`` at ``path`` (a build of its source, or of
    a variant with the same C interface), its entry points typed."""
    lib = ctypes.CDLL(str(path))
    for entry in (name, *EXTRA_ENTRY_POINTS.get(name, ())):
        fn = getattr(lib, f"{entry}_launch")
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    if name == "mla_decode_attention":
        lib.mla_decode_grid.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
        lib.mla_decode_grid.restype = ctypes.c_int
    if name == "flash_attention_backward":
        lib.flash_attention_backward_scratch.argtypes = [_I] * 7
        lib.flash_attention_backward_scratch.restype = ctypes.c_int64
    if name == "decode_attention" and lib.decode_attention_split() != DECODE_SPLIT:
        raise RuntimeError(f"decode_attention.cu splits by {lib.decode_attention_split()}, "
                           f"kernel.py by {DECODE_SPLIT}")
    return lib


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
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale)
    if on_host(q):
        return ref.mha_reference(q, k, v, **kw)
    if records_grad(q, k, v):
        return FlashAttentionGrad.apply(functools.partial(_flash_launch, with_lse=True, **kw),
                                        functools.partial(_flash_backward_launch, **kw),
                                        q, k, v)
    return _flash_launch(q, k, v, **kw)


class FlashAttentionGrad(torch.autograd.Function):
    """``apply(forward_fn, backward_fn, q, k, v)``: the forward is
    ``forward_fn(q, k, v) -> (o, lse)`` and returns o, saving q, k, v, o and
    lse; the backward is ``backward_fn(q, k, v, o, do, lse) -> (dq, dk, dv)``
    and returns the gradients of the inputs that need one. On the card the
    pair is the two kernels; the CPU tests pass the plain pair
    (``ref.mha_forward_with_lse_reference``, ``ref.mha_backward_reference``).
    Under ``torch.utils.checkpoint`` the recompute runs ``forward_fn`` again."""

    @staticmethod
    def forward(ctx, forward_fn, backward_fn, q, k, v):
        o, lse = forward_fn(q, k, v)
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = ctx.backward_fn(q, k, v, o, do, lse)
        return (None, None, *(g if n else None for g, n in zip(grads, ctx.needs_input_grad[2:])))


@launcher
def _flash_launch(q, k, v, *, causal: bool, q_offset, kv_len, scale, with_lse: bool = False):
    """o, or (o, lse (B, H, Sq) fp32) with ``with_lse``."""
    _check(q, k, v, "flash_attention")
    B, Sq, H, dqk = q.shape
    Skv, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else dqk ** -0.5
    o = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    lens = None if kv_len is None else _lengths(kv_len, B, q.device)
    lib = _lib("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if lens is None else lens.data_ptr(), _DTYPE_CODES[q.dtype],
        B, Sq, Skv, H, KV, dqk, dv,
        _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)), _strides(v, (0, 1, 2)),
        float(scale), int(causal), int(q_offset) if q_offset is not None else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (o, lse) if with_lse else o


def flash_attention_backward(q, k, v, o, do, lse, *, causal: bool = True, q_offset=None,
                             kv_len=None, scale: Optional[float] = None):
    """The gradient of ``flash_attention`` for q, k and v: (dq, dk, dv) in the
    inputs' shapes and dtype, from its output o and the output's gradient do
    (B, Sq, H, dv), and lse (B, H, Sq) fp32, the forward's log-sum-exp
    (``ref.mha_forward_with_lse_reference`` gives both). The masks are the
    forward's."""
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, scale=scale)
    if on_host(q):
        return ref.mha_backward_reference(q, k, v, o, do, lse, **kw)
    return _flash_backward_launch(q, k, v, o, do, lse, **kw)


@launcher
def _flash_backward_launch(q, k, v, o, do, lse, *, causal: bool, q_offset, kv_len, scale):
    _check(q, k, v, "flash_attention")
    B, Sq, H, dqk = q.shape
    Skv, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    do = do.contiguous()   # autograd may hand it over strided or expanded
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, Sq, H, dv) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be ({B}, {Sq}, {H}, {dv}) {q.dtype} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous ({B}, {H}, {Sq}) float32 on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    scale = scale if scale is not None else dqk ** -0.5
    dq, dk, dv_ = (torch.empty(t.shape, dtype=q.dtype, device=q.device) for t in (q, k, v))
    lens = None if kv_len is None else _lengths(kv_len, B, q.device)
    lib = _lib("flash_attention_backward")
    # each row's lse (log2 units) and rowsum(do * o), and under GQA fp32 dk | dv partials
    scratch = torch.empty(lib.flash_attention_backward_scratch(B, Sq, Skv, H, KV, dqk, dv),
                          dtype=torch.float32, device=q.device)
    err = lib.flash_attention_backward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        None if lens is None else lens.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv_.data_ptr(), scratch.data_ptr(), _DTYPE_CODES[q.dtype], B, Sq, Skv, H, KV, dqk, dv,
        _strides(q, (0, 1, 2)), _strides(k, (0, 1, 2)), _strides(v, (0, 1, 2)),
        float(scale), int(causal), int(q_offset) if q_offset is not None else 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv_


def decode_attention(q, k_cache, v_cache, pos, *, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention: q (B,1,H,dqk) against caches (B,S,KV,dqk) and
    (B,S,KV,dv) whose entries <= pos are valid -> (B,1,H,dv); ``pos`` is a
    scalar or (B,) (continuous batching)."""
    if on_host(q):
        return ref.decode_attention_reference(q, k_cache, v_cache, pos, scale=scale)
    refuse_grad("decode_attention", q, k_cache, v_cache)
    return _decode_launch(q, k_cache, v_cache, pos, scale)


@launcher
def _decode_launch(q, k_cache, v_cache, pos, scale) -> torch.Tensor:
    _check(q, k_cache, v_cache, "decode_attention")
    B, Sq, H, dqk = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention takes one query token per row, got {Sq}")
    S, KV, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    scale = scale if scale is not None else dqk ** -0.5
    o = torch.empty((B, 1, H, dv), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    pos = _positions(pos, B, q.device)
    scratch = _decode_scratch(B, S, H, dv, q.device)
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


def _positions(pos, batch: int, device) -> torch.Tensor:
    """A scalar or (B,) position as an int32 or int64 tensor on the device:
    the kernels read it themselves (no host sync, no extra launch)."""
    pos = torch.as_tensor(pos, device=device)
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int64)
    if pos.shape not in ((), (batch,)):
        raise ValueError(f"pos must be a scalar or ({batch},), got {tuple(pos.shape)}")
    return pos


def _decode_scratch(B: int, S: int, H: int, dv: int, device) -> torch.Tensor:
    """Per (row, split, head): the split's accumulator (dv), max and sum, fp32."""
    n_split = -(-S // DECODE_SPLIT)
    return torch.empty(B * n_split * H * (dv + 2), dtype=torch.float32, device=device)


def decode_attention_partials(q, k_cache, v_cache, pos, *, pos_offset: int = 0,
                              scale: Optional[float] = None):
    """The decode over one sequence shard of a cache: q (B,1,H,dqk), shards
    (B,S,KV,dqk) and (B,S,KV,dv) whose entry s holds global position
    ``pos_offset + s``; row b attends to the entries at or before ``pos[b]``.
    Returns fp32 (m, l, acc): the shard's max score (B,1,H), its sum of
    exp(score - m) (B,1,H) and the unnormalised accumulator (B,1,H,dv); a row
    with no valid entry here gives m = -inf, l = 0, acc = 0."""
    if on_host(q):
        return ref.decode_attention_partials_reference(q, k_cache, v_cache, pos,
                                                       pos_offset=pos_offset, scale=scale)
    refuse_grad("decode_attention_partials", q, k_cache, v_cache)
    return _partials_launch(q, k_cache, v_cache, pos, pos_offset, scale)


@launcher
def _partials_launch(q, k_cache, v_cache, pos, pos_offset: int, scale):
    _check(q, k_cache, v_cache, "decode_attention")
    B, Sq, H, dqk = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention takes one query token per row, got {Sq}")
    S, KV, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    scale = scale if scale is not None else dqk ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    m, l = torch.empty((B, 1, H), **f32), torch.empty((B, 1, H), **f32)
    acc = torch.empty((B, 1, H, dv), **f32)
    if acc.numel() == 0:
        return m, l, acc
    pos = _positions(pos, B, q.device)
    scratch = _decode_scratch(B, S, H, dv, q.device)
    lib = _lib("decode_attention")
    err = lib.decode_attention_partials_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), pos.data_ptr(), int(pos.dtype == torch.int64),
        pos.stride(0) if pos.ndim else 0, int(pos_offset), scratch.data_ptr(),
        _DTYPE_CODES[q.dtype], B, S, H, KV, dqk, dv,
        _strides(q, (0, 2)), _strides(k_cache, (0, 1, 2)), _strides(v_cache, (0, 1, 2)),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "decode_attention")
    LAUNCHES["decode_attention_partials"] += 1
    return m, l, acc


def mla_decode_attention(q, ckv, krope, pos, *, scale: float) -> torch.Tensor:
    """MLA's absorbed decode: q (B,1,H,dl+dr) against the latent caches ckv
    (B,S,dl) and krope (B,S,dr), K = [ckv | krope] and V = ckv, entries
    <= pos valid -> (B,1,H,dl); ``pos`` is a scalar or (B,)."""
    if on_host(q):
        return ref.mla_decode_reference(q, ckv, krope, pos, scale=scale)
    refuse_grad("mla_decode_attention", q, ckv, krope)
    return _mla_launch(q, ckv, krope, pos, None, scale)


def mla_decode_attention_partials(q, ckv, krope, pos, *, pos_offset: int = 0, scale: float):
    """The absorbed decode over one sequence shard of the latent caches, whose
    entry s holds global position ``pos_offset + s``: fp32 (m, l, acc) as
    ``decode_attention_partials`` returns them, acc (B,1,H,dl)."""
    if on_host(q):
        return ref.mla_decode_partials_reference(q, ckv, krope, pos, pos_offset=pos_offset,
                                                 scale=scale)
    refuse_grad("mla_decode_attention_partials", q, ckv, krope)
    return _mla_launch(q, ckv, krope, pos, int(pos_offset), scale)


def _check_mla(q: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor) -> None:
    """q (B, 1, H, dl + dr), ckv (B, S, dl), krope (B, S, dr): one dtype, widths
    mla_decode.cu takes, then one card and rows it can copy in 16-byte pieces
    (shapes and dtypes first, so the checks also read CPU tensors)."""
    for name, t, ndim in (("q", q, 4), ("ckv", ckv, 3), ("krope", krope, 3)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"mla_decode_attention takes float32 or bfloat16, got {q.dtype}")
    B, Sq, _, dqk = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention takes one query token per row, got {Sq}")
    dl, dr = ckv.shape[-1], krope.shape[-1]
    if ckv.shape[:2] != krope.shape[:2] or ckv.shape[0] != B or dqk != dl + dr:
        raise ValueError(f"ckv {tuple(ckv.shape)} / krope {tuple(krope.shape)} do not match q "
                         f"{tuple(q.shape)}: the caches need the same (B, S), and q's head "
                         "dim is their widths' sum")
    max_dl, max_dr = MLA_MAX_DIMS
    if dl % 16 or dr % 8 or not 0 < dl <= max_dl or dr > max_dr:
        raise ValueError(f"mla_decode_attention: the latent width {dl} must be a multiple of "
                         f"16 up to {max_dl}, the rope width {dr} a multiple of 8 up to "
                         f"{max_dr}")
    for name, t in (("q", q), ("ckv", ckv), ("krope", krope)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        strides = (t.stride(0), t.stride(2)) if t.ndim == 4 else t.stride()[:2]
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(x % 8 for x in strides):
            raise ValueError(f"{name} must be 16-byte aligned with a unit stride on its last "
                             f"dim and the others in multiples of 8 elements: strides "
                             f"{t.stride()}")


def mla_grid(B: int, S: int, H: int, dl: int, dr: int, dtype=torch.bfloat16) -> dict:
    """``mla_decode.cu``'s launch at B rows, S cache positions, H heads and
    widths dl, dr on this card (``csrc/mla_decode_plan.cuh``): one cluster of
    ``cluster`` blocks per (row, group of ``group_heads`` heads), ``groups``
    groups, and the ``clusters`` the card holds at once."""
    out = (ctypes.c_int * 5)()
    err = _lib("mla_decode_attention").mla_decode_grid(_DTYPE_CODES[dtype], B, S, H, dl, dr,
                                                       out)
    _raise_on(err, "mla_decode_attention")
    return dict(zip(("cluster", "groups", "rows", "group_heads", "clusters"), out))


def mla_share(length: int, cluster: int) -> int:
    """The keys each block of a row of ``length`` takes when ``cluster``
    blocks share it: ceil(length / cluster) rounded up to 16
    (``csrc/mla_decode_plan.cuh`` ``share``)."""
    per_block = -(-length // cluster)
    return -(-per_block // 16) * 16


@launcher
def _mla_launch(q, ckv, krope, pos, pos_offset: Optional[int], scale: float):
    """One launch of mla_decode.cu: the output (pos_offset None) or one
    sequence shard's fp32 partials."""
    _check_mla(q, ckv, krope)
    B, _, H, _ = q.shape
    S, dl, dr = ckv.shape[1], ckv.shape[-1], krope.shape[-1]
    f32 = dict(dtype=torch.float32, device=q.device)
    if pos_offset is None:
        outs = (torch.empty((B, 1, H, dl), dtype=q.dtype, device=q.device),)
    else:
        outs = (torch.empty((B, 1, H), **f32), torch.empty((B, 1, H), **f32),
                torch.empty((B, 1, H, dl), **f32))
    if outs[-1].numel() == 0:
        return outs[0] if pos_offset is None else outs
    pos = _positions(pos, B, q.device)
    lib = _lib("mla_decode_attention")
    common = (pos.data_ptr(), int(pos.dtype == torch.int64), pos.stride(0) if pos.ndim else 0)
    tail = (_DTYPE_CODES[q.dtype], B, S, H, dl, dr,
            _strides(q, (0, 2)), _strides(ckv, (0, 1)), _strides(krope, (0, 1)), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    heads = (q.data_ptr(), ckv.data_ptr(), krope.data_ptr())
    if pos_offset is None:
        name = "mla_decode_attention"
        err = lib.mla_decode_attention_launch(*heads, outs[0].data_ptr(), *common, *tail)
    else:
        name = "mla_decode_attention_partials"
        err = lib.mla_decode_attention_partials_launch(
            *heads, *(t.data_ptr() for t in outs), *common, pos_offset, *tail)
    _raise_on(err, "mla_decode_attention")
    LAUNCHES[name] += 1
    return outs[0] if pos_offset is None else outs
