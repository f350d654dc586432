"""Dispatching wrapper: the Hopper SSD kernel on CUDA tensors, the plain version on CPU ones.

``impl``: "auto" (the kernel for a CUDA tensor, the reference for a CPU
tensor), "kernel" (the kernel; a CPU tensor is an error), "ref" (the plain
PyTorch version on any device, which ``chip_smoke.py`` uses as the yardstick
of correctness). A CUDA tensor under "auto" never falls back to the reference,
``initial_state`` included. Given DTensors (a model on a mesh) the scan runs
on every rank's shard through ``sharding.local.local_call``, independent over
batch and SSD heads (the B/C groups shard with the heads where there is more
than one); a sharded sequence or state dim is gathered first.
"""
from __future__ import annotations

from .. import use_ref
from ...sharding.local import local_call
from ...sharding.partition import is_dtensor
from . import kernel, ref


def ssd(x, dt, A, B_, C_, *, chunk: int = 256, initial_state=None,
        return_final_state: bool = False, impl: str = "auto"):
    """Mamba2 SSD scan. x (B,S,H,P), dt (B,S,H), A (H,), B_/C_ (B,S,G,N)."""
    fn = ref.ssd_reference if use_ref(x, impl) else kernel.ssd
    if is_dtensor(x):
        bc = "b.h." if B_.shape[2] > 1 else "b..."

        def call(x, dt, A, B_, C_, initial_state=None):
            y, state = fn(x, dt, A, B_, C_, chunk=chunk, initial_state=initial_state,
                          return_final_state=return_final_state)
            return (y, state) if return_final_state else y

        args = [x, dt, A, B_, C_] + ([] if initial_state is None else [initial_state])
        keys = ["b.h.", "b.h", "h", bc, bc] + ([] if initial_state is None else ["bh.."])
        out = local_call(call, args, keys, ("b.h.", "bh..") if return_final_state else "b.h.")
        return out if return_final_state else (out, None)
    return fn(x, dt, A, B_, C_, chunk=chunk, initial_state=initial_state,
              return_final_state=return_final_state)


def ssd_decode(state, x_t, dt_t, A, B_t, C_t):
    """O(1) single-token SSD recurrence, plain torch on every device (no
    kernel needed: bandwidth-trivial, as in the reference's ops.py)."""
    return ref.ssd_decode_reference(state, x_t, dt_t, A, B_t, C_t)
