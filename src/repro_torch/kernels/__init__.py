"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

Every ``ops`` module dispatches with ``impl``: "auto" (the kernel for a CUDA
tensor, the reference for a CPU tensor), "kernel" (the kernel; a CPU tensor is
an error), "ref" (the plain PyTorch version on any device).
"""

IMPLS = ("auto", "kernel", "ref")


def use_ref(t, impl: str) -> bool:
    """Whether ``impl`` sends tensor ``t`` to the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and not t.is_cuda:
        raise ValueError(f"impl='kernel' needs CUDA tensors, got {t.device}")
    return impl == "ref"
