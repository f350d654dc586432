"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

Every ``ops`` module dispatches with ``impl``: "auto" (the kernel for a CUDA
tensor, the reference for a CPU tensor), "kernel" (the kernel; a CPU tensor is
an error), "ref" (the plain PyTorch version on any device). A kernel wrapper
given a tensor on the CPU or on the meta device (a trace with no data, as
``launch/analysis.py`` counts FLOPs) computes the plain version (``on_host``).

Gradients: a kernel wrapper given CUDA inputs that autograd records (grad
mode on and an input that requires grad) launches its kernel through an
autograd Function, or raises where the kernel is on no training path
(decode attention). Flash attention's Function
(``flash_attention.kernel.FlashAttentionGrad``) has a backward kernel of its
own; the add + norm and the SSD scan launch through ``KernelWithPlainGrad``,
whose backward is the plain version's gradient, until their backward kernels
come. A wrapper never returns an output without a ``grad_fn`` there.

Compiled code: each kernel's launch on CUDA tensors (its pointer checks, the
ctypes call, the launch counter) is a ``launcher``, which ``torch.compile``
calls as it is, between the graphs it compiles around it.
"""
from __future__ import annotations

import functools

import torch

IMPLS = ("auto", "kernel", "ref")


def use_ref(t, impl: str) -> bool:
    """Whether ``impl`` sends tensor ``t`` to the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and not t.is_cuda:
        raise ValueError(f"impl='kernel' needs CUDA tensors, got {t.device}")
    return impl == "ref"


def on_host(t) -> bool:
    """Whether a kernel wrapper computes its plain version for tensor ``t``:
    it lies on the CPU, or on the meta device (shapes only, no launch)."""
    return t.device.type in ("cpu", "meta")


def launcher(fn):
    """``fn``, a kernel's launch on CUDA tensors, run as it is under
    ``torch.compile``: Dynamo breaks the graph around the call and does not
    trace into it. Traced, its pointer arithmetic on fake tensors would make
    Dynamo drop the whole calling frame to eager, and its launch counter (an
    int it would guard on) would recompile the code after it at every call.

    An eager call (``torch.compiler.is_compiling()`` false) calls ``fn``
    itself, with no eval-frame switch. Under a trace the call goes through
    ``torch._disable_dynamo(fn)``, which Dynamo skips, and which imports
    ``torch._dynamo`` only when first called: importing the kernels does not."""
    traced = torch._disable_dynamo(fn)

    @functools.wraps(fn)
    def launch(*args, **kwargs):
        if torch.compiler.is_compiling():
            return traced(*args, **kwargs)
        return fn(*args, **kwargs)

    return launch


def records_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None entries skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a call of kernel ``name``, which has
    no backward: its output would silently carry no gradient."""
    if records_grad(*tensors):
        raise RuntimeError(f"{name} has no gradient on the card: it is on no training path; "
                           "call it under torch.no_grad() or on tensors that do not require grad")


class KernelWithPlainGrad(torch.autograd.Function):
    """``apply(kernel_fn, plain_fn, *inputs)``: the forward is ``kernel_fn(*inputs)``
    (a hand-written kernel's launch); the backward recomputes ``plain_fn(*inputs)``
    (its plain PyTorch version) from the saved inputs under grad and returns
    its gradient for every input that needs one. Outputs are a tensor or a
    tuple of tensors, the same for both functions.

    The JAX package has no backward kernel and cannot differentiate its
    forward ones, so the plain version's gradient is the reference here."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, *inputs):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*inputs)
        return kernel_fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            outs = ctx.plain_fn(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True))
        return (None, None, *(next(got) if n else None for n in needs))
