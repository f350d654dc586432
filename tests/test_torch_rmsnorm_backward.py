"""The fused add + RMSNorm's backward: its plain version and autograd Function against JAX.

The port's backward kernel (``csrc/fused_add_rmsnorm_backward.cu``) runs only
on the card; its plain version, ``ref.fused_add_rmsnorm_backward_reference``
(the explicit formulas), is held here against ``jax.vjp`` of the JAX
package's ``fused_add_rmsnorm_reference`` on the same numpy inputs, in f32,
within 1e-5 relative L2 for dx, ddelta and dscale, with both output
gradients nonzero and with only the normed output's. ``kernel.AddRMSNormGrad``
runs with the plain pair in the kernels' place: autograd of
``fused_add_rmsnorm_reference``, ``torch.autograd.gradcheck`` in float64,
``None`` for inputs that need no gradient, under ``torch.utils.checkpoint``,
and along a residual stream, where the one tensor returned for both dx and
ddelta is added into by the gradients of both. The card's tests hold the
kernel to the plain version (tests/test_torch_kernels_cuda.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import ref as jref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as tkernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as tref  # noqa: E402

REL_L2 = 1e-5   # f32: each gradient's relative L2 distance to the other's
EPS = 1e-6


def _arrays(shape, seed, dtype=np.float32, only_out=False):
    """numpy (x, delta, scale, g_res, g_out); g_res zeros with ``only_out``."""
    r = np.random.default_rng(seed)
    x, d, g_res, g_out = (r.standard_normal(shape) for _ in range(4))
    scale = r.random(shape[-1]) + 0.5
    if only_out:
        g_res = np.zeros(shape)
    return [a.astype(dtype) for a in (x, d, scale, g_res, g_out)]


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
                 for a in (got, want))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("shape,only_out", [((2, 5, 64), False), ((3, 7, 896), False),
                                            ((4, 2560), True), ((1, 3, 6144), False)],
                         ids=["small", "qwen2-width", "zamba2-width-only-out", "internvl2-width"])
def test_backward_reference_matches_jax_vjp(shape, only_out):
    x, d, scale, g_res, g_out = _arrays(shape, 0, only_out=only_out)
    _, vjp = jax.vjp(functools.partial(jref.fused_add_rmsnorm_reference, eps=EPS),
                     *map(jnp.asarray, (x, d, scale)))
    want = vjp((jnp.asarray(g_res), jnp.asarray(g_out)))
    got = tref.fused_add_rmsnorm_backward_reference(*map(torch.from_numpy, (x, d, scale, g_res,
                                                                            g_out)), EPS)
    assert got[0] is got[1]
    for name, g, w in zip(("dx", "ddelta", "dscale"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert _rel_l2(g, w) <= REL_L2, f"{name}: {_rel_l2(g, w):.3e}"


def _function(calls=None):
    """``AddRMSNormGrad`` with the plain pair in the kernels' place; ``calls``
    counts each callable's calls."""
    fwd = functools.partial(tref.fused_add_rmsnorm_reference, eps=EPS)
    bwd = functools.partial(tref.fused_add_rmsnorm_backward_reference, eps=EPS)
    if calls is not None:
        fwd0, bwd0 = fwd, bwd

        def fwd(*a):
            calls["forward"] += 1
            return fwd0(*a)

        def bwd(*a):
            calls["backward"] += 1
            return bwd0(*a)

    return lambda x, d, scale: tkernel.AddRMSNormGrad.apply(fwd, bwd, x, d, scale)


def _autograd(x, d, scale, g_res, g_out):
    xs = [a.clone().requires_grad_() for a in (x, d, scale)]
    return torch.autograd.grad(tref.fused_add_rmsnorm_reference(*xs, EPS), xs, (g_res, g_out))


def test_function_with_the_plain_pair_is_autograd_of_the_reference():
    """Both outputs equal the reference's, and the gradients of x, delta and
    the fp32 scale equal autograd's: with both output gradients, and with
    the normed output's alone (the residual's materialised as zeros)."""
    x, d, scale, g_res, g_out = map(torch.from_numpy, _arrays((3, 5, 16), 2))
    xs = [a.clone().requires_grad_() for a in (x, d, scale)]
    res, out = _function()(*xs)
    want_res, want_out = tref.fused_add_rmsnorm_reference(x, d, scale, EPS)
    assert torch.equal(res, want_res) and torch.equal(out, want_out)
    got = torch.autograd.grad((res, out), xs, (g_res, g_out))
    for g, w in zip(got, _autograd(x, d, scale, g_res, g_out)):
        assert _rel_l2(g, w) <= REL_L2
    (gx,) = torch.autograd.grad(_function()(*xs)[1].sum(), xs[0])
    (wx,) = torch.autograd.grad(tref.fused_add_rmsnorm_reference(*xs, EPS)[1].sum(), xs[0])
    assert _rel_l2(gx, wx) <= REL_L2


def test_function_gradcheck_float64():
    """The Function's analytic gradient (the plain backward) against finite
    differences of its forward, float64."""
    x, d, scale = (torch.from_numpy(a).requires_grad_() for a in _arrays((2, 3, 8), 3,
                                                                           np.float64)[:3])
    assert torch.autograd.gradcheck(_function(), (x, d, scale))


def test_function_returns_none_for_inputs_that_need_no_gradient():
    """With only delta requiring grad, the backward returns its gradient
    alone (and none for the two callables)."""
    x, d, scale, g_res, g_out = map(torch.from_numpy, _arrays((2, 4, 32), 4))
    d.requires_grad_()
    res, _ = _function()(x, d, scale)
    grads = res.grad_fn.apply(g_res, g_out)
    assert len(grads) == 5 and [g is not None for g in grads] == [False, False, False, True,
                                                                  False]
    assert _rel_l2(grads[3], _autograd(x, d, scale, g_res, g_out)[1]) <= REL_L2


def test_function_under_checkpoint_matches_autograd_of_the_reference():
    """Under ``torch.utils.checkpoint`` (non-reentrant, as the models' remat)
    the Function runs its forward twice and its backward once; its gradients
    equal autograd of the reference within REL_L2."""
    from torch.utils.checkpoint import checkpoint

    x, d, scale, g_res, g_out = map(torch.from_numpy, _arrays((2, 9, 64), 5))
    xs = [a.clone().requires_grad_() for a in (x, d, scale)]
    calls = {"forward": 0, "backward": 0}
    fn = _function(calls)
    res, out = checkpoint(lambda *a: fn(*a), *xs, use_reentrant=False)
    got = torch.autograd.grad((res, out), xs, (g_res, g_out))
    assert calls == {"forward": 2, "backward": 1}
    for g, w in zip(got, _autograd(x, d, scale, g_res, g_out)):
        assert _rel_l2(g, w) <= REL_L2


def test_one_gradient_tensor_for_x_and_delta_along_a_residual_stream():
    """Three layers of a residual stream, as the dense family runs them: each
    layer's delta is a product of the residual, and each add + norm returns
    one tensor as the gradient of both x and delta, into which autograd then
    adds the product's gradient of the same residual. Every weight's, every
    scale's and the stream input's gradient equal autograd of the plain
    chain's within REL_L2."""
    r = np.random.default_rng(6)
    D = 32
    x0 = torch.from_numpy(r.standard_normal((2, 5, D)).astype(np.float32))
    ws = [torch.from_numpy(r.standard_normal((D, D)).astype(np.float32) / D ** 0.5)
          for _ in range(3)]
    scales = [torch.from_numpy((r.random(D) + 0.5).astype(np.float32)) for _ in range(3)]
    g = torch.from_numpy(r.standard_normal((2, 5, D)).astype(np.float32))

    def chain(norm):
        leaves = [a.clone().requires_grad_() for a in [x0, *ws, *scales]]
        res, normed = leaves[0], leaves[0]
        for w, s in zip(leaves[1:4], leaves[4:]):
            res, normed = norm(res, torch.tanh(normed @ w), s)
        loss = (normed * g).sum() + (res * g).sum() * 0.5
        return torch.autograd.grad(loss, leaves)

    got = chain(_function())
    want = chain(lambda x, d, s: tref.fused_add_rmsnorm_reference(x, d, s, EPS))
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel_l2(a, b) <= REL_L2, f"leaf {i}"


def test_wrappers_on_cpu_take_the_plain_versions():
    """On CPU tensors ``fused_add_rmsnorm_backward`` is the plain backward and
    ``fused_add_rmsnorm`` under autograd is the reference differentiated by
    autograd, bit for bit; no kernel launch is counted."""
    x, d, scale, g_res, g_out = map(torch.from_numpy, _arrays((4, 48), 7))
    before = dict(tkernel.LAUNCHES)
    got = tkernel.fused_add_rmsnorm_backward(x, d, scale, g_res, g_out, EPS)
    for a, b in zip(got, tref.fused_add_rmsnorm_backward_reference(x, d, scale, g_res, g_out,
                                                                   EPS)):
        assert torch.equal(a, b)
    xs = [a.clone().requires_grad_() for a in (x, d, scale)]
    got = torch.autograd.grad(tkernel.fused_add_rmsnorm(*xs, EPS), xs, (g_res, g_out))
    for a, b in zip(got, _autograd(x, d, scale, g_res, g_out)):
        assert torch.equal(a, b)
    assert tkernel.LAUNCHES == before
