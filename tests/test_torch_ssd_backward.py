"""The SSD scan's backward: its plain version and autograd Function against JAX.

The port's backward kernel (``csrc/ssd_backward.cu``) runs only on the card;
its plain version, ``ref.ssd_backward_reference`` (the explicit formulas, pass
by pass as the kernel runs them), is held here against ``jax.vjp`` of the JAX
package's ``ssd_reference`` on the same numpy inputs, in f32: relative L2
within 1e-5 for dx, dB, dC and the initial state's gradient, 1e-4 for ddt and
dA, which pass through the cumulative sums of dt A. A tail padded with dt = 0
(as ``models/mamba2.py`` pads S to a chunk multiple) is held against autograd
of the port's own ``ssd_reference``. ``kernel.SSDGrad`` runs with the plain
pair in the kernels' place: autograd of ``ssd_reference`` for every
initial/final-state combination, ``torch.autograd.gradcheck`` in float64,
``None`` for inputs that need no gradient, and under
``torch.utils.checkpoint`` equal to autograd of ``ssd_reference`` within
1e-5. The card's tests hold the kernel to the plain version
(tests/test_torch_kernels_cuda.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ref as jref  # noqa: E402
from repro_torch.kernels.ssd import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ssd import ref as tref  # noqa: E402

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# f32 relative L2, port against JAX: ddt and dA pass through the cumulative sums
REL_L2 = {"dx": 1e-5, "ddt": 1e-4, "dA": 1e-4, "dB": 1e-5, "dC": 1e-5, "dinit": 1e-5}
# (id, (B, S, H, P, G, N, chunk), initial state and final-state gradient)
CASES = [  # the four of tests/test_torch_ssd.py's SWEEP, then G = 2, chunk 1, both states
    ("sweep-2-chunks", (1, 64, 2, 16, 1, 16, 16), False),
    ("sweep-G2", (2, 128, 4, 32, 2, 8, 32), False),
    ("sweep-3-chunks", (1, 96, 6, 16, 1, 32, 32), False),
    ("sweep-1-chunk", (2, 64, 8, 64, 4, 16, 64), False),
    ("G2-H6", (2, 24, 6, 8, 2, 6, 8), False),
    ("chunk-1", (1, 5, 2, 4, 1, 3, 1), False),
    ("initial-and-final-state", (2, 24, 4, 8, 2, 6, 8), True),
]
IDS = [c[0] for c in CASES]


def _arrays(shape, seed, states=False, dtype=np.float32):
    """numpy (x, dt, A, B, C, dy, initial state, final-state gradient) as
    tests/test_kernels_ssd.py draws the inputs; the states None without
    ``states``."""
    B, S, H, P, G, N, _ = shape
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(r.standard_normal((B, S, H)))) * 0.5
    A = -np.exp(r.standard_normal(H) * 0.3)
    Bm, Cm = (r.standard_normal((B, S, G, N)) * 0.3 for _ in range(2))
    dy = r.standard_normal((B, S, H, P))
    h0, df = (r.standard_normal((B, H, P, N)) if states else None for _ in range(2))
    return [None if a is None else a.astype(dtype) for a in (x, dt, A, Bm, Cm, dy, h0, df)]


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
                 for a in (got, want))
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ssd_backward_reference_matches_jax_vjp(case):
    _, shape, states = case
    chunk = shape[-1]
    x, dt, A, Bm, Cm, dy, h0, df = _arrays(shape, 0, states)

    def jfn(x, dt, A, Bm, Cm, h0):
        return jref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, initial_state=h0,
                                  return_final_state=True)

    primals = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)] + [
        jnp.asarray(h0) if states else jnp.zeros((shape[0], shape[2], shape[3], shape[5]))]
    out, vjp = jax.vjp(jfn, *primals)
    want = vjp((jnp.asarray(dy), jnp.asarray(df) if states else jnp.zeros_like(out[1])))
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = tref.ssd_backward_reference(*map(t, (x, dt, A, Bm, Cm, dy)), chunk=chunk,
                                      initial_state=t(h0), dfinal=t(df))
    assert (got[5] is None) != states
    for name, g, w in zip(NAMES, got, want):
        if g is None:
            continue
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert _rel_l2(g.numpy(), w) <= REL_L2[name], f"{name}: {_rel_l2(g.numpy(), w):.3e}"


def _autograd(inputs, dy, df, chunk):
    """Autograd of the port's ``ssd_reference`` for every input."""
    xs = [a.clone().requires_grad_() for a in inputs]
    y, st = tref.ssd_reference(*xs[:5], chunk=chunk,
                               initial_state=xs[5] if len(xs) > 5 else None,
                               return_final_state=df is not None)
    outs, cot = ([y, st], [dy, df]) if df is not None else ([y], [dy])
    return torch.autograd.grad(outs, xs, cot)


def test_ssd_backward_reference_on_a_dt_zero_tail_matches_autograd():
    """Three chunks of 16 whose last 21 positions are padding (dt = 0, x, B
    and C zero, dy zero as the model slices y): the plain backward equals
    autograd of ``ssd_reference`` within 1e-6 relative, dx is exactly 0 on
    the tail, and every gradient of the real positions equals the unpadded
    call's."""
    shape = (2, 48, 4, 8, 2, 6, 16)
    S, pad = 48, 21
    x, dt, A, Bm, Cm, dy, h0, df = map(
        lambda a: None if a is None else torch.from_numpy(a), _arrays(shape, 1, True))
    for a in (x, dt, Bm, Cm, dy):
        a[:, S - pad:] = 0
    got = tref.ssd_backward_reference(x, dt, A, Bm, Cm, dy, chunk=16, initial_state=h0,
                                      dfinal=df)
    want = _autograd([x, dt, A, Bm, Cm, h0], dy, df, 16)
    for name, g, w in zip(NAMES, got, want):
        assert _rel_l2(g, w) <= 1e-6, name
    assert torch.equal(got[0][:, S - pad:], torch.zeros_like(got[0][:, S - pad:]))
    # the unpadded call, one chunk of the 27 real positions: the same
    # gradients there, and the same dA and initial-state gradient (the state
    # is chunked otherwise, so within 1e-5)
    real = S - pad
    cut = _autograd([x[:, :real], dt[:, :real], A, Bm[:, :real], Cm[:, :real], h0],
                    dy[:, :real], df, real)
    for name, g, w in zip(NAMES, got, cut):
        g = g[:, :real] if name in ("dx", "ddt", "dB", "dC") else g
        assert _rel_l2(g, w) <= 1e-5, name


def _function(chunk, final, calls=None):
    """``SSDGrad`` with the plain pair in the kernels' place (y alone without
    the final state, as ``kernel.ssd``); ``calls`` counts each callable's calls."""
    fwd = functools.partial(tref.ssd_reference, chunk=chunk, return_final_state=final)
    bwd = functools.partial(tref.ssd_backward_reference, chunk=chunk)
    if calls is not None:
        fwd0, bwd0 = fwd, bwd

        def fwd(*a, **kw):
            calls["forward"] += 1
            return fwd0(*a, **kw)

        def bwd(*a, **kw):
            calls["backward"] += 1
            return bwd0(*a, **kw)

    def fn(x, dt, A, Bm, Cm, h0=None):
        y, state = tkernel.SSDGrad.apply(fwd, bwd, x, dt, A, Bm, Cm, h0)
        return (y, state) if final else y

    return fn


@pytest.mark.parametrize("final_state", [False, True])
@pytest.mark.parametrize("initial_state", [False, True])
def test_ssd_function_with_the_plain_pair_is_autograd_of_ssd_reference(initial_state,
                                                                        final_state):
    """``SSDGrad`` with the plain forward and backward: y (and the final
    state) equal ``ssd_reference``'s, and the gradients of x, dt, A, B, C (and
    the initial state) equal autograd's within 1e-5 relative L2."""
    shape = (2, 12, 4, 8, 2, 6, 4)
    x, dt, A, Bm, Cm, dy, h0, df = map(
        lambda a: None if a is None else torch.from_numpy(a), _arrays(shape, 4, True))
    inputs = [x, dt, A, Bm, Cm] + ([h0] if initial_state else [])
    xs = [a.clone().requires_grad_() for a in inputs]
    out = _function(4, final_state)(*xs)
    y = out[0] if final_state else out
    want_y, want_state = tref.ssd_reference(*inputs[:5], chunk=4,
                                            initial_state=h0 if initial_state else None,
                                            return_final_state=True)
    assert torch.equal(y, want_y)
    if final_state:
        assert torch.equal(out[1], want_state)
    outs, cot = ([out[0], out[1]], [dy, df]) if final_state else ([out], [dy])
    got = torch.autograd.grad(outs, xs, cot)
    want = _autograd(inputs, dy, df if final_state else None, 4)
    for name, g, w in zip(NAMES, got, want):
        assert _rel_l2(g, w) <= 1e-5, name


@pytest.mark.parametrize("final_state", [False, True])
def test_ssd_function_gradcheck_float64(final_state):
    """The Function's analytic gradient (the plain backward) against finite
    differences of its forward, float64, two chunks, G 2 over H 4, from an
    initial state."""
    shape = (1, 6, 4, 3, 2, 2, 3)
    x, dt, A, Bm, Cm, _, h0, _ = (None if a is None else torch.from_numpy(a).requires_grad_()
                                  for a in _arrays(shape, 5, True, np.float64))
    fn = _function(3, final_state)
    assert torch.autograd.gradcheck(lambda *a: fn(*a), (x, dt, A, Bm, Cm, h0))


def test_ssd_function_returns_none_for_inputs_that_need_no_gradient():
    """With only B and dt requiring grad, the backward returns gradients for
    them alone (and none for the two callables)."""
    shape = (1, 8, 2, 4, 1, 3, 4)
    x, dt, A, Bm, Cm, dy, _, _ = (torch.from_numpy(a) if a is not None else None
                                  for a in _arrays(shape, 6))
    dt.requires_grad_()
    Bm.requires_grad_()
    y = _function(4, False)(x, dt, A, Bm, Cm)
    grads = y.grad_fn.apply(dy, None)
    assert len(grads) == 8 and grads[0] is None and grads[1] is None
    assert [g is not None for g in grads[2:]] == [False, True, False, True, False, False]
    want = _autograd([x, dt, A, Bm, Cm], dy, None, 4)
    assert _rel_l2(grads[3], want[1]) <= 1e-5 and _rel_l2(grads[5], want[3]) <= 1e-5


def test_ssd_function_under_checkpoint_matches_autograd_of_ssd_reference():
    """Under ``torch.utils.checkpoint`` (non-reentrant, as the models' remat)
    the Function runs its forward twice (forward and recompute) and its
    backward once; its gradients equal autograd of ``ssd_reference`` within
    1e-5."""
    from torch.utils.checkpoint import checkpoint

    shape = (2, 32, 4, 8, 2, 6, 16)
    x, dt, A, Bm, Cm, dy, _, _ = (torch.from_numpy(a) if a is not None else None
                                  for a in _arrays(shape, 7))
    xs = [a.clone().requires_grad_() for a in (x, dt, A, Bm, Cm)]
    calls = {"forward": 0, "backward": 0}
    fn = _function(16, False, calls)
    out = checkpoint(lambda *a: fn(*a) * 2.0, *xs, use_reentrant=False)
    got = torch.autograd.grad(out, xs, dy)
    assert calls == {"forward": 2, "backward": 1}
    want = _autograd([x, dt, A, Bm, Cm], dy * 2.0, None, 16)
    for name, g, w in zip(NAMES, got, want):
        assert _rel_l2(g, w) <= 1e-5, name


def test_ssd_wrappers_on_cpu_take_the_plain_versions():
    """On CPU tensors ``ssd_backward`` is the plain backward and ``ssd`` under
    autograd is ``ssd_reference`` differentiated by autograd, bit for bit; no
    kernel launch is counted."""
    shape = (1, 16, 2, 4, 1, 3, 8)
    x, dt, A, Bm, Cm, dy, h0, df = (None if a is None else torch.from_numpy(a)
                                    for a in _arrays(shape, 8, True))
    before = dict(tkernel.LAUNCHES)
    got = tkernel.ssd_backward(x, dt, A, Bm, Cm, dy, chunk=8, initial_state=h0, dfinal=df)
    want = tref.ssd_backward_reference(x, dt, A, Bm, Cm, dy, chunk=8, initial_state=h0,
                                       dfinal=df)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    xs = [a.clone().requires_grad_() for a in (x, dt, A, Bm, Cm, h0)]
    y, st = tkernel.ssd(*xs[:5], chunk=8, initial_state=xs[5], return_final_state=True)
    got = torch.autograd.grad([y, st], xs, [dy, df])
    for g, w in zip(got, _autograd([x, dt, A, Bm, Cm, h0], dy, df, 8)):
        assert torch.equal(g, w)
    assert tkernel.LAUNCHES == before
