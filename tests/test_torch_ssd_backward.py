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
1e-5. The regrouped formulas of the plain backward (C B^T once a group, the
heads' scores summed into W) are held in float64 against autograd of
``ssd_reference`` with both states at G = 1, 2 and 4. The card's launcher
plans its scratch and its sub-groups with ``csrc/ssd_backward_plan.cuh``,
plain C++, compiled here with the host compiler. The card's tests hold the
kernel to the plain version (tests/test_torch_kernels_cuda.py).
"""
import functools
from pathlib import Path

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


@pytest.mark.parametrize("G", [1, 2, 4])
def test_ssd_backward_reference_regrouped_matches_autograd_float64(G):
    """Three chunks of 16 over 8 heads in G groups, both states, float64: every
    gradient of the regrouped plain backward equals autograd of
    ``ssd_reference`` within 1e-10 relative L2."""
    shape = (2, 48, 8, 8, G, 6, 16)
    x, dt, A, Bm, Cm, dy, h0, df = (torch.from_numpy(a)
                                    for a in _arrays(shape, 9, True, np.float64))
    got = tref.ssd_backward_reference(x, dt, A, Bm, Cm, dy, chunk=16, initial_state=h0,
                                      dfinal=df)
    want = _autograd([x, dt, A, Bm, Cm, h0], dy, df, 16)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        assert _rel_l2(g, w) <= 1e-10, f"{name}: {_rel_l2(g, w):.3e}"


# --------------------------------------------------------------------- host plan
# The card's launcher plans the bf16 chunk-local pass's sub-groups and each
# dtype's scratch with ``csrc/ssd_backward_plan.cuh``, plain C++: compiled here
# with the host compiler and called through ctypes, so the rules the card runs
# are the ones held.
PLAN_SHIM = """
#include "ssd_backward_plan.cuh"
using namespace repro_torch::ssd_bwd_plan;
extern "C" {
void plan_layout(int dtype, int B, int S, int H, int P, int G, int N, int chunk, int s,
                 int64_t* out) {
  const Layout l = layout(dtype, B, S, H, P, G, N, chunk, s);
  const int64_t v[16] = {l.states, l.dstates, l.gplane, l.hplane, l.decay, l.cum, l.pdt,
                         l.pv, l.py, l.rpart, l.wpart, l.ghpart, l.dApart, l.dB_part,
                         l.dC_part, l.total};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}
int plan_subgroups(int B, int S, int H, int G, int chunk, int slots) {
  return subgroups(B, S, H, G, chunk, slots);
}
int plan_pairs(int chunk) { return pairs(chunk); }
int plan_pair_index(int it, int jt) { return pair_index(it, jt); }
}
"""
PIECES = ("states", "dstates", "gplane", "hplane", "decay", "cum", "pdt", "pv", "py", "rpart",
          "wpart", "ghpart", "dApart", "dB_part", "dC_part")
SLOTS = (132, 264)  # an H100's SMs at one and two resident blocks a SM


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan header")
    csrc = Path(tkernel.__file__).parent / "csrc"
    d = tmp_path_factory.mktemp("ssd_plan")
    (d / "shim.cpp").write_text(PLAN_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{csrc}", "-o",
                    str(d / "libplan.so"), str(d / "shim.cpp")], check=True)
    return ctypes.CDLL(str(d / "libplan.so"))


def _layout(plan, dtype, shape, s) -> dict:
    import ctypes
    out = (ctypes.c_int64 * 16)()
    plan.plan_layout(dtype, *shape, s, out)
    return dict(zip(PIECES + ("total",), out))


def _pieces_needed(dtype, shape, s) -> dict:
    """The floats each pass writes into the scratch, as csrc/ssd_backward.cu
    indexes it."""
    B, S, H, P, G, N, chunk = shape
    nc, PN, nt = S // chunk, P * N, -(-chunk // 64)
    per = B * nc * H
    if dtype == 0:
        return dict(states=per * PN, dstates=per * PN, decay=per, dB_part=B * S * H * N,
                    dC_part=B * S * H * N, dApart=per)
    return dict(states=B * (nc - 1) * H * PN, dstates=B * (nc - 1) * H * PN,
                gplane=-(-per * PN // 2), hplane=-(-per * PN // 2), decay=per, cum=per * chunk,
                pdt=per * chunk, pv=per * chunk, py=per * chunk, rpart=per * nt * chunk,
                wpart=B * nc * G * s * (nt * (nt + 1) // 2) * 64 * 64,
                ghpart=per * -(-PN // 256), dApart=per)


def _cases():
    from test_torch_kernels_cuda import SSD_BWD_CASES
    return [c[1] for c in SSD_BWD_CASES]


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("dtype", [0, 1], ids=["float32", "bfloat16"])
def test_plan_scratch_holds_every_pass(plan, dtype, slots):
    """At every shape of the card's backward cases the scratch gives each
    pass's piece room for all it writes, on 256-byte boundaries, with no two
    pieces overlapping and the total at the end of the last (an empty piece,
    the chunk states at one chunk, takes no room)."""
    for shape in _cases():
        B, S, H, P, G, N, chunk = shape
        s = plan.plan_subgroups(B, S, H, G, chunk, slots) if dtype == 1 else 1
        lay = _layout(plan, dtype, shape, s)
        need = _pieces_needed(dtype, shape, s)
        starts = sorted((lay[name], name) for name in need if need[name] > 0)
        ends = [start for start, _ in starts[1:]] + [lay["total"]]
        for (start, name), end in zip(starts, ends):
            assert start % 64 == 0, (shape, name)
            assert end - start >= need[name], (shape, name, end - start, need[name])


@pytest.mark.parametrize("slots", SLOTS)
def test_plan_subgroups_are_sane(plan, slots):
    """1 <= sub-groups <= heads a group, no sub-group empty, and no fewer
    sub-groups would keep the longest block within a quarter of an even share
    of the pass's (tile pair, head) units over ``slots`` resident blocks."""
    for B, S, H, P, G, N, chunk in _cases():
        rep, nt = H // G, -(-chunk // 64)
        s = plan.plan_subgroups(B, S, H, G, chunk, slots)
        assert 1 <= s <= rep
        hs = -(-rep // s)
        assert (s - 1) * hs < rep                      # the last sub-group has a head
        quarter = B * (S // chunk) * G * rep * plan.plan_pairs(chunk) // (4 * slots)
        if 1 < s < rep:
            assert nt * hs <= quarter
        for fewer in range(1, s):
            if -(-rep // -(-rep // fewer)) < s:        # a count that gives fewer sub-groups
                assert nt * -(-rep // fewer) > quarter
    assert plan.plan_subgroups(8, 1024, 80, 1, 256, 0) == 1
    assert plan.plan_subgroups(8, 1024, 1, 1, 256, 132) == 1


def test_plan_pairs_index_the_lower_tile_pairs(plan):
    for chunk in (1, 64, 100, 192, 256):
        nt = -(-chunk // 64)
        idx = sorted(plan.plan_pair_index(it, jt) for it in range(nt) for jt in range(it + 1))
        assert idx == list(range(plan.plan_pairs(chunk)))


def test_plan_at_mamba2s_training_call(plan):
    """mamba2-2.7b's call (8, 1024, 80, 64, G 1, N 128, chunk 256) on an H100's
    132 SMs: 7 sub-groups of 12 heads, and the bf16 scratch under a third of
    the first design's (two fp32 state pieces and the per-head dB / dC
    partials, 838.9 MB)."""
    shape = (8, 1024, 80, 64, 1, 128, 256)
    B, S, H, P, G, N, chunk = shape
    s = plan.plan_subgroups(B, S, H, G, chunk, 132)
    assert s == 7
    first = (2 * B * (S // chunk) * H * P * N + 2 * B * (S // chunk) * H
             + 2 * B * S * H * N) * 4
    assert abs(first / 1e6 - 838.9) < 0.1
    new = _layout(plan, 1, shape, s)["total"] * 4
    assert new < first / 3, (new / 1e6, first / 1e6)
