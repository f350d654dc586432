"""The port's SSD scan against the JAX package's.

On the CPU the port's plain versions (``ref.py``, and the kernel wrapper,
which takes the plain path for CPU tensors) are held against JAX's ``ref.*``
and, on two cases, ``ssd_pallas(interpret=True)``, on the same numpy inputs,
at the reference's tolerances (1e-4 f32, 5e-2 bf16; tests/test_kernels_ssd.py:10).
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd import ref as jref  # noqa: E402
from repro.kernels.ssd.kernel import ssd_pallas  # noqa: E402
from repro_torch.kernels.ssd import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ssd import ops as tops  # noqa: E402
from repro_torch.kernels.ssd import ref as tref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
SWEEP = [  # B, S, H, P, G, N, chunk — the sweep of tests/test_kernels_ssd.py:41-46
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 8, 32),
    (1, 96, 6, 16, 1, 32, 32),   # S not a power of two (3 chunks)
    (2, 64, 8, 64, 4, 16, 64),   # single chunk
]


def _inputs(seed, B, S, H, P, G, N):
    """numpy (x, dt, A, B, C) as tests/test_kernels_ssd.py draws them."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(r.standard_normal((B, S, H)))) * 0.5).astype(np.float32)
    A = (-np.exp(r.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (r.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (r.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _both(arrays, dtype):
    """x, B and C in `dtype`; dt and A stay float32, as the model passes them."""
    jdt, tdt, _ = DTYPES[dtype]
    x, dt, A, Bm, Cm = arrays
    cast = {0: (jdt, tdt), 3: (jdt, tdt), 4: (jdt, tdt)}
    js, ts = [], []
    for i, a in enumerate(arrays):
        jd, td = cast.get(i, (jnp.float32, torch.float32))
        js.append(jnp.asarray(a, jd))
        ts.append(torch.from_numpy(a).to(td))
    return js, ts


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SWEEP, ids=[str(s) for s in SWEEP])
def test_ssd_reference_matches_jax(shape, dtype):
    *dims, chunk = shape
    (jx, jdt, jA, jB, jC), (x, dt, A, Bm, Cm) = _both(_inputs(0, *dims), dtype)
    y, st = tref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)
    jy, jst = jref.ssd_reference(jx, jdt, jA, jB, jC, chunk=chunk, return_final_state=True)
    tol = DTYPES[dtype][2]
    assert y.dtype == DTYPES[dtype][1] and st.dtype == torch.float32
    _close(y, jy, tol)
    _close(st, jst, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_initial_state_matches_jax(dtype):
    (jx, jdt, jA, jB, jC), (x, dt, A, Bm, Cm) = _both(_inputs(1, 2, 64, 4, 16, 2, 16), dtype)
    h0 = np.random.default_rng(2).standard_normal((2, 4, 16, 16)).astype(np.float32)
    y, st = tref.ssd_reference(x, dt, A, Bm, Cm, chunk=16, return_final_state=True,
                               initial_state=torch.from_numpy(h0))
    jy, jst = jref.ssd_reference(jx, jdt, jA, jB, jC, chunk=16, return_final_state=True,
                                 initial_state=jnp.asarray(h0))
    tol = DTYPES[dtype][2]
    _close(y, jy, tol)
    _close(st, jst, tol)


def test_ssd_ragged_chunk_matches_jax():
    """S = chunk = 37: the model's chunk for a 37-token prompt."""
    (jx, jdt, jA, jB, jC), (x, dt, A, Bm, Cm) = _both(_inputs(3, 1, 37, 4, 16, 1, 16), "float32")
    y, st = tref.ssd_reference(x, dt, A, Bm, Cm, chunk=37, return_final_state=True)
    jy, jst = jref.ssd_reference(jx, jdt, jA, jB, jC, chunk=37, return_final_state=True)
    _close(y, jy, 1e-4)
    _close(st, jst, 1e-4)


def test_ssd_dt_zero_padded_tail_changes_nothing():
    """Positions padded with dt = 0 (the model's chunk padding) leave y[:S]
    and the final state as they were."""
    S, pad = 40, 24
    _, (x, dt, A, Bm, Cm) = _both(_inputs(4, 2, S, 4, 16, 2, 16), "float32")
    y, st = tops.ssd(x, dt, A, Bm, Cm, chunk=S, return_final_state=True)

    def zpad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
    yp, stp = tops.ssd(zpad(x), zpad(dt), A, zpad(Bm), zpad(Cm), chunk=32,
                       return_final_state=True)
    torch.testing.assert_close(yp[:, :S], y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stp, st, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_reference_matches_jax(G, dtype):
    r = np.random.default_rng(5)
    B, H, P, N = 3, 4, 16, 8
    state = r.standard_normal((B, H, P, N)).astype(np.float32)
    x_t = r.standard_normal((B, H, P)).astype(np.float32)
    dt_t = (np.log1p(np.exp(r.standard_normal((B, H)))) * 0.5).astype(np.float32)
    A = (-np.exp(r.standard_normal(H) * 0.3)).astype(np.float32)
    B_t = (r.standard_normal((B, G, N)) * 0.3).astype(np.float32)
    C_t = (r.standard_normal((B, G, N)) * 0.3).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype]
    y, ns = tref.ssd_decode_reference(
        torch.from_numpy(state), torch.from_numpy(x_t).to(tdt), torch.from_numpy(dt_t),
        torch.from_numpy(A), torch.from_numpy(B_t).to(tdt), torch.from_numpy(C_t).to(tdt))
    jy, jns = jref.ssd_decode_reference(
        jnp.asarray(state), jnp.asarray(x_t, jdt), jnp.asarray(dt_t), jnp.asarray(A),
        jnp.asarray(B_t, jdt), jnp.asarray(C_t, jdt))
    assert y.dtype == tdt and ns.dtype == torch.float32
    _close(y, jy, tol)
    _close(ns, jns, tol)


def test_ssd_reference_matches_its_own_sequential_decode():
    """The chunked math against a literal per-token recurrence (an oracle
    independent of it), with a nonzero initial state."""
    _, (x, dt, A, Bm, Cm) = _both(_inputs(6, 2, 48, 4, 16, 2, 8), "float32")
    h0 = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 4, 16, 8)).astype(
        np.float32))
    y, st = tref.ssd_reference(x, dt, A, Bm, Cm, chunk=16, initial_state=h0,
                               return_final_state=True)
    ys, state = [], h0
    for t in range(x.shape[1]):
        yt, state = tref.ssd_decode_reference(state, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(yt)
    torch.testing.assert_close(y, torch.stack(ys, dim=1), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, state, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", [(1, 64, 2, 16, 1, 16, 16), (2, 48, 4, 16, 2, 8, 16)],
                         ids=["G1-4chunks", "G2-3chunks"])
def test_port_matches_pallas_interpret(case):
    """Two cases against the Pallas kernel itself, run as its own tests run it
    (zero initial state: the TPU kernel takes no other)."""
    *dims, chunk = case
    (jx, jdt, jA, jB, jC), (x, dt, A, Bm, Cm) = _both(_inputs(8, *dims), "float32")
    jy, jst = ssd_pallas(jx, jdt, jA, jB, jC, chunk=chunk, return_final_state=True,
                         interpret=True)
    y, st = tops.ssd(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)
    _close(y, jy, 1e-4)
    _close(st, jst, 1e-4)


# ---------------------------------------------------------------- dispatch on the CPU
def test_cpu_wrapper_takes_the_plain_path_and_counts_no_launch():
    _, (x, dt, A, Bm, Cm) = _both(_inputs(9, 1, 32, 2, 16, 1, 16), "float32")
    before = dict(tkernel.LAUNCHES)
    y, st = tkernel.ssd(x, dt, A, Bm, Cm, chunk=16, return_final_state=True)
    ry, rst = tref.ssd_reference(x, dt, A, Bm, Cm, chunk=16, return_final_state=True)
    assert torch.equal(y, ry) and torch.equal(st, rst)
    assert tkernel.ssd(x, dt, A, Bm, Cm, chunk=16)[1] is None
    assert tkernel.LAUNCHES == before


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_dispatch_on_cpu_is_the_reference(impl):
    _, (x, dt, A, Bm, Cm) = _both(_inputs(10, 2, 32, 4, 16, 2, 8), "float32")
    y, _ = tops.ssd(x, dt, A, Bm, Cm, chunk=8, impl=impl)
    assert torch.equal(y, tref.ssd_reference(x, dt, A, Bm, Cm, chunk=8)[0])


def test_ops_rejects_kernel_on_cpu_and_unknown_impl():
    _, (x, dt, A, Bm, Cm) = _both(_inputs(11, 1, 8, 2, 8, 1, 8), "float32")
    with pytest.raises(ValueError, match="needs CUDA"):
        tops.ssd(x, dt, A, Bm, Cm, chunk=8, impl="kernel")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.ssd(x, dt, A, Bm, Cm, chunk=8, impl="pallas")
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tref.ssd_reference(x, dt, A, Bm, Cm, chunk=3)
