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


# ------------------------------------------- the bf16 kernel's decomposition on the CPU
I_TILE, J_TILE = 128, 64  # csrc/ssd.cu kITile, kTile: the output pass's i and j tiles


def _round_bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _three_pass_ssd(x, dt, A, Bm, Cm, chunk, initial_state=None, bf16=False):
    """csrc/ssd.cu's bf16 scan as its passes, in plain float32 torch at the
    kernel's tiles. With ``bf16`` the values are rounded where the kernel
    rounds them: x_j w_j in the chunk-state pass as bf16(v) + bf16(v - bf16(v)),
    the scores C_i B_j^T L_ij dt_j once before their product with x, h_in read
    out as the same hi + lo pair, and y at the store."""
    rnd = _round_bf16 if bf16 else (lambda t: t)

    def split(t):  # the hi + lo pair the kernel feeds to two products
        hi = rnd(t)
        return hi + rnd(t - hi) if bf16 else t
    Bb, S, H, P = x.shape
    rep = H // Bm.shape[2]
    nc = S // chunk
    Bh, Ch = Bm.repeat_interleave(rep, dim=2), Cm.repeat_interleave(rep, dim=2)
    dA = dt * A

    # 1. chunk state: dS_k = sum_j (x_j w_j)^T B_j, w_j = dt_j exp(cum_last - cum_j)
    cums, dS, decay = [], [], []
    for k in range(nc):
        sl = slice(k * chunk, (k + 1) * chunk)
        cum = torch.cumsum(dA[:, sl], dim=1)                       # (B, c, H)
        w = dt[:, sl] * torch.exp(cum[:, -1:] - cum)
        dS.append(torch.einsum("bchp,bchn->bhpn", split(x[:, sl] * w[..., None]), Bh[:, sl]))
        decay.append(torch.exp(cum[:, -1]))                       # (B, H)
        cums.append(cum)

    # 2. state passing, in order over the chunks
    h = (initial_state if initial_state is not None
         else torch.zeros((Bb, H, P, Bm.shape[3]), dtype=torch.float32))
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = h * decay[k][..., None, None] + dS[k]

    # 3. output, one 128-row i tile at a time over the 64-row j tiles at or below it
    y = torch.zeros((Bb, S, H, P), dtype=torch.float32)
    for k in range(nc):
        s0, cum = k * chunk, cums[k]
        hk = split(h_in[k])
        for i0 in range(0, chunk, I_TILE):
            i1 = min(chunk, i0 + I_TILE)
            Ci = Ch[:, s0 + i0:s0 + i1]
            yi = torch.einsum("bihn,bhpn->bihp", Ci, hk) * torch.exp(cum[:, i0:i1])[..., None]
            for j0 in range(0, i1, J_TILE):
                j1 = min(chunk, j0 + J_TILE)
                s = torch.einsum("bihn,bjhn->bhij", Ci, Bh[:, s0 + j0:s0 + j1])
                diff = cum[:, i0:i1].transpose(1, 2)[..., :, None] - \
                    cum[:, j0:j1].transpose(1, 2)[..., None, :]
                mask = torch.arange(i0, i1)[:, None] >= torch.arange(j0, j1)[None, :]
                dtj = dt[:, s0 + j0:s0 + j1].transpose(1, 2)[..., None, :]
                scores = torch.where(mask, s * torch.exp(diff) * dtj, torch.zeros(()))
                yi = yi + torch.einsum("bhij,bjhp->bihp", rnd(scores), x[:, s0 + j0:s0 + j1])
            y[:, s0 + i0:s0 + i1] = yi
    return rnd(y), h


DECOMP_CASES = {  # B, S, H, P, G, N, chunk, initial state
    "one-chunk": (1, 128, 4, 16, 1, 32, 128, False),
    "two-chunks": (1, 256, 4, 16, 1, 32, 128, True),
    "three-chunks": (1, 384, 4, 16, 1, 32, 128, False),
    "ragged-chunk-1": (1, 1, 4, 16, 1, 16, 1, False),
    "ragged-chunk-2": (2, 2, 4, 16, 1, 16, 2, False),
    "ragged-chunk-137": (1, 137, 4, 16, 1, 32, 137, False),
    "initial-state": (2, 192, 4, 16, 1, 32, 64, True),
    "N64": (1, 256, 2, 64, 1, 64, 128, True),
    "N128": (1, 256, 2, 64, 1, 128, 128, True),
    "G2": (2, 192, 4, 16, 2, 16, 64, True),
    "N128-three-chunks": (1, 384, 2, 64, 1, 128, 128, True),
}


def _decomp_inputs(case, dtype):
    B, S, H, P, G, N, chunk, init = DECOMP_CASES[case]
    arrays = list(_inputs(20, B, S, H, P, G, N))
    if dtype == "bfloat16":  # x, B, C are bf16 inputs to both packages
        for i in (0, 3, 4):
            arrays[i] = np.array(jnp.asarray(arrays[i], jnp.bfloat16).astype(jnp.float32))
    h0 = (np.random.default_rng(21).standard_normal((B, H, P, N)).astype(np.float32)
          if init else None)
    return arrays, h0, chunk


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(DECOMP_CASES))
def test_three_pass_decomposition_matches_jax(case, dtype):
    """The three passes against JAX's ssd_reference on the same numpy inputs:
    exact f32 at 1e-4, and with the kernel's bf16 roundings at 5e-2."""
    arrays, h0, chunk = _decomp_inputs(case, dtype)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    y, st = _three_pass_ssd(x, dt, A, Bm, Cm, chunk,
                            None if h0 is None else torch.from_numpy(h0),
                            bf16=dtype == "bfloat16")
    jdt = DTYPES[dtype][0]
    jy, jst = jref.ssd_reference(*(jnp.asarray(a, jdt if i in (0, 3, 4) else jnp.float32)
                                   for i, a in enumerate(arrays)),
                                 chunk=chunk, return_final_state=True,
                                 initial_state=None if h0 is None else jnp.asarray(h0))
    tol = DTYPES[dtype][2]
    _close(y, jy, tol)
    _close(st, jst, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["one-chunk", "two-chunks-no-init", "three-chunks",
                                  "ragged-chunk-137", "G2-no-init"])
def test_three_pass_decomposition_matches_pallas_interpret(case, dtype):
    """The three passes against ssd_pallas(interpret=True), which takes a zero
    initial state only."""
    arrays, _, chunk = _decomp_inputs(case.removesuffix("-no-init"), dtype)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    y, st = _three_pass_ssd(x, dt, A, Bm, Cm, chunk, bf16=dtype == "bfloat16")
    jdt = DTYPES[dtype][0]
    jy, jst = ssd_pallas(*(jnp.asarray(a, jdt if i in (0, 3, 4) else jnp.float32)
                           for i, a in enumerate(arrays)),
                         chunk=chunk, return_final_state=True, interpret=True)
    tol = DTYPES[dtype][2]
    _close(y, jy, tol)
    _close(st, jst, tol)


@pytest.mark.parametrize("total", [512, 768], ids=["2chunks", "3chunks"])
def test_three_pass_one_chunk_and_padded_chunks_agree(total):
    """One chunk (a 137-token chunk) and the same inputs padded with dt = 0 to
    two or three chunks of 256 give the same y[:S] and final state, from a
    nonzero initial state, with the bf16 roundings."""
    arrays, _, _ = _decomp_inputs("ragged-chunk-137", "bfloat16")
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    h0 = torch.from_numpy(np.random.default_rng(22).standard_normal((1, 4, 16, 32)).astype(
        np.float32))
    y, st = _three_pass_ssd(x, dt, A, Bm, Cm, 137, h0, bf16=True)

    def zpad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, total - 137))
    yp, stp = _three_pass_ssd(zpad(x), zpad(dt), A, zpad(Bm), zpad(Cm), 256, h0, bf16=True)
    torch.testing.assert_close(yp[:, :137], y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stp, st, rtol=1e-5, atol=1e-5)

