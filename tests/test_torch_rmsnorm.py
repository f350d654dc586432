"""The port's fused residual add + RMSNorm against the JAX package's.

On the CPU the port's plain version (``ref.py``, and the kernel wrapper and
``ops`` dispatch, which take the plain path for CPU tensors) is held against
JAX's ``fused_add_rmsnorm_reference`` and ``fused_add_rmsnorm_pallas(...,
interpret=True)`` on the same numpy inputs, at the reference's tolerances
(1e-6 f32, 1e-2 bf16; tests/test_kernels_rmsnorm.py:10). The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rmsnorm.kernel import fused_add_rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import fused_add_rmsnorm_reference as jax_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as tkernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as tops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as tref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
SHAPES = [(4, 32, 64), (2, 100, 128), (1, 8, 256), (7, 96)]  # tests/test_kernels_rmsnorm.py:14


def _inputs(seed, shape):
    """numpy (x, delta, scale) as tests/test_kernels_rmsnorm.py draws them:
    standard normal x and delta, scale = |normal| + 0.5."""
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32)
    d = r.standard_normal(shape).astype(np.float32)
    scale = (np.abs(r.standard_normal(shape[-1])) + 0.5).astype(np.float32)
    return x, d, scale


def _both(x, d, scale, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    js = (jnp.asarray(x, jdt), jnp.asarray(d, jdt), jnp.asarray(scale))
    ts = (torch.from_numpy(x).to(tdt), torch.from_numpy(d).to(tdt), torch.from_numpy(scale))
    return js, ts


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_matches_jax_ref(shape, dtype):
    js, ts = _both(*_inputs(0, shape), dtype)
    res, out = tref.fused_add_rmsnorm_reference(*ts)
    jres, jout = jax_ref(*js)
    assert res.dtype == out.dtype == DTYPES[dtype][1]
    assert res.shape == out.shape == shape
    tol = DTYPES[dtype][2]
    _close(res, jres, tol)
    _close(out, jout, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_matches_pallas_interpret(shape, dtype):
    js, ts = _both(*_inputs(1, shape), dtype)
    jres, jout = fused_add_rmsnorm_pallas(*js, block_rows=8, interpret=True)
    res, out = tref.fused_add_rmsnorm_reference(*ts)
    tol = DTYPES[dtype][2]
    _close(res, jres, tol)
    _close(out, jout, tol)


@pytest.mark.parametrize("D", [896, 2560])
def test_ref_matches_jax_at_the_slice_widths(D):
    """qwen2-0.5b's and zamba2-2.7b's d_model, a prefill of 37 rows."""
    for dtype in DTYPES:
        js, ts = _both(*_inputs(2, (1, 37, D)), dtype)
        tol = DTYPES[dtype][2]
        res, out = tref.fused_add_rmsnorm_reference(*ts, eps=1e-6)
        jres, jout = jax_ref(*js, eps=1e-6)
        _close(res, jres, tol)
        _close(out, jout, tol)


def test_ref_equals_model_rmsnorm_of_the_sum():
    """In f32 the fused version is exactly the port's `h + a; rmsnorm(h)`."""
    x, d, scale = (torch.from_numpy(a) for a in _inputs(3, (2, 16, 32)))
    res, out = tref.fused_add_rmsnorm_reference(x, d, scale, eps=1e-5)
    assert torch.equal(res, x + d)
    assert torch.equal(out, layers.rmsnorm(x + d, {"scale": scale}, eps=1e-5))


def test_bf16_norm_reads_the_unrounded_sum():
    """The one difference from JAX's unfused `h + a; rmsnorm(h)` in bf16: the
    residual is the same rounded sum, the norm reads the fp32 sum."""
    x, d, scale = _inputs(4, (3, 64))
    xt, dt = torch.from_numpy(x).bfloat16(), torch.from_numpy(d).bfloat16()
    st = torch.from_numpy(scale)
    res, out = tref.fused_add_rmsnorm_reference(xt, dt, st)
    assert torch.equal(res, xt + dt)
    unrounded = xt.float() + dt.float()
    want = unrounded * torch.rsqrt((unrounded * unrounded).mean(-1, keepdim=True) + 1e-5) * st
    assert torch.equal(out, want.bfloat16())


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_and_kernel_wrapper_take_the_plain_path_on_cpu(impl):
    x, d, scale = (torch.from_numpy(a) for a in _inputs(5, (4, 96)))
    want = tref.fused_add_rmsnorm_reference(x, d, scale)
    before = tkernel.LAUNCHES["fused_add_rmsnorm"]
    for got in (tops.fused_add_rmsnorm(x, d, scale, impl=impl),
                tkernel.fused_add_rmsnorm(x, d, scale)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tkernel.LAUNCHES["fused_add_rmsnorm"] == before  # no kernel ran


def test_kernel_impl_on_a_cpu_tensor_raises():
    x, d, scale = (torch.from_numpy(a) for a in _inputs(6, (2, 64)))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.fused_add_rmsnorm(x, d, scale, impl="kernel")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.fused_add_rmsnorm(x, d, scale, impl="pallas")


def test_reset_launches_zeroes_the_count():
    tkernel.LAUNCHES["fused_add_rmsnorm"] += 3
    tkernel.reset_launches()
    assert tkernel.LAUNCHES == {"fused_add_rmsnorm": 0}
