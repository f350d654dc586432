"""The four kernel wrappers on DTensors, through ``local_map``, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card of compute
capability 9.0. A one-rank NCCL process group holds a (data 1, model 1)
mesh; each wrapper given DTensors sharded over batch and heads (rows for the
add + norm) launches its kernel on the local shard, and the result equals
the direct call on the plain tensors exactly (the same kernel on the same
data), with one launch counted; under autograd the three wrappers with a
gradient give the direct call's gradients. The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    init = tmp_path_factory.mktemp("nccl") / "rendezvous"
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), "cuda")
    dist.destroy_process_group()


def _t(seed, *shape, dtype=torch.bfloat16):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


def _d(t, mesh, *placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, list(placements), run_check=False)


def _bh(mesh):
    from torch.distributed.tensor import Shard
    return Shard(0), Shard(2)


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "autograd"])
def test_flash_attention_through_local_map(mesh, grad):
    q, k, v = _t(0, 2, 128, 8, 64), _t(1, 2, 128, 2, 64), _t(2, 2, 128, 2, 64)
    leaves = [x.clone().requires_grad_(grad) for x in (q, k, v)]
    want = attn_ops.flash_attention(*leaves, causal=True)
    dleaves = [x.clone().requires_grad_(grad) for x in (q, k, v)]
    before = attn_kernel.LAUNCHES["flash_attention"]
    got = attn_ops.flash_attention(*(_d(x, mesh, *_bh(mesh)) for x in dleaves), causal=True)
    assert attn_kernel.LAUNCHES["flash_attention"] == before + 1
    assert torch.equal(got.to_local(), want)
    if grad:
        g = _t(3, *want.shape)
        want.backward(g)
        got.backward(_d(g, mesh, *_bh(mesh)))
        for a, b in zip(dleaves, leaves):
            assert torch.equal(a.grad, b.grad)


def test_decode_attention_through_local_map(mesh):
    q, kc, vc = _t(0, 4, 1, 8, 64), _t(1, 4, 300, 2, 64), _t(2, 4, 300, 2, 64)
    pos = torch.tensor([0, 17, 128, 299], device="cuda")
    want = attn_ops.decode_attention(q, kc, vc, pos)
    before = attn_kernel.LAUNCHES["decode_attention"]
    got = attn_ops.decode_attention(*(_d(x, mesh, *_bh(mesh)) for x in (q, kc, vc)), pos)
    assert attn_kernel.LAUNCHES["decode_attention"] == before + 1
    assert torch.equal(got.to_local(), want)


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "autograd"])
def test_fused_add_rmsnorm_through_local_map(mesh, grad):
    from torch.distributed.tensor import Replicate, Shard

    x, d = _t(0, 4, 64, 896), _t(1, 4, 64, 896)
    scale = _t(2, 896, dtype=torch.float32)
    plain = [t.clone().requires_grad_(grad) for t in (x, d, scale)]
    want = rms_ops.fused_add_rmsnorm(*plain, 1e-6)
    dist_in = [t.clone().requires_grad_(grad) for t in (x, d, scale)]
    before = rms_kernel.LAUNCHES["fused_add_rmsnorm"]
    got = rms_ops.fused_add_rmsnorm(_d(dist_in[0], mesh, Shard(0), Shard(1)),
                                    _d(dist_in[1], mesh, Shard(0), Shard(1)),
                                    _d(dist_in[2], mesh, Replicate(), Replicate()), 1e-6)
    assert rms_kernel.LAUNCHES["fused_add_rmsnorm"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.to_local(), b)
    if grad:
        g = _t(3, 4, 64, 896)
        (want[0] * g + want[1] * g).sum().backward()
        (got[0] * _d(g, mesh, Shard(0), Shard(1))
         + got[1] * _d(g, mesh, Shard(0), Shard(1))).sum().backward()
        for a, b in zip(dist_in, plain):
            torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "autograd"])
def test_ssd_through_local_map(mesh, grad):
    from torch.distributed.tensor import Replicate, Shard

    B, S, H, P, G, N = 2, 256, 8, 64, 1, 128
    x, dt = _t(0, B, S, H, P), _t(1, B, S, H, dtype=torch.float32).abs() * 0.1
    A = -_t(2, H, dtype=torch.float32).abs()
    Bm, Cm = _t(3, B, S, G, N), _t(4, B, S, G, N)
    plain = [t.clone().requires_grad_(grad) for t in (x, dt, A, Bm, Cm)]
    want, want_state = ssd_ops.ssd(*plain, chunk=128, return_final_state=True)
    dist_in = [t.clone().requires_grad_(grad) for t in (x, dt, A, Bm, Cm)]
    placed = [_d(dist_in[0], mesh, Shard(0), Shard(2)), _d(dist_in[1], mesh, Shard(0), Shard(2)),
              _d(dist_in[2], mesh, Replicate(), Shard(0)),
              _d(dist_in[3], mesh, Shard(0), Replicate()),
              _d(dist_in[4], mesh, Shard(0), Replicate())]
    before = ssd_kernel.LAUNCHES["ssd"]
    got, got_state = ssd_ops.ssd(*placed, chunk=128, return_final_state=True)
    assert ssd_kernel.LAUNCHES["ssd"] == before + 1
    assert torch.equal(got.to_local(), want) and torch.equal(got_state.to_local(), want_state)
    if grad:
        g = _t(5, B, S, H, P)
        (want.float() * g.float()).sum().backward()
        (got.float() * _d(g, mesh, Shard(0), Shard(2)).float()).sum().backward()
        for a, b in zip(dist_in, plain):
            torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
