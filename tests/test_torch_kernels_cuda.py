"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card of compute
capability 9.0 (the kernels have no CPU mode). The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are the reference's (tests/test_kernels_flash.py:18): 2e-5 f32,
2e-2 bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
SHAPES = [  # B, Sq, Skv, H, KV, hd — the sweep of tests/test_kernels_flash.py, then the slice's
    (1, 64, 64, 4, 4, 32),
    (2, 128, 128, 8, 2, 64),
    (1, 96, 96, 6, 1, 16),
    (1, 100, 132, 4, 2, 32),
    (2, 32, 256, 4, 4, 64),
    (1, 512, 512, 14, 2, 64),
    (1, 70, 70, 8, 1, 128),
]
SWEEP = [(s, c) for s in SHAPES for c in (True, False) if not (c and s[1] != s[2])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, seed, *shapes):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in shapes]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,causal", SWEEP, ids=[f"{s}-causal={c}" for s, c in SWEEP])
def test_flash_kernel_matches_plain(shape, causal, dtype, cuda_device):
    B, Sq, Skv, H, KV, hd = shape
    tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(cuda_device, tdt, 0, (B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))
    before = tkernel.LAUNCHES["flash_attention"]
    out = tkernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), tref.mha_reference(q, k, v, causal=causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kw", [{"kv_len": 20}, {"q_offset": 48}, {"kv_len": [7, 64]}],
                         ids=["kv_len", "q_offset", "kv_len-per-row"])
def test_flash_kernel_masks(kw, dtype, cuda_device):
    tdt, tol = DTYPES[dtype]
    causal = "q_offset" in kw
    Sq = 16 if causal else 32
    q, k, v = _inputs(cuda_device, tdt, 1, (2, Sq, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16))
    if isinstance(kw.get("kv_len"), list):
        kw = {"kv_len": torch.tensor(kw["kv_len"], device=cuda_device)}
    out = tkernel.flash_attention(q, k, v, causal=causal, **kw)
    torch.testing.assert_close(out.float(),
                               tref.mha_reference(q, k, v, causal=causal, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv", [1, 2, 7])
def test_decode_kernel_matches_plain(kv, dtype, cuda_device):
    B, S, H, hd = 4, 300, 14, 64
    tdt, tol = DTYPES[dtype]
    q, kc, vc = _inputs(cuda_device, tdt, 2, (B, 1, H, hd), (B, S, kv, hd), (B, S, kv, hd))
    for pos in (torch.tensor([0, 1, 150, S - 1], device=cuda_device), 0, S - 1):
        before = tkernel.LAUNCHES["decode_attention"]
        out = tkernel.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES["decode_attention"] == before + 1
        torch.testing.assert_close(
            out.float(), tref.decode_attention_reference(q, kc, vc, pos).float(),
            rtol=tol, atol=tol)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v = _inputs(cuda_device, torch.float32, 3, (1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tkernel.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        tkernel.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="dv == dqk"):
        tkernel.flash_attention(q, k, v[..., :8].contiguous())
    with pytest.raises(ValueError, match="one query token"):
        tkernel.decode_attention(q, k, v, 3)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen1.5-0.5b", "deepseek-67b"])
def test_model_kernel_path_matches_plain_path(arch, cuda_device):
    """Prefill + decode of a reduced model through the kernels against the
    same model with impl="ref" (f32: the decode-equivalence tolerances)."""
    cfg = get_reduced(arch).with_(dtype="float32")
    model = Model(cfg, device=cuda_device).init(torch.Generator(cuda_device).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 24))).to(
        cuda_device)
    outs = {}
    for impl in ("auto", "ref"):
        model.attn_impl = impl
        logits, seq = model.prefill({"tokens": tokens[:, :16]})
        cache = model.init_cache(2, 24)
        for name in cache:
            cache[name][:, :, :16] = seq[name]
        steps = [logits]
        for i in range(16, 23):
            pos = torch.tensor([i, i], device=cuda_device)
            logits, cache = model.decode_step(tokens[:, i:i + 1], cache, pos)
            steps.append(logits)
        outs[impl] = torch.stack(steps)
    torch.testing.assert_close(outs["auto"], outs["ref"], rtol=2e-4, atol=2e-4)
