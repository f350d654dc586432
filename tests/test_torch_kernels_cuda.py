"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA card of compute
capability 9.0 (the kernels have no CPU mode). The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are the reference's: 2e-5 f32, 2e-2 bf16 for attention
(tests/test_kernels_flash.py:18); 1e-4 f32, 5e-2 bf16 for the SSD scan
(tests/test_kernels_ssd.py:10); 1e-6 f32, 1e-2 bf16 for the fused add +
RMSNorm (tests/test_kernels_rmsnorm.py:10).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
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
    (1, 512, 512, 32, 32, 80),   # zamba2-2.7b's shared block: MHA (G = 1), hd 80
    (2, 100, 100, 32, 32, 80),
    (1, 768, 768, 48, 8, 128),   # internvl2-26b: GQA 48/8 (G = 6), hd 128, 256 patches + 512
    (2, 100, 100, 48, 8, 128),
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
    before = tkernel.LAUNCHES["flash_attention"]
    out = tkernel.flash_attention(q, k, v, causal=causal, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["flash_attention"] == before + 1
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


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_at_the_hybrid_shape(dtype, cuda_device):
    """zamba2-2.7b's shared block: 8 slots of a 1024-long cache, 32 heads over
    32 KV heads (G = 1), hd 80, ragged lengths including an empty-but-one and
    a full row."""
    B, S, H, hd = 8, 1024, 32, 80
    tdt, tol = DTYPES[dtype]
    q, kc, vc = _inputs(cuda_device, tdt, 9, (B, 1, H, hd), (B, S, H, hd), (B, S, H, hd))
    pos = torch.tensor([0, 675, 555, 323, 360, 104, 137, S - 1], device=cuda_device)
    before = tkernel.LAUNCHES["decode_attention"]
    out = tkernel.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(out.float(),
                               tref.decode_attention_reference(q, kc, vc, pos).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_at_the_vlm_shape(dtype, cuda_device):
    """internvl2-26b's decode: 8 slots of a 1024-long cache, 48 query heads
    over 8 KV heads (G = 6), hd 128, lengths 1 and 1024 among mixed ones (a
    length across the split boundaries, one a split long), then scalar
    positions."""
    B, S, H, KV, hd = 8, 1024, 48, 8, 128
    tdt, tol = DTYPES[dtype]
    q, kc, vc = _inputs(cuda_device, tdt, 43, (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    pos = torch.tensor([0, 675, 555, 127, 128, 300, 767, S - 1], device=cuda_device)
    before = tkernel.LAUNCHES["decode_attention"]
    out = tkernel.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(out.float(),
                               tref.decode_attention_reference(q, kc, vc, pos).float(),
                               rtol=tol, atol=tol)
    for p in (0, S - 1):
        out = tkernel.decode_attention(q, kc, vc, p)
        torch.testing.assert_close(out.float(),
                                   tref.decode_attention_reference(q, kc, vc, p).float(),
                                   rtol=tol, atol=tol)


HEAD_DIMS = [80, 128, 24]   # zamba2-2.7b's; the widest; one that is not a multiple of 16


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_kernel_head_dims(hd, causal, dtype, cuda_device):
    """hd in 64-column slabs: two slabs at 80 and 128 (the second zero-filled
    past 80), and 24 zero-padded to 32 inside the kernel."""
    tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(cuda_device, tdt, 12, (2, 130, 6, hd), (2, 130, 3, hd), (2, 130, 3, hd))
    before = tkernel.LAUNCHES["flash_attention"]
    out = tkernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), tref.mha_reference(q, k, v, causal=causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["sq100-skv132", "sq1", "sq1-causal-offset",
                                  "hd80-q_offset", "hd80-kv_len-per-row"])
def test_flash_kernel_ragged_shapes_and_masks(case, dtype, cuda_device):
    tdt, tol = DTYPES[dtype]
    Sq, Skv, hd, causal, kw = {
        "sq100-skv132": (100, 132, 64, False, {}),
        "sq1": (1, 132, 64, False, {}),
        "sq1-causal-offset": (1, 132, 64, True, {"q_offset": 131}),
        "hd80-q_offset": (70, 200, 80, True, {"q_offset": 130}),
        "hd80-kv_len-per-row": (100, 200, 80, False, {"kv_len": [1, 137]}),
    }[case]
    q, k, v = _inputs(cuda_device, tdt, 13, (2, Sq, 4, hd), (2, Skv, 2, hd), (2, Skv, 2, hd))
    if "kv_len" in kw:
        kw = {"kv_len": torch.tensor(kw["kv_len"], device=cuda_device)}
    before = tkernel.LAUNCHES["flash_attention"]
    out = tkernel.flash_attention(q, k, v, causal=causal, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(),
                               tref.mha_reference(q, k, v, causal=causal, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["fused-qkv", "every-other-head", "kv-expanded-over-batch"])
def test_flash_kernel_strided_views(layout, dtype, cuda_device):
    """q, k, v as views with head and row strides of their own: slices of one
    fused projection (B, S, (H + 2 KV) hd), as a fused q/k/v matmul hands them
    over; every other head of a wider tensor (head stride 2 hd); and one K/V
    row expanded over the batch (batch stride 0)."""
    tdt, tol = DTYPES[dtype]
    B, S, H, KV, hd = 2, 96, 4, 2, 80
    if layout == "fused-qkv":
        (wide,) = _inputs(cuda_device, tdt, 14, (B, S, (H + 2 * KV) * hd))
        q = wide[..., :H * hd].unflatten(-1, (H, hd))
        k = wide[..., H * hd:(H + KV) * hd].unflatten(-1, (KV, hd))
        v = wide[..., (H + KV) * hd:].unflatten(-1, (KV, hd))
    elif layout == "every-other-head":
        qw, kw_, vw = _inputs(cuda_device, tdt, 14, (B, S, 2 * H, hd), (B, S, 2 * KV, hd),
                              (B, S, 2 * KV, hd))
        q, k, v = qw[:, :, ::2], kw_[:, :, 1::2], vw[:, :, ::2]
    else:  # a batch stride of 0, which _check admits
        q, k1, v1 = _inputs(cuda_device, tdt, 14, (B, S, H, hd), (1, S, KV, hd), (1, S, KV, hd))
        k, v = k1.expand(B, -1, -1, -1), v1.expand(B, -1, -1, -1)
    assert not (q.is_contiguous() and k.is_contiguous())
    before = tkernel.LAUNCHES["flash_attention"]
    out = tkernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), tref.mha_reference(q, k, v, causal=True).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,KV", [(4, 4), (14, 2)], ids=["G=1", "G=7"])
def test_decode_kernel_split_boundaries(H, KV, dtype, cuda_device):
    """Lengths 1, SPLIT - 1, SPLIT, SPLIT + 1 and S in one batch: a split that
    is one key long, a last split that is full, and a row that fills the cache."""
    split = tkernel.DECODE_SPLIT
    S, hd = 3 * split + 44, 80
    tdt, tol = DTYPES[dtype]
    lens = [1, split - 1, split, split + 1, S]
    q, kc, vc = _inputs(cuda_device, tdt, 15, (len(lens), 1, H, hd), (len(lens), S, KV, hd),
                        (len(lens), S, KV, hd))
    pos = torch.tensor(lens, device=cuda_device) - 1
    before = tkernel.LAUNCHES["decode_attention"]
    out = tkernel.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(out.float(),
                               tref.decode_attention_reference(q, kc, vc, pos).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["group-slice", "batch-strided"])
def test_decode_kernel_per_group_cache_views(layout, dtype, cuda_device):
    """The hybrid's decode_step hands each group's attn cache over as a view:
    group g of a (groups, B, S, KV, hd) cache (an offset base), and, strided,
    group g of a (B, groups, S, KV, hd) one (batch stride groups * S * KV * hd)."""
    tdt, tol = DTYPES[dtype]
    groups, B, S, H, KV, hd = 3, 4, 300, 8, 8, 80
    shape = (groups, B, S, KV, hd) if layout == "group-slice" else (B, groups, S, KV, hd)
    q, kall, vall = _inputs(cuda_device, tdt, 16, (B, 1, H, hd), shape, shape)
    kc, vc = (kall[1], vall[1]) if layout == "group-slice" else (kall[:, 1], vall[:, 1])
    pos = torch.tensor([0, 128, 200, S - 1], device=cuda_device)
    before = tkernel.LAUNCHES["decode_attention"]
    out = tkernel.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(out.float(),
                               tref.decode_attention_reference(q, kc, vc, pos).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv_len", [0, [0, 40]], ids=["kv_len-0", "per-row-0-and-40"])
def test_flash_kernel_row_with_no_valid_key_gives_zeros(kv_len, dtype, cuda_device):
    """A row that sees no valid key is zeros in the kernel and in ref.py, at
    hd 64 (the bf16 kernel's one-slab path); the other row matches ref.py."""
    tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(cuda_device, tdt, 17, (2, 70, 4, 64), (2, 70, 2, 64), (2, 70, 2, 64))
    lens = torch.tensor(kv_len, device=cuda_device)
    for causal in (False, True):
        out = tkernel.flash_attention(q, k, v, causal=causal, kv_len=lens)
        torch.cuda.synchronize()
        want = tref.mha_reference(q, k, v, causal=causal, kv_len=lens)
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        assert torch.equal(want[0], torch.zeros_like(want[0]))
        torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos", [-1, [-1, 150, -1, 299]], ids=["pos-minus-1", "mixed"])
def test_decode_kernel_row_with_no_valid_key_gives_zeros(pos, dtype, cuda_device):
    """pos = -1 (length 0): zeros in both passes' result and in ref.py; the
    rows with keys match ref.py."""
    B, S, H, KV, hd = 4, 300, 14, 2, 64
    tdt, tol = DTYPES[dtype]
    q, kc, vc = _inputs(cuda_device, tdt, 18, (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    pos = torch.tensor(pos, device=cuda_device)
    out = tkernel.decode_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    want = tref.decode_attention_reference(q, kc, vc, pos)
    empty = pos.expand(B) < 0
    assert torch.equal(out[empty], torch.zeros_like(out[empty]))
    assert torch.equal(want[empty], torch.zeros_like(want[empty]))
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v = _inputs(cuda_device, torch.float32, 3, (1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tkernel.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        tkernel.flash_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="the same \\(B, S, KV\\)"):
        tkernel.flash_attention(q, k, v[:, :4].contiguous())
    with pytest.raises(ValueError, match="the same head dim"):
        tkernel.flash_attention(q, k[..., :8].contiguous(), v)
    with pytest.raises(ValueError, match="one query token"):
        tkernel.decode_attention(q, k, v, 3)
    wide = _inputs(cuda_device, torch.float32, 3, (1, 8, 4, 136), (1, 8, 2, 136),
                   (1, 8, 2, 264), (1, 1, 4, 296), (1, 8, 2, 296))
    with pytest.raises(ValueError, match="dqk at most 128"):
        tkernel.flash_attention(wide[0], wide[1], v)
    with pytest.raises(ValueError, match="dv at most 256"):
        tkernel.decode_attention(wide[3][..., :8].contiguous(), k[..., :8].contiguous(),
                                 wide[2], 3)
    with pytest.raises(ValueError, match="dqk at most 288"):
        tkernel.decode_attention(wide[3], wide[4], v, 3)


# ------------------------------------------------------------- MLA (dv != dqk)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 512, 40, 96, 64), (2, 100, 4, 24, 16), (1, 70, 4, 64, 128),
                                   (1, 130, 6, 128, 64)],
                         ids=["minicpm3-prefill", "reduced", "dv-wider", "two-slabs-to-one"])
def test_flash_kernel_dv_differs_from_dqk(shape, dtype, cuda_device):
    """MLA's expanded prefill: q and k of dqk, v and o of dv (minicpm3-4b:
    40 heads, 64 + 32 against 64), causal and not, against the plain version;
    every (QK slabs, PV slabs) pair of the bf16 kernel."""
    B, S, H, dqk, dv = shape
    tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(cuda_device, tdt, 30, (B, S, H, dqk), (B, S, H, dqk), (B, S, H, dv))
    for causal in (True, False):
        before = tkernel.LAUNCHES["flash_attention"]
        out = tkernel.flash_attention(q, k, v, causal=causal, scale=dqk ** -0.5)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES["flash_attention"] == before + 1
        assert out.shape == (B, S, H, dv)
        torch.testing.assert_close(
            out.float(), tref.mha_reference(q, k, v, causal=causal, scale=dqk ** -0.5).float(),
            rtol=tol, atol=tol)


# ------------------------------------------------------- whisper (encdec)
WHISPER_FLASH = {  # B, Sq, Skv, H, KV, hd: every call non-causal, Skv = 1500 = 23 x 64 + 28
    "encoder": (1, 1500, 1500, 12, 12, 64),
    "cross-prefill-64": (1, 64, 1500, 12, 12, 64),
    "cross-prefill-7": (1, 7, 1500, 12, 12, 64),
    "cross-prefill-1": (1, 1, 1500, 12, 12, 64),
    "cross-decode": (8, 1, 1500, 12, 12, 64),     # row 0 an idle slot: zero keys and values
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(WHISPER_FLASH))
def test_flash_kernel_at_whisper_shapes(case, dtype, cuda_device):
    """whisper-small's flash calls: the encoder (Sq = Skv = 1500), cross-
    attention of a 64-, 7- and 1-token prompt against 1500 encoder keys (a
    masked 28-key tail tile; at Sq < 64 a 64-row box over fewer rows), and
    the decode step's Sq = 1 cross-attention over 8 slots, one of them idle
    (all-zero keys and values: zeros out, not NaN)."""
    B, Sq, Skv, H, KV, hd = WHISPER_FLASH[case]
    tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(cuda_device, tdt, 40, (B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))
    if B > 1:
        k[0].zero_()
        v[0].zero_()
    before = tkernel.LAUNCHES["flash_attention"]
    out = tkernel.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["flash_attention"] == before + 1
    assert out.shape == (B, Sq, H, hd) and torch.isfinite(out).all()
    if B > 1:
        assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out.float(), tref.mha_reference(q, k, v, causal=False).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_at_whisper_self_decode_shape(dtype, cuda_device):
    """whisper-small's decoder self-attention at decode: MHA 12/12 hd 64, 8
    slots of a 448-position cache (its text context), row 0 an idle slot
    (zero cache, pos 0), a full row; and the same kernel as the Sq = 1
    cross-attention's function (pos 1499 over 1500 keys)."""
    tdt, tol = DTYPES[dtype]
    B, S, H = 8, 448, 12
    q, k, v = _inputs(cuda_device, tdt, 41, (B, 1, H, 64), (B, S, H, 64), (B, S, H, 64))
    k[0].zero_()
    v[0].zero_()
    pos = torch.tensor([0, 3, 64, 127, 128, 300, 446, S - 1], device=cuda_device)
    out = tkernel.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out.float(),
                               tref.decode_attention_reference(q, k, v, pos).float(),
                               rtol=tol, atol=tol)
    ck, cv = _inputs(cuda_device, tdt, 42, (B, 1500, H, 64), (B, 1500, H, 64))
    out = tkernel.decode_attention(q, ck, cv, 1499)
    torch.testing.assert_close(out.float(),
                               tref.mha_reference(q, ck, cv, causal=False).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_kernel_at_the_mla_shape(dtype, cuda_device):
    """minicpm3-4b's absorbed decode: 8 slots of a 1024-long cache, 40 query
    heads over one KV head, dqk 256 + 32 and dv 256 (v the latent part of the
    same cache rows, as models/mla.py hands it over), mixed lengths with a row
    of length 0 and a full row."""
    B, S, H, dqk, dv = 8, 1024, 40, 288, 256
    tdt, tol = DTYPES[dtype]
    q, k_full = _inputs(cuda_device, tdt, 31, (B, 1, H, dqk), (B, S, 1, dqk))
    v = k_full[..., :dv]                 # a view: row stride dqk
    pos = torch.tensor([-1, 675, 555, 127, 128, 104, 137, S - 1], device=cuda_device)
    before = tkernel.LAUNCHES["decode_attention"]
    out = tkernel.decode_attention(q, k_full, v, pos, scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["decode_attention"] == before + 1
    assert out.shape == (B, 1, H, dv)
    want = tref.decode_attention_reference(q, k_full, v, pos, scale=96 ** -0.5)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for p in (0, S - 1):                 # scalar positions
        out = tkernel.decode_attention(q, k_full, v, p, scale=96 ** -0.5)
        torch.testing.assert_close(
            out.float(),
            tref.decode_attention_reference(q, k_full, v, p, scale=96 ** -0.5).float(),
            rtol=tol, atol=tol)


PARTIALS_CASES = {  # B, S, H, KV, dqk, dv, scale: qwen2-0.5b's GQA, minicpm3-4b's MLA
    "gqa": (6, 1024, 14, 2, 64, 64, None),
    "mla": (6, 1024, 40, 1, 288, 256, 96 ** -0.5),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", list(PARTIALS_CASES))
def test_decode_partials_kernel_over_sequence_shards(case, shards, dtype, cuda_device):
    """``decode_attention_partials`` on each sequence shard at its offset,
    against the plain partials shard by shard and, merged by log-sum-exp,
    against the plain decode on the whole cache; rows that end in the first
    shard and of length 0 give (-inf, 0, 0) where they hold no position; one
    launch a call, counted under its own name."""
    B, S, H, KV, dqk, dv, scale = PARTIALS_CASES[case]
    tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(cuda_device, tdt, 41, (B, 1, H, dqk), (B, S, KV, dqk), (B, S, KV, dv))
    pos = torch.tensor([S // 4 - 7, -1, S - 1, S // 2, 300, 901], device=cuda_device)
    L = S // shards
    parts = []
    for i in range(shards):
        ks, vs = k[:, i * L:(i + 1) * L], v[:, i * L:(i + 1) * L]
        before = dict(tkernel.LAUNCHES)
        got = tkernel.decode_attention_partials(q, ks, vs, pos, pos_offset=i * L, scale=scale)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES["decode_attention_partials"] == \
            before["decode_attention_partials"] + 1
        assert tkernel.LAUNCHES["decode_attention"] == before["decode_attention"]
        want = tref.decode_attention_partials_reference(q, ks, vs, pos, pos_offset=i * L,
                                                        scale=scale)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
        m, l, acc = got
        empty = [1] + ([0] if i else [])
        assert torch.isneginf(m[empty]).all() and (l[empty] == 0).all() and (acc[empty] == 0).all()
        live = torch.isfinite(want[0])
        assert torch.equal(torch.isfinite(m), live)
        # the kernel's max is the plain one; its sum and accumulator are relative to it
        torch.testing.assert_close(m[live], want[0][live], rtol=tol, atol=tol)
        torch.testing.assert_close((acc / l.clamp_min(1e-30)[..., None])[live],
                                   (want[2] / want[1].clamp_min(1e-30)[..., None])[live],
                                   rtol=tol, atol=tol)
        parts.append(got)
    out = tref.combine_partials(parts, tdt)
    torch.testing.assert_close(out.float(),
                               tref.decode_attention_reference(q, k, v, pos, scale=scale).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(out[1], torch.zeros_like(out[1]))


# ----------------------------------------------------- MLA's absorbed decode
MLA_SCALE = 96 ** -0.5
MLA_CASES = {  # B, S, H, dl, dr: minicpm3-4b's served shape; its reduced config;
    # shares of many tiles, more than the ring's stages; 56 heads at B 2, in
    # groups of 8 (the card holds more clusters than B); 72 heads at B 16,
    # two groups of 36; dl 192 (bf16's m64n192k16 P V) with dr 64 (two f32
    # rope slabs); dl 256 with dr 64, where f32's ring is one stage, over
    # shares of 8 tiles
    "minicpm3-4b": (8, 1024, 40, 256, 32),
    "reduced": (3, 100, 4, 16, 8),
    "multi-tile": (16, 8192, 40, 256, 32),
    "head-groups": (2, 300, 56, 128, 32),
    "two-groups": (16, 520, 72, 256, 32),
    "n192-rope64": (2, 300, 40, 192, 64),
    "one-stage": (2, 4096, 40, 256, 64),
}


def _mla_inputs(device, dtype, seed, B, S, H, dl, dr):
    return _inputs(device, dtype, seed, (B, 1, H, dl + dr), (B, S, dl), (B, S, dr))


def _mla_edge(B, S, H, dl, dr) -> int:
    """C * 16: the shortest row whose every block of the cluster takes keys."""
    return tkernel.mla_grid(B, S, H, dl, dr)["cluster"] * 16


def _mla_positions(B, S, edge, device):
    """A row of length 0, then lengths 1, edge - 1, edge, edge + 1 (around
    the share boundaries) and S, the rest mixed."""
    lens = [0, 1, edge - 1, edge, edge + 1, S, 2 * edge + 7, S // 2 + 3]
    lens = [min(max(n, 0), S) for n in (lens * (B // len(lens) + 1))[:B]]
    return torch.tensor(lens, device=device) - 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_decode_kernel_matches_plain(case, dtype, cuda_device):
    """``mla_decode_attention`` against its plain version (the two caches
    concatenated, then the plain decode), one launch counted a call, with a
    row of length 0 (zeros) and lengths at the share boundaries; scalar and
    int32 positions."""
    B, S, H, dl, dr = MLA_CASES[case]
    tdt, tol = DTYPES[dtype]
    q, ckv, krope = _mla_inputs(cuda_device, tdt, 51, B, S, H, dl, dr)
    pos = _mla_positions(B, S, _mla_edge(B, S, H, dl, dr), cuda_device)
    before = dict(tkernel.LAUNCHES)
    out = tkernel.mla_decode_attention(q, ckv, krope, pos, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["mla_decode_attention"] == before["mla_decode_attention"] + 1
    assert tkernel.LAUNCHES["decode_attention"] == before["decode_attention"]
    assert out.shape == (B, 1, H, dl) and out.dtype == tdt
    want = tref.mla_decode_reference(q, ckv, krope, pos, scale=MLA_SCALE)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for p in (0, S - 1, torch.tensor(S // 3, device=cuda_device),
              pos.to(torch.int32)):
        out = tkernel.mla_decode_attention(q, ckv, krope, p, scale=MLA_SCALE)
        torch.testing.assert_close(
            out.float(), tref.mla_decode_reference(q, ckv, krope, p, scale=MLA_SCALE).float(),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_decode_kernel_reads_strided_caches(dtype, cuda_device):
    """The caches as views: the first S positions of longer caches, and one
    layer of a stacked (L, B, S, d) cache whose batch rows are not adjacent."""
    tdt, tol = DTYPES[dtype]
    B, S, H, dl, dr = 4, 200, 40, 256, 32
    q, ckv, krope = _mla_inputs(cuda_device, tdt, 52, B, 2 * S, H, dl, dr)
    stacked = _inputs(cuda_device, tdt, 53, (2, B, S, dl), (2, B, S, dr))
    pos = torch.tensor([S - 1, 0, 77, 150], device=cuda_device)
    for c, r in ((ckv[:, :S], krope[:, :S]), (stacked[0][1], stacked[1][1])):
        out = tkernel.mla_decode_attention(q, c, r, pos, scale=MLA_SCALE)
        torch.testing.assert_close(
            out.float(), tref.mla_decode_reference(q, c, r, pos, scale=MLA_SCALE).float(),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["minicpm3-4b", "reduced", "two-groups", "n192-rope64",
                                  "one-stage"])
def test_mla_decode_kernel_ignores_stale_cache_positions(case, dtype, cuda_device):
    """Every cache position at or past each row's length holds NaN or Inf
    (a stale row; the key tiles are loaded whole): the output equals the
    kernel's on clean caches bit for bit and the plain version's on clean
    caches within the tolerance, whole and as partials."""
    B, S, H, dl, dr = MLA_CASES[case]
    tdt, tol = DTYPES[dtype]
    q, ckv, krope = _mla_inputs(cuda_device, tdt, 56, B, S, H, dl, dr)
    pos = _mla_positions(B, S, _mla_edge(B, S, H, dl, dr), cuda_device)
    stale = torch.arange(S, device=cuda_device)[None, :] > pos[:, None]       # (B, S)
    bad = torch.where(torch.arange(S, device=cuda_device) % 2 == 0, float("nan"), float("inf"))
    dirty = [torch.where(stale[..., None], bad[None, :, None].to(tdt), c) for c in (ckv, krope)]
    clean = tkernel.mla_decode_attention(q, ckv, krope, pos, scale=MLA_SCALE)
    out = tkernel.mla_decode_attention(q, *dirty, pos, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)
    torch.testing.assert_close(
        out.float(), tref.mla_decode_reference(q, ckv, krope, pos, scale=MLA_SCALE).float(),
        rtol=tol, atol=tol)
    parts = tkernel.mla_decode_attention_partials(q, *dirty, pos, scale=MLA_SCALE)
    live = pos >= 0
    for t in parts:
        assert torch.isfinite(t[live]).all()
    torch.testing.assert_close(tref.combine_partials([parts], tdt).float(), out.float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["minicpm3-4b", "multi-tile", "two-groups", "n192-rope64",
                                  "one-stage"])
def test_mla_decode_kernel_gives_the_same_bits_twice(case, dtype, cuda_device):
    """Two calls on the same inputs give the same bits: the merge sums the
    cluster's blocks in rank order, with no atomics."""
    B, S, H, dl, dr = MLA_CASES[case]
    tdt, _ = DTYPES[dtype]
    q, ckv, krope = _mla_inputs(cuda_device, tdt, 57, B, S, H, dl, dr)
    pos = _mla_positions(B, S, _mla_edge(B, S, H, dl, dr), cuda_device)
    first = tkernel.mla_decode_attention(q, ckv, krope, pos, scale=MLA_SCALE)
    second = tkernel.mla_decode_attention(q, ckv, krope, pos, scale=MLA_SCALE)
    parts = [tkernel.mla_decode_attention_partials(q, ckv, krope, pos, pos_offset=0,
                                                   scale=MLA_SCALE) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for a, b in zip(*parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shards", [2, 4])
def test_mla_decode_partials_kernel_over_sequence_shards(shards, dtype, cuda_device):
    """``mla_decode_attention_partials`` on each sequence shard of the two
    caches at its offset, against the plain partials and, merged by
    log-sum-exp, against the plain decode on the whole caches; (-inf, 0, 0)
    where a shard holds none of a row; counted under its own name."""
    B, S, H, dl, dr = 6, 1024, 40, 256, 32
    tdt, tol = DTYPES[dtype]
    q, ckv, krope = _mla_inputs(cuda_device, tdt, 54, B, S, H, dl, dr)
    pos = torch.tensor([S // 4 - 7, -1, S - 1, S // 2, 300, 901], device=cuda_device)
    L = S // shards
    parts = []
    for i in range(shards):
        c, r = ckv[:, i * L:(i + 1) * L], krope[:, i * L:(i + 1) * L]
        before = dict(tkernel.LAUNCHES)
        got = tkernel.mla_decode_attention_partials(q, c, r, pos, pos_offset=i * L,
                                                    scale=MLA_SCALE)
        torch.cuda.synchronize()
        assert tkernel.LAUNCHES["mla_decode_attention_partials"] == \
            before["mla_decode_attention_partials"] + 1
        assert tkernel.LAUNCHES["mla_decode_attention"] == before["mla_decode_attention"]
        want = tref.mla_decode_partials_reference(q, c, r, pos, pos_offset=i * L,
                                                  scale=MLA_SCALE)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
        m, l, acc = got
        empty = [1] + ([0] if i else [])
        assert torch.isneginf(m[empty]).all() and (l[empty] == 0).all() and (acc[empty] == 0).all()
        live = torch.isfinite(want[0])
        assert torch.equal(torch.isfinite(m), live)
        torch.testing.assert_close(m[live], want[0][live], rtol=tol, atol=tol)
        torch.testing.assert_close((acc / l.clamp_min(1e-30)[..., None])[live],
                                   (want[2] / want[1].clamp_min(1e-30)[..., None])[live],
                                   rtol=tol, atol=tol)
        parts.append(got)
    out = tref.combine_partials(parts, tdt)
    torch.testing.assert_close(
        out.float(), tref.mla_decode_reference(q, ckv, krope, pos, scale=MLA_SCALE).float(),
        rtol=tol, atol=tol)


def test_mla_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    q, ckv, krope = _mla_inputs(cuda_device, torch.float32, 55, 2, 32, 4, 16, 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tkernel.mla_decode_attention(q.half(), ckv.half(), krope.half(), 3, scale=1.0)
    with pytest.raises(ValueError, match="has dtype"):
        tkernel.mla_decode_attention(q, ckv.bfloat16(), krope, 3, scale=1.0)
    with pytest.raises(ValueError, match="multiple of 16"):
        tkernel.mla_decode_attention(q, ckv[..., :8].contiguous(),
                                     torch.cat([ckv[..., 8:], krope], -1), 3, scale=1.0)
    with pytest.raises(ValueError, match="widths' sum"):
        tkernel.mla_decode_attention(q, ckv, krope[..., :4].contiguous(), 3, scale=1.0)
    with pytest.raises(ValueError, match="one query token"):
        tkernel.mla_decode_attention(q.expand(2, 2, 4, 24), ckv, krope, 3, scale=1.0)
    with pytest.raises(RuntimeError, match="no gradient"):
        tkernel.mla_decode_attention(q.requires_grad_(), ckv, krope, 3, scale=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_step_replays_from_a_cuda_graph(dtype, cuda_device):
    """One decode step of the reduced minicpm3-4b captured as a CUDA graph
    (the step captures the kernel's cluster launch once a layer), replayed at
    two sets of lengths around the share boundaries: logits and caches equal
    the eager step's bit for bit."""
    cfg = get_reduced("minicpm3-4b").with_(dtype=dtype)
    model = Model(cfg, device=cuda_device).init(torch.Generator(cuda_device).manual_seed(0))
    B, S = 4, 256
    cache = model.init_cache(B, S)
    leaves = [cache["ckv"], cache["krope"]]
    for i, leaf in enumerate(leaves):
        leaf.copy_(_inputs(cuda_device, leaf.dtype, 60 + i, tuple(leaf.shape))[0])
    start = [leaf.clone() for leaf in leaves]
    tokens = torch.zeros((B, 1), dtype=torch.long, device=cuda_device)
    pos = torch.zeros((B,), dtype=torch.long, device=cuda_device)

    def step():
        logits, _ = model.decode_step(tokens, cache, pos)
        return logits

    def restore():
        for leaf, s0 in zip(leaves, start):
            leaf.copy_(s0)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        step()                                       # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    restore()
    graph = torch.cuda.CUDAGraph()
    before = tkernel.LAUNCHES["mla_decode_attention"]
    with torch.no_grad(), torch.cuda.graph(graph):
        static_logits = step()
    assert tkernel.LAUNCHES["mla_decode_attention"] == before + cfg.n_layers
    edge = _mla_edge(B, S, cfg.n_heads, cache["ckv"].shape[-1], cache["krope"].shape[-1])
    rng = np.random.default_rng(7)
    for lengths in ([1, edge, edge + 1, S], [S - 3, 2, 2 * edge - 1, edge - 1]):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).to(cuda_device)
        restore()
        tokens.copy_(toks)
        pos.copy_(torch.tensor(lengths, device=cuda_device) - 1)
        graph.replay()
        got, got_cache = static_logits.clone(), [leaf.clone() for leaf in leaves]
        restore()
        with torch.no_grad():
            want = step()
        assert torch.equal(got, want)
        for g, w in zip(got_cache, leaves):
            assert torch.equal(g, w)


SSD_DTYPES = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 5e-2)}
SSD_SWEEP = [  # B, S, H, P, G, N, chunk — tests/test_kernels_ssd.py:41-46, then the slice's
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 32, 2, 8, 32),
    (1, 96, 6, 16, 1, 32, 32),
    (2, 64, 8, 64, 4, 16, 64),
    (1, 137, 4, 64, 1, 128, 137),   # a ragged chunk: S = chunk = 137
    (1, 512, 80, 64, 1, 128, 256),
    (1, 512, 80, 64, 1, 64, 256),    # zamba2-2.7b: state N = 64
    (1, 137, 80, 64, 1, 64, 137),    # ... and a ragged chunk
    (1, 768, 80, 64, 1, 128, 256),   # three chunks at the full heads
    (1, 1, 80, 64, 1, 128, 1),       # chunks of 1 and 2: 1- and 2-token prompts
    (1, 2, 80, 64, 1, 64, 2),
]


def _ssd_inputs(device, dtype, seed, B, S, H, P, G, N):
    r = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)
    return (t(r.standard_normal((B, S, H, P)), dtype),
            t(np.log1p(np.exp(r.standard_normal((B, S, H)))) * 0.5),
            t(-np.exp(r.standard_normal(H) * 0.3)),
            t(r.standard_normal((B, S, G, N)) * 0.3, dtype),
            t(r.standard_normal((B, S, G, N)) * 0.3, dtype))


def _ssd_close(got, want, tol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
@pytest.mark.parametrize("shape", SSD_SWEEP, ids=[str(s) for s in SSD_SWEEP])
def test_ssd_kernel_matches_plain(shape, dtype, cuda_device):
    *dims, chunk = shape
    tdt, tol = SSD_DTYPES[dtype]
    args = _ssd_inputs(cuda_device, tdt, 5, *dims)
    before = ssd_kernel.LAUNCHES["ssd"]
    got = ssd_kernel.ssd(*args, chunk=chunk, return_final_state=True)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd"] == before + 1
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    _ssd_close(got, ssd_ref.ssd_reference(*args, chunk=chunk, return_final_state=True), tol)


@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
def test_ssd_kernel_initial_state_and_strided_inputs(dtype, cuda_device):
    """A nonzero initial state, and B/C/x as views of one wide tensor, as the
    model's split hands them over."""
    tdt, tol = SSD_DTYPES[dtype]
    B, S, H, P, G, N = 2, 96, 4, 64, 2, 32
    x, dt, A, _, _ = _ssd_inputs(cuda_device, tdt, 6, B, S, H, P, G, N)
    wide = torch.randn(B, S, H * P + 2 * G * N, device=cuda_device).to(tdt)
    xs = wide[..., :H * P].unflatten(-1, (H, P))
    Bs = wide[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cs = wide[..., H * P + G * N:].unflatten(-1, (G, N))
    h0 = torch.randn(B, H, P, N, device=cuda_device)
    got = ssd_kernel.ssd(xs, dt, A, Bs, Cs, chunk=32, initial_state=h0, return_final_state=True)
    want = ssd_ref.ssd_reference(xs, dt, A, Bs, Cs, chunk=32, initial_state=h0,
                                 return_final_state=True)
    _ssd_close(got, want, tol)


@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
@pytest.mark.parametrize("shape", [(2, 512, 80, 64, 1, 128, 256), (2, 137, 80, 64, 1, 64, 137)],
                         ids=["mamba2-2chunks", "zamba2-1chunk"])
def test_ssd_kernel_initial_state_at_full_heads(shape, dtype, cuda_device):
    """A batch of 2 with a nonzero initial state at the full 80 heads, at two
    chunks (the state-passing pass writes the final state) and at one (the
    chunk-state pass writes it)."""
    *dims, chunk = shape
    tdt, tol = SSD_DTYPES[dtype]
    args = _ssd_inputs(cuda_device, tdt, 17, *dims)
    B, _, H, P, _, N = dims
    h0 = torch.randn(B, H, P, N, generator=torch.Generator(cuda_device).manual_seed(17),
                     device=cuda_device)
    before = ssd_kernel.LAUNCHES["ssd"]
    got = ssd_kernel.ssd(*args, chunk=chunk, initial_state=h0, return_final_state=True)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd"] == before + 1
    want = ssd_ref.ssd_reference(*args, chunk=chunk, initial_state=h0, return_final_state=True)
    _ssd_close(got, want, tol)


@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
@pytest.mark.parametrize("total", [512, 768], ids=["2chunks", "3chunks"])
def test_ssd_kernel_one_chunk_and_multi_chunk_branches_agree(total, dtype, cuda_device):
    """A 137-token prompt as one chunk of 137 (the chunk-state pass writes the
    final state), and the same inputs padded with dt = 0 to two or three
    chunks of 256 (the state-passing pass writes it), from the same initial
    state: y[:S] and the final state agree."""
    S = 137
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, SSD_DTYPES[dtype][0], 18, 2, S, 80, 64, 1, 128)
    h0 = torch.randn(2, 80, 64, 128, generator=torch.Generator(cuda_device).manual_seed(18),
                     device=cuda_device)
    y, st = ssd_kernel.ssd(x, dt, A, Bm, Cm, chunk=S, initial_state=h0, return_final_state=True)

    def zpad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, total - S))
    yp, stp = ssd_kernel.ssd(zpad(x), zpad(dt), A, zpad(Bm), zpad(Cm), chunk=256,
                             initial_state=h0, return_final_state=True)
    torch.testing.assert_close(yp[:, :S].float(), y.float(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stp, st, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
@pytest.mark.parametrize("layout", ["odd-offset", "batch-stride-0"])
def test_ssd_kernel_strided_views(layout, dtype, cuda_device):
    """x, B and C as views the 16-byte copies cannot take (bases one element
    off, so the bf16 passes copy elements), and B/C expanded over the batch
    (batch stride 0); the same seeded values either way."""
    tdt, tol = SSD_DTYPES[dtype]
    B, S, H, P, G, N, chunk = 2, 300, 8, 64, 2, 64, 100
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, tdt, 19, B, S, H, P, G, N)
    if layout == "odd-offset":
        wide = torch.cat([torch.zeros(B, S, 1, device=cuda_device, dtype=tdt), x.flatten(2),
                          Bm.flatten(2), Cm.flatten(2)], dim=-1)
        x = wide[..., 1:1 + H * P].unflatten(-1, (H, P))
        Bm = wide[..., 1 + H * P:1 + H * P + G * N].unflatten(-1, (G, N))
        Cm = wide[..., 1 + H * P + G * N:].unflatten(-1, (G, N))
    else:
        Bm, Cm = Bm[:1].expand(B, -1, -1, -1), Cm[:1].expand(B, -1, -1, -1)
    before = ssd_kernel.LAUNCHES["ssd"]
    got = ssd_kernel.ssd(x, dt, A, Bm, Cm, chunk=chunk, return_final_state=True)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd"] == before + 1
    _ssd_close(got, ssd_ref.ssd_reference(x, dt, A, Bm, Cm, chunk=chunk,
                                          return_final_state=True), tol)


def test_ssd_kernel_dt_zero_tail_changes_nothing(cuda_device):
    S, pad = 137, 119
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, torch.float32, 7, 1, S, 8, 64, 1, 128)
    y, st = ssd_kernel.ssd(x, dt, A, Bm, Cm, chunk=S, return_final_state=True)

    def zpad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
    yp, stp = ssd_kernel.ssd(zpad(x), zpad(dt), A, zpad(Bm), zpad(Cm), chunk=256,
                             return_final_state=True)
    torch.testing.assert_close(yp[:, :S], y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(stp, st, rtol=1e-5, atol=1e-5)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda_device):
    x, dt, A, Bm, Cm = _ssd_inputs(cuda_device, torch.float32, 8, 1, 64, 2, 16, 1, 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_kernel.ssd(x.half(), dt, A, Bm.half(), Cm.half(), chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel.ssd(x, dt, A, Bm, Cm, chunk=24)
    with pytest.raises(ValueError, match="dt must be float32"):
        ssd_kernel.ssd(x, dt.bfloat16(), A, Bm, Cm, chunk=16)


RMS_DTYPES = {"float32": (torch.float32, 1e-6), "bfloat16": (torch.bfloat16, 1e-2)}
RMS_SHAPES = [  # tests/test_kernels_rmsnorm.py:14, then the slices' prefill and decode rows
    (4, 32, 64), (2, 100, 128), (1, 8, 256), (7, 96),
    (1, 512, 896), (8, 1, 896), (1, 512, 2560), (8, 1, 2560),
    (1, 768, 6144), (8, 1, 6144),   # internvl2-26b: 384 threads of two 8-wide chunks a row
]


def _rms_inputs(device, dtype, seed, shape):
    r = np.random.default_rng(seed)
    x, d = (torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for _ in range(2))
    scale = torch.from_numpy((np.abs(r.standard_normal(shape[-1])) + 0.5).astype(np.float32))
    return x, d, scale.to(device)


@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_fused_add_rmsnorm_kernel_matches_plain(shape, dtype, cuda_device):
    tdt, tol = RMS_DTYPES[dtype]
    x, d, scale = _rms_inputs(cuda_device, tdt, 10, shape)
    before = rms_kernel.LAUNCHES["fused_add_rmsnorm"]
    res, out = rms_kernel.fused_add_rmsnorm(x, d, scale, 1e-6)
    torch.cuda.synchronize()
    assert rms_kernel.LAUNCHES["fused_add_rmsnorm"] == before + 1
    assert res.dtype == out.dtype == tdt and res.shape == out.shape == shape
    want_res, want_out = rms_ref.fused_add_rmsnorm_reference(x, d, scale, 1e-6)
    assert torch.equal(res, want_res)  # one rounding of the same fp32 sum
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)


def test_fused_add_rmsnorm_kernel_takes_strided_rows(cuda_device):
    """Rows of x and delta that are views of wider tensors (row strides of
    their own), as a slice of a wider activation hands them over."""
    wide_x, wide_d, scale = _rms_inputs(cuda_device, torch.bfloat16, 11, (6, 2560 + 64))
    x, d = wide_x[:, :2560], wide_d[:, 64:]
    res, out = rms_kernel.fused_add_rmsnorm(x, d, scale[:2560].contiguous())
    want = rms_ref.fused_add_rmsnorm_reference(x, d, scale[:2560])
    assert torch.equal(res, want[0])
    torch.testing.assert_close(out.float(), want[1].float(), rtol=1e-2, atol=1e-2)


def test_fused_add_rmsnorm_kernel_refuses_what_it_does_not_take(cuda_device):
    x, d, scale = _rms_inputs(cuda_device, torch.float32, 12, (4, 64))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rms_kernel.fused_add_rmsnorm(x.half(), d.half(), scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        rms_kernel.fused_add_rmsnorm(x[:, :60], d[:, :60], scale[:60])
    square = torch.randn(64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="unit stride"):
        rms_kernel.fused_add_rmsnorm(square.t(), square.t(), scale)
    with pytest.raises(ValueError, match="scale must be"):
        rms_kernel.fused_add_rmsnorm(x, d, scale.bfloat16())
    with pytest.raises(ValueError, match="must match"):
        rms_kernel.fused_add_rmsnorm(x, d[:2], scale)


# (rows, D, row padding of x and delta): D = 8 (one busy thread), 136 (17
# chunks), the slices' 896 and 2560, 4096 (the widest at one chunk a thread),
# 4104 (the first at two) and 16384 (four); one row and many; strided rows
LAYOUT_CASES = [
    (1, 8, 0), (300, 8, 0), (1, 136, 0), (600, 136, 24), (512, 896, 0), (133, 896, 8),
    (3, 2056, 0), (512, 2560, 0), (1, 2560, 64), (2, 4096, 0), (5, 4104, 8),
    (1, 16384, 0), (9, 16384, 16),
]


@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("case", LAYOUT_CASES, ids=lambda c: f"{c[0]}x{c[1]}+{c[2]}")
def test_fused_add_rmsnorm_kernel_every_layout(case, dtype, cuda_device):
    """Every launch shape the launcher can pick (one to four 8-wide chunks a
    thread, a part-filled last warp), held to ref.py: res bit for bit, out
    within the reference's tolerance."""
    T, D, pad = case
    tdt, tol = RMS_DTYPES[dtype]
    wide_x, wide_d, scale = _rms_inputs(cuda_device, tdt, 19, (T, D + pad))
    x, d, scale = wide_x[:, pad:], wide_d[:, :D], scale[:D].contiguous()
    res, out = rms_kernel.fused_add_rmsnorm(x, d, scale, 1e-6)
    torch.cuda.synchronize()
    want_res, want_out = rms_ref.fused_add_rmsnorm_reference(x, d, scale, 1e-6)
    assert torch.equal(res, want_res)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)


def _product_norm_chain(a, w, scale, x, norm):
    """A decode step's 24 (attention output product, add + norm) pairs, the
    residual threaded from each pair to the next; returns every res and out."""
    outs = []
    for i in range(w.shape[0]):
        x, o = norm(x, torch.matmul(a, w[i]), scale[i], 1e-6)
        outs += [x, o]
    return outs


def _chain_inputs(device, dtype, D):
    r = np.random.default_rng(20)
    a = torch.from_numpy(r.standard_normal((8, 1, D)).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy((r.standard_normal((24, D, D)) * D ** -0.5).astype(np.float32)).to(
        device, dtype)
    scale = torch.from_numpy((np.abs(r.standard_normal((24, D))) + 0.5).astype(np.float32))
    x = torch.from_numpy(r.standard_normal((8, 1, D)).astype(np.float32)).to(device, dtype)
    return a, w, scale.to(device), x


@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("D", [896, 2560])
def test_fused_add_rmsnorm_after_a_product_in_a_chain(D, dtype, cuda_device):
    """torch.matmul (a cuBLAS kernel that never triggers the programmatic
    launch) then the kernel, 24 times with the residual threaded through: each
    res equals the plain chain's bit for bit."""
    tdt, tol = RMS_DTYPES[dtype]
    a, w, scale, x = _chain_inputs(cuda_device, tdt, D)
    got = _product_norm_chain(a, w, scale, x, rms_kernel.fused_add_rmsnorm)
    torch.cuda.synchronize()
    want = _product_norm_chain(a, w, scale, x, rms_ref.fused_add_rmsnorm_reference)
    for i in range(0, len(got), 2):
        assert torch.equal(got[i], want[i]), f"res of pair {i // 2}"
        torch.testing.assert_close(got[i + 1].float(), want[i + 1].float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("D", [896, 2560])
def test_fused_add_rmsnorm_chain_replays_from_a_cuda_graph(D, cuda_device):
    """The 24 product + norm pairs captured in a CUDA graph: the launch is
    capture-safe, and a replay on new inputs equals the eager run bit for bit."""
    a, w, scale, x = _chain_inputs(cuda_device, torch.bfloat16, D)
    static_a, static_x = a.clone(), x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(2):
            _product_norm_chain(static_a, w, scale, static_x, rms_kernel.fused_add_rmsnorm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rms_kernel.LAUNCHES["fused_add_rmsnorm"]
    with torch.cuda.graph(graph):
        static_outs = _product_norm_chain(static_a, w, scale, static_x,
                                          rms_kernel.fused_add_rmsnorm)
    assert rms_kernel.LAUNCHES["fused_add_rmsnorm"] == before + 24
    new_a, new_x = (t + 0.25 * torch.randn_like(t) for t in (a, x))
    static_a.copy_(new_a)
    static_x.copy_(new_x)
    graph.replay()
    torch.cuda.synchronize()
    eager = _product_norm_chain(new_a, w, scale, new_x, rms_kernel.fused_add_rmsnorm)
    torch.cuda.synchronize()
    for i, (g, e) in enumerate(zip(static_outs, eager)):
        assert torch.equal(g, e), f"{'res' if i % 2 == 0 else 'out'} of pair {i // 2}"


def _blit(cache: dict, seq: dict) -> None:
    for name, dst in cache.items():
        if isinstance(dst, dict):
            _blit(dst, seq[name])
        else:
            dst[tuple(slice(0, n) for n in seq[name].shape)] = seq[name]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen1.5-0.5b", "deepseek-67b", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_model_kernel_path_matches_plain_path(arch, cuda_device):
    """Prefill + decode of a reduced model through the kernels against the
    same model with impl="ref" (f32: the decode-equivalence tolerances)."""
    cfg = get_reduced(arch).with_(dtype="float32")
    model = Model(cfg, device=cuda_device).init(torch.Generator(cuda_device).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 24))).to(
        cuda_device)
    outs = {}
    for impl in ("auto", "ref"):
        model.kernel_impl = impl
        logits, seq = model.prefill({"tokens": tokens[:, :16]})
        cache = model.init_cache(2, 24)
        _blit(cache, seq)
        steps = [logits]
        for i in range(16, 23):
            pos = torch.tensor([i, i], device=cuda_device)
            logits, cache = model.decode_step(tokens[:, i:i + 1], cache, pos)
            steps.append(logits)
        outs[impl] = torch.stack(steps)
    torch.testing.assert_close(outs["auto"], outs["ref"], rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------ gradients
# Under autograd flash attention launches its kernel forward (which also
# writes the log-sum-exp) and, backward, flash_attention_backward's kernel;
# the add + norm and the scan launch their kernel forward and, backward,
# fused_add_rmsnorm_backward's and ssd_backward's kernels; decode attention,
# on no training path, raises.
# (id, (B, Sq, Skv, H, KV, dqk, dv), kwargs): small; qwen2-0.5b's and
# zamba2-2.7b's training calls; minicpm3-4b's expanded prefill (dqk 96, dv
# 64, its own scale); whisper-small's cross attention (64 queries over 1500
# keys, non-causal); internvl2-26b's GQA 48/8 at hd 128; per-row kv_len with
# a row of length 0 and a q_offset; zero-padded head dims, Sq != Skv
GRAD_FLASH_CASES = [
    ("small", (2, 64, 64, 4, 2, 32, 32), {"causal": True}),
    ("qwen2-train", (8, 1024, 1024, 14, 2, 64, 64), {"causal": True}),
    ("zamba2-train", (8, 1024, 1024, 32, 32, 80, 80), {"causal": True}),
    ("mla-prefill", (1, 512, 512, 40, 40, 96, 64), {"causal": True, "scale": 96 ** -0.5}),
    ("whisper-cross", (1, 64, 1500, 12, 12, 64, 64), {"causal": False}),
    ("internvl2", (1, 768, 768, 48, 8, 128, 128), {"causal": True}),
    ("kv_len-q_offset", (3, 100, 164, 8, 2, 64, 64),
     {"causal": True, "q_offset": 64, "kv_len": [0, 37, 164]}),
    ("padded-noncausal", (2, 70, 90, 6, 6, 24, 16), {"causal": False, "kv_len": [90, 41]}),
]
GRAD_RMS_SHAPES = [(2, 5, 64), (8, 1024, 896)]                            # small; qwen2 training
# each gradient's relative L2 distance to the plain gradient in f32 from the
# same inputs: f32 sums in another order; bf16 rounds P and dS for the products
GRAD_REL_L2 = {"float32": 1e-5, "bfloat16": 2e-2}


def _close_grads(got, want, dtype, tol, summed=()):
    """Each gradient within ``tol`` of autograd's, element by element; those
    at the indices ``summed`` (sums over many rows or positions, which the
    backward kernels take in another order than autograd's reductions) by
    their relative L2 within ``tol`` and max |diff| within 1e-4 max |plain|
    (f32) or ``tol`` max |plain| (bf16)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None and g.dtype == w.dtype
        g, w = g.float(), w.float()
        if i in summed:
            rel = float((g - w).norm() / w.norm())
            worst = float((g - w).abs().max()) / float(w.abs().max())
            assert rel <= tol and worst <= (1e-4 if dtype == "float32" else tol), \
                f"gradient {i}: relative L2 {rel:.3e}, max |diff| {worst:.3e} of max |plain|"
        else:
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def _grad_case(case, dtype, device, seed=7):
    """q, k, v (requiring grad), the output's gradient and the kwargs of a
    GRAD_FLASH_CASES entry."""
    _, (B, Sq, Skv, H, KV, dqk, dv), kw = case
    q, k, v, go = _inputs(device, DTYPES[dtype][0], seed, (B, Sq, H, dqk), (B, Skv, KV, dqk),
                          (B, Skv, KV, dv), (B, Sq, H, dv))
    kw = {n: torch.tensor(x, device=device) if isinstance(x, list) else x for n, x in kw.items()}
    return [t.requires_grad_() for t in (q, k, v)], go, kw


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", GRAD_FLASH_CASES, ids=[c[0] for c in GRAD_FLASH_CASES])
def test_flash_gradients_are_the_plain_versions(case, dtype, cuda_device):
    """Under autograd one forward launch and one flash_attention_backward
    launch, no plain attention on the card; dq, dk, dv against autograd of
    the plain version in f32 on the same inputs within GRAD_REL_L2 (and, f32,
    max |diff| <= 1e-4 max |plain|); the output within the forward's tolerance."""
    tdt, tol = DTYPES[dtype]
    (q, k, v), go, kw = _grad_case(case, dtype, cuda_device)
    before = dict(tkernel.LAUNCHES)
    out = tkernel.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), go)
    torch.cuda.synchronize()
    ran = {n: tkernel.LAUNCHES[n] - before[n] for n in before}
    assert ran == {**dict.fromkeys(before, 0), "flash_attention": 1,
                   "flash_attention_backward": 1}
    with torch.no_grad():
        want_out = tref.mha_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    x32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tref.mha_reference(*x32, **kw), x32, go.float())
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt and g.shape == w.shape
        rel = float((g.float() - w).norm() / w.norm())
        assert rel <= GRAD_REL_L2[dtype], f"d{name}: relative L2 {rel:.3e}"
        if dtype == "float32":
            worst = float((g - w).abs().max())
            assert worst <= 1e-4 * float(w.abs().max()), f"d{name}: max |diff| {worst:.3e}"


# head dims that fill a 64-column slab in part (8, 48) or in full (64), then a
# narrow second slab (72, 80: 16 columns; 96: 32) or a full one (112, 128),
# dqk != dv both ways (one head dim's slab zero-filled for the other's), causal
# and not, with lengths and a q_offset
BWD_WIDTH_CASES = [
    ("width-8", (2, 96, 96, 4, 2, 8, 8), {"causal": True}),
    ("width-72", (2, 130, 130, 4, 2, 72, 72), {"causal": True}),
    ("width-80-lengths", (2, 100, 170, 6, 3, 80, 80), {"causal": False, "kv_len": [170, 93]}),
    ("dqk-72-dv-80", (1, 128, 128, 4, 4, 72, 80), {"causal": True}),
    ("dqk-80-dv-72", (1, 128, 200, 4, 2, 80, 72), {"causal": True, "q_offset": 72}),
    ("dqk-8-dv-128", (1, 70, 70, 4, 1, 8, 128), {"causal": True}),
    ("dqk-128-dv-8", (1, 70, 70, 4, 1, 128, 8), {"causal": False}),
    ("dqk-112-dv-48", (2, 64, 64, 6, 2, 112, 48), {"causal": True}),
    ("width-96", (1, 128, 160, 6, 2, 96, 96), {"causal": False, "kv_len": 131}),
    ("dqk-64-dv-80", (2, 100, 100, 4, 4, 64, 80), {"causal": True}),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", GRAD_FLASH_CASES + BWD_WIDTH_CASES, ids=str)
def test_flash_backward_kernel_matches_its_plain_version(case, dtype, cuda_device):
    """``flash_attention_backward`` on the forward kernel's (o, lse) against
    ``ref.mha_backward_reference`` on the same tensors, at every family's
    training shape (``chip_smoke.BWD_TIMED_SHAPES``, ``BWD_HELD_SHAPES``)
    and the head dims of BWD_WIDTH_CASES, and the kernel's lse against
    ``ref.mha_forward_with_lse_reference``'s (-inf where a row sees no
    key)."""
    tdt, tol = DTYPES[dtype]
    (q, k, v), go, kw = _grad_case(case, dtype, cuda_device, seed=8)
    q, k, v = (t.detach() for t in (q, k, v))
    full = dict(causal=True, q_offset=None, kv_len=None, scale=None) | kw
    o, lse = tkernel._flash_launch(q, k, v, with_lse=True, **full)
    _, want_lse = tref.mha_forward_with_lse_reference(q, k, v, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[finite], want_lse[finite].float(), rtol=1e-5, atol=1e-5)
    before = tkernel.LAUNCHES["flash_attention_backward"]
    got = tkernel.flash_attention_backward(q, k, v, o, go, lse, **kw)
    torch.cuda.synchronize()
    assert tkernel.LAUNCHES["flash_attention_backward"] == before + 1
    want = tref.mha_backward_reference(q, k, v, o, go, lse, **kw)
    for name, g, w in zip("qkv", got, want):
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= GRAD_REL_L2[dtype], f"d{name}: relative L2 {rel:.3e}"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_backward_on_strided_views_of_one_projection(dtype, cuda_device):
    """q, k and v as the model hands them: views of one fused projection
    (B, S, H + 2 KV, hd), strided along the sequence and the heads; the
    gradients equal the kernel's on contiguous copies bit for bit, and hold
    to the plain version."""
    tdt, _ = DTYPES[dtype]
    B, S, H, KV, hd = 2, 200, 14, 2, 64
    qkv, go = _inputs(cuda_device, tdt, 21, (B, S, H + 2 * KV, hd), (B, S, H, hd))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous() and not k.is_contiguous()
    o, lse = tkernel._flash_launch(q, k, v, causal=True, q_offset=None, kv_len=None,
                                   scale=None, with_lse=True)
    got = tkernel.flash_attention_backward(q, k, v, o, go, lse)
    dense = tkernel.flash_attention_backward(q.contiguous(), k.contiguous(), v.contiguous(), o,
                                             go, lse)
    torch.cuda.synchronize()
    want = tref.mha_backward_reference(q, k, v, o, go, lse)
    for name, g, c, w in zip("qkv", got, dense, want):
        assert torch.equal(g, c), f"d{name} differs from the contiguous inputs'"
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= GRAD_REL_L2[dtype], f"d{name}: relative L2 {rel:.3e}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [
    ("mha", (2, 256, 256, 4, 4, 64, 64), {"causal": True}),
    ("gqa-7", (2, 256, 256, 14, 2, 64, 64), {"causal": True}),
    ("gqa-6-hd128", (1, 192, 192, 12, 2, 128, 128), {"causal": True}),
    ("zero-row", (3, 100, 164, 8, 2, 80, 80), {"causal": True, "q_offset": 64,
                                              "kv_len": [0, 37, 164]}),
], ids=lambda c: c[0])
def test_flash_backward_gives_the_same_bits_twice(case, dtype, cuda_device):
    """Two calls on the same inputs give the same bits (no atomics: the
    1-rank mesh train steps are held bit-equal to the unsharded ones), with
    and without GQA, and with a row of kv_len 0."""
    (q, k, v), go, kw = _grad_case(case, dtype, cuda_device, seed=23)
    q, k, v = (t.detach() for t in (q, k, v))
    full = dict(causal=True, q_offset=None, kv_len=None, scale=None) | kw
    o, lse = tkernel._flash_launch(q, k, v, with_lse=True, **full)
    first = tkernel.flash_attention_backward(q, k, v, o, go, lse, **kw)
    for _ in range(3):
        again = tkernel.flash_attention_backward(q, k, v, o, go, lse, **kw)
        for name, a, b in zip("qkv", first, again):
            assert torch.equal(a, b), f"d{name} differs between two calls"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_gradient_of_a_row_with_no_valid_key_is_zero(dtype, cuda_device):
    """A batch row of kv_len 0 (causal and not): its dq, dk and dv are exact
    zeros from the kernel; the other rows hold to the plain gradient."""
    for causal in (False, True):
        (q, k, v), go, kw = _grad_case(
            ("", (2, 70, 70, 4, 2, 64, 64), {"causal": causal, "kv_len": [0, 40]}), dtype,
            cuda_device, seed=17)
        got = torch.autograd.grad(tkernel.flash_attention(q, k, v, **kw), (q, k, v), go)
        torch.cuda.synchronize()
        for g in got:
            assert torch.equal(g[0], torch.zeros_like(g[0]))
        x32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(tref.mha_reference(*x32, **kw), x32, go.float())
        for g, w in zip(got, want):
            assert float((g.float() - w).norm() / w.norm()) <= GRAD_REL_L2[dtype]


def test_flash_backward_refuses_what_it_does_not_take(cuda_device):
    q, k, v, o = _inputs(cuda_device, torch.float32, 3, (1, 8, 4, 16), (1, 8, 2, 16),
                         (1, 8, 2, 16), (1, 8, 4, 16))
    lse = torch.zeros((1, 4, 8), device=cuda_device)
    bwd = tkernel.flash_attention_backward
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bwd(q.half(), k.half(), v.half(), o.half(), o.half(), lse)
    with pytest.raises(ValueError, match="multiple of 8"):
        bwd(q[..., :12], k[..., :12], v[..., :12], o[..., :12], o[..., :12], lse)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bwd(q, k.cpu(), v, o, o, lse)
    with pytest.raises(ValueError, match="o must be"):
        bwd(q, k, v, o.cpu(), o, lse)
    with pytest.raises(ValueError, match="do must be"):
        bwd(q, k, v, o, o.bfloat16(), lse)
    with pytest.raises(ValueError, match="lse must be"):
        bwd(q, k, v, o, o, lse.bfloat16())
    with pytest.raises(ValueError, match="lse must be"):
        bwd(q, k, v, o, o, lse[:, :, :4])


@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("shape", GRAD_RMS_SHAPES, ids=str)
def test_fused_add_rmsnorm_gradients_are_the_plain_versions(shape, dtype, cuda_device):
    """Under autograd one forward launch and one fused_add_rmsnorm_backward
    launch; the gradients of x, delta and scale against autograd of the
    plain version on the same inputs."""
    tdt, tol = RMS_DTYPES[dtype]
    x, d, scale = _rms_inputs(cuda_device, tdt, 8, shape)
    g_res, g_out = _rms_inputs(cuda_device, tdt, 9, shape)[:2]
    x, d, scale = (t.requires_grad_() for t in (x, d, scale))
    before = dict(rms_kernel.LAUNCHES)
    res, out = rms_kernel.fused_add_rmsnorm(x, d, scale, 1e-6)
    assert res.grad_fn is not None and out.grad_fn is not None
    got = torch.autograd.grad((res, out), (x, d, scale), (g_res, g_out))
    torch.cuda.synchronize()
    assert {n: rms_kernel.LAUNCHES[n] - before[n] for n in before} == {
        "fused_add_rmsnorm": 1, "fused_add_rmsnorm_backward": 1}
    want = rms_ref.fused_add_rmsnorm_reference(x, d, scale, 1e-6)
    # dscale sums over every row
    _close_grads(got, torch.autograd.grad(want, (x, d, scale), (g_res, g_out)), dtype,
                 tol if dtype == "bfloat16" else 1e-5, summed=(2,))


# the add + norm backward kernel against its plain version: each gradient's
# relative L2 (f32: sums in another order; bf16: dh rounded once, at the store)
RMS_BWD_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}
# qwen2-0.5b's and zamba2-2.7b's training rows, internvl2-26b's width, decode
# rows, a ragged count of rows, and x / delta with row strides
RMS_BWD_SHAPES = [(8, 1024, 896), (8, 1024, 2560), (1, 768, 6144), (8, 1, 896), (1037, 64),
                  (3, 5, 64)]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", list(RMS_DTYPES))
@pytest.mark.parametrize("shape", RMS_BWD_SHAPES, ids=str)
def test_fused_add_rmsnorm_backward_kernel_matches_its_plain_version(shape, dtype, strided,
                                                                     cuda_device):
    """``fused_add_rmsnorm_backward`` against
    ``ref.fused_add_rmsnorm_backward_reference`` on the same tensors (x and
    delta strided rows with ``strided``, the output gradients transposed
    views, which the wrapper makes contiguous); dx is ddelta; one launch;
    two runs give the same bits."""
    tdt, _ = RMS_DTYPES[dtype]
    x, d, scale = _rms_inputs(cuda_device, tdt, 18, shape)
    g_res, g_out = _rms_inputs(cuda_device, tdt, 19, shape)[:2]
    if strided:
        D = shape[-1]
        wide = torch.zeros(shape[:-1] + (D + 16,), dtype=tdt, device=cuda_device)
        wide[..., 8:8 + D] = x
        x = wide[..., 8:8 + D]
        g_out = g_out.transpose(0, -2).contiguous().transpose(0, -2) if len(shape) > 2 else g_out
    before = rms_kernel.LAUNCHES["fused_add_rmsnorm_backward"]
    got = rms_kernel.fused_add_rmsnorm_backward(x, d, scale, g_res, g_out, 1e-6)
    torch.cuda.synchronize()
    assert rms_kernel.LAUNCHES["fused_add_rmsnorm_backward"] == before + 1
    assert got[0] is got[1] and got[0].dtype == tdt and got[2].dtype == torch.float32
    want = rms_ref.fused_add_rmsnorm_backward_reference(x, d, scale, g_res, g_out, 1e-6)
    for name, g, w in zip(("dx", "ddelta", "dscale"), got, want):
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= RMS_BWD_REL_L2[dtype], f"{name}: relative L2 {rel:.3e}"
    again = rms_kernel.fused_add_rmsnorm_backward(x, d, scale, g_res, g_out, 1e-6)
    assert torch.equal(again[0], got[0]) and torch.equal(again[2], got[2])


def test_fused_add_rmsnorm_backward_refuses_what_it_does_not_take(cuda_device):
    x, d, scale = _rms_inputs(cuda_device, torch.float32, 20, (4, 64))
    g = torch.ones_like(x)
    bwd = rms_kernel.fused_add_rmsnorm_backward
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bwd(x.half(), d.half(), scale, g.half(), g.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        bwd(x[:, :60], d[:, :60], scale[:60], g[:, :60], g[:, :60])
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bwd(x, d.cpu(), scale, g, g)
    with pytest.raises(ValueError, match="g_res must be"):
        bwd(x, d, scale, g.bfloat16(), g)
    with pytest.raises(ValueError, match="g_out must be"):
        bwd(x, d, scale, g, g[:2])
    with pytest.raises(ValueError, match="scale must be"):
        bwd(x, d, scale.double(), g, g)


def test_decode_attention_and_ssd_raise_under_grad(cuda_device):
    """Decode attention, on no training path, raises under autograd; the
    scan launches through its Function there (a gradient since the ssm and
    hybrid families train on the card)."""
    q, kc, vc = _inputs(cuda_device, torch.float32, 10, (2, 1, 4, 16), (2, 32, 2, 16),
                        (2, 32, 2, 16))
    with pytest.raises(RuntimeError, match="no gradient"):
        tkernel.decode_attention(q.requires_grad_(), kc, vc, 5)
    x, dt, A, B_, C_ = _ssd_inputs(cuda_device, torch.float32, 11, 1, 64, 2, 16, 1, 16)
    y, _ = ssd_kernel.ssd(x, dt, A.requires_grad_(), B_, C_, chunk=16)
    assert y.grad_fn is not None
    with torch.no_grad():   # the same calls outside autograd launch
        tkernel.decode_attention(q, kc, vc, 5)
        ssd_kernel.ssd(x, dt, A, B_, C_, chunk=16)


# B, S, H, P, G, N, chunk: small (two chunks, two groups); mamba2-2.7b's and
# zamba2-2.7b's training calls (B = 8, S = 1024: four chunks of 256)
GRAD_SSD_SHAPES = [(2, 64, 4, 16, 2, 16, 32), (8, 1024, 80, 64, 1, 128, 256),
                   (8, 1024, 80, 64, 1, 64, 256)]


@pytest.mark.parametrize("final_state", [False, True])
@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
@pytest.mark.parametrize("shape", GRAD_SSD_SHAPES, ids=str)
def test_ssd_gradients_are_the_plain_versions(shape, dtype, final_state, cuda_device):
    """Under autograd the scan launches its kernel forward once and
    ssd_backward's kernel once; the gradients of x, dt, A, B, C (and, with a
    final state asked for, an initial state) against autograd of
    ``ssd_reference``."""
    B, S, H, P, G, N, chunk = shape
    tdt, tol = SSD_DTYPES[dtype]
    x, dt, A, B_, C_ = _ssd_inputs(cuda_device, tdt, 14, B, S, H, P, G, N)
    inputs = [x, dt, A, B_, C_]
    init = None
    if final_state:
        init = torch.from_numpy(np.random.default_rng(15).standard_normal(
            (B, H, P, N)).astype(np.float32)).to(cuda_device)
        inputs.append(init)
    inputs = [t.requires_grad_() for t in inputs]
    init = inputs[5] if final_state else None
    kw = dict(chunk=chunk, initial_state=init, return_final_state=final_state)
    gy = torch.randn(x.shape, generator=torch.Generator(cuda_device).manual_seed(16),
                     device=cuda_device).to(tdt)
    before = dict(ssd_kernel.LAUNCHES)
    y, state = ssd_kernel.ssd(*inputs[:5], **kw)
    assert y.grad_fn is not None and (state is not None) == final_state
    outs, grads = [y], [gy]
    if final_state:
        outs.append(state)
        grads.append(torch.ones_like(state))
    got = torch.autograd.grad(outs, inputs, grads)
    torch.cuda.synchronize()
    assert {n: ssd_kernel.LAUNCHES[n] - before[n] for n in before} == {"ssd": 1,
                                                                     "ssd_backward": 1}
    want_y, want_state = ssd_ref.ssd_reference(*inputs[:5], **kw)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
    want = torch.autograd.grad([want_y] + ([want_state] if final_state else []), inputs,
                               grads)
    # dA sums over every row and position, dB and dC over each group's heads
    # (80 at G = 1) and the chunk's positions; ddt passes through the chunk's
    # suffix sums of the cum gradient (up to 256 positions)
    _close_grads(got, want, dtype, tol, summed=(1, 2, 3, 4))


# the scan's backward kernel against its plain version: each gradient's
# relative L2 (f32: every product an fp32 FMA, sums in another order; bf16:
# dx, dB and dC rounded once, at the store)
SSD_BWD_REL_L2 = {"float32": 1e-4, "bfloat16": 2e-2}
# (id, (B, S, H, P, G, N, chunk), an initial state and a final-state gradient,
# a dt = 0 padded tail of this many positions): the reference's sweep, G = 2,
# chunks of 1 and 2, one chunk and several, a ragged chunk, both states, a
# padded tail, mamba2-2.7b's and zamba2-2.7b's training calls, a prime head
# count (no sub-group count of the bf16 chunk-local pass but 1 and H divides
# it: a short last sub-group, and a warpgroup with no head in it) and G = 8
# over 80 heads
SSD_BWD_CASES = [
    ("sweep-2-chunks", (1, 64, 2, 16, 1, 16, 16), False, 0),
    ("sweep-G2", (2, 128, 4, 32, 2, 8, 32), False, 0),
    ("sweep-3-chunks", (1, 96, 6, 16, 1, 32, 32), False, 0),
    ("sweep-1-chunk-G4", (2, 64, 8, 64, 4, 16, 64), False, 0),
    ("chunk-1", (2, 5, 80, 64, 1, 128, 1), True, 0),
    ("chunk-2", (1, 6, 80, 64, 1, 64, 2), True, 0),
    ("ragged-chunk-137", (1, 137, 8, 64, 1, 128, 137), False, 0),
    ("states-3-chunks", (2, 768, 80, 64, 1, 128, 256), True, 0),
    ("dt-0-tail", (1, 512, 80, 64, 1, 128, 256), True, 375),
    ("mamba2-train", (8, 1024, 80, 64, 1, 128, 256), False, 0),
    ("zamba2-train", (8, 1024, 80, 64, 1, 64, 256), False, 0),
    ("heads-53", (4, 1024, 53, 64, 1, 128, 256), False, 0),
    ("G8-H80", (2, 1024, 80, 64, 8, 64, 256), True, 0),
]


@pytest.mark.parametrize("dtype", list(SSD_DTYPES))
@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=[c[0] for c in SSD_BWD_CASES])
def test_ssd_backward_kernel_matches_its_plain_version(case, dtype, cuda_device):
    """``ssd_backward`` against ``ref.ssd_backward_reference`` on the same
    tensors (x, B and C strided views at the sweep's first case; dy a
    transposed view, which the wrapper makes contiguous); one launch; dx
    exactly 0 on a dt = 0 tail; two runs give the same bits."""
    _, (B, S, H, P, G, N, chunk), states, pad = case
    tdt, _ = SSD_DTYPES[dtype]
    x, dt, A, B_, C_ = _ssd_inputs(cuda_device, tdt, 21, B, S, H, P, G, N)
    if case[0] == "sweep-2-chunks":
        x = torch.cat([x, x], dim=-1)[..., :P]
        B_ = torch.cat([B_, C_], dim=2)[:, :, :G]
    gen = torch.Generator(cuda_device).manual_seed(22)
    dy = torch.randn((B, S, P, H), generator=gen, device=cuda_device).to(tdt).transpose(2, 3)
    h0 = df = None
    if states:
        h0, df = (torch.randn((B, H, P, N), generator=gen, device=cuda_device)
                  for _ in range(2))
    if pad:
        for t in (x, dt, B_, C_, dy):
            t[:, S - pad:] = 0
    before = ssd_kernel.LAUNCHES["ssd_backward"]
    got = ssd_kernel.ssd_backward(x, dt, A, B_, C_, dy, chunk=chunk, initial_state=h0,
                                  dfinal=df)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES["ssd_backward"] == before + 1
    want = ssd_ref.ssd_backward_reference(x, dt, A, B_, C_, dy, chunk=chunk, initial_state=h0,
                                          dfinal=df)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dinit"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= SSD_BWD_REL_L2[dtype], f"{name}: relative L2 {rel:.3e}"
    if pad:
        assert torch.equal(got[0][:, S - pad:], torch.zeros_like(got[0][:, S - pad:]))
    again = ssd_kernel.ssd_backward(x, dt, A, B_, C_, dy, chunk=chunk, initial_state=h0,
                                    dfinal=df)
    assert all(torch.equal(a, b) for a, b in zip(again, got) if a is not None)


def test_ssd_backward_splits_53_heads_unevenly(cuda_device):
    """The heads-53 case above runs the bf16 chunk-local pass with a sub-group
    count that does not divide the heads (53 is prime: any count but 1 and
    53); float32 keeps one."""
    lib = ssd_kernel._lib("ssd_backward")
    s = lib.ssd_backward_subgroups(1, 4, 1024, 53, 1, 128, 256)
    assert 1 < s < 53, s
    assert lib.ssd_backward_subgroups(0, 4, 1024, 53, 1, 128, 256) == 1


def test_ssd_backward_refuses_what_it_does_not_take(cuda_device):
    x, dt, A, B_, C_ = _ssd_inputs(cuda_device, torch.float32, 23, 1, 32, 2, 16, 1, 16)
    dy = torch.ones_like(x)
    bwd = functools.partial(ssd_kernel.ssd_backward, chunk=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bwd(x.half(), dt, A, B_.half(), C_.half(), dy.half())
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        bwd(x, dt, A.cpu(), B_, C_, dy)
    with pytest.raises(ValueError, match="dy must be"):
        bwd(x, dt, A, B_, C_, dy.bfloat16())
    with pytest.raises(ValueError, match="dy must be"):
        bwd(x, dt, A, B_, C_, dy[:, :16])
    with pytest.raises(ValueError, match="dfinal must be"):
        bwd(x, dt, A, B_, C_, dy, dfinal=torch.zeros((1, 2, 16, 8), device=cuda_device))
    with pytest.raises(ValueError, match="chunk 24 must be"):
        ssd_kernel.ssd_backward(x, dt, A, B_, C_, dy, chunk=24)
    with pytest.raises(ValueError, match="above the kernel's"):
        big = torch.zeros((1, 32, 2, 80), device=cuda_device)
        bwd(big, dt, A, B_, C_, torch.zeros_like(big))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b", "minicpm3-4b",
                                  "whisper-small", "internvl2-26b"])
def test_model_loss_backward_reaches_every_weight(arch, cuda_device):
    """A reduced model's loss backward through the kernels (remat on) gives
    every weight a nonzero gradient, close to the plain path's (f32), and
    launches flash attention and the add + norm twice a layer (forward and
    recompute) and their backward kernels once."""
    cfg = get_reduced(arch).with_(dtype="float32")
    model = Model(cfg, device=cuda_device).init(torch.Generator(cuda_device).manual_seed(0))
    model.requires_grad_(True)
    r = np.random.default_rng(12)
    batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab, (2, 24))).to(cuda_device)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.n_patches, cfg.d_model, device=cuda_device)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model, device=cuda_device)
    names, leaves = zip(*model.named_parameters())
    grads = {}
    for impl in ("auto", "ref"):
        model.kernel_impl = impl
        tkernel.reset_launches()
        rms_kernel.reset_launches()
        loss, _ = model.loss(batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
        if impl == "auto":
            encdec = cfg.family == "encdec"   # encoder self, decoder self + cross; LayerNorms
            per_forward = cfg.n_enc_layers + 2 * cfg.n_layers if encdec else cfg.n_layers
            assert tkernel.LAUNCHES["flash_attention"] == 2 * per_forward
            assert tkernel.LAUNCHES["flash_attention_backward"] == per_forward
            assert rms_kernel.LAUNCHES["fused_add_rmsnorm"] == (0 if encdec else 2 * cfg.n_layers)
            assert rms_kernel.LAUNCHES["fused_add_rmsnorm_backward"] == (
                0 if encdec else cfg.n_layers)
            assert tkernel.LAUNCHES["decode_attention"] == 0
    for name, g, w in zip(names, grads["auto"], grads["ref"]):
        assert g is not None and float(g.abs().max()) > 0, f"{name} has no gradient"
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * float(w.abs().max()))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_families_do_not_train_on_the_card_yet(arch, cuda_device):
    """The ssm and hybrid families train on the card: a reduced model's loss
    backward through the kernels (remat on) gives every weight a nonzero
    gradient close to the plain path's (f32), and launches the scan twice a
    Mamba2 layer (forward and recompute) and its backward kernel once, the
    hybrid's shared block's flash attention and add + norm twice a group and
    their backward kernels once."""
    cfg = get_reduced(arch).with_(dtype="float32")
    model = Model(cfg, device=cuda_device).init(torch.Generator(cuda_device).manual_seed(0))
    model.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab, (2, 24)))
    batch = {"tokens": tokens.to(cuda_device)}
    names, leaves = zip(*model.named_parameters())
    grads = {}
    for impl in ("auto", "ref"):
        model.kernel_impl = impl
        for mod in (tkernel, rms_kernel, ssd_kernel):
            mod.reset_launches()
        loss, _ = model.loss(batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
        if impl == "auto":
            groups = cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid" else 0
            assert ssd_kernel.LAUNCHES["ssd"] == 2 * cfg.n_layers
            assert tkernel.LAUNCHES["flash_attention"] == 2 * groups
            assert tkernel.LAUNCHES["flash_attention_backward"] == groups
            assert rms_kernel.LAUNCHES["fused_add_rmsnorm"] == 2 * groups
            assert rms_kernel.LAUNCHES["fused_add_rmsnorm_backward"] == groups
            assert ssd_kernel.LAUNCHES["ssd_backward"] == cfg.n_layers
            assert tkernel.LAUNCHES["decode_attention"] == 0
    for name, g, w in zip(names, grads["auto"], grads["ref"]):
        assert g is not None and float(g.abs().max()) > 0, f"{name} has no gradient"
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * float(w.abs().max()))


def test_one_decode_32k_step_at_8_slots(cuda_device):
    """One step of the ``decode_32k`` cell through ``build_decode_step`` on
    full-width bf16 qwen2-0.5b (random weights from seed 0), 8 slots of a
    32768-position cache filled with seeded random values, at pos = 32767:
    the kernels' next tokens equal the plain path's or part at a near-tie
    (bf16 logits within 0.25, chip_smoke.py's SLICE_BF16_TOL)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.training.steps import build_decode_step

    S, B, tol = SHAPES["decode_32k"].seq_len, 8, 0.25
    model = Model(get_config("qwen2-0.5b"), device=cuda_device).init(
        torch.Generator(cuda_device).manual_seed(0))
    gen = torch.Generator(cuda_device).manual_seed(1)
    cache = model.init_cache(B, S)
    for leaf in cache.values():
        leaf.normal_(generator=gen)
    token = torch.randint(0, model.cfg.vocab, (B, 1), generator=gen, device=cuda_device)
    pos = torch.tensor(S - 1, device=cuda_device)
    tkernel.reset_launches()
    nxt, out = build_decode_step(model).fn(model.params, token, cache, pos)
    assert out is cache and tkernel.LAUNCHES["decode_attention"] == model.cfg.n_layers
    with torch.no_grad():
        got, _ = model.decode_step(token, cache, pos)
        model.kernel_impl = "ref"
        want, _ = model.decode_step(token, cache, pos)
    assert torch.isfinite(got).all() and nxt.shape == (B, 1)
    torch.testing.assert_close(nxt[:, 0].long(), got.argmax(-1))
    assert (got.float() - want.float()).abs().max().item() <= tol
    gap = want.amax(-1) - want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
    assert gap.max().item() <= tol
