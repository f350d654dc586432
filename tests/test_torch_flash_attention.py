"""The port's attention against the JAX package's.

On the CPU the port's plain versions (``ref.py``, and the kernel wrappers,
which take the plain path for CPU tensors) are held against JAX's ``ref.*``
and, on a few cases, ``flash_attention_pallas(interpret=True)``, on the same
numpy inputs, at the reference's tolerances (2e-5 f32, 2e-2 bf16;
tests/test_kernels_flash.py:18). The CUDA kernels themselves are held against
the plain version on the card by tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    decode_attention_pallas,
    flash_attention_pallas,
)
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SHAPES = [  # B, Sq, Skv, H, KV, hd — the sweep of tests/test_kernels_flash.py
    (1, 64, 64, 4, 4, 32),     # MHA
    (2, 128, 128, 8, 2, 64),   # GQA 4:1
    (1, 96, 96, 6, 1, 16),     # MQA, non-pow2 heads
    (1, 100, 132, 4, 2, 32),   # unaligned seq
    (2, 32, 256, 4, 4, 64),    # Skv >> Sq
]
SWEEP = [(s, c) for s in SHAPES for c in (True, False) if not (c and s[1] != s[2])]


def _inputs(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


def _close(ours, theirs, tol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,causal", SWEEP, ids=[f"{s}-causal={c}" for s, c in SWEEP])
def test_mha_reference_matches_jax(shape, causal, dtype):
    B, Sq, Skv, H, KV, hd = shape
    arrs = _inputs(0, (B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    _close(tref.mha_reference(q, k, v, causal=causal),
           jref.mha_reference(jq, jk, jv, causal=causal), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv_len", [20, 1, 64, [7, 40]], ids=["20", "1", "64", "per-row"])
def test_kv_len_masking_matches_jax(kv_len, dtype):
    B = 2
    arrs = _inputs(1, (B, 16, 2, 16), (B, 64, 2, 16), (B, 64, 2, 16))
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    _close(tref.mha_reference(q, k, v, causal=False, kv_len=torch.tensor(kv_len)),
           jref.mha_reference(jq, jk, jv, causal=False, kv_len=jnp.asarray(kv_len, jnp.int32)),
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q_offset", [0, 17, 48])
def test_q_offset_matches_jax(q_offset, dtype):
    S = 64
    arrs = _inputs(2, (1, S - q_offset, 2, 16), (1, S, 2, 16), (1, S, 2, 16))
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    _close(tref.mha_reference(q, k, v, causal=True, q_offset=q_offset),
           jref.mha_reference(jq, jk, jv, causal=True, q_offset=jnp.int32(q_offset)),
           DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv", [1, 2, 4])
@pytest.mark.parametrize("pos", [0, 23, 47])
def test_decode_scalar_pos_matches_jax(pos, kv, dtype):
    B, S, H, hd = 2, 48, 4, 16
    arrs = _inputs(3, (B, 1, H, hd), (B, S, kv, hd), (B, S, kv, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    _close(tref.decode_attention_reference(q, k, v, torch.tensor(pos, dtype=torch.int32)),
           jref.decode_attention_reference(jq, jk, jv, jnp.int32(pos)), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv", [1, 2])
def test_decode_vector_pos_matches_jax(kv, dtype):
    B, S, H, hd = 3, 32, 4, 16
    arrs = _inputs(4, (B, 1, H, hd), (B, S, kv, hd), (B, S, kv, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    pos = np.array([3, 17, 31], np.int32)
    _close(tref.decode_attention_reference(q, k, v, torch.from_numpy(pos)),
           jref.decode_attention_reference(jq, jk, jv, jnp.asarray(pos)), DTYPES[dtype][2])


@pytest.mark.parametrize("case", ["gqa-causal", "mqa-noncausal", "kv_len"])
def test_port_matches_pallas_interpret(case):
    """A few cases against the Pallas kernel itself, run as its own tests run it."""
    if case == "gqa-causal":
        B, Sq, Skv, H, KV, hd, causal, kw = 1, 64, 64, 6, 2, 16, True, {}
    elif case == "mqa-noncausal":
        B, Sq, Skv, H, KV, hd, causal, kw = 1, 40, 72, 4, 1, 16, False, {}
    else:
        B, Sq, Skv, H, KV, hd, causal, kw = 1, 16, 64, 2, 2, 16, False, {"kv_len": 20}
    arrs = _inputs(5, (B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, "float32")
    jkw = {n: jnp.int32(x) for n, x in kw.items()}
    theirs = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=16, block_k=16,
                                    interpret=True, **jkw)
    _close(tops.flash_attention(q, k, v, causal=causal, **kw), theirs, 2e-5)


WHISPER_CASES = {  # B, Sq, Skv, H, KV, hd: non-causal, Skv not a multiple of 128 (nor 64)
    "cross-decode-sq1": (3, 1, 150, 4, 4, 16),     # one token against every encoder key
    "cross-prefill-sq7": (1, 7, 150, 4, 4, 16),    # a prompt against the encoder's keys
    "cross-prefill-sq64": (2, 64, 150, 4, 4, 16),
    "encoder-square": (1, 150, 150, 4, 4, 16),     # the encoder's own attention
}


@pytest.mark.parametrize("case", list(WHISPER_CASES))
def test_whisper_attention_matches_pallas_interpret(case):
    """The encoder-decoder family's flash calls (all non-causal) against the
    Pallas kernel in interpret mode: Sq = 1, Sq < Skv and Sq = Skv, against
    key counts that fill no whole block."""
    B, Sq, Skv, H, KV, hd = WHISPER_CASES[case]
    arrs = _inputs(8, (B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, "float32")
    theirs = flash_attention_pallas(jq, jk, jv, causal=False, block_q=16, block_k=16,
                                    interpret=True)
    ours = tops.flash_attention(q, k, v, causal=False)
    assert ours.shape == (B, Sq, H, hd)
    _close(ours, theirs, 2e-5)


def test_cross_attention_over_an_empty_slot_gives_zeros():
    """An idle engine slot's cross keys and values are zeros: its Sq = 1
    cross-attention gives zeros, not NaN, as the Pallas kernel does."""
    q = _inputs(9, (2, 1, 4, 16))[0]
    kv = np.zeros((2, 150, 4, 16), np.float32)
    theirs = flash_attention_pallas(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                                    causal=False, block_q=16, block_k=16, interpret=True)
    ours = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                                torch.from_numpy(kv), causal=False)
    assert torch.equal(ours, torch.zeros_like(ours))
    _close(ours, theirs, 0.0)


def test_decode_matches_pallas_interpret_vector_pos():
    B, S, KV, H, hd = 3, 32, 2, 4, 16
    arrs = _inputs(6, (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, "float32")
    pos = np.array([0, 17, 31], np.int32)
    theirs = decode_attention_pallas(jq, jk, jv, jnp.asarray(pos), interpret=True)
    _close(tops.decode_attention(q, k, v, torch.from_numpy(pos)), theirs, 3e-5)


# ---------------------------------------------------------------- dispatch on the CPU
def test_cpu_wrappers_take_the_plain_path_and_count_no_launch():
    arrs = _inputs(7, (1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    before = dict(tkernel.LAUNCHES)
    out = tkernel.flash_attention(q, k, v, causal=True)
    dec = tkernel.decode_attention(q[:, :1], k, v, torch.tensor([5]))
    assert torch.equal(out, tref.mha_reference(q, k, v, causal=True))
    assert torch.equal(dec, tref.decode_attention_reference(q[:, :1], k, v, torch.tensor([5])))
    assert tkernel.LAUNCHES == before


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_ops_dispatch_on_cpu_is_the_reference(impl):
    arrs = _inputs(8, (2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    assert torch.equal(tops.flash_attention(q, k, v, impl=impl),
                       tref.mha_reference(q, k, v))
    pos = torch.tensor([3, 7])
    assert torch.equal(tops.decode_attention(q[:, :1], k, v, pos, impl=impl),
                       tref.decode_attention_reference(q[:, :1], k, v, pos))


def test_ops_rejects_kernel_on_cpu_and_unknown_impl():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        tops.flash_attention(q, q, q, impl="kernel")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.decode_attention(q[:, :1], q, q, 0, impl="pallas")


def test_fully_masked_rows_stay_finite():
    """A row with no valid key gives zeros, as the CUDA kernels do: finite,
    not NaN, and not JAX's mean of v over every key."""
    arrs = _inputs(9, (1, 4, 2, 8), (1, 6, 2, 8), (1, 6, 2, 8))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    out = tref.mha_reference(q, k, v, causal=False, kv_len=0)
    assert torch.isfinite(out).all()
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["mha-kv_len-0", "decode-pos-minus-1"])
def test_no_valid_key_gives_exact_zeros(fn, dtype):
    """kv_len = 0 (prefill) and pos = -1 (decode): every row is empty."""
    tdt = DTYPES[dtype][1]
    arrs = _inputs(12, (2, 5, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16))
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    if fn == "mha-kv_len-0":
        out = tref.mha_reference(q, k, v, causal=False, kv_len=torch.tensor(0))
        assert out.shape == q.shape
    else:
        out = tref.decode_attention_reference(q[:, :1], k, v, torch.tensor([-1, -1]))
        assert out.shape == q[:, :1].shape
    assert out.dtype == tdt
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["mha-kv_len", "decode-pos"])
def test_empty_row_leaves_the_other_rows_as_jax(fn, dtype):
    """A batch that mixes a zero-length row with a normal one: the empty row
    is zeros, the other row equals JAX's reference at its tolerance."""
    arrs = _inputs(13, (2, 6, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16))
    (jq, jk, jv), (q, k, v) = _both(arrs, dtype)
    if fn == "mha-kv_len":
        lens = np.array([0, 23], np.int32)
        ours = tref.mha_reference(q, k, v, causal=False, kv_len=torch.from_numpy(lens))
        theirs = jref.mha_reference(jq, jk, jv, causal=False, kv_len=jnp.asarray(lens))
    else:
        pos = np.array([17, -1], np.int32)
        ours = tref.decode_attention_reference(q[:, :1], k, v, torch.from_numpy(pos))
        theirs = jref.decode_attention_reference(jq[:, :1], jk, jv, jnp.asarray(pos))
    empty = 0 if fn == "mha-kv_len" else 1
    assert torch.equal(ours[empty], torch.zeros_like(ours[empty]))
    _close(ours[1 - empty], theirs[1 - empty], DTYPES[dtype][2])



# ------------------------------------------- the kernels' decompositions, in plain torch
def _split_kv_decode(q, k, v, pos, split):
    """The decode kernel's algorithm: per split of ``split`` cache positions a
    local max, sum and unnormalised accumulator; then a log-sum-exp merge of
    the live splits of each row (csrc/decode_attention.cu, passes 1 and 2)."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    out = torch.zeros(B, H, hd)
    for b in range(B):
        L = min(max(int(pos[b]) + 1, 0), S)
        qg = q[b, 0].float().reshape(KV, G, hd)
        parts = []
        for s0 in range(0, L, split):
            kk, vv = k[b, s0:min(s0 + split, L)].float(), v[b, s0:min(s0 + split, L)].float()
            s = torch.einsum("kgd,nkd->kgn", qg, kk) * hd ** -0.5
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgn,nkd->kgd", p, vv)))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        num = sum(torch.exp(m - M)[..., None] * acc for m, _, acc in parts)
        den = sum(torch.exp(m - M) * l for m, l, _ in parts)
        out[b] = (num / den[..., None]).reshape(H, hd)
    return out[:, None]


@pytest.mark.parametrize("lens", ["1", "split", "split+1", "S", "mix"])
@pytest.mark.parametrize("H,KV,hd", [(14, 2, 64), (4, 4, 80)], ids=["qwen2-heads", "zamba2-heads"])
def test_split_kv_decode_matches_jax(H, KV, hd, lens):
    """The split-KV decomposition at the SPLIT the kernel uses, in f32 against
    JAX's reference: lengths 1, SPLIT, SPLIT + 1, the whole cache and a mix."""
    split = tkernel.DECODE_SPLIT
    S = 3 * split + 44
    per_row = {"1": [1] * 2, "split": [split] * 2, "split+1": [split + 1] * 2, "S": [S] * 2,
               "mix": [1, split - 1, split, split + 1, 2 * split + 7, S]}[lens]
    B = len(per_row)
    arrs = _inputs(10, (B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, "float32")
    pos = np.array(per_row, np.int32) - 1
    _close(_split_kv_decode(q, k, v, pos, split),
           jref.decode_attention_reference(jq, jk, jv, jnp.asarray(pos)), 2e-5)


def _blocked_prefill_p_bf16(q, k, v, block=64):
    """The bf16 prefill kernel's algorithm: causal, 64 x 64 tiles, fp32 scores,
    an online softmax in log2 units, P rounded to bf16 before P V, the fp32
    accumulator divided by the row sum at the end (csrc/flash_attention.cu)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale_log2 = hd ** -0.5 * 1.4426950408889634
    qg = q.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    out = torch.zeros(B, Sq, KV, G, hd)
    for q0 in range(0, Sq, block):
        rows = torch.arange(q0, min(q0 + block, Sq))
        m = torch.full((B, KV, G, len(rows)), tref.NEG_INF)
        l = torch.zeros(B, KV, G, len(rows))
        acc = torch.zeros(B, KV, G, len(rows), hd)
        for k0 in range(0, min(Skv, int(rows[-1]) + 1), block):
            keys = torch.arange(k0, min(k0 + block, Skv))
            s = torch.einsum("brkgd,bnkd->bkgrn", qg[:, rows], kf[:, keys]) * scale_log2
            s = torch.where(keys[None, :] <= rows[:, None], s, tref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            m_use = torch.where(m_new == tref.NEG_INF, 0.0, m_new)
            p = torch.exp2(s - m_use[..., None])
            corr = torch.exp2(m - m_use)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgrn,bnkd->bkgrd", p.to(torch.bfloat16).float(), vf[:, keys])
            m = m_new
        out[:, rows] = (acc / l[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 200, 14, 2, 64), (1, 200, 32, 32, 80)],
                         ids=["qwen2-heads", "zamba2-heads"])
def test_blocked_prefill_with_bf16_p_matches_jax(B, S, H, KV, hd):
    """Rounding P to bf16 before P V (the one place the wgmma kernel departs
    from ref.py's fp32 P) stays inside the bf16 tolerance of 2e-2."""
    arrs = _inputs(11, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    (jq, jk, jv), (q, k, v) = _both(arrs, "bfloat16")
    _close(_blocked_prefill_p_bf16(q, k, v), jref.mha_reference(jq, jk, jv, causal=True), 2e-2)
